#!/usr/bin/env python
"""Autotuner gain report: default kernel vs tuned best per (matrix, format)
— the fork's headline result, rebuilt (BASELINE.md: 'per-matrix tuned config
beats the untuned default kernel')."""

from __future__ import annotations

import sys

import numpy as np

sys.path.insert(0, ".")

from benchmarks.harness import time_fn_device
from benchmarks.bytes_per_spmv import bytes_per_spmv


def run(small: bool = False, scale: int | None = None):
    import jax
    from benchmarks.spmv import matrix_suite
    from cusp_autotuned_tpu.ops.convert import convert
    from cusp_autotuned_tpu.kernels.variants import build_spmv, default_config
    from cusp_autotuned_tpu.backend.reference import reference_spmv
    from cusp_autotuned_tpu.autotune.tuner import Tuner
    from cusp_autotuned_tpu.utils.exceptions import FormatConversionException

    tuner = Tuner(warmup=1, repeats=3)
    print(f"{'matrix':16s} {'fmt':5s} {'default us':>11} {'tuned us':>10} "
          f"{'speedup':>8}  best config")
    for name, A0 in matrix_suite(small, scale):
        rng = np.random.RandomState(0)
        x = jax.numpy.asarray(rng.randn(A0.num_cols).astype(np.float32))
        for fmt in ("dia", "ell", "ellr", "csr", "coo"):
            try:
                A = convert(A0, fmt)
            except FormatConversionException:
                continue
            f_def = jax.jit(build_spmv(A, default_config(A)))
            t_def, _ = time_fn_device(f_def, x)
            tuner.tune(A, np.asarray(x), reference_computation=reference_spmv)
            best = tuner.best_configuration(A)
            f_best = jax.jit(build_spmv(A, best))
            t_best, _ = time_fn_device(f_best, x)
            print(f"{name:16s} {fmt:5s} {t_def*1e6:11.1f} {t_best*1e6:10.1f} "
                  f"{t_def/t_best:8.2f}x  {best}")


if __name__ == "__main__":
    import argparse
    p = argparse.ArgumentParser()
    p.add_argument("--small", action="store_true")
    p.add_argument("--scale", type=int, default=None)
    a = p.parse_args()
    run(small=a.small, scale=a.scale)
