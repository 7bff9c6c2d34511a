#!/usr/bin/env python
"""SpMV benchmark across formats × matrix suite.

Parity: performance/spmv (GFLOP/s = 2 nnz / t, GB/s vs the per-format byte
model, L2 error vs host oracle) over the reference's Laplacian-stencil suite
(testing/data/laplacian analogue — SuiteSparse downloads are unavailable in
this zero-egress environment, so the suite is the stencil family plus
synthetic diagonal and random matrices from the gallery).

Usage: python benchmarks/spmv.py [--tuned] [--csv out.csv] [--small]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

sys.path.insert(0, ".")

from benchmarks.harness import (time_fn_device, stream_bandwidth_gbps,
                                l2_error)
from benchmarks.bytes_per_spmv import bytes_per_spmv, flops_per_spmv


def matrix_suite(small: bool = False, scale: int | None = None):
    from cusp_autotuned_tpu import gallery
    s = scale if scale is not None else (10 if small else 1)
    yield "poisson5pt_2d", gallery.poisson5pt(1000 // s, 1000 // s, format="coo")
    yield "poisson9pt_2d", gallery.poisson9pt(1000 // s, 1000 // s, format="coo")
    yield "poisson7pt_3d", gallery.poisson7pt(100 // s, 100 // s, 100 // s,
                                              format="coo")
    yield "poisson27pt_3d", gallery.poisson27pt(64 // s, 64 // s, 64 // s,
                                                format="coo")
    yield "diag33", gallery.make_diagonal_symmetric_matrix(
        500_000 // s, 500_000 // s, 7, 33).asformat("coo")
    yield "random_8pr", gallery.random(100_000 // s, 100_000 // s,
                                       800_000 // s, format="coo")


FORMATS = ("csr", "dia", "ell", "ellr", "hyb", "coo")


def run(tuned: bool = False, small: bool = False, csv_path: str | None = None,
        scale: int | None = None):
    import jax
    from cusp_autotuned_tpu.ops.convert import convert
    from cusp_autotuned_tpu.kernels.variants import build_spmv, default_config
    from cusp_autotuned_tpu.backend.reference import reference_spmv
    from cusp_autotuned_tpu.utils.exceptions import (
        FormatConversionException, NotImplementedException)
    from cusp_autotuned_tpu.autotune.tuner import Tuner

    stream = stream_bandwidth_gbps()
    print(f"# stream baseline: {stream:.1f} GB/s "
          f"({jax.devices()[0].device_kind})")
    rows = []
    tuner = Tuner(warmup=1, repeats=3) if tuned else None
    for name, A0 in matrix_suite(small, scale):
        rng = np.random.RandomState(0)
        x = rng.randn(A0.num_cols).astype(np.float32)
        ref = reference_spmv(A0, x)
        for fmt in FORMATS:
            try:
                A = convert(A0, fmt)
            except FormatConversionException:
                continue
            config = default_config(A)
            if tuned:
                tuner.tune(A, x, reference_computation=reference_spmv)
                config = tuner.best_configuration(A)
            try:
                fn = jax.jit(build_spmv(A, config))
            except (NotImplementedException, FormatConversionException):
                continue
            xs = jax.numpy.asarray(x)
            err = l2_error(fn(xs), ref)
            # device time from the profiler trace; wall per call beside it
            tm, t = time_fn_device(fn, xs)
            gbs = bytes_per_spmv(A) / tm / 1e9
            gflops = flops_per_spmv(A) / tm / 1e9
            rows.append((name, fmt, str(config), t * 1e6, tm * 1e6, gflops,
                         gbs, gbs / stream, err))
            print(f"{name:16s} {fmt:5s} {t*1e6:9.1f}us "
                  f"marg {tm*1e6:8.1f}us {gflops:7.2f} GFLOP/s "
                  f"{gbs:8.2f} GB/s  {gbs/stream:6.1%} roofline  "
                  f"L2err {err:.2e}  {config}")
    if csv_path:
        import csv
        with open(csv_path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["matrix", "format", "config", "us", "marginal_us",
                        "gflops", "gbs", "roofline_frac", "l2_error"])
            w.writerows(rows)
    return rows


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--tuned", action="store_true",
                   help="tune each (matrix, format) and use the best config")
    p.add_argument("--small", action="store_true")
    p.add_argument("--scale", type=int, default=None,
                   help="divide suite dimensions by this factor")
    p.add_argument("--csv")
    a = p.parse_args()
    run(tuned=a.tuned, small=a.small, csv_path=a.csv, scale=a.scale)
