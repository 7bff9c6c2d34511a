#!/usr/bin/env python
"""SpMM, BLAS, and dispatch-overhead micro-benchmarks
(parity: performance/{spmm,blas,overhead})."""

from __future__ import annotations

import sys
import time

import numpy as np

sys.path.insert(0, ".")

from benchmarks.harness import time_fn_device


def bench_spmm(grid: int = 300, k: int = 32):
    import jax
    import jax.numpy as jnp
    from cusp_autotuned_tpu import gallery
    from cusp_autotuned_tpu.ops.multiply import multiply

    print(f"# SpMM: poisson5pt({grid}x{grid}) x dense ({grid*grid}, {k})")
    X = jnp.asarray(np.random.RandomState(0).randn(grid * grid, k)
                    .astype(np.float32))
    for fmt in ("dia", "ell", "csr"):
        A = gallery.poisson5pt(grid, grid, format=fmt, dtype=np.float32)
        f = jax.jit(lambda X, A=A: multiply(A, X))
        tm, t = time_fn_device(f, X)
        flops = 2 * A.nnz * k
        print(f"  {fmt:4s} {t*1e3:8.2f} ms (marg {tm*1e3:.3f})  "
              f"{flops/tm/1e9:8.2f} GFLOP/s (device time)")


def bench_blas(n: int = 1 << 22):
    import jax
    import jax.numpy as jnp
    from cusp_autotuned_tpu.ops import blas

    print(f"# BLAS-1 on {n} f32 elements")
    x = jnp.asarray(np.random.randn(n).astype(np.float32))
    y = jnp.asarray(np.random.randn(n).astype(np.float32))
    for name, f, bytes_ in [
        ("axpy", jax.jit(lambda x, y: blas.axpy(x, y, 2.0)), 12 * n),
        ("dot", jax.jit(lambda x, y: blas.dot(x, y)), 8 * n),
        ("nrm2", jax.jit(lambda x, y: blas.nrm2(x)), 4 * n),
    ]:
        tm, t = time_fn_device(f, x, y)
        print(f"  {name:5s} {t*1e6:9.1f} us (marg {tm*1e6:.1f})  "
              f"{bytes_/tm/1e9:8.2f} GB/s (device time)")


def bench_overhead(n_calls: int = 50):
    """Per-multiply dispatch overhead: eager vs tuner-routed vs jitted —
    the analogue of the reference's KTT argument-registration overhead
    benchmark (performance/overhead)."""
    import jax
    from cusp_autotuned_tpu import autotune, gallery
    from cusp_autotuned_tpu.ops.multiply import multiply

    A = gallery.poisson5pt(30, 30, format="dia", dtype=np.float32)
    x = np.ones(A.num_rows, np.float32)
    print("# dispatch overhead per multiply (900-row DIA)")

    jax.block_until_ready(multiply(A, x))
    t0 = time.perf_counter()
    for _ in range(n_calls):
        y = multiply(A, x)
    jax.block_until_ready(y)
    print(f"  eager multiply:        {(time.perf_counter()-t0)/n_calls*1e3:8.3f} ms")

    autotune.enable()
    try:
        jax.block_until_ready(multiply(A, x))
        t0 = time.perf_counter()
        for _ in range(n_calls):
            y = multiply(A, x)
        jax.block_until_ready(y)
        print(f"  tuner-routed multiply: {(time.perf_counter()-t0)/n_calls*1e3:8.3f} ms")
    finally:
        autotune.disable()

    f = jax.jit(lambda A, x: multiply(A, x))
    jax.block_until_ready(f(A, x))
    t0 = time.perf_counter()
    for _ in range(n_calls):
        y = f(A, x)
    jax.block_until_ready(y)
    print(f"  jitted multiply:       {(time.perf_counter()-t0)/n_calls*1e3:8.3f} ms")


def bench_spgemm(grid: int = 140):
    """Device SpGEMM (ESC sort + segment pass) and the Galerkin-style
    triple product — parity: the reference's generalized SpGEMM path
    (cusp/system/cuda/detail/multiply/spgemm.h); the AMG SETUP keeps its
    RAP on the host by design (SetupMatrixType split), so this measures
    the solve-path verb."""
    import time as _time
    import jax
    from cusp_autotuned_tpu import gallery
    from cusp_autotuned_tpu.ops.spgemm import spgemm

    A = gallery.poisson5pt(grid, grid, format="csr", dtype=np.float32)
    print(f"# SpGEMM: A@A, poisson5pt({grid}x{grid}), {A.nnz} nnz")
    C = spgemm(A, A)                      # compile + device-resident ESC
    jax.block_until_ready(C.val)
    t0 = _time.perf_counter()
    C = spgemm(A, A)
    jax.block_until_ready(C.val)
    dt = _time.perf_counter() - t0
    # flops = 2 * sum_k nnz(A[:,k]) * nnz(A[k,:]) ~ 2 * nnz * nnz/row
    flops = 2 * A.nnz * (A.nnz / max(A.num_rows, 1))
    print(f"  A@A: {dt*1e3:8.2f} ms warm, C nnz={C.nnz}, "
          f"~{flops/dt/1e9:.2f} GFLOP/s")


if __name__ == "__main__":
    bench_spmm()
    bench_blas()
    bench_overhead()
    bench_spgemm()
