"""On-chip end-to-end AMG-CG wall-clock at the reference's two headline
configurations (performance/amg/smoothed_aggregation.cu and the
performance/solver/cg.cu scale), with the model-guided per-level rails
(spmv_config={}).

Usage: python benchmarks/amg_endtoend.py [N] [rtol] [dtype]
  N      grid side (default 1000 -> 1M unknowns)
  rtol   relative tolerance (default 1e-5)
  dtype  float32|float64 (default float32)

Prints setup time, V-cycle device time, iterations, warm solve wall-clock,
and s/iter.  Reference analogue: performance/amg/smoothed_aggregation.cu
prints setup/solve timing and V-cycle counts for SA-AMG vs plain CG.
"""
from __future__ import annotations

import os
import sys
import time

import jax

if os.environ.get("JAX_PLATFORMS") == "cpu":
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from cusp_autotuned_tpu import gallery, solvers, autotune      # noqa: E402
from cusp_autotuned_tpu.precond.aggregation import \
    smoothed_aggregation                                       # noqa: E402
from cusp_autotuned_tpu.solvers.monitor import Monitor         # noqa: E402
from cusp_autotuned_tpu.utils.config import enable_compile_cache  # noqa: E402
from benchmarks.harness import time_fn_device                # noqa: E402


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 1000
    rtol = float(sys.argv[2]) if len(sys.argv) > 2 else 1e-5
    dtype = np.dtype(sys.argv[3] if len(sys.argv) > 3 else "float32")
    enable_compile_cache()

    A = gallery.poisson5pt(n, n, format="csr", dtype=dtype)
    print(f"poisson5pt {n}x{n}: {A.num_rows} rows, {A.num_entries} nnz, "
          f"rtol={rtol}, {dtype}")

    t0 = time.perf_counter()
    M = smoothed_aggregation(A, spmv_config={})
    t_setup = time.perf_counter() - t0
    print(f"setup (model-guided rails) {t_setup:.1f} s")
    for i, lvl in enumerate(M.levels):
        print(f"  level {i}: " + " ".join(
            f"{nm}={getattr(getattr(lvl, nm), 'impl', '-')}"
            for nm in ("Aop", "Rop", "Pop")))

    rng = np.random.RandomState(0)
    b = jnp.asarray(rng.randn(A.num_rows).astype(dtype))
    # M rides as a jit ARGUMENT: closing over it would embed every planned
    # array as a compile-request constant (size-capped, slow at 1M rows)
    tm, traw = time_fn_device(jax.jit(lambda v, M_: M_(v)), b, M)
    print(f"V-cycle device {tm*1e3:.2f} ms ({traw*1e3:.2f} ms/call)")

    # the CG operator itself goes through the cost model's zero-compile
    # pick (via_dia on this stencil)
    op = autotune.tuned_operator(A)

    limit = 2000
    xw, monw = solvers.cg(op, b, M=M, monitor=Monitor(b, limit, rtol))
    jax.block_until_ready(xw)   # compile + warm
    b2 = jnp.asarray(np.abs(rng.randn(A.num_rows)).astype(dtype) + 0.1)
    t0 = time.perf_counter()
    x, mon = solvers.cg(op, b2, M=M, monitor=Monitor(b2, limit, rtol))
    jax.block_until_ready(x)
    dt = time.perf_counter() - t0
    it = max(1, int(mon.iteration_count()))
    print(f"AMG-CG: {it} iterations, {dt:.3f} s warm "
          f"({dt/it*1e3:.1f} ms/iter), converged={mon.converged()}")

    # plain tuned CG for the end-to-end comparison (same b2)
    t0 = time.perf_counter()
    xp, monp = solvers.cg(op, b2, monitor=Monitor(b2, limit, rtol))
    jax.block_until_ready(xp)
    dtp0 = time.perf_counter() - t0   # cold-ish (compile may hit cache)
    t0 = time.perf_counter()
    b3 = jnp.asarray(np.abs(rng.randn(A.num_rows)).astype(dtype) + 0.2)
    xp, monp = solvers.cg(op, b3, monitor=Monitor(b3, limit, rtol))
    jax.block_until_ready(xp)
    dtp = time.perf_counter() - t0
    itp = max(1, int(monp.iteration_count()))
    print(f"plain CG: {itp} iterations, {dtp:.3f} s warm "
          f"({dtp/itp*1e3:.2f} ms/iter), converged={monp.converged()} "
          f"(first run {dtp0:.3f} s)")
    print(f"AMG end-to-end vs plain CG: {dtp/dt:.2f}x")


if __name__ == "__main__":
    main()
