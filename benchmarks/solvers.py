#!/usr/bin/env python
"""Solver benchmarks.

Parity: performance/solver/cg.cu (CG on HYB poisson5pt 1000x1000, rel-tol
1e-5, <=2000 iterations — wall-clock + ms/iteration) and
performance/amg/smoothed_aggregation.cu (SA-AMG setup/solve timing + plain
CG vs AMG-CG iteration comparison).
"""

from __future__ import annotations

import sys
import time

import numpy as np

sys.path.insert(0, ".")


def bench_cg(grid: int = 1000):
    from cusp_autotuned_tpu import gallery
    from cusp_autotuned_tpu.solvers import cg, Monitor

    A = gallery.poisson5pt(grid, grid, format="hyb", dtype=np.float32)
    b = np.ones(A.num_rows, np.float32)
    monitor = Monitor(b, iteration_limit=2000, relative_tolerance=1e-5)
    t0 = time.perf_counter()
    x, monitor = cg(A, b, monitor=monitor)
    dt = time.perf_counter() - t0
    iters = monitor.iteration_count()
    print(f"CG hyb poisson5pt({grid}x{grid}): {dt*1e3:.1f} ms total, "
          f"{iters} iters, {dt*1e3/max(iters,1):.3f} ms/iter, "
          f"converged={monitor.converged()}")
    return dt, iters


def bench_amg(grid: int = 200, tol: float = 1e-10):
    from cusp_autotuned_tpu import gallery, precond
    from cusp_autotuned_tpu.solvers import cg, Monitor

    A = gallery.poisson5pt(grid, grid, format="csr", dtype=np.float64)
    b = np.ones(A.num_rows)
    t0 = time.perf_counter()
    M = precond.smoothed_aggregation(A)
    t_setup = time.perf_counter() - t0
    M.print()
    t0 = time.perf_counter()
    x, mon_amg = cg(A, b, M=M, monitor=Monitor(b, 1000, tol))
    t_amg = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, mon_cg = cg(A, b, monitor=Monitor(b, 10000, tol))
    t_cg = time.perf_counter() - t0
    print(f"SA-AMG setup: {t_setup*1e3:.1f} ms")
    print(f"AMG-CG solve: {t_amg*1e3:.1f} ms, {mon_amg.iteration_count()} "
          f"iters (converged={mon_amg.converged()})")
    print(f"plain CG:     {t_cg*1e3:.1f} ms, {mon_cg.iteration_count()} iters "
          f"(converged={mon_cg.converged()})")
    return t_setup, t_amg, t_cg


if __name__ == "__main__":
    import argparse
    p = argparse.ArgumentParser()
    p.add_argument("--grid", type=int, default=1000)
    p.add_argument("--amg-grid", type=int, default=200)
    a = p.parse_args()
    bench_cg(a.grid)
    bench_amg(a.amg_grid)
