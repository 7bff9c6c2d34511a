"""Smoothed-aggregation AMG as a CG preconditioner
(reference: examples/Preconditioners)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from cusp_autotuned_tpu import gallery, precond, solvers


def main():
    A = gallery.poisson5pt(150, 150, format="csr", dtype=np.float64)
    b = np.random.RandomState(0).randn(A.num_rows)

    M = precond.smoothed_aggregation(A)
    M.print()                      # hierarchy + complexity report

    x, mon_amg = solvers.cg(A, b, M=M, monitor=solvers.Monitor(b, 100, 1e-8))
    _, mon_cg = solvers.cg(A, b, monitor=solvers.Monitor(b, 2000, 1e-8))
    print(f"AMG-CG: {mon_amg.iteration_count()} iterations; "
          f"plain CG: {mon_cg.iteration_count()}")

    # every level's A/R/P can run through planned kernels (and the CG
    # operator too): spmv_config={} takes the cost model's pick per level
    # operator, tuned_operator the tuner's pick for A
    from cusp_autotuned_tpu.autotune import tuned_operator
    Af = gallery.poisson5pt(150, 150, format="csr", dtype=np.float32)
    Mt = precond.smoothed_aggregation(Af, spmv_config={})
    bt = np.asarray(b, np.float32)
    xt, mont = solvers.cg(tuned_operator(Af), bt, M=Mt,
                          monitor=solvers.Monitor(bt, 100, 1e-5))
    print(f"fully tuned AMG-CG: {mont.iteration_count()} iterations, "
          f"converged={mont.converged()}")


if __name__ == "__main__":
    main()
