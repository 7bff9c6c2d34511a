"""Large unstructured operators: planned kernels as solver arguments.

Every SpMV rail exposes its planned arrays; wrapping them in a
PlannedOperator makes those arrays pytree LEAVES, so a jitted Krylov solve
receives the matrix as an argument instead of compiling a copy of it into
the program.  Matrix size is then bounded by device memory, not by the
size of a compiled program."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import numpy as np

from cusp_autotuned_tpu import gallery, solvers, autotune
from cusp_autotuned_tpu.operators import jit_operator, planned_operator


def main():
    # an unstructured operator (CSR) through the segment-sum rail
    A = gallery.poisson9pt(120, 120, format="csr", dtype=np.float32)
    op = planned_operator(A, {"impl": "segsum"})
    b = np.ones(A.num_rows, np.float32)
    x, mon = solvers.cg(op, b, monitor=solvers.Monitor(b, 2000, 1e-5))
    print(f"planned-operator CG: converged={mon.converged()} "
          f"in {mon.iteration_count()} iterations")

    # or let the autotuner pick the configuration (offline search + cache)
    op2 = autotune.tuned_operator(A)
    y = op2(b)
    print(f"tuned operator ({op2.impl}) applied: "
          f"||y|| = {float(np.linalg.norm(y)):.3e}")

    # the planned arrays stay jit ARGUMENTS under jit_operator too: the
    # compiled program does not grow with the matrix (scale the grid up
    # and the same code runs at tens of millions of nonzeros)
    B = gallery.poisson9pt(300, 300, format="csr", dtype=np.float32)
    op3 = planned_operator(B, {"impl": "via_dia"})
    r = jit_operator(op3)(np.ones(B.num_cols, np.float32))
    text = jax.jit(lambda o, v: o(v)).lower(
        op3, np.ones(B.num_cols, np.float32)).as_text()
    print(f"via_dia SpMV on {B.num_rows} rows: "
          f"finite={bool(np.all(np.isfinite(np.asarray(r))))}, "
          f"lowered program {len(text)} characters")


if __name__ == "__main__":
    main()
