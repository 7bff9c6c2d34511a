import numpy as np
import pytest

import cusp_autotuned_tpu as ct
from cusp_autotuned_tpu import gallery
from cusp_autotuned_tpu.solvers import cg, Monitor
from cusp_autotuned_tpu.operators import make_linear_operator
from cusp_autotuned_tpu.ops.format_utils import extract_diagonal


def test_cg_poisson_identity():
    """Milestone config: CG on poisson5pt converging (BASELINE.json #1)."""
    A = gallery.poisson5pt(20, 20, format="csr", dtype=np.float64)
    n = A.num_rows
    rng = np.random.RandomState(0)
    b = rng.randn(n)
    monitor = Monitor(b, iteration_limit=400, relative_tolerance=1e-6)
    x, monitor = cg(A, b, monitor=monitor)
    assert monitor.converged()
    r = b - np.asarray(ct.multiply(A, x))
    assert np.linalg.norm(r) <= 1e-6 * np.linalg.norm(b) * 1.01


@pytest.mark.parametrize("fmt", ["coo", "csr", "dia", "ell", "hyb"])
def test_cg_all_formats(fmt):
    A = gallery.poisson5pt(12, 12, format=fmt, dtype=np.float64)
    b = np.ones(A.num_rows)
    x, monitor = cg(A, b, monitor=Monitor(b, 300, 1e-8))
    assert monitor.converged()


def test_cg_with_jacobi_preconditioner():
    A = gallery.poisson5pt(15, 15, format="csr", dtype=np.float64)
    d = np.asarray(extract_diagonal(A))
    M = make_linear_operator(lambda r: r / d)
    b = np.ones(A.num_rows)
    x, mon_precond = cg(A, b, M=M, monitor=Monitor(b, 300, 1e-8))
    assert mon_precond.converged()


def test_monitor_semantics():
    b = np.array([3.0, 4.0])
    m = Monitor(b, iteration_limit=10, relative_tolerance=0.1)
    assert m.b_norm == 5.0
    assert m.tolerance() == pytest.approx(0.5)
    assert not m.finished(np.array([1.0, 0.0]))   # ||r||=1 > 0.5
    assert m.finished(np.array([0.3, 0.0]))       # converged
    assert m.converged()
    assert m.iteration_count() == 1
    assert m.residual_norm() == pytest.approx(0.3)
    assert m.immediate_rate() == pytest.approx(0.3)


def test_monitor_iteration_limit():
    b = np.ones(4)
    m = Monitor(b, iteration_limit=3, relative_tolerance=1e-30)
    for i in range(3):
        assert not m.finished(b)
    assert m.finished(b)          # hit the limit
    assert not m.converged()


def test_cg_with_matrix_free_operator():
    """Solvers accept any linear operator as A (cusp/linear_operator.h
    parity) — e.g. a tuned kernel closure or a matrix-free apply."""
    A = gallery.poisson5pt(12, 12, format="dia", dtype=np.float64)
    from cusp_autotuned_tpu.kernels.variants import build_spmv, default_config
    spmv = build_spmv(A, default_config(A))
    op = make_linear_operator(spmv, A.shape)
    b = np.ones(A.num_rows)
    x, mon = cg(op, b, monitor=Monitor(b, 300, 1e-8))
    assert mon.converged()
    r = b - np.asarray(ct.multiply(A, np.asarray(x)))
    assert np.linalg.norm(r) < 1e-6


def test_planned_operator_in_cg():
    # planned kernel arrays flow through the jitted solve as pytree leaves
    import jax
    from cusp_autotuned_tpu.operators import planned_operator, PlannedOperator
    from cusp_autotuned_tpu import solvers, gallery
    A = gallery.poisson9pt(24, 24, format="csr", dtype=np.float32)
    op = planned_operator(A, {"impl": "segsum"})
    assert isinstance(op, PlannedOperator)
    leaves = jax.tree_util.tree_leaves(op)
    assert len(leaves) >= 3          # the CSR container's arrays are leaves
    b = np.ones(A.num_rows, np.float32)
    x, mon = solvers.cg(op, b)
    assert mon.converged()
    r = b - np.asarray(ct.multiply(A, np.asarray(x)))
    assert np.linalg.norm(r) <= 1e-3 * np.linalg.norm(b)


def test_planned_operator_falls_back_to_function():
    # every rail now exposes its planned arrays, the default DIA slices
    # rail included: no rail falls back to a closure-holding
    # FunctionOperator, so no matrix is embedded in a compiled program
    from cusp_autotuned_tpu.operators import planned_operator, PlannedOperator
    from cusp_autotuned_tpu import gallery
    A = gallery.poisson5pt(20, 20, format="dia", dtype=np.float32)
    op = planned_operator(A)
    assert isinstance(op, PlannedOperator) and op.impl == "slices"
    x = np.ones(A.num_cols, np.float32)
    np.testing.assert_allclose(np.asarray(op(x)),
                               np.asarray(ct.multiply(A, x)), rtol=1e-5)


def test_planned_operator_across_solvers():
    # the planned operator drives every Krylov family, not just CG
    from cusp_autotuned_tpu.operators import planned_operator
    from cusp_autotuned_tpu import solvers, gallery
    A = gallery.poisson9pt(22, 22, format="csr", dtype=np.float32)
    op = planned_operator(A, {"impl": "rcm_dia"})
    b = np.ones(A.num_rows, np.float32)
    for solve in (solvers.bicgstab, solvers.cr, solvers.gmres):
        x, mon = solve(op, b)
        assert mon.converged(), solve.__name__
        r = b - np.asarray(ct.multiply(A, np.asarray(x)))
        assert np.linalg.norm(r) <= 2e-3 * np.linalg.norm(b), solve.__name__
