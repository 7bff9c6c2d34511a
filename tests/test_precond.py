import io

import numpy as np
import pytest
import scipy.sparse as sp

import cusp_autotuned_tpu as ct
from cusp_autotuned_tpu import gallery, precond
from cusp_autotuned_tpu.solvers import cg, bicgstab, Monitor
from cusp_autotuned_tpu.ops.multiply import multiply
from tests.util import build


def _poisson(n=16):
    return gallery.poisson5pt(n, n, format="csr", dtype=np.float64)


def test_diagonal_preconditioner():
    A = _poisson()
    M = precond.diagonal(A)
    b = np.ones(A.num_rows)
    x, mon = cg(A, b, M=M, monitor=Monitor(b, 400, 1e-8))
    assert mon.converged()


def test_bridson_ainv_accelerates_cg():
    A = _poisson(10)
    b = np.ones(A.num_rows)
    _, mon_plain = cg(A, b, monitor=Monitor(b, 400, 1e-8))
    M = precond.bridson_ainv(A, drop_tolerance=0.05)
    x, mon = cg(A, b, M=M, monitor=Monitor(b, 400, 1e-8))
    assert mon.converged()
    assert mon.iteration_count() < mon_plain.iteration_count()


def test_scaled_bridson_ainv():
    A = _poisson(8)
    b = np.ones(A.num_rows)
    M = precond.scaled_bridson_ainv(A, drop_tolerance=0.05)
    x, mon = cg(A, b, M=M, monitor=Monitor(b, 300, 1e-8))
    assert mon.converged()


def test_nonsym_ainv_with_bicgstab():
    rng = np.random.RandomState(3)
    n = 80
    S = (sp.random(n, n, density=0.05, random_state=rng)
         + sp.diags(np.full(n, 4.0))).tocoo()
    A = build(S, "csr", dtype=np.float64)
    b = np.ones(n)
    M = precond.nonsym_bridson_ainv(A, drop_tolerance=0.05)
    x, mon = bicgstab(A, b, M=M, monitor=Monitor(b, 300, 1e-8))
    assert mon.converged()
    r = b - np.asarray(multiply(A, np.asarray(x)))
    assert np.linalg.norm(r) < 1e-6


def test_ainv_exact_when_no_dropping():
    """With drop_tolerance=0 and no caps, AINV is the exact inverse."""
    A = _poisson(4)
    M = precond.bridson_ainv(A, drop_tolerance=0.0, nonzero_per_row=-1)
    S = np.asarray(A.to_scipy().todense())
    r = np.random.RandomState(0).randn(16)
    np.testing.assert_allclose(np.asarray(M(r)), np.linalg.solve(S, r),
                               rtol=1e-8, atol=1e-10)


def test_smoothed_aggregation_preconditions_cg():
    A = _poisson(20)   # 400 rows -> single level + coarse
    b = np.random.RandomState(0).randn(A.num_rows)
    M = precond.smoothed_aggregation(A, min_level_size=50)
    mon = Monitor(b, 100, 1e-8)
    x, mon = cg(A, b, M=M, monitor=mon)
    assert mon.converged()
    # AMG-CG should converge far faster than plain CG
    _, mon_plain = cg(A, b, monitor=Monitor(b, 400, 1e-8))
    assert mon.iteration_count() < mon_plain.iteration_count() / 2


def test_smoothed_aggregation_standalone_solve():
    A = _poisson(20)
    b = np.ones(A.num_rows)
    M = precond.smoothed_aggregation(A, min_level_size=50)
    x, mon = M.solve(b, monitor=Monitor(b, 60, 1e-8))
    assert mon.converged()
    r = b - np.asarray(multiply(A, np.asarray(x)))
    assert np.linalg.norm(r) <= 1e-8 * np.linalg.norm(b) * 1.1


def test_sa_hierarchy_report():
    A = _poisson(20)
    M = precond.smoothed_aggregation(A, min_level_size=50)
    buf = io.StringIO()
    M.print(buf)
    out = buf.getvalue()
    assert "operator complexity" in out
    assert M.operator_complexity() >= 1.0
    assert M.grid_complexity() >= 1.0


@pytest.mark.parametrize("aggregator", ["standard", "mis"])
def test_sa_aggregators(aggregator):
    A = _poisson(12)
    b = np.ones(A.num_rows)
    M = precond.smoothed_aggregation(A, min_level_size=30,
                                     aggregator=aggregator)
    x, mon = cg(A, b, M=M, monitor=Monitor(b, 100, 1e-8))
    assert mon.converged()


@pytest.mark.parametrize("smoother", ["jacobi", "gauss_seidel", "polynomial"])
def test_sa_smoothers(smoother):
    A = _poisson(12)
    b = np.ones(A.num_rows)
    M = precond.smoothed_aggregation(A, min_level_size=30, smoother=smoother)
    x, mon = cg(A, b, M=M, monitor=Monitor(b, 150, 1e-8))
    assert mon.converged()


def test_strength_measures():
    from cusp_autotuned_tpu.precond.aggregation.strength import (
        symmetric_strength_of_connection, evolution_strength_of_connection,
    )
    A = gallery.diffusion(10, 10, eps=1e-3, format="csr", dtype=np.float64)
    C = symmetric_strength_of_connection(A, theta=0.25)
    assert C.nnz < A.nnz          # anisotropy filters weak couplings
    E = evolution_strength_of_connection(A)
    assert E.nnz <= A.nnz + A.num_rows


def test_evolution_strength_uses_candidate_B():
    """The near-nullspace argument must shape the measure (parity:
    evolution_strength.h:264-301 scales the approximation test by B) —
    a different candidate yields a different strength pattern, and the
    anisotropic pattern keeps the strong axis."""
    from cusp_autotuned_tpu.backend.reference import to_scipy
    from cusp_autotuned_tpu.precond.aggregation.strength import (
        evolution_strength_of_connection,
    )
    A = gallery.diffusion(20, 20, eps=1e-3, format="csr", dtype=np.float64)
    E_ones = evolution_strength_of_connection(A)
    rng = np.random.RandomState(3)
    E_rand = evolution_strength_of_connection(
        A, B=0.5 + rng.rand(A.num_rows))
    S1, S2 = to_scipy(E_ones).tocsr(), to_scipy(E_rand).tocsr()
    same = (S1.nnz == S2.nnz
            and np.array_equal(S1.indices, S2.indices))
    assert not same, "candidate B did not change the strength pattern"
    # the epsilon distance filter keeps a filtered pattern, diagonal intact
    assert S1.nnz < to_scipy(A).nnz + A.num_rows
    assert np.all(S1.diagonal() != 0)


def test_sa_amg_evolution_strength_anisotropic():
    """strength='evolution' is selectable and helps (or at least matches)
    symmetric strength on an anisotropic diffusion operator (parity:
    evolution_strength.h:180-399 exposed through smoothed_aggregation)."""
    from cusp_autotuned_tpu import gallery, solvers
    from cusp_autotuned_tpu.precond.aggregation import smoothed_aggregation
    from cusp_autotuned_tpu.solvers.monitor import Monitor
    A = gallery.diffusion(40, 40, eps=1e-3, theta=0.0, format="csr",
                          dtype=np.float64)
    b = np.ones(A.num_rows, np.float64)

    iters = {}
    for strength in ("symmetric", "evolution"):
        M = smoothed_aggregation(A, strength=strength)
        mon = Monitor(b, iteration_limit=200, relative_tolerance=1e-8)
        x, mon = solvers.cg(A, b, monitor=mon, M=M)
        assert mon.converged(), f"{strength} did not converge"
        iters[strength] = mon.iteration_count()
    # evolution strength must not be (much) worse; on anisotropy it usually
    # reduces the iteration count
    assert iters["evolution"] <= iters["symmetric"] + 2, iters


def test_smoothed_aggregation_with_level_operators():
    # per-level tuned apply operators (planned arrays as jit arguments)
    from cusp_autotuned_tpu.precond.aggregation import smoothed_aggregation
    from cusp_autotuned_tpu.operators import PlannedOperator
    from cusp_autotuned_tpu import solvers, gallery
    A = gallery.poisson5pt(40, 40, format="csr", dtype=np.float32)
    M = smoothed_aggregation(A, spmv_config={"impl": "segsum"})
    assert any(isinstance(l.Aop, PlannedOperator) for l in M.levels)
    b = np.ones(A.num_rows, np.float32)
    x, mon = solvers.cg(A, b, M=M)
    x0, mon0 = solvers.cg(A, b, M=smoothed_aggregation(A))
    assert mon.converged() and mon0.converged()
    assert abs(mon.iteration_count() - mon0.iteration_count()) <= 2
    np.testing.assert_allclose(np.asarray(x), np.asarray(x0),
                               rtol=1e-3, atol=1e-4)


def test_smoothed_aggregation_fine_R_plans():
    # every level operator, the wide fine-level restriction (coarse rows
    # x fine cols) included, is planned — none drops to the container
    # path
    from cusp_autotuned_tpu.precond.aggregation import smoothed_aggregation
    from cusp_autotuned_tpu.operators import (
        PlannedOperator, FactoredProlongator, FactoredRestriction)
    from cusp_autotuned_tpu import gallery
    A = gallery.poisson5pt(120, 120, format="csr", dtype=np.float32)
    M = smoothed_aggregation(A, spmv_config={})
    planned = (PlannedOperator, FactoredProlongator, FactoredRestriction)
    for i, lvl in enumerate(M.levels):
        for nm in ("Aop", "Rop", "Pop"):
            assert isinstance(getattr(lvl, nm), planned), \
                f"level {i} {nm} fell back to the container path"


def test_smoothed_aggregation_factored_rp():
    # on a structured level (A rides via_dia) the smoothed P/R applies are
    # FACTORED: P e = T e - s*Dinv*(A(T e)), R r = T^T (r - s*A*(Dinv r))
    # — the materialized P is a scattered 2-3 nnz/row pattern while the
    # factored form rides the structured A rail + a 1-nnz/row tentative
    # apply
    from cusp_autotuned_tpu.precond.aggregation import smoothed_aggregation
    from cusp_autotuned_tpu.operators import (
        FactoredProlongator, FactoredRestriction)
    from cusp_autotuned_tpu.backend.reference import to_scipy
    from cusp_autotuned_tpu import gallery
    A = gallery.poisson5pt(60, 60, format="csr", dtype=np.float32)
    M = smoothed_aggregation(A, spmv_config={})
    lvl = M.levels[0]
    assert isinstance(lvl.Pop, FactoredProlongator)
    assert isinstance(lvl.Rop, FactoredRestriction)
    rng = np.random.RandomState(0)
    Psp = to_scipy(lvl.P)
    e = rng.randn(lvl.P.num_cols).astype(np.float32)
    r = rng.randn(lvl.A.num_rows).astype(np.float32)
    np.testing.assert_allclose(np.asarray(lvl.prolong_op(e)), Psp @ e,
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(np.asarray(lvl.restrict_op(r)), Psp.T @ r,
                               rtol=2e-4, atol=2e-5)
    # block (2-D) applies broadcast Dinv down columns
    E = rng.randn(lvl.P.num_cols, 3).astype(np.float32)
    Rr = rng.randn(lvl.A.num_rows, 3).astype(np.float32)
    np.testing.assert_allclose(np.asarray(lvl.prolong_op(E)), Psp @ E,
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(np.asarray(lvl.restrict_op(Rr)), Psp.T @ Rr,
                               rtol=2e-4, atol=2e-5)


def test_factored_rp_nonsymmetric_falls_back():
    # R = P^T = T^T (I - s A^T Dinv) needs A^T; on a nonsymmetric level
    # the factored restriction must NOT be used (it would silently apply
    # A instead of A^T), while the factored prolongator is still valid
    from cusp_autotuned_tpu.precond.aggregation import smoothed_aggregation
    from cusp_autotuned_tpu.operators import FactoredRestriction
    from cusp_autotuned_tpu.backend.reference import to_scipy
    from cusp_autotuned_tpu import gallery
    from cusp_autotuned_tpu.backend.reference import from_scipy
    A0 = gallery.poisson5pt(60, 60, format="coo", dtype=np.float32)
    S = to_scipy(A0).tocoo()
    # skew the strict upper triangle to break symmetry
    S.data = np.where(S.row < S.col, 0.5 * S.data, S.data)
    A = from_scipy(S.tocsr(), "csr", dtype=np.float32)
    M = smoothed_aggregation(A, spmv_config={})
    lvl = M.levels[0]
    assert not isinstance(lvl.Rop, FactoredRestriction)
    rng = np.random.RandomState(1)
    r = rng.randn(lvl.A.num_rows).astype(np.float32)
    Psp = to_scipy(lvl.P)
    np.testing.assert_allclose(np.asarray(lvl.restrict_op(r)), Psp.T @ r,
                               rtol=2e-4, atol=2e-5)


def test_smoothed_aggregation_model_guided_rails(model_device):
    # spmv_config={}: each level operator asks the analytic cost model
    # (autotune.cost_model.recommend_config) — the levels span different
    # pattern classes (banded fine A, wide-rectangular R, tall P).  The
    # stencil fine A must land on the DIA rail; the hierarchy must still
    # precondition.
    from cusp_autotuned_tpu.precond.aggregation import smoothed_aggregation
    from cusp_autotuned_tpu import solvers, gallery
    A = gallery.poisson5pt(60, 60, format="csr", dtype=np.float32)
    M = smoothed_aggregation(A, spmv_config={})
    assert M.levels[0].Aop is not None
    assert M.levels[0].Aop.impl == "via_dia", M.levels[0].Aop.impl
    assert M.levels[0].Rop is not None and M.levels[0].Rop.impl
    b = np.ones(A.num_rows, np.float32)
    x, mon = solvers.cg(A, b, M=M)
    assert mon.converged()


def test_smoothed_aggregation_tuned_levels(monkeypatch):
    # spmv_config='tune': each (large-enough) level's A goes through the
    # cached autotuner; the pick is validated + persisted, so re-setups
    # reuse it (the AMG analogue of the reference's per-matrix KTT tuning)
    from cusp_autotuned_tpu.precond.aggregation import smoothed_aggregation
    from cusp_autotuned_tpu.autotune.tuner import (get_tuner,
                                                   matrix_signature, Tuner)
    from cusp_autotuned_tpu.autotune import tuner as tuner_mod
    from cusp_autotuned_tpu import solvers, gallery
    # validation-only global tuner: per-level timing is irrelevant to the
    # caching/plumbing under test and dominates the test's wall time
    monkeypatch.setattr(tuner_mod, "_global_tuner", Tuner(measure=False))
    A = gallery.poisson5pt(30, 30, format="csr", dtype=np.float32)
    M = smoothed_aggregation(A, spmv_config={"tune": True,
                                             "tune_min_rows": 1})
    assert M.levels[0].Aop is not None
    sig = matrix_signature(M.levels[0].A)
    store = get_tuner().results.get(sig, {})
    assert any(r.is_valid() for r in store.values()), (
        "tuner cached no validated result for the fine level")
    b = np.ones(A.num_rows, np.float32)
    x, mon = solvers.cg(A, b, M=M)
    assert mon.converged()
    # second setup must reuse the cache (no new walk): result count stable
    n_before = len(store)
    M2 = smoothed_aggregation(A, spmv_config={"tune": True,
                                              "tune_min_rows": 1})
    assert len(get_tuner().results.get(sig, {})) == n_before
    assert M2.levels[0].Aop is not None


def test_sa_amg_cg_poisson27pt_3d():
    """BASELINE north star: SA-AMG-preconditioned CG on the 3-D 27-point
    Poisson operator (reference workload class:
    performance/amg/smoothed_aggregation.cu on gallery/poisson.h:168) —
    converges to 1e-8 with a fraction of plain CG's iterations."""
    A = gallery.poisson27pt(9, 9, 9, format="csr", dtype=np.float64)
    b = np.random.RandomState(1).randn(A.num_rows)
    M = precond.smoothed_aggregation(A, min_level_size=60)
    x, mon = cg(A, b, M=M, monitor=Monitor(b, 100, 1e-8))
    assert mon.converged()
    r = b - np.asarray(multiply(A, np.asarray(x)))
    assert np.linalg.norm(r) <= 1e-7 * np.linalg.norm(b)
    _, mon_plain = cg(A, b, monitor=Monitor(b, 400, 1e-8))
    assert mon.iteration_count() < mon_plain.iteration_count() / 2


def test_sa_setup_stages_stay_on_host():
    """AMG setup is host-side planning: aggregation / tentative-fit
    outputs are numpy (not device arrays), and every setup product
    carries a host mirror — a device round trip per stage would cost a
    compile and a transfer per level."""
    from cusp_autotuned_tpu.precond.aggregation.strength import (
        symmetric_strength_of_connection)
    from cusp_autotuned_tpu.precond.aggregation.aggregate import (
        standard_aggregate)
    from cusp_autotuned_tpu.precond.aggregation.tentative import (
        fit_candidates)

    A = gallery.poisson5pt(30, 30, format="csr", dtype=np.float32)
    C = symmetric_strength_of_connection(A, 0.0)
    agg, roots = standard_aggregate(C)
    assert type(agg) is np.ndarray and type(roots) is np.ndarray
    T, Bc = fit_candidates(agg, np.ones(A.num_rows, np.float32))
    assert type(Bc) is np.ndarray
    assert getattr(T, "_host_coo", None) is not None
    M = precond.smoothed_aggregation(A)
    for lvl in M.levels:
        assert getattr(lvl.A, "_host_coo", None) is not None


def test_factored_rp_tiny_magnitude_nonsymmetric_falls_back():
    # ADVICE r3 (medium): the symmetry gate must be purely RELATIVE —
    # a nonsymmetric operator whose entries are all tiny (h^2-scaled)
    # must NOT pass as symmetric (the old absolute 1e-6 floor let it
    # through and FactoredRestriction silently applied A for A^T)
    from cusp_autotuned_tpu.precond.aggregation import smoothed_aggregation
    from cusp_autotuned_tpu.operators import FactoredRestriction
    from cusp_autotuned_tpu.backend.reference import to_scipy, from_scipy
    from cusp_autotuned_tpu import gallery
    A0 = gallery.poisson5pt(60, 60, format="coo", dtype=np.float32)
    S = to_scipy(A0).tocoo()
    S.data = np.where(S.row < S.col, 0.5 * S.data, S.data)
    S.data = (S.data * 1e-7).astype(np.float32)   # all entries < 1e-6
    A = from_scipy(S.tocsr(), "csr", dtype=np.float32)
    M = smoothed_aggregation(A, spmv_config={})
    lvl = M.levels[0]
    assert not isinstance(lvl.Rop, FactoredRestriction)
    rng = np.random.RandomState(1)
    r = rng.randn(lvl.A.num_rows).astype(np.float32)
    Psp = to_scipy(lvl.P)
    np.testing.assert_allclose(np.asarray(lvl.restrict_op(r)), Psp.T @ r,
                               rtol=2e-4, atol=2e-5)


def test_factored_rp_explicit_config_honored():
    # ADVICE r3 (low): with an explicit non-auto spmv_config the model
    # gate doesn't describe what would actually be built — the user's
    # rail is honored (no factored substitution) and applies stay correct.
    # The STRUCTURED factored form is exempt (it is model-free and
    # supersedes any rail on grid levels), so this contract is exercised
    # on a permuted — grid-structure-destroyed — operator.
    import scipy.sparse as sp
    from cusp_autotuned_tpu.precond.aggregation import smoothed_aggregation
    from cusp_autotuned_tpu.operators import (
        FactoredProlongator, FactoredRestriction)
    from cusp_autotuned_tpu.backend.reference import to_scipy, from_scipy
    from cusp_autotuned_tpu import gallery
    A0 = gallery.poisson5pt(60, 60, format="csr", dtype=np.float32)
    S = to_scipy(A0).tocsr()
    rng = np.random.RandomState(3)
    perm = rng.permutation(S.shape[0])
    Pm = sp.csr_matrix((np.ones(S.shape[0], np.float32),
                        (np.arange(S.shape[0]), perm)), shape=S.shape)
    A = from_scipy((Pm @ S @ Pm.T).tocsr(), "csr")
    M = smoothed_aggregation(A, spmv_config={"impl": "segsum"})
    lvl = M.levels[0]
    assert not isinstance(lvl.Pop, (FactoredProlongator,))
    assert not isinstance(lvl.Rop, (FactoredRestriction,))
    rng = np.random.RandomState(2)
    Psp = to_scipy(lvl.P)
    e = rng.randn(lvl.P.num_cols).astype(np.float32)
    np.testing.assert_allclose(np.asarray(lvl.prolong_op(e)), Psp @ e,
                               rtol=2e-4, atol=2e-5)


def test_factored_rp_structured_supersedes_explicit_config():
    # On a grid-structured level the structured factored form is used even
    # under an explicit spmv_config: it is not a model-gated guess (the
    # ADVICE r3 concern) and needs no scattered P apply there
    from cusp_autotuned_tpu.precond.aggregation import smoothed_aggregation
    from cusp_autotuned_tpu.operators import (
        FactoredProlongator, StructuredTentative)
    from cusp_autotuned_tpu.backend.reference import to_scipy
    from cusp_autotuned_tpu import gallery
    A = gallery.poisson5pt(60, 60, format="csr", dtype=np.float32)
    M = smoothed_aggregation(A, spmv_config={"impl": "segsum"})
    lvl = M.levels[0]
    assert isinstance(lvl.Pop, FactoredProlongator)
    assert isinstance(lvl.Pop.Top, StructuredTentative)
    rng = np.random.RandomState(2)
    Psp = to_scipy(lvl.P)
    e = rng.randn(lvl.P.num_cols).astype(np.float32)
    np.testing.assert_allclose(np.asarray(lvl.Pop(e)), Psp @ e,
                               rtol=2e-4, atol=2e-5)


def test_jit_operator_factored_types():
    # ADVICE r3 (low): jit_operator must not let jax.jit close over the
    # factored operators' planned arrays as embedded constants — it jits
    # the apply with the operator pytree as a traced argument
    from cusp_autotuned_tpu.precond.aggregation import smoothed_aggregation
    from cusp_autotuned_tpu.operators import (
        jit_operator, FactoredProlongator, FactoredRestriction)
    from cusp_autotuned_tpu.backend.reference import to_scipy
    from cusp_autotuned_tpu import gallery
    A = gallery.poisson5pt(60, 60, format="csr", dtype=np.float32)
    M = smoothed_aggregation(A, spmv_config={})
    lvl = M.levels[0]
    assert isinstance(lvl.Pop, FactoredProlongator)
    assert isinstance(lvl.Rop, FactoredRestriction)
    rng = np.random.RandomState(4)
    Psp = to_scipy(lvl.P)
    e = rng.randn(lvl.P.num_cols).astype(np.float32)
    r = rng.randn(lvl.A.num_rows).astype(np.float32)
    np.testing.assert_allclose(np.asarray(jit_operator(lvl.Pop)(e)),
                               Psp @ e, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(np.asarray(jit_operator(lvl.Rop)(r)),
                               Psp.T @ r, rtol=2e-4, atol=2e-5)
