"""The structured-interpolation rail: grid detection, grid-blocked
aggregation, and the broadcast/reshape tentative applies that replace
scattered R/P kernels on raster-ordered stencil levels (VERDICT r3 item 3).

No reference analog — the reference applies T/P/R as generic sparse
matrices (cusp/precond/aggregation/detail/tentative.inl); the rebuild
specializes the grid case because upsample/fold-sum run at the stream
rate while a 1-nnz/row scattered SpMV gathers."""

import numpy as np
import pytest
import scipy.sparse as sp

from cusp_autotuned_tpu.gallery import poisson5pt, poisson9pt
from cusp_autotuned_tpu.precond.aggregation import smoothed_aggregation
from cusp_autotuned_tpu.precond.aggregation.aggregate import (
    detect_grid, structured_aggregate, standard_aggregate)
from cusp_autotuned_tpu.backend.reference import to_scipy, from_scipy
from cusp_autotuned_tpu.operators import (
    FactoredProlongator, FactoredRestriction,
    StructuredTentative, StructuredTentativeT, jit_operator)
from cusp_autotuned_tpu.solvers import cg, Monitor


def test_detect_grid_stencils():
    # gallery convention: poisson5pt(m, n) rasters with stride m (m = x)
    assert detect_grid(poisson5pt(17, 23, format="csr")) == (23, 17)
    assert detect_grid(poisson9pt(12, 31, format="csr")) == (31, 12)


def test_detect_grid_rejects_unstructured():
    rng = np.random.RandomState(0)
    S = sp.random(300, 300, density=0.02, random_state=rng,
                  format="csr", dtype=np.float32)
    S = S + S.T + 10 * sp.eye(300, format="csr", dtype=np.float32)
    assert detect_grid(from_scipy(S.tocsr(), "csr")) is None


def test_detect_grid_rejects_wrong_factorization():
    # 1-D tridiagonal: no offset beyond radius, so no grid claim
    T = sp.diags([1.0, -2.0, 1.0], [-1, 0, 1], shape=(60, 60),
                 format="csr", dtype=np.float32)
    assert detect_grid(from_scipy(T.tocsr(), "csr")) is None


@pytest.mark.parametrize("ny,nx,blk", [(30, 30, (3, 3)), (31, 29, (2, 3)),
                                       (10, 100, (3, 2))])
def test_structured_aggregate_exact_blocks(ny, nx, blk):
    A = poisson5pt(nx, ny, format="csr")   # stride = first gallery arg
    agg, roots = structured_aggregate(A, block=blk)
    py, px = blk
    nby, nbx = -(-ny // py), -(-nx // px)
    assert agg.shape == (ny * nx,)
    assert roots.shape == (nby * nbx,)
    yy, xx = np.divmod(np.arange(ny * nx), nx)
    np.testing.assert_array_equal(agg, (yy // py) * nbx + (xx // px))
    # roots are members of their own aggregate
    np.testing.assert_array_equal(agg[roots], np.arange(nby * nbx))


def test_structured_aggregate_raises_without_grid():
    T = sp.diags([1.0, -2.0, 1.0], [-1, 0, 1], shape=(60, 60),
                 format="csr", dtype=np.float32)
    with pytest.raises(ValueError):
        structured_aggregate(from_scipy(T.tocsr(), "csr"))


@pytest.mark.parametrize("ny,nx", [(33, 33), (31, 35)])
def test_structured_tentative_matches_materialized(ny, nx):
    """Factored P/R built on the structured rail reproduce the
    materialized smoothed prolongator / restriction exactly (f64)."""
    A = poisson5pt(ny, nx, format="csr", dtype=np.float64)
    M = smoothed_aggregation(A, spmv_config={}, aggregator="structured")
    lv = M.levels[0]
    assert isinstance(lv.Pop, FactoredProlongator)
    assert isinstance(lv.Pop.Top, StructuredTentative)
    assert isinstance(lv.Rop, FactoredRestriction)
    assert isinstance(lv.Rop.Ttop, StructuredTentativeT)
    Psp = to_scipy(lv.P).tocsr()
    Rsp = to_scipy(lv.R).tocsr()
    rng = np.random.RandomState(1)
    e = rng.randn(Psp.shape[1])
    r = rng.randn(Psp.shape[0])
    np.testing.assert_allclose(np.asarray(lv.Pop(np.asarray(e))),
                               Psp @ e, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(np.asarray(lv.Rop(np.asarray(r))),
                               Rsp @ r, rtol=1e-12, atol=1e-12)
    # multi-rhs path
    E = rng.randn(Psp.shape[1], 3)
    Z = rng.randn(Psp.shape[0], 3)
    np.testing.assert_allclose(np.asarray(lv.Pop(np.asarray(E))),
                               Psp @ E, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(np.asarray(lv.Rop(np.asarray(Z))),
                               Rsp @ Z, rtol=1e-12, atol=1e-12)


def test_structure_recurses_to_coarse_levels():
    """The Galerkin coarse operator of a structured level is again a
    raster-grid stencil, so every level of the hierarchy rides the rail."""
    A = poisson5pt(100, 100, format="csr", dtype=np.float32)
    M = smoothed_aggregation(A, spmv_config={}, aggregator="structured")
    assert len(M.levels) >= 2
    for lv in M.levels:
        if lv.Pop is not None:
            assert isinstance(getattr(lv.Pop, "Top", None),
                              StructuredTentative), lv.Pop


def test_auto_uses_structured_on_grid_and_standard_off_grid():
    A = poisson5pt(40, 40, format="csr", dtype=np.float32)
    M = smoothed_aggregation(A, spmv_config={})
    assert isinstance(getattr(M.levels[0].Pop, "Top", None),
                      StructuredTentative)
    # evolution strength must keep steering aggregation (anisotropy)
    M2 = smoothed_aggregation(A, spmv_config={}, strength="evolution")
    assert not isinstance(getattr(M2.levels[0].Pop, "Top", None),
                          StructuredTentative)


def test_structured_amg_cg_converges_like_standard():
    A = poisson5pt(80, 80, format="csr", dtype=np.float32)
    b = np.ones(A.num_rows, np.float32)
    iters = {}
    for label, kw in [("standard", dict(aggregator="standard")),
                      ("structured", dict(aggregator="structured"))]:
        M = smoothed_aggregation(A, **kw)
        mon = Monitor(b, iteration_limit=60, relative_tolerance=1e-6)
        _, mon = cg(A, b, monitor=mon, M=M)
        assert mon.converged(), label
        iters[label] = mon.iteration_count()
    # same ballpark: the exact-block aggregates must not degrade AMG
    assert iters["structured"] <= iters["standard"] + 5, iters


def test_jit_operator_handles_structured_types():
    A = poisson5pt(30, 30, format="csr", dtype=np.float32)
    M = smoothed_aggregation(A, spmv_config={}, aggregator="structured")
    Top = M.levels[0].Pop.Top
    jf = jit_operator(Top)
    e = np.linspace(-1, 1, Top.shape[1]).astype(np.float32)
    np.testing.assert_allclose(np.asarray(jf(e)), np.asarray(Top(e)),
                               rtol=1e-6)


def test_detect_grid_rejects_1d_multiband_chain():
    """A 1-D chain with offsets {-4,-1,0,1,4} decomposes arithmetically
    as a (n/4, 4) grid but has +1 entries crossing the claimed row
    boundary — the per-entry boundary validation must reject it
    (review finding: 'auto' is the default, so misdetection silently
    changes aggregation)."""
    n = 400
    T = sp.diags([1.0, 1.0, -4.0, 1.0, 1.0], [-4, -1, 0, 1, 4],
                 shape=(n, n), format="csr", dtype=np.float32)
    assert detect_grid(from_scipy(T.tocsr(), "csr")) is None


def test_auto_respects_theta_threshold():
    """A nonzero theta means the user wants strength-thresholded
    aggregation; 'auto' must not override it with geometric blocks."""
    A = poisson5pt(40, 40, format="csr", dtype=np.float32)
    M = smoothed_aggregation(A, spmv_config={}, theta=0.25)
    assert not isinstance(getattr(M.levels[0].Pop, "Top", None),
                          StructuredTentative)
