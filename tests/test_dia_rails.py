"""The DIA rails (`slices`: unrolled shifted slices, `gather`: one gather)
against the SciPy oracle over the offset patterns DIA meets: stencils,
offsets on and off 128-row boundaries, offsets wider than the matrix is
tall, rectangular shapes, block right-hand sides, float64, and diagonal
counts on both sides of the unroll limit.  Mirrors the oracle pattern of
the reference's KTT test (testing/ktt.cu: every configuration validated
against the reference multiply)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import scipy.sparse as sp

from cusp_autotuned_tpu import gallery
from cusp_autotuned_tpu.backend.reference import from_scipy, to_scipy
from cusp_autotuned_tpu.kernels.variants import build_spmv


def _wide():
    S = sp.diags([np.ones(300), 2 * np.ones(300), 3 * np.ones(200)],
                 [0, 150, 320], shape=(300, 520)).tocoo()
    return from_scipy(S, "dia")


def _tall():
    S = sp.diags([np.ones(300), 2 * np.ones(300)], [-220, 0],
                 shape=(520, 300)).tocoo()
    return from_scipy(S, "dia")


def _wide_short():
    S = sp.diags([np.ones(8), 2 * np.ones(8)], [0, 1],
                 shape=(8, 300)).tocoo()
    return from_scipy(S, "dia")


CASES = {
    "poisson5": lambda: gallery.poisson5pt(37, 41, format="dia",
                                           dtype=np.float32),
    "aligned_offsets": lambda: gallery.make_diagonal_matrix(
        1500, 1500, [-256, -128, 0, 128, 384]),
    "unaligned_offsets": lambda: gallery.make_diagonal_matrix(
        1500, 1500, [-1000, -3, 0, 5, 999]),
    "symmetric_9": lambda: gallery.make_diagonal_symmetric_matrix(
        3000, 3000, 7, 9),
    "rect_wide": _wide,
    "rect_tall": _tall,
    "wide_short": _wide_short,
}


def _check(A, X, rtol=1e-5):
    ref = to_scipy(A).astype(np.float64) @ np.asarray(X, np.float64)
    for impl in ("slices", "gather"):
        fn = build_spmv(A, {"impl": impl})
        Y = np.asarray(jax.jit(fn.apply)(fn.planned_arrays, jnp.asarray(X)))
        assert Y.shape == ref.shape, impl
        scale = max(np.abs(ref).max(), 1e-30)
        np.testing.assert_allclose(Y, ref, rtol=rtol, atol=rtol * scale,
                                   err_msg=impl)


@pytest.mark.parametrize("case", sorted(CASES))
def test_dia_rails_spmv(case):
    A = CASES[case]()
    x = np.random.RandomState(3).randn(A.num_cols).astype(np.float32)
    _check(A, x)


@pytest.mark.parametrize("k", [1, 3, 8, 16, 128])
@pytest.mark.parametrize("case", ["poisson5", "rect_wide", "wide_short"])
def test_dia_rails_spmm(case, k):
    A = CASES[case]()
    X = np.random.RandomState(17).randn(A.num_cols, k).astype(np.float32)
    _check(A, X, rtol=1e-4)


def test_dia_rails_float64():
    A = gallery.poisson5pt(30, 30, format="dia", dtype=np.float64)
    x = np.random.RandomState(5).randn(A.num_cols)
    for impl in ("slices", "gather"):
        y = build_spmv(A, {"impl": impl})(jnp.asarray(x))
        assert y.dtype == jnp.float64
    _check(A, x, rtol=1e-13)


@pytest.mark.parametrize("ndiag", [40, 300])
def test_dia_slices_on_both_sides_of_the_unroll_limit(ndiag):
    """At most _DIA_UNROLL_LIMIT diagonals unroll into shifted slices;
    beyond it one gather keeps the compiled program bounded.  Both agree
    with the oracle."""
    import importlib
    mm = importlib.import_module("cusp_autotuned_tpu.ops.multiply")
    offsets = sorted(np.random.RandomState(ndiag).choice(
        np.arange(-900, 900), ndiag, replace=False).tolist())
    A = gallery.make_diagonal_matrix(1000, 1000, offsets)
    assert (len(A.offsets) <= mm._DIA_UNROLL_LIMIT) == (ndiag == 40)
    x = np.random.RandomState(1).randn(1000).astype(np.float32)
    _check(A, x, rtol=1e-4)
