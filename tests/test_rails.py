"""SciPy-oracle tests of every SpMV rail in the registry
(kernels/variants.py) over the pattern families the rails meet: stencils,
uniform random scatter, power-law hubs, rectangular, a single dense row
and empty rows; SpMM at k in {1, 8, 16, 128}; bf16 value storage; and the
planned-operator contract (the matrix is a jit argument of every rail).
The Pallas DIA kernel's own tests are in test_pallas.py."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import scipy.sparse as sp

from cusp_autotuned_tpu import gallery
from cusp_autotuned_tpu.backend.reference import from_scipy, to_scipy
from cusp_autotuned_tpu.kernels.variants import build_spmv, VARIANTS
from cusp_autotuned_tpu.operators import planned_operator, PlannedOperator
from cusp_autotuned_tpu.utils.exceptions import FormatConversionException


def _poisson9():
    return to_scipy(gallery.poisson9pt(23, 19, format="csr",
                                       dtype=np.float32)).tocsr()


def _random():
    return sp.random(700, 700, density=0.006, random_state=1, format="csr",
                     dtype=np.float32)


def _powerlaw():
    rng = np.random.RandomState(2)
    deg = np.clip((rng.pareto(1.3, 600) * 3).astype(int) + 1, 1, 300)
    rows = np.repeat(np.arange(600), deg)
    cols = rng.randint(0, 600, rows.size)
    S = sp.coo_matrix((rng.randn(rows.size).astype(np.float32),
                       (rows, cols)), shape=(600, 600)).tocsr()
    S.sum_duplicates()
    return S


def _rectangular():
    return sp.random(300, 1100, density=0.01, random_state=3, format="csr",
                     dtype=np.float32)


def _dense_row():
    S = sp.random(500, 500, density=0.004, random_state=4, format="lil",
                  dtype=np.float32)
    S[7, :] = np.linspace(-1, 1, 500, dtype=np.float32)
    S.setdiag(1.0)
    return S.tocsr()


def _empty_rows():
    S = sp.random(600, 600, density=0.01, random_state=5, format="lil",
                  dtype=np.float32)
    S[100:180, :] = 0
    S[400, :] = 0
    S = S.tocsr()
    S.eliminate_zeros()
    return S


PATTERNS = {"poisson9": _poisson9, "random": _random,
            "powerlaw": _powerlaw, "rectangular": _rectangular,
            "dense_row": _dense_row, "empty_rows": _empty_rows}

# (container format, rail) for every rail that serves any pattern
RAILS = [("csr", "segsum"), ("coo", "segsum"), ("ell", "gather"),
         ("ellr", "gather"), ("ellr", "rowlen"), ("csr", "via_dia"),
         ("csr", "bcoo"), ("hyb", "default")]


def _x(n, k=None, seed=0):
    rng = np.random.RandomState(seed)
    shape = (n,) if k is None else (n, k)
    return rng.randn(*shape).astype(np.float32)


def _oracle(S, x):
    return S.astype(np.float64) @ x.astype(np.float64)


def _assert_close(y, want, rtol=1e-4):
    y = np.asarray(y, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(y, want, rtol=rtol, atol=rtol * scale)


@pytest.mark.parametrize("pattern", sorted(PATTERNS))
@pytest.mark.parametrize("fmt,impl", RAILS)
def test_rail_matches_oracle(pattern, fmt, impl):
    S = PATTERNS[pattern]()
    A = from_scipy(S, fmt)
    x = _x(S.shape[1])
    fn = build_spmv(A, {"impl": impl})
    y = jax.jit(fn.apply)(fn.planned_arrays, jnp.asarray(x))
    assert y.shape == (S.shape[0],)
    _assert_close(y, _oracle(S, x))


@pytest.mark.parametrize("pattern", ["poisson9", "random", "powerlaw",
                                     "dense_row", "empty_rows"])
def test_rcm_dia_matches_oracle(pattern):
    S = PATTERNS[pattern]()
    A = from_scipy(S, "csr")
    x = _x(S.shape[1])
    _assert_close(build_spmv(A, {"impl": "rcm_dia"})(jnp.asarray(x)),
                  _oracle(S, x))


@pytest.mark.parametrize("fmt", ["csr", "coo", "ell", "ellr", "hyb"])
def test_via_dense_matches_oracle(fmt):
    S = sp.random(120, 90, density=0.6, random_state=6, format="csr",
                  dtype=np.float32)
    A = from_scipy(S, fmt)
    x = _x(90)
    _assert_close(build_spmv(A, {"impl": "via_dense"})(jnp.asarray(x)),
                  _oracle(S, x))


def test_via_dense_guard_is_skippable_on_sparse_patterns():
    A = from_scipy(_random(), "csr")
    with pytest.raises(FormatConversionException):
        build_spmv(A, {"impl": "via_dense"})


@pytest.mark.parametrize("impl", ["slices", "gather"])
@pytest.mark.parametrize("pattern", ["poisson9", "rectangular", "dense_row"])
def test_dia_rails_match_oracle(pattern, impl):
    S = PATTERNS[pattern]()
    A = from_scipy(S, "dia")
    x = _x(S.shape[1])
    _assert_close(build_spmv(A, {"impl": impl})(jnp.asarray(x)),
                  _oracle(S, x))


@pytest.mark.parametrize("k", [1, 8, 16, 128])
@pytest.mark.parametrize("fmt,impl", [("csr", "segsum"), ("csr", "via_dia"),
                                      ("csr", "bcoo"), ("ell", "gather"),
                                      ("ellr", "rowlen"), ("dia", "slices"),
                                      ("dia", "gather")])
def test_rail_spmm_matches_oracle(fmt, impl, k):
    S = _poisson9() if fmt == "dia" else _powerlaw()
    A = from_scipy(S, fmt)
    X = _x(S.shape[1], k, seed=k)
    Y = build_spmv(A, {"impl": impl})(jnp.asarray(X))
    assert Y.shape == (S.shape[0], k)
    _assert_close(Y, _oracle(S, X))


@pytest.mark.parametrize("fmt,impl", [("dia", "slices"), ("csr", "via_dia"),
                                      ("csr", "rcm_dia")])
def test_rail_bf16_value_storage(fmt, impl):
    """value_dtype='bfloat16' stores the diagonals at half width and
    accumulates in float32: output float32, error bf16-bounded."""
    S = _poisson9()     # generic values: bf16 must actually round them
    S.data = (S.data * (1 + 0.013 * np.sin(np.arange(S.nnz)))) \
        .astype(np.float32)
    A = from_scipy(S, fmt)
    x = _x(S.shape[1])
    y = np.asarray(build_spmv(A, {"impl": impl, "value_dtype": "bfloat16"})(
        jnp.asarray(x)))
    assert y.dtype == np.float32
    want = _oracle(S, x)
    err = np.abs(y - want).max() / np.abs(want).max()
    assert 1e-6 < err < 3e-2


@pytest.mark.parametrize("fmt,impl", sorted(
    (f, i) for f, rails in VARIANTS.items() for i in rails
    if i not in ("pallas", "via_dense")))
def test_planned_rail_data_is_jit_argument(fmt, impl):
    """Every rail exposes planned arrays, so a solver that takes the
    operator as an argument compiles no copy of the matrix into its
    program: the lowered program stays small while the matrix is large."""
    n = 100_000        # tridiagonal: every rail, RCM included, plans it
    S = sp.diags([np.full(n - 1, -1.0), np.full(n, 2.0),
                  np.full(n - 1, -1.0)], [-1, 0, 1], format="csr",
                 dtype=np.float32)
    A = from_scipy(S, fmt)
    op = planned_operator(A, {"impl": impl})
    assert isinstance(op, PlannedOperator)
    x = jnp.ones(S.shape[1], jnp.float32)
    text = jax.jit(lambda o, v: o(v)).lower(op, x).as_text()
    assert len(text) < 100_000, len(text)    # the matrix is ~2 MB
    _assert_close(jax.jit(lambda o, v: o(v))(op, x),
                  _oracle(S, np.ones(S.shape[1], np.float32)))
