import numpy as np
import jax
import jax.numpy as jnp
import pytest

import cusp_autotuned_tpu as ct
from cusp_autotuned_tpu.ops.multiply import generalized_spmv
from tests.util import ALL_FORMATS, build, example_matrices


@pytest.mark.parametrize("fmt", ALL_FORMATS)
@pytest.mark.parametrize("name", list(example_matrices()))
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_spmv_all_formats(fmt, name, dtype):
    S = example_matrices()[name].astype(dtype)
    if fmt == "dia" and name == "rand50x40":
        pytest.skip("unstructured matrix not meaningful in DIA")
    A = build(S, fmt)
    rng = np.random.RandomState(7)
    x = rng.randn(S.shape[1]).astype(dtype)
    y = ct.multiply(A, x)
    rtol = 1e-5 if dtype == np.float32 else 1e-12
    np.testing.assert_allclose(np.asarray(y), S @ x, rtol=rtol, atol=rtol)


@pytest.mark.parametrize("fmt", ALL_FORMATS)
def test_spmm(fmt):
    S = example_matrices()["tri37"]
    A = build(S, fmt)
    rng = np.random.RandomState(3)
    X = rng.randn(37, 4).astype(np.float32)
    Y = ct.multiply(A, X)
    np.testing.assert_allclose(np.asarray(Y), S @ X, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fmt", ALL_FORMATS)
def test_spmv_inside_jit(fmt):
    S = example_matrices()["tri37"]
    A = build(S, fmt)
    x = np.linspace(0, 1, 37).astype(np.float32)

    @jax.jit
    def f(A, x):
        return ct.multiply(A, x) * 2.0

    np.testing.assert_allclose(np.asarray(f(A, x)), 2.0 * (S @ x),
                               rtol=1e-5, atol=1e-5)


def test_dense_times_sparse():
    S = example_matrices()["rect3x5"]
    A = build(S, "csr")
    v = np.arange(3, dtype=np.float32)
    y = ct.multiply(v, A)
    np.testing.assert_allclose(np.asarray(y), v @ np.asarray(S.todense()),
                               rtol=1e-5)


@pytest.mark.parametrize("fmt", ["coo", "csr", "ell", "dia", "hyb"])
def test_generalized_spmv_plus_times(fmt):
    S = example_matrices()["small4x4"]
    A = build(S, fmt)
    x = np.array([1.0, 2.0, 3.0, 4.0], np.float32)
    y = np.full(4, 10.0, np.float32)
    z = generalized_spmv(A, x, y, lambda yi: yi * 0.5,
                         jnp.multiply, jnp.add)
    expect = 0.5 * y + S @ x
    np.testing.assert_allclose(np.asarray(z), expect, rtol=1e-5)


@pytest.mark.parametrize("fmt", ["coo", "csr", "ell", "dia", "hyb"])
def test_generalized_spmv_min_plus(fmt):
    """(min, +) semiring — shortest-path relaxation step."""
    S = example_matrices()["small4x4"]
    A = build(S, fmt)
    n = 4
    x = np.array([0.0, 1.0, 2.0, 3.0], np.float32)
    big = np.float32(1e9)
    y = np.full(n, big)
    z = generalized_spmv(A, x, y, lambda yi: yi,
                         jnp.add, jnp.minimum)
    dense = np.asarray(S.todense())
    expect = y.copy()
    for i in range(n):
        for j in range(n):
            if dense[i, j] != 0:
                expect[i] = min(expect[i], dense[i, j] + x[j])
    np.testing.assert_allclose(np.asarray(z), expect, rtol=1e-5)


def test_dimension_mismatch():
    S = example_matrices()["rect3x5"]
    A = build(S, "csr")
    with pytest.raises(ct.InvalidInputException):
        ct.multiply(A, np.zeros(3, np.float32))


def test_bfloat16_spmv():
    """bf16 containers flow through SpMV (half-width storage; loose tolerance)."""
    import jax.numpy as jnp
    S = example_matrices()["tri37"]
    from cusp_autotuned_tpu.backend.reference import from_scipy
    for fmt in ("dia", "ell", "csr"):
        A = from_scipy(S, fmt, dtype=jnp.bfloat16)
        x = np.linspace(-1, 1, 37).astype(np.float32)
        y = np.asarray(ct.multiply(A, x.astype(jnp.bfloat16)),
                       dtype=np.float32)
        np.testing.assert_allclose(y, S @ x, rtol=0.05, atol=0.05)


def test_dia_many_diagonals_gather_fallback():
    """More than _DIA_UNROLL_LIMIT diagonals takes the gather path."""
    from cusp_autotuned_tpu import gallery
    from cusp_autotuned_tpu.ops.multiply import _DIA_UNROLL_LIMIT
    k = _DIA_UNROLL_LIMIT + 5
    A = gallery.make_diagonal_symmetric_matrix(400, 400, 1, k)
    assert A.num_diagonals > _DIA_UNROLL_LIMIT
    x = np.random.RandomState(0).randn(400).astype(np.float32)
    y = np.asarray(ct.multiply(A, x))
    from cusp_autotuned_tpu.backend.reference import reference_spmv
    np.testing.assert_allclose(y, reference_spmv(A, x), rtol=1e-4, atol=1e-4)


def test_multiply_sparse_times_array2d():
    from cusp_autotuned_tpu.formats.dense import Array2d
    from cusp_autotuned_tpu.ops.multiply import multiply
    A = ct.gallery.poisson5pt(12, 12, format="csr", dtype=np.float32)
    Bd = np.random.RandomState(0).randn(A.num_cols, 5).astype(np.float32)
    B = Array2d.from_dense(Bd)
    Y = np.asarray(multiply(A, B))
    ref = A.to_scipy() @ Bd
    np.testing.assert_allclose(Y, ref, rtol=1e-5, atol=1e-5)
