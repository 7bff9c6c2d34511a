"""Native C++ runtime components: compiled availability, and equivalence of
the native AINV/RCM paths against the pure-Python fallbacks."""

import numpy as np
import scipy.sparse as sp

from cusp_autotuned_tpu import native, gallery, graph, precond
from tests.util import build


def test_native_compiles():
    assert native.available(), "g++ toolchain expected in this environment"


def test_native_rcm_matches_python_quality():
    A = gallery.poisson5pt(15, 15, format="csr", dtype=np.float64)
    S = A.to_scipy().tocoo()
    P = graph.symmetric_rcm(A)       # native path
    perm = np.asarray(P.perm)
    assert np.array_equal(np.sort(perm), np.arange(A.num_rows))
    reord = S.tocsr()[perm][:, perm].tocoo()
    # RCM on a 2-D grid must keep bandwidth near the grid width
    assert np.abs(reord.row - reord.col).max() <= 2 * 15


def test_native_ainv_exact_no_dropping():
    A = gallery.poisson5pt(5, 5, format="csr", dtype=np.float64)
    M = precond.bridson_ainv(A, drop_tolerance=0.0)
    S = np.asarray(A.to_scipy().todense())
    r = np.random.RandomState(0).randn(25)
    np.testing.assert_allclose(np.asarray(M(r)), np.linalg.solve(S, r),
                               rtol=1e-8, atol=1e-9)


def test_native_matches_python_fallback(monkeypatch):
    """Force the Python path and compare factors against native."""
    A = gallery.poisson5pt(6, 6, format="csr", dtype=np.float64)
    M_native = precond.bridson_ainv(A, drop_tolerance=0.05)
    monkeypatch.setattr(native, "ainv_spd", lambda *a, **k: None)
    M_python = precond.bridson_ainv(A, drop_tolerance=0.05)
    r = np.random.RandomState(1).randn(36)
    np.testing.assert_allclose(np.asarray(M_native(r)),
                               np.asarray(M_python(r)), rtol=1e-8, atol=1e-10)


def test_native_nonsym_matches_python(monkeypatch):
    rng = np.random.RandomState(5)
    S = (sp.random(40, 40, density=0.08, random_state=rng)
         + sp.diags(np.full(40, 4.0))).tocoo()
    A = build(S, "csr", dtype=np.float64)
    M_native = precond.nonsym_bridson_ainv(A, drop_tolerance=0.05)
    monkeypatch.setattr(native, "ainv_nonsym", lambda *a, **k: None)
    M_python = precond.nonsym_bridson_ainv(A, drop_tolerance=0.05)
    r = rng.randn(40)
    np.testing.assert_allclose(np.asarray(M_native(r)),
                               np.asarray(M_python(r)), rtol=1e-7, atol=1e-9)


def test_native_ainv_speed_scales():
    """The native path should handle a few-thousand-row factorization fast."""
    import time
    A = gallery.poisson5pt(50, 50, format="csr", dtype=np.float64)  # 2500 rows
    t0 = time.time()
    M = precond.bridson_ainv(A, drop_tolerance=0.1)
    dt = time.time() - t0
    assert dt < 30.0
    assert np.all(np.isfinite(np.asarray(M(np.ones(2500)))))
