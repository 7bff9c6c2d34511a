"""NumPy/SciPy reference backend — the test oracle.

Plays the role of the reference's sequential backend
(cusp/system/detail/sequential/reference/): a trusted, slow, host-side
implementation every device kernel is validated against, both in the unit
tests (SURVEY.md §4 oracle pattern) and in autotune's per-configuration
validation (parity: KTT SetReferenceComputation, cusp/system/cuda/ktt/multiply.h:125-129).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def to_scipy(A):
    """Convert any container to a scipy.sparse matrix (or dense ndarray).

    Cached per container (`_host_scipy`), and built from the host COO
    mirror when one exists — repeated setup-time oracle reads then never
    pull arrays back from the device.  The returned object is
    SHARED across calls: treat it as read-only (make an explicit .copy()
    before mutating), matching the containers' own immutability."""
    cached = getattr(A, "_host_scipy", None)
    if cached is not None:
        return cached
    from cusp_autotuned_tpu import formats as F

    S = None
    mirror = getattr(A, "_host_coo", None)
    if mirror is not None:
        row, col, val, shape = mirror
        S = sp.coo_matrix((val, (row, col)), shape=shape)
        if isinstance(A, F.CSR):
            S = S.tocsr()
        elif isinstance(A, F.DIA):
            S = S.todia()
    if S is None:
        S = _to_scipy_uncached(A)
    _freeze_scipy(S)
    try:
        object.__setattr__(A, "_host_scipy", S)
    except Exception:  # noqa: BLE001
        pass
    return S


def _freeze_scipy(S):
    """Mark a cached scipy object's buffers read-only so an in-place
    mutation by a caller raises instead of silently corrupting the oracle
    cache for every later read (callers that need to mutate must .copy())."""
    for name in ("data", "row", "col", "indices", "indptr", "offsets"):
        arr = getattr(S, name, None)
        if isinstance(arr, np.ndarray):
            arr.flags.writeable = False
    if isinstance(S, np.ndarray):
        S.flags.writeable = False


def _to_scipy_uncached(A):
    from cusp_autotuned_tpu import formats as F

    if isinstance(A, F.COO):
        row = np.asarray(A.row)[: A.nnz]
        col = np.asarray(A.col)[: A.nnz]
        val = np.asarray(A.val)[: A.nnz]
        return sp.coo_matrix((val, (row, col)), shape=A.shape)
    if isinstance(A, F.CSR):
        nnz = A.nnz
        return sp.csr_matrix(
            (np.asarray(A.val)[:nnz], np.asarray(A.col)[:nnz], np.asarray(A.indptr)),
            shape=A.shape)
    if isinstance(A, F.DIA):
        offsets = np.asarray(A.offsets)
        data = np.asarray(A.data)
        m, n = A.shape
        # our layout is data[d, i] = A[i, i+off]; scipy dia is data[d, j] = A[j-off, j]
        sdata = np.zeros((len(offsets), n), dtype=data.dtype)
        for d, off in enumerate(offsets):
            i = np.arange(m)
            j = i + off
            valid = (j >= 0) & (j < n)
            sdata[d, j[valid]] = data[d, i[valid]]
        return sp.dia_matrix((sdata, offsets), shape=A.shape)
    if isinstance(A, (F.ELL, F.ELLR)):
        col = np.asarray(A.col)
        val = np.asarray(A.val)
        slot, r = np.nonzero(col != F.INVALID_INDEX)
        rows = r
        cols = col[slot, r]
        vals = val[slot, r]
        return sp.coo_matrix((vals, (rows, cols)), shape=A.shape)
    if isinstance(A, F.HYB):
        return (to_scipy(A.ell) + to_scipy(A.coo)).tocoo()
    if isinstance(A, F.PermutationMatrix):
        n = A.shape[0]
        perm = np.asarray(A.perm)
        return sp.coo_matrix((np.ones(n), (np.arange(n), perm)), shape=A.shape)
    raise TypeError(f"cannot convert {type(A)} to scipy")


def from_scipy(A, fmt: str = "csr", dtype=None):
    from cusp_autotuned_tpu.ops.convert import convert
    from cusp_autotuned_tpu.formats.coo import coo_from_scipy
    coo = coo_from_scipy(A.tocoo(), dtype=dtype)
    return convert(coo, fmt)


def reference_spmv(A, x) -> np.ndarray:
    """Oracle y = A @ x via scipy, in float64."""
    S = to_scipy(A).astype(np.float64)
    return S @ np.asarray(x, dtype=np.float64)


def reference_spgemm(A, B) -> sp.spmatrix:
    return (to_scipy(A).astype(np.float64) @ to_scipy(B).astype(np.float64)).tocoo()
