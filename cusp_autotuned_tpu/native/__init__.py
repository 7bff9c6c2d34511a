"""Native host runtime — C++ implementations of the inherently sequential
setup algorithms (AINV factorization, RCM/pseudo-peripheral orderings),
compiled on demand with g++ and bound via ctypes.

The reference keeps these on the host in C++ too (cusp/precond/detail/
ainv.inl builds std::map rows host-side; the orderings are sequential BFS).
Falls back gracefully to the pure-Python implementations when no compiler
is available (AVAILABLE == False)."""

from __future__ import annotations

import ctypes
import hashlib
import pathlib
import subprocess

import numpy as np

_SRC_DIR = pathlib.Path(__file__).resolve().parents[2] / "native"
_BUILD_DIR = pathlib.Path(__file__).resolve().parent / "_build"

_lib = None
_tried = False


def _compile() -> ctypes.CDLL | None:
    sources = sorted(_SRC_DIR.glob("*.cpp"))
    if not sources:
        return None
    digest = hashlib.sha256(
        b"".join(s.read_bytes() for s in sources)).hexdigest()[:16]
    _BUILD_DIR.mkdir(exist_ok=True)
    so_path = _BUILD_DIR / f"libcusp_native_{digest}.so"
    if not so_path.exists():
        cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
               *map(str, sources), "-o", str(so_path)]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=240)
        except Exception:  # noqa: BLE001 — fall back to pure Python
            return None
    lib = ctypes.CDLL(str(so_path))

    i32p = ctypes.POINTER(ctypes.c_int32)
    f64p = ctypes.POINTER(ctypes.c_double)
    i64p = ctypes.POINTER(ctypes.c_int64)

    lib.ainv_spd.restype = ctypes.c_int64
    lib.ainv_spd.argtypes = [ctypes.c_int32, i32p, i32p, f64p,
                             ctypes.c_double, ctypes.c_int, ctypes.c_int,
                             ctypes.c_int, ctypes.c_int,
                             i32p, i32p, f64p, ctypes.c_int64, f64p]
    lib.ainv_nonsym.restype = ctypes.c_int64
    lib.ainv_nonsym.argtypes = [ctypes.c_int32, i32p, i32p, f64p,
                                i32p, i32p, f64p,
                                ctypes.c_double, ctypes.c_int, ctypes.c_int,
                                ctypes.c_int,
                                i32p, i32p, f64p, ctypes.c_int64,
                                i32p, i32p, f64p, ctypes.c_int64,
                                f64p, i64p, i64p]
    lib.standard_aggregate.restype = ctypes.c_int32
    lib.standard_aggregate.argtypes = [ctypes.c_int32, i32p, i32p, i32p, i32p]
    lib.pseudo_peripheral.restype = ctypes.c_int32
    lib.pseudo_peripheral.argtypes = [ctypes.c_int32, i32p, i32p]
    lib.rcm.restype = None
    lib.rcm.argtypes = [ctypes.c_int32, i32p, i32p, i32p]
    return lib


def get_lib():
    global _lib, _tried
    if not _tried:
        _tried = True
        _lib = _compile()
    return _lib


def available() -> bool:
    return get_lib() is not None


def _ptr_i32(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _ptr_f64(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


# -- AINV --------------------------------------------------------------------

def ainv_spd(indptr, col, val, drop_tol, nonzero_per_row, lin_dropping,
             lin_param, scaled):
    """Returns (w_row, w_col, w_val, diag) COO triplets of W or None if the
    native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n = indptr.shape[0] - 1
    indptr = np.ascontiguousarray(indptr, np.int32)
    col = np.ascontiguousarray(col, np.int32)
    val = np.ascontiguousarray(val, np.float64)
    diag = np.zeros(n, np.float64)
    cap = max(4 * (val.size + n), 1024)
    for _ in range(6):
        w_row = np.empty(cap, np.int32)
        w_col = np.empty(cap, np.int32)
        w_val = np.empty(cap, np.float64)
        nnz = lib.ainv_spd(n, _ptr_i32(indptr), _ptr_i32(col), _ptr_f64(val),
                           float(drop_tol), int(nonzero_per_row),
                           int(lin_dropping), int(lin_param), int(scaled),
                           _ptr_i32(w_row), _ptr_i32(w_col), _ptr_f64(w_val),
                           cap, _ptr_f64(diag))
        if nnz >= 0:
            return w_row[:nnz], w_col[:nnz], w_val[:nnz], diag
        cap *= 4
    return None


def ainv_nonsym(indptr, col, val, at_indptr, at_col, at_val, drop_tol,
                nonzero_per_row, lin_dropping, lin_param):
    lib = get_lib()
    if lib is None:
        return None
    n = indptr.shape[0] - 1
    arrs = [np.ascontiguousarray(a, np.int32) for a in (indptr, col,
                                                        at_indptr, at_col)]
    indptr, col, at_indptr, at_col = arrs
    val = np.ascontiguousarray(val, np.float64)
    at_val = np.ascontiguousarray(at_val, np.float64)
    diag = np.zeros(n, np.float64)
    cap = max(4 * (val.size + n), 1024)
    for _ in range(6):
        z = [np.empty(cap, np.int32), np.empty(cap, np.int32),
             np.empty(cap, np.float64)]
        w = [np.empty(cap, np.int32), np.empty(cap, np.int32),
             np.empty(cap, np.float64)]
        z_nnz = np.zeros(1, np.int64)
        w_nnz = np.zeros(1, np.int64)
        rc = lib.ainv_nonsym(
            n, _ptr_i32(indptr), _ptr_i32(col), _ptr_f64(val),
            _ptr_i32(at_indptr), _ptr_i32(at_col), _ptr_f64(at_val),
            float(drop_tol), int(nonzero_per_row), int(lin_dropping),
            int(lin_param),
            _ptr_i32(z[0]), _ptr_i32(z[1]), _ptr_f64(z[2]), cap,
            _ptr_i32(w[0]), _ptr_i32(w[1]), _ptr_f64(w[2]), cap,
            _ptr_f64(diag),
            z_nnz.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            w_nnz.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        if rc == 0:
            zn, wn = int(z_nnz[0]), int(w_nnz[0])
            return ((z[0][:zn], z[1][:zn], z[2][:zn]),
                    (w[0][:wn], w[1][:wn], w[2][:wn]), diag)
        cap *= 4
    return None


# -- orderings ----------------------------------------------------------------

def rcm(indptr, col):
    lib = get_lib()
    if lib is None:
        return None
    n = indptr.shape[0] - 1
    indptr = np.ascontiguousarray(indptr, np.int32)
    col = np.ascontiguousarray(col, np.int32)
    perm = np.empty(n, np.int32)
    lib.rcm(n, _ptr_i32(indptr), _ptr_i32(col), _ptr_i32(perm))
    return perm


def pseudo_peripheral(indptr, col):
    lib = get_lib()
    if lib is None:
        return None
    n = indptr.shape[0] - 1
    indptr = np.ascontiguousarray(indptr, np.int32)
    col = np.ascontiguousarray(col, np.int32)
    return int(lib.pseudo_peripheral(n, _ptr_i32(indptr), _ptr_i32(col)))


def standard_aggregate(indptr, col):
    """Returns (agg, roots) or None when the native library is missing."""
    lib = get_lib()
    if lib is None:
        return None
    n = indptr.shape[0] - 1
    indptr = np.ascontiguousarray(indptr, np.int32)
    col = np.ascontiguousarray(col, np.int32)
    agg = np.empty(n, np.int32)
    roots = np.empty(n, np.int32)
    n_agg = lib.standard_aggregate(n, _ptr_i32(indptr), _ptr_i32(col),
                                   _ptr_i32(agg), _ptr_i32(roots))
    return agg, roots[:n_agg]
