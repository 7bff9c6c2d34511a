"""Any-format → any-format conversion, with COO as the hub format.

Parity target: cusp/convert.h frontend and the pairwise routines in
cusp/system/detail/generic/conversions/*_to_other.h, including the
reference's planning heuristics:
  - DIA fill guard: reject when fill_ratio > 3.0 and fill size > 1e6
    (coo_to_other.h:155-161) unless dont_throw;
  - ELL width = max entries per row, same fill guard (coo_to_other.h:230-252);
  - HYB split via compute_optimal_entries_per_row(relative_speed=3.0,
    breakeven_threshold=4096) (coo_to_other.h:295-318).

Stance: conversions are *setup-time planning* — sizes are data
dependent, so they run host-side in NumPy and build lane-aligned padded
device containers; the resulting containers then flow through jitted compute
with fully static shapes.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from cusp_autotuned_tpu import formats as F
from cusp_autotuned_tpu.formats.coo import coo_matrix
from cusp_autotuned_tpu.formats.csr import csr_matrix
from cusp_autotuned_tpu.formats.dia import dia_matrix
from cusp_autotuned_tpu.formats.ell import ell_matrix, ellr_matrix, INVALID_INDEX
from cusp_autotuned_tpu.formats.hyb import hyb_matrix
from cusp_autotuned_tpu.utils.exceptions import FormatConversionException

MAX_FILL_RATIO = 3.0
FILL_THRESHOLD = 1e6


# -- extraction to canonical host COO triplets -------------------------------

def _coo_arrays(A):
    """(row, col, val, shape) as host arrays, trimmed of padding, sorted by
    (row, col).  Containers carry a host mirror (`_host_coo`, stashed at
    construction/conversion time) so repeated setup-time reads don't pay a
    device->host round trip per call."""
    cached = getattr(A, "_host_coo", None)
    if cached is not None:
        return cached
    out = _coo_arrays_uncached(A)
    try:
        object.__setattr__(A, "_host_coo", out)
    except Exception:  # noqa: BLE001 — plain ndarrays don't take attributes
        pass
    return out


def _coo_arrays_uncached(A):
    from cusp_autotuned_tpu.formats.dense import Array2d
    if isinstance(A, (np.ndarray, jnp.ndarray, Array2d)):
        dense = np.asarray(A)
        if dense.ndim != 2:
            raise ValueError("dense source must be 2-D")
        row, col = np.nonzero(dense)
        return (row.astype(np.int32), col.astype(np.int32),
                dense[row, col], dense.shape)
    if isinstance(A, F.COO):
        return (np.asarray(A.row)[: A.nnz], np.asarray(A.col)[: A.nnz],
                np.asarray(A.val)[: A.nnz], A.shape)
    if isinstance(A, F.CSR):
        indptr = np.asarray(A.indptr)
        row = np.repeat(np.arange(A.num_rows, dtype=np.int32), np.diff(indptr))
        return (row, np.asarray(A.col)[: A.nnz], np.asarray(A.val)[: A.nnz], A.shape)
    if isinstance(A, F.DIA):
        offsets = np.asarray(A.offsets)
        data = np.asarray(A.data)
        m, n = A.shape
        i = np.arange(m)
        rows, cols, vals = [], [], []
        for d, off in enumerate(offsets):
            j = i + off
            valid = (j >= 0) & (j < n)
            v = data[d, :m][valid]
            keep = v != 0
            rows.append(i[valid][keep])
            cols.append(j[valid][keep])
            vals.append(v[keep])
        row = np.concatenate(rows) if rows else np.zeros(0, np.int32)
        col = np.concatenate(cols) if cols else np.zeros(0, np.int32)
        val = np.concatenate(vals) if vals else np.zeros(0, data.dtype)
        return _sorted(row.astype(np.int32), col.astype(np.int32), val, A.shape)
    if isinstance(A, (F.ELL, F.ELLR)):
        col2 = np.asarray(A.col)
        val2 = np.asarray(A.val)
        slot, r = np.nonzero(col2 != INVALID_INDEX)
        return _sorted(r.astype(np.int32), col2[slot, r].astype(np.int32),
                       val2[slot, r], A.shape)
    if isinstance(A, F.HYB):
        r1, c1, v1, _ = _coo_arrays(A.ell)
        r2, c2, v2, _ = _coo_arrays(A.coo)
        return _sorted(np.concatenate([r1, r2]), np.concatenate([c1, c2]),
                       np.concatenate([v1, v2]), A.shape)
    if isinstance(A, F.PermutationMatrix):
        n = A.shape[0]
        perm = np.asarray(A.perm)
        return (np.arange(n, dtype=np.int32), perm.astype(np.int32),
                np.ones(n, dtype=np.float32), A.shape)
    raise TypeError(f"cannot extract COO triplets from {type(A)}")


def _sorted(row, col, val, shape):
    key = row.astype(np.int64) * (shape[1] + 1) + col
    order = np.argsort(key, kind="stable")
    return row[order], col[order], val[order], shape


# -- COO -> target format builders -------------------------------------------

def _coo_to_csr(row, col, val, shape):
    m = shape[0]
    indptr = np.zeros(m + 1, dtype=np.int64)
    np.add.at(indptr, row + 1, 1)
    indptr = np.cumsum(indptr).astype(np.int32)
    return csr_matrix(indptr, col, val, shape)


def _coo_to_dia(row, col, val, shape, *, dont_throw=False, dtype=None):
    m, n = shape
    diag_offsets = np.unique(col.astype(np.int64) - row.astype(np.int64))
    num_diagonals = diag_offsets.size
    size = float(num_diagonals) * float(m)
    fill_ratio = size / max(1.0, float(val.size))
    if fill_ratio > MAX_FILL_RATIO and size > FILL_THRESHOLD and not dont_throw:
        raise FormatConversionException(
            "dia_matrix fill-in would exceed maximum tolerance")
    from cusp_autotuned_tpu.utils.padding import LANE, round_up
    rows_pad = max(LANE, round_up(m, LANE))
    data = np.zeros((max(1, num_diagonals), rows_pad), dtype=val.dtype if dtype is None else dtype)
    if num_diagonals:
        dmap = np.searchsorted(diag_offsets, col.astype(np.int64) - row.astype(np.int64))
        data[dmap, row] = val
        offsets = diag_offsets.astype(np.int32)
    else:
        offsets = np.zeros(1, dtype=np.int32)
    return dia_matrix(offsets, data, shape, nnz=int(val.size))


def _row_slot_positions(row):
    """Position of each entry within its row (entries sorted by row)."""
    if row.size == 0:
        return np.zeros(0, dtype=np.int64)
    starts = np.flatnonzero(np.diff(row)) + 1
    starts = np.concatenate([[0], starts])
    run_start = np.zeros(row.size, dtype=np.int64)
    run_start[starts] = starts
    run_start = np.maximum.accumulate(run_start)
    return np.arange(row.size) - run_start


def _coo_to_slots(row, col, val, shape, width):
    """Scatter sorted COO triplets into slot-major (width, rows_pad) arrays,
    returning also the spilled tail (entries beyond `width` per row)."""
    from cusp_autotuned_tpu.utils.padding import LANE, round_up
    m, n = shape
    rows_pad = max(LANE, round_up(m, LANE))
    slot = _row_slot_positions(row)
    in_ell = slot < width
    cols2 = np.full((max(1, width), rows_pad), INVALID_INDEX, dtype=np.int32)
    vals2 = np.zeros((max(1, width), rows_pad), dtype=val.dtype)
    cols2[slot[in_ell], row[in_ell]] = col[in_ell]
    vals2[slot[in_ell], row[in_ell]] = val[in_ell]
    spill = ~in_ell
    return cols2, vals2, (row[spill], col[spill], val[spill])


def _coo_to_ell(row, col, val, shape, *, num_entries_per_row=0, dont_throw=False):
    m, n = shape
    if num_entries_per_row == 0 and row.size:
        width = int(np.bincount(row, minlength=m).max())
        size = float(width) * float(m)
        fill_ratio = size / max(1.0, float(val.size))
        if fill_ratio > MAX_FILL_RATIO and size > FILL_THRESHOLD and not dont_throw:
            raise FormatConversionException(
                "ell_matrix fill-in would exceed maximum tolerance")
    else:
        width = int(num_entries_per_row)
    cols2, vals2, (sr, _, _) = _coo_to_slots(row, col, val, shape, max(width, 0))
    if sr.size:
        raise FormatConversionException(
            "ell_matrix num_entries_per_row too small for this matrix")
    return cols2, vals2


def _coo_to_hyb(row, col, val, shape, *, num_entries_per_row=0):
    m, n = shape
    if num_entries_per_row == 0 and row.size:
        from cusp_autotuned_tpu.ops.format_utils import compute_optimal_entries_per_row
        indptr = np.zeros(m + 1, dtype=np.int64)
        np.add.at(indptr, row + 1, 1)
        indptr = np.cumsum(indptr)
        num_entries_per_row = compute_optimal_entries_per_row(indptr)
    cols2, vals2, (sr, sc, sv) = _coo_to_slots(row, col, val, shape,
                                               int(num_entries_per_row))
    ell = ell_matrix(cols2, vals2, shape)
    coo = coo_matrix(sr, sc, sv.astype(val.dtype), shape)
    return hyb_matrix(ell, coo)


# -- public API ---------------------------------------------------------------

def convert(src, fmt, **kwargs):
    """Convert `src` (any container or dense 2-D array) to format `fmt`
    ('coo'/'csr'/'dia'/'ell'/'ellr'/'hyb'/'dense' or a container class).

    Keyword args mirror the reference's conversion knobs:
    num_entries_per_row (ELL/HYB), dont_throw (disable fill guards)."""
    if isinstance(fmt, type):
        fmt = {F.COO: "coo", F.CSR: "csr", F.DIA: "dia", F.ELL: "ell",
               F.ELLR: "ellr", F.HYB: "hyb"}[fmt]
    fmt = fmt.lower()

    if fmt == "dense":
        return to_dense(src)
    if getattr(src, "format", None) == fmt:
        return src

    row, col, val, shape = _coo_arrays(src)

    if fmt == "coo":
        out = coo_matrix(row, col, val, shape, sort=False)
    elif fmt == "csr":
        out = _coo_to_csr(row, col, val, shape)
    elif fmt == "dia":
        out = _coo_to_dia(row, col, val, shape,
                          dont_throw=kwargs.get("dont_throw", False))
    elif fmt == "ell":
        cols2, vals2 = _coo_to_ell(
            row, col, val, shape,
            num_entries_per_row=kwargs.get("num_entries_per_row", 0),
            dont_throw=kwargs.get("dont_throw", False))
        out = ell_matrix(cols2, vals2, shape)
    elif fmt == "ellr":
        cols2, vals2 = _coo_to_ell(
            row, col, val, shape,
            num_entries_per_row=kwargs.get("num_entries_per_row", 0),
            dont_throw=kwargs.get("dont_throw", False))
        out = ellr_matrix(cols2, vals2, shape)
    elif fmt == "hyb":
        out = _coo_to_hyb(row, col, val, shape,
                          num_entries_per_row=kwargs.get(
                              "num_entries_per_row", 0))
    else:
        raise ValueError(f"unknown target format {fmt!r}")
    try:
        # the mirror must hold the OUTPUT container's value dtype (the
        # construction may downcast); skip if the container already stashed
        # a mirror of its own (coo_matrix does)
        if not hasattr(out, "_host_coo"):
            out_dt = np.dtype(out.dtype)
            if val.dtype != out_dt:
                val = val.astype(out_dt)
            if fmt == "dia":
                # the DIA extraction drops explicit zeros (keep = v != 0);
                # the mirror must match or later conversions from this
                # container would see nnz drift
                keep = val != 0
                if not keep.all():
                    row, col, val = row[keep], col[keep], val[keep]
            object.__setattr__(out, "_host_coo", (row, col, val, shape))
    except Exception:  # noqa: BLE001
        pass
    return out


def copy(src):
    """A deep copy of a container: same format, freshly materialized
    device buffers (parity: cusp::copy, cusp/copy.h:39,84 — the reference's
    same-format cross-memory-space copy; the rebuild has one memory
    space, so this is the buffer-duplication half of those semantics).
    Host-side mirrors are re-attached so the copy needs no device pull."""
    import jax

    out = jax.tree_util.tree_map(
        lambda leaf: jnp.array(leaf) if hasattr(leaf, "dtype") else leaf,
        src)
    for attr in ("_host_coo", "_host_scipy"):
        mirror = getattr(src, attr, None)
        if mirror is not None:
            try:
                object.__setattr__(out, attr, mirror)
            except Exception:  # noqa: BLE001
                pass
    return out


def to_dense(A) -> jnp.ndarray:
    if isinstance(A, (np.ndarray, jnp.ndarray)):
        return jnp.asarray(A)
    row, col, val, shape = _coo_arrays(A)
    dense = np.zeros(shape, dtype=val.dtype)
    np.add.at(dense, (row, col), val)
    return jnp.asarray(dense)
