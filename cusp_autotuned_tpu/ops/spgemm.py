"""SpGEMM — sparse × sparse multiply via ESC (expand, sort, compress).

Parity target: the reference's COO ESC SpGEMM
(cusp/system/cuda/detail/multiply/spgemm.h — expansion with workspace capping
and slicing) and generalized_spgemm (cusp/detail/multiply.inl:114-151).

Design: the expansion size is data-dependent, so planning runs on
the host (cheap integer work over row lengths), while the expansion, the
lexicographic sort, and the duplicate compression run as one jitted XLA
program with static shapes.  Atomics-free: duplicates are merged with a
deterministic sorted segmented reduction.  Large products are sliced over
rows of A to bound workspace, mirroring the reference's capped-workspace
sub-products (spgemm.h:229-257).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from cusp_autotuned_tpu import formats as F
from cusp_autotuned_tpu.ops.convert import _coo_arrays, convert
from cusp_autotuned_tpu.formats.coo import coo_matrix
from cusp_autotuned_tpu.utils.exceptions import InvalidInputException
from cusp_autotuned_tpu.utils.padding import LANE, round_up

# cap on the expanded-workspace length of a single slice (entries); mirrors
# the reference's min(nnz, 16<<20) workspace cap
MAX_WORKSPACE = 16 << 20


@partial(jax.jit, static_argnames=("E", "E_pad", "num_rows", "combine",
                                   "reduce"))
def _esc_kernel(a_row, a_col, a_val, exp_offsets, b_indptr, b_col, b_val,
                E, E_pad, num_rows, combine=None, reduce=None):
    """Expand-sort-compress one slice, parameterized by the semiring
    (parity: cusp/detail/multiply.inl:114-151 — generalized_spgemm runs the
    same device path as plain SpGEMM with combine/reduce plugged in).
    Returns (rows, cols, vals, nseg) with duplicates merged into the first
    slot of each (row, col) segment."""
    e = jnp.arange(E_pad, dtype=jnp.int32)
    k = jnp.searchsorted(exp_offsets, e, side="right").astype(jnp.int32) - 1
    k = jnp.clip(k, 0, a_row.shape[0] - 1)
    t = e - exp_offsets[k]
    bidx = jnp.clip(b_indptr[jnp.clip(a_col[k], 0, b_indptr.shape[0] - 2)] + t,
                    0, b_col.shape[0] - 1)
    valid = e < E
    crow = jnp.where(valid, a_row[k], num_rows).astype(jnp.int32)
    ccol = jnp.where(valid, b_col[bidx], 0).astype(jnp.int32)
    raw = (a_val[k] * b_val[bidx] if combine is None
           else combine(a_val[k], b_val[bidx]))
    cval = jnp.where(valid, raw, 0)
    return _sort_compress(crow, ccol, cval, num_rows, reduce)


def _sort_compress(crow, ccol, cval, num_rows, reduce=None):
    """Sort (row, col, val) triplets and merge duplicate (row, col) pairs
    into the first slot of each segment; shared by the per-slice ESC kernel
    and the cross-slice device merge."""
    E_pad = crow.shape[0]
    crow, ccol, cval = jax.lax.sort((crow, ccol, cval), num_keys=2)
    prev_r = jnp.concatenate([jnp.full((1,), -1, jnp.int32), crow[:-1]])
    prev_c = jnp.concatenate([jnp.full((1,), -1, jnp.int32), ccol[:-1]])
    new_seg = (crow != prev_r) | (ccol != prev_c)
    seg_id = jnp.cumsum(new_seg.astype(jnp.int32)) - 1
    if reduce is None:
        vals = jax.ops.segment_sum(cval, seg_id, num_segments=E_pad,
                                   indices_are_sorted=True)
    else:
        from cusp_autotuned_tpu.ops.segment import segment_reduce
        vals, _ = segment_reduce(cval, seg_id, E_pad, reduce)
    nseg = seg_id[-1] + 1
    # slots beyond nseg follow the COO padding convention (row=num_rows,
    # col=0, val=0) so the compressed output IS a valid padded sorted COO —
    # the device-resident path wraps it without any array download
    rows = jnp.full(E_pad, num_rows, jnp.int32).at[seg_id].set(crow)
    cols = jnp.zeros(E_pad, jnp.int32).at[seg_id].set(ccol)
    vals = jnp.where(jnp.arange(E_pad, dtype=jnp.int32) < nseg, vals, 0)
    return rows, cols, vals, nseg


@partial(jax.jit, static_argnames=("num_rows", "reduce"))
def _merge_kernel(rows, cols, vals, num_rows, reduce=None):
    return _sort_compress(rows, cols, vals, num_rows, reduce)


_BUILTIN_OPS = {}


def _normalize_op(fn):
    """Map Python builtins/operators to their jnp equivalents so the same
    semiring call works on host scalars and on device tracers."""
    import operator
    if not _BUILTIN_OPS:
        _BUILTIN_OPS.update({
            min: jnp.minimum, max: jnp.maximum,
            operator.add: jnp.add, operator.mul: jnp.multiply,
            operator.sub: jnp.subtract,
            np.add: jnp.add, np.multiply: jnp.multiply,
            np.subtract: jnp.subtract,
            np.minimum: jnp.minimum, np.maximum: jnp.maximum,
        })
    return _BUILTIN_OPS.get(fn, fn)


def spgemm(A, B, initialize=None, combine=None, reduce=None):
    """C = A @ B (or the semiring generalization when combine/reduce given)."""
    combine = _normalize_op(combine) if combine is not None else None
    reduce = _normalize_op(reduce) if reduce is not None else None
    if A.num_cols != B.num_rows:
        raise InvalidInputException(f"dimension mismatch: {A.shape} @ {B.shape}")
    out_fmt = getattr(A, "format", "coo")
    if out_fmt not in ("coo", "csr", "dia", "ell", "ellr", "hyb"):
        out_fmt = "coo"           # e.g. permutation @ sparse yields COO

    a_row, a_col, a_val, (m, _) = _coo_arrays(A)
    Bc = convert(B, "csr")
    n = B.num_cols
    b_indptr = np.asarray(Bc.indptr)
    b_len = np.diff(b_indptr)

    exp_len = b_len[a_col] if a_col.size else np.zeros(0, np.int64)
    total = int(exp_len.sum())
    if total == 0:
        C = coo_matrix(np.zeros(0, np.int32), np.zeros(0, np.int32),
                       np.zeros(0, a_val.dtype), (m, n))
        return C if out_fmt == "coo" else convert(C, out_fmt)

    # slice over A's entries so each slice's expansion fits the workspace cap
    cum = np.concatenate([[0], np.cumsum(exp_len)])

    if total <= MAX_WORKSPACE:
        # single slice: DEVICE-RESIDENT result.  The compressed kernel
        # output is already a padded sorted COO; only the segment-count
        # scalar crosses to the host (no O(nnz) download/re-upload), so
        # SpGEMM chains (Galerkin RAP, semiring graph products) stay on
        # device end to end.
        E = total
        E_pad = max(LANE, round_up(E, LANE))
        rows_d, cols_d, vals_d, nseg = _esc_kernel(
            jnp.asarray(a_row), jnp.asarray(a_col), jnp.asarray(a_val),
            jnp.asarray(cum.astype(np.int32)), Bc.indptr, Bc.col, Bc.val,
            E=E, E_pad=E_pad, num_rows=m, combine=combine, reduce=reduce)
        nnz = int(nseg) - (1 if E_pad > E else 0)   # drop the pad segment
        C = F.COO(row=rows_d, col=cols_d, val=vals_d, shape=(m, n),
                  nnz=max(nnz, 0))
        return C if out_fmt == "coo" else convert(C, out_fmt)

    # multi-slice: each slice's compressed output stays DEVICE-RESIDENT
    # (only the segment-count scalar syncs), slices are device-sliced to
    # their compressed length, concatenated on device, and merged with one
    # final sort + segmented reduction — no O(nnz) host transfer (parity:
    # the reference slices within device memory, spgemm.h:229-257)
    pieces = []
    start = 0
    while start < a_row.size:
        stop = int(np.searchsorted(cum, cum[start] + MAX_WORKSPACE,
                                   side="right")) - 1
        stop = max(stop, start + 1)
        E = int(cum[stop] - cum[start])
        E_pad = max(LANE, round_up(E, LANE))
        offs = (cum[start:stop + 1] - cum[start]).astype(np.int32)
        r_d, c_d, v_d, nseg = _esc_kernel(
            jnp.asarray(a_row[start:stop]), jnp.asarray(a_col[start:stop]),
            jnp.asarray(a_val[start:stop]), jnp.asarray(offs),
            Bc.indptr, Bc.col, Bc.val,
            E=E, E_pad=E_pad, num_rows=m, combine=combine, reduce=reduce)
        nseg_i = int(nseg)
        real_i = nseg_i - (1 if E_pad > E else 0)   # minus in-slice pad seg
        keep = min(max(LANE, round_up(nseg_i, LANE)), E_pad)
        pieces.append((jax.lax.slice_in_dim(r_d, 0, keep),
                       jax.lax.slice_in_dim(c_d, 0, keep),
                       jax.lax.slice_in_dim(v_d, 0, keep), keep, real_i))
        start = stop
    rows = jnp.concatenate([p[0] for p in pieces])
    cols = jnp.concatenate([p[1] for p in pieces])
    vals = jnp.concatenate([p[2] for p in pieces])
    rows, cols, vals, nseg = _merge_kernel(rows, cols, vals, num_rows=m,
                                           reduce=reduce)
    # all pad slots (row == m) merge into one trailing segment; present
    # iff any slice carried padding past its real entries
    has_pad = sum(p[3] for p in pieces) > sum(p[4] for p in pieces)
    nnz = int(nseg) - (1 if has_pad else 0)
    C = F.COO(row=rows, col=cols, val=vals, shape=(m, n), nnz=max(nnz, 0))
    return C if out_fmt == "coo" else convert(C, out_fmt)
