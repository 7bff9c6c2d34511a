"""multiply — SpMV / SpMM / SpGEMM / operator apply, the central verb.

Parity target: cusp/multiply.h:98-120 (simple + generalized with
initialize/combine/reduce), dispatch in cusp/system/detail/generic/
multiply.inl and the format-specialized SpMV in generic/multiply/spmv.h
(DIA :49-119, ELL :124-180, COO :185-238, CSR-as-COO :243-270,
HYB = ELL pass then COO pass :275-290).

Design: every SpMV is a traceable jnp function with static shapes (usable
inside jitted solver loops); the default implementations below lean on
XLA's fusion, and the variants in cusp_autotuned_tpu.kernels override them
on the hot path via the autotuner.  The reference's KTT hook
(generic/multiply.inl:125-163 — route ELL/DIA multiplies through one tuning
iteration when enabled) is reproduced: when autotuning is enabled and the
operands are concrete (not tracers), multiply() routes through
autotune.multiply.
"""

from __future__ import annotations

import operator

import jax
import jax.numpy as jnp

from cusp_autotuned_tpu import formats as F
from cusp_autotuned_tpu.ops.segment import segment_sum, segment_reduce
from cusp_autotuned_tpu.utils.exceptions import InvalidInputException

# unrolled shifted-slice DIA path only up to this many diagonals; beyond it a
# gather-based path keeps compiled code size bounded.  XLA fuses the
# unrolled slices into one memory-bound loop on the GPU: at 159 diagonals
# (the Protein stand-in, 201 MB) it ran at 2.9 TB/s on an H100, 1.18x the
# gather path (PERF.md, "Kernel decisions on the H100")
_DIA_UNROLL_LIMIT = 256


def _is_concrete(*arrays) -> bool:
    return not any(isinstance(a, jax.core.Tracer)
                   for a in jax.tree_util.tree_leaves(arrays))


# -- per-format SpMV (x may be (n,) or (n, k)) --------------------------------

def spmv_coo(A: F.COO, x):
    prod = _scale(A.val, x[A.col])
    return segment_sum(prod, A.row, A.num_rows, indices_are_sorted=True)


def spmv_csr(A: F.CSR, x):
    prod = _scale(A.val, x[A.col])
    return segment_sum(prod, A.row, A.num_rows, indices_are_sorted=True)


def spmv_dia(A: F.DIA, x):
    m, n = A.shape
    mp = A.rows_padded
    offs = A.offsets
    if len(offs) <= _DIA_UNROLL_LIMIT:
        lo = min(0, min(offs))
        hi = max(n, mp + max(offs))
        pad_left = -lo
        x_pad = _pad_rows(x, pad_left, hi - n)
        acc = None
        for d, off in enumerate(offs):
            seg = x_pad[pad_left + off: pad_left + off + mp]
            term = _scale(A.data[d], seg)
            acc = term if acc is None else acc + term
        return acc[:m]
    # many-diagonal fallback: one gather
    idx = jnp.arange(mp, dtype=jnp.int32)[None, :] + jnp.asarray(offs, jnp.int32)[:, None]
    valid = (idx >= 0) & (idx < n)
    xg = x[jnp.clip(idx, 0, n - 1)]
    prod = _scale(A.data, xg)
    prod = jnp.where(_expand(valid, prod), prod, 0)
    return jnp.sum(prod, axis=0)[:m]


def spmv_ell(A, x):
    # invalid slots carry val == 0, so the clamped gather contributes nothing
    n = A.num_cols
    xg = x[jnp.clip(A.col, 0, n - 1)]
    return jnp.sum(_scale(A.val, xg), axis=0)[: A.num_rows]


def spmv_hyb(A: F.HYB, x):
    return spmv_ell(A.ell, x) + spmv_coo(A.coo, x)


def spmv_permutation(A: F.PermutationMatrix, x):
    return x[A.perm]


_SPMV = {
    "coo": spmv_coo, "csr": spmv_csr, "dia": spmv_dia,
    "ell": spmv_ell, "ellr": spmv_ell, "hyb": spmv_hyb,
    "permutation": spmv_permutation,
}


def _scale(vals, xs):
    """vals (E,) or (k,E) times gathered x which may have a trailing dense
    column axis (SpMM)."""
    if xs.ndim == vals.ndim:
        return vals * xs
    return vals[..., None] * xs


def _expand(mask, like):
    return mask.reshape(mask.shape + (1,) * (like.ndim - mask.ndim))


def _pad_rows(x, left, right):
    cfg = [(left, right)] + [(0, 0)] * (x.ndim - 1)
    return jnp.pad(x, cfg)


# -- public API ---------------------------------------------------------------

def multiply(A, B, *, use_autotuning: bool | None = None):
    """C = A @ B.  A sparse × vector → SpMV; A sparse × dense 2-D → SpMM;
    dense × dense → jnp.dot; sparse × sparse → SpGEMM; permutation applies a
    gather.  When autotuning is enabled (autotune.enable(), parity with
    cusp::ktt::enable) and inputs are concrete, sparse×vector routes through
    one tuning iteration exactly like the reference's multiply hook."""
    from cusp_autotuned_tpu.operators import _OPERATOR_TYPES
    from cusp_autotuned_tpu.formats.dense import Array2d
    if isinstance(B, Array2d):
        B = B.to_dense()              # sparse/operator x array2d block
    if isinstance(A, _OPERATOR_TYPES):
        # matrix-free linear operators apply directly (parity:
        # cusp/linear_operator.h — solvers accept any linear_operator as A)
        return A(B)
    if F.is_sparse(A) or isinstance(A, F.PermutationMatrix):
        if F.is_sparse(B) or isinstance(B, F.PermutationMatrix):
            from cusp_autotuned_tpu.ops.spgemm import spgemm
            return spgemm(A, B)
        B = jnp.asarray(B)
        if B.shape[0] != A.num_cols:
            raise InvalidInputException(
                f"dimension mismatch: {A.shape} @ {B.shape}")
        if use_autotuning is not False and _is_concrete(A, B) \
                and B.ndim in (1, 2):
            from cusp_autotuned_tpu import autotune
            if autotune.is_enabled() and A.format in autotune.TUNABLE_FORMATS:
                return autotune.multiply(A, B)
        return _SPMV[A.format](A, B)
    A = jnp.asarray(A)
    if F.is_sparse(B):
        from cusp_autotuned_tpu.ops.transpose import transpose
        # dense @ sparse = (sparse^T @ dense^T)^T
        yt = multiply(transpose(B), jnp.swapaxes(A, -1, -2) if A.ndim > 1 else A)
        return jnp.swapaxes(yt, -1, -2) if yt.ndim > 1 else yt
    return jnp.dot(A, jnp.asarray(B), preferred_element_type=A.dtype)


def generalized_spmv(A, x, y, initialize, combine, reduce):
    """z[i] = reduce(initialize(y[i]), reduce_{j in row i} combine(A_ij, x_j)).

    Parity: cusp::generalized_spmv (cusp/detail/multiply.inl:160-199).  Works
    for any associative `reduce`; fast-paths addition through segment_sum.
    """
    x = jnp.asarray(x)
    y = jnp.asarray(y)
    row, col, val, valid = _coo_view(A)
    init = initialize(y)

    combined = combine(val, x[jnp.clip(col, 0, A.num_cols - 1)])
    if reduce in (operator.add, jnp.add):
        combined = jnp.where(valid, combined, 0)
        contrib = segment_sum(combined, row, A.num_rows)
        return init + contrib

    row = jnp.where(valid, row, A.num_rows)
    counts = jax.ops.segment_sum(valid.astype(jnp.int32), row,
                                 num_segments=A.num_rows)
    mask = counts > 0
    # fast paths on XLA's native segment reductions
    if reduce in (jnp.maximum, max):
        contrib = jax.ops.segment_max(jnp.where(valid, combined, -jnp.inf),
                                      row, num_segments=A.num_rows)
    elif reduce in (jnp.minimum, min):
        contrib = jax.ops.segment_min(jnp.where(valid, combined, jnp.inf),
                                      row, num_segments=A.num_rows)
    elif reduce in (operator.mul, jnp.multiply):
        contrib = jax.ops.segment_prod(jnp.where(valid, combined, 1),
                                       row, num_segments=A.num_rows)
    else:
        # arbitrary associative reduce: sort so each row is one contiguous
        # segment (format views may interleave invalid slots), then a
        # segmented associative scan
        row_s, combined_s = jax.lax.sort((row, combined), num_keys=1)
        contrib, mask = segment_reduce(combined_s, row_s, A.num_rows, reduce)
    return jnp.where(mask, reduce(init, contrib), init)


def generalized_spgemm(A, B, initialize, combine, reduce):
    """Semiring SpGEMM (parity: cusp/detail/multiply.inl:114-151)."""
    from cusp_autotuned_tpu.ops.spgemm import spgemm
    return spgemm(A, B, initialize=initialize, combine=combine, reduce=reduce)


def _coo_view(A):
    """(row, col, val, valid_mask) padded arrays for any sparse format."""
    if isinstance(A, F.COO):
        valid = jnp.arange(A.nnz_padded) < A.nnz
        return A.row, A.col, A.val, valid
    if isinstance(A, F.CSR):
        valid = jnp.arange(A.nnz_padded) < A.nnz
        return A.row, A.col, A.val, valid
    if isinstance(A, (F.ELL, F.ELLR)):
        mp = A.rows_padded
        w = A.width
        rows = jnp.broadcast_to(jnp.arange(mp, dtype=jnp.int32)[None, :], (w, mp))
        valid = A.col != F.INVALID_INDEX
        # flatten row-major over rows so entries are sorted by row
        order = (jnp.swapaxes(rows, 0, 1).reshape(-1),
                 jnp.swapaxes(A.col, 0, 1).reshape(-1),
                 jnp.swapaxes(A.val, 0, 1).reshape(-1),
                 jnp.swapaxes(valid, 0, 1).reshape(-1))
        r, c, v, ok = order
        r = jnp.where(ok, r, A.num_rows)
        return r, jnp.where(ok, c, 0), v, ok
    if isinstance(A, F.HYB):
        r1, c1, v1, k1 = _coo_view(A.ell)
        r2, c2, v2, k2 = _coo_view(A.coo)
        # not globally sorted; generalized path re-sorts
        r = jnp.concatenate([r1, r2])
        c = jnp.concatenate([c1, c2])
        v = jnp.concatenate([v1, v2])
        k = jnp.concatenate([k1, k2])
        srt = jnp.argsort(jnp.where(k, r, A.num_rows), stable=True)
        return r[srt], c[srt], v[srt], k[srt]
    if isinstance(A, F.DIA):
        mp = A.rows_padded
        k = A.num_diagonals
        rows = jnp.broadcast_to(jnp.arange(mp, dtype=jnp.int32)[None, :], (k, mp))
        cols = rows + jnp.asarray(A.offsets, jnp.int32)[:, None]
        valid = (cols >= 0) & (cols < A.num_cols) & (rows < A.num_rows) & (A.data != 0)
        r = jnp.swapaxes(rows, 0, 1).reshape(-1)
        c = jnp.swapaxes(cols, 0, 1).reshape(-1)
        v = jnp.swapaxes(A.data, 0, 1).reshape(-1)
        ok = jnp.swapaxes(valid, 0, 1).reshape(-1)
        return jnp.where(ok, r, A.num_rows), jnp.where(ok, c, 0), v, ok
    raise TypeError(f"no COO view for {type(A)}")

