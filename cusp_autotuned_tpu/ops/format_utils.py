"""Format utilities.

Parity target: cusp/format_utils.h — offsets_to_indices (:41),
indices_to_offsets (:90), extract_diagonal (:140), count_diagonals (:191),
compute_max_entries_per_row, compute_optimal_entries_per_row (heuristic
constants from generic/format_utils.inl:281-320 and
cusp/detail/functional.inl:114-132).

The index<->offset transforms are traceable jnp functions (usable inside jit);
the planning heuristics are host-side NumPy (conversion planning happens at
setup time, the analogue of CUSP running them on the backend's exec).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


# -- traceable --------------------------------------------------------------

def offsets_to_indices(offsets: jnp.ndarray, num_entries: int) -> jnp.ndarray:
    """Expand CSR row offsets to per-entry row indices.  Padding entries
    (positions >= offsets[-1]) map to num_rows, out of range for segment
    reductions."""
    positions = jnp.arange(num_entries, dtype=offsets.dtype)
    return jnp.searchsorted(offsets, positions, side="right").astype(jnp.int32) - 1


def indices_to_offsets(indices: jnp.ndarray, num_rows: int) -> jnp.ndarray:
    """Compress sorted per-entry row indices to CSR offsets.  Out-of-range
    (padding) indices are dropped by the scatter."""
    counts = jnp.zeros(num_rows + 1, dtype=jnp.int32)
    counts = counts.at[indices + 1].add(1, mode="drop")
    return jnp.cumsum(counts).astype(jnp.int32)


def diagonal_host(A):
    """Main diagonal as a HOST numpy vector, or None when A is traced.
    Setup-time consumers (jacobi/diagonal preconditioners, smoother
    factories) should do their arithmetic on this and upload ONCE —
    eager jnp elementwise ops cost one XLA compile each per distinct
    shape."""
    import jax

    if any(isinstance(leaf, jax.core.Tracer)
           for leaf in jax.tree_util.tree_leaves(A)):
        return None
    from cusp_autotuned_tpu.ops.convert import _coo_arrays
    m, n = A.shape
    k = min(m, n)
    row, col, val, _ = _coo_arrays(A)
    on = row == col
    d = np.zeros(k, np.asarray(val).dtype)
    d[row[on]] = val[on]
    return d


def extract_diagonal(A) -> jnp.ndarray:
    """Main diagonal of A as a dense vector of length min(m, n).

    Concrete (non-traced) operands take a host fast path: the device scatter
    this otherwise lowers to costs an XLA compile per distinct shape, and
    diagonal extraction is a setup-time op
    (jacobi/diagonal preconditioners, SA-AMG smoother factories)."""
    import jax
    from cusp_autotuned_tpu import formats as F

    m, n = A.shape
    k = min(m, n)
    d = diagonal_host(A)
    if d is not None:
        return jnp.asarray(d, dtype=A.dtype)
    if isinstance(A, F.DIA):
        offsets = np.asarray(A.offsets)
        hit = np.nonzero(offsets == 0)[0]
        if hit.size == 0:
            return jnp.zeros(k, dtype=A.dtype)
        return A.data[int(hit[0]), :k]
    if isinstance(A, (F.ELL, F.ELLR)):
        rows = jnp.arange(A.rows_padded, dtype=jnp.int32)
        on_diag = (A.col == rows[None, :])
        return jnp.sum(jnp.where(on_diag, A.val, 0), axis=0)[:k]
    if isinstance(A, F.COO):
        on_diag = (A.row == A.col)
        diag = jnp.zeros(k, dtype=A.dtype)
        idx = jnp.where(on_diag, A.row, k)  # k = out of range -> dropped
        return diag.at[idx].add(jnp.where(on_diag, A.val, 0), mode="drop")
    if isinstance(A, F.CSR):
        row = A.row
        on_diag = (row == A.col) & (jnp.arange(A.nnz_padded) < A.nnz)
        diag = jnp.zeros(k, dtype=A.dtype)
        idx = jnp.where(on_diag, row, k)
        return diag.at[idx].add(jnp.where(on_diag, A.val, 0), mode="drop")
    if isinstance(A, F.HYB):
        return extract_diagonal(A.ell) + extract_diagonal(A.coo)
    if isinstance(A, (jnp.ndarray, np.ndarray)):
        return jnp.diagonal(jnp.asarray(A))
    raise TypeError(f"extract_diagonal: unsupported type {type(A)}")


# -- host planning ----------------------------------------------------------

def count_diagonals(num_rows: int, num_cols: int, row_indices, column_indices) -> int:
    """Number of occupied diagonals (parity: cusp/format_utils.h:191)."""
    row = np.asarray(row_indices)
    col = np.asarray(column_indices)
    return int(np.unique(col.astype(np.int64) - row.astype(np.int64)).size)


def compute_max_entries_per_row(row_offsets) -> int:
    ro = np.asarray(row_offsets)
    if ro.size <= 1:
        return 0
    return int(np.max(np.diff(ro)))


def compute_optimal_entries_per_row(row_offsets, relative_speed: float = 3.0,
                                    breakeven_threshold: int = 4096) -> int:
    """ELL width for the HYB split: smallest K such that the rows longer than
    K are either rare (< num_rows / relative_speed) or few in absolute terms
    (< breakeven_threshold).  Same decision rule as the reference
    (generic/format_utils.inl:313-317 + functional.inl:128-131)."""
    ro = np.asarray(row_offsets)
    num_rows = ro.size - 1
    if num_rows == 0:
        return 0
    lengths = np.diff(ro)
    max_len = int(lengths.max()) if num_rows else 0
    # cumulative_histogram[K] = number of rows with length <= K
    hist = np.bincount(lengths, minlength=max_len + 1)
    cumulative = np.cumsum(hist)
    for K in range(max_len + 1):
        rows_below = int(cumulative[K])
        longer = num_rows - rows_below
        if relative_speed * longer < num_rows or longer < breakeven_threshold:
            return K
    return max_len
