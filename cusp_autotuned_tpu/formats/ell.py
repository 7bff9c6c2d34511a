"""ELL / ELLR (ELLPACK) sparse matrices.

Parity targets: cusp::ell_matrix (cusp/ell_matrix.h:119 — col-major pitched
column_indices/values with invalid_index = -1 padding at :129) and the fork's
cusp::ktt::ellr_matrix (cusp/ktt/ellr_matrix.h:18-90 — ELL plus an explicit
per-row length array so kernels skip the padding test).

Layout: slot-major (width, rows_pad) — each of the `width` entry slots is
a full vector over rows (the same reasoning that made the reference choose
column-major ELL for coalescing).
Invalid slots keep the reference's col == -1 sentinel with val == 0.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax.numpy as jnp
import numpy as np

from cusp_autotuned_tpu.formats.base import (
    MatrixBase, register_matrix, static_field, as_index_array, as_value_array,
)
from cusp_autotuned_tpu.utils.padding import LANE, round_up, pad_axis_to

INVALID_INDEX = -1


@register_matrix
@dataclasses.dataclass(frozen=True)
class ELL(MatrixBase):
    col: jnp.ndarray          # (width, rows_pad) int32; invalid = -1
    val: jnp.ndarray          # (width, rows_pad) values; invalid = 0
    shape: Tuple[int, int] = static_field()
    nnz: int = static_field()

    format = "ell"

    @property
    def width(self) -> int:
        """Max entries per row (cusp num_entries_per_row)."""
        return self.col.shape[0]

    @property
    def rows_padded(self) -> int:
        return self.col.shape[1]


@register_matrix
@dataclasses.dataclass(frozen=True)
class ELLR(MatrixBase):
    col: jnp.ndarray          # (width, rows_pad) int32; invalid = -1
    val: jnp.ndarray          # (width, rows_pad) values
    row_lengths: jnp.ndarray  # (rows_pad,) int32; padding rows = 0
    shape: Tuple[int, int] = static_field()
    nnz: int = static_field()

    format = "ellr"

    width = ELL.width
    rows_padded = ELL.rows_padded


def _build_slots(col, val, shape, dtype):
    col = as_index_array(col)
    val = as_value_array(val, dtype)
    m, n = int(shape[0]), int(shape[1])
    if col.shape != val.shape or col.ndim != 2:
        raise ValueError("col/val must be equal-shape (width, rows) arrays")
    rows_pad = max(LANE, round_up(m, LANE))
    col = pad_axis_to(col, 1, rows_pad, fill=INVALID_INDEX)
    val = pad_axis_to(val, 1, rows_pad, fill=0)
    val = np.where(col == INVALID_INDEX, 0, val)
    nnz = int(np.count_nonzero(col != INVALID_INDEX))
    return col, val, (m, n), nnz


def ell_matrix(col, val, shape, *, dtype=None) -> ELL:
    """Build from slot-major (width, rows) arrays with -1 marking padding."""
    col, val, shape, nnz = _build_slots(col, val, shape, dtype)
    return ELL(col=jnp.asarray(col), val=jnp.asarray(val), shape=shape, nnz=nnz)


def ellr_matrix(col, val, shape, *, row_lengths=None, dtype=None) -> ELLR:
    """ELL plus per-row lengths; lengths recomputed from the sentinel when not
    given (parity: ellr_matrix::update_row_lengths, cusp/ktt/detail/ellr_matrix.inl:37-52)."""
    col, val, shape, nnz = _build_slots(col, val, shape, dtype)
    if row_lengths is None:
        row_lengths = np.sum(col != INVALID_INDEX, axis=0).astype(np.int32)
    else:
        row_lengths = pad_axis_to(as_index_array(row_lengths), 0, col.shape[1], fill=0)
    return ELLR(col=jnp.asarray(col), val=jnp.asarray(val),
                row_lengths=jnp.asarray(row_lengths), shape=shape, nnz=nnz)
