"""CSR (compressed sparse row) matrix.

Parity target: cusp::csr_matrix (cusp/csr_matrix.h:107, members
row_offsets/column_indices/values at :150-158).

Layout: col/val padded to a multiple of 128 with col == 0,
val == 0 beyond indptr[num_rows]; indptr is the exact (num_rows+1) offsets
array.  The expanded per-entry row ids (the reference's csr→coo view trick,
generic/multiply/spmv.h:243-270) are materialized ONCE at construction and
carried in the container: +4 bytes/nnz buys segment reductions without a
per-SpMV searchsorted, which would otherwise dominate CSR SpMV time.
Padding entries carry row == num_rows (dropped by segment reductions).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax.numpy as jnp
import numpy as np

from cusp_autotuned_tpu.formats.base import (
    MatrixBase, register_matrix, static_field, as_index_array, as_value_array,
)
from cusp_autotuned_tpu.utils.padding import LANE, round_up, pad_to


@register_matrix
@dataclasses.dataclass(frozen=True)
class CSR(MatrixBase):
    indptr: jnp.ndarray       # (num_rows + 1,) int32
    col: jnp.ndarray          # (nnz_pad,) int32; padding = 0
    val: jnp.ndarray          # (nnz_pad,) values; padding = 0
    row: jnp.ndarray          # (nnz_pad,) int32 cached row ids; padding = m
    shape: Tuple[int, int] = static_field()
    nnz: int = static_field()

    format = "csr"

    @property
    def nnz_padded(self) -> int:
        return self.col.shape[0]


def csr_matrix(indptr, col, val, shape, *, dtype=None,
               pad_to_len: int | None = None) -> CSR:
    indptr = as_index_array(indptr)
    col = as_index_array(col)
    val = as_value_array(val, dtype)
    m, n = int(shape[0]), int(shape[1])
    if indptr.shape != (m + 1,):
        raise ValueError(f"indptr must have shape ({m + 1},), got {indptr.shape}")
    nnz = int(indptr[-1])
    if col.shape[0] < nnz or val.shape[0] < nnz:
        raise ValueError("col/val shorter than indptr[-1]")
    col, val = col[:nnz], val[:nnz]
    npad = pad_to_len if pad_to_len is not None else max(LANE, round_up(nnz, LANE))
    row = np.repeat(np.arange(m, dtype=np.int32), np.diff(indptr))
    return CSR(
        indptr=jnp.asarray(indptr),
        col=jnp.asarray(pad_to(col, npad, fill=0)),
        val=jnp.asarray(pad_to(val, npad, fill=0)),
        row=jnp.asarray(pad_to(row, npad, fill=m)),
        shape=(m, n),
        nnz=nnz,
    )


def csr_from_scipy(sp, dtype=None) -> CSR:
    sp = sp.tocsr()
    sp.sort_indices()
    return csr_matrix(sp.indptr, sp.indices, sp.data, sp.shape, dtype=dtype)
