"""COO (coordinate) sparse matrix.

Parity target: cusp::coo_matrix (cusp/coo_matrix.h:116, members
row_indices/column_indices/values at :155-163) plus sort_by_row_and_column /
is_sorted_by_row helpers.

Layout: the three arrays are padded to a multiple of 128 so every kernel
sees static shapes.  Padding
entries use row == num_rows — out of range, so JAX segment reductions drop
them, and sortedness by row is preserved — with col == 0 and val == 0.
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
class COO(MatrixBase):
    row: jnp.ndarray          # (nnz_pad,) int32; padding = num_rows
    col: jnp.ndarray          # (nnz_pad,) int32; padding = 0
    val: jnp.ndarray          # (nnz_pad,) values; padding = 0
    shape: Tuple[int, int] = static_field()
    nnz: int = static_field()

    format = "coo"

    @property
    def nnz_padded(self) -> int:
        return self.row.shape[0]

    def is_sorted_by_row(self) -> bool:
        r = np.asarray(self.row)
        return bool(np.all(r[:-1] <= r[1:]))

    def is_sorted_by_row_and_column(self) -> bool:
        r = np.asarray(self.row)[: self.nnz]
        c = np.asarray(self.col)[: self.nnz]
        key = r.astype(np.int64) * (self.shape[1] + 1) + c
        return bool(np.all(key[:-1] <= key[1:]))

    def sort_by_row_and_column(self) -> "COO":
        return coo_matrix(
            np.asarray(self.row)[: self.nnz],
            np.asarray(self.col)[: self.nnz],
            np.asarray(self.val)[: self.nnz],
            self.shape,
            sort=True,
            pad_to_len=self.nnz_padded,
        )


def coo_matrix(row, col, val, shape, *, sort: bool = True, dtype=None,
               pad_to_len: int | None = None,
               sum_duplicates: bool = False) -> COO:
    """Build a COO container from host or device arrays, canonicalizing
    (sort by row then column) and padding to a lane-aligned length.

    sum_duplicates=True merges repeated (i, j) triplets by addition — the
    unordered-assembly idiom (reference:
    examples/MatrixAssembly/unordered_triplets.cu, sort + reduce_by_key).
    Requires sort=True."""
    row = as_index_array(row)
    col = as_index_array(col)
    val = as_value_array(val, dtype)
    if not (row.shape == col.shape == val.shape) or row.ndim != 1:
        raise ValueError("row/col/val must be equal-length 1-D arrays")
    nnz = int(row.shape[0])
    m, n = int(shape[0]), int(shape[1])
    if sort and nnz > 1:
        key = row.astype(np.int64) * (n + 1) + col
        order = np.argsort(key, kind="stable")
        row, col, val = row[order], col[order], val[order]
        if sum_duplicates:
            key = key[order]
            starts = np.flatnonzero(np.r_[True, key[1:] != key[:-1]])
            if starts.size < nnz:
                val = np.add.reduceat(val, starts)
                row, col = row[starts], col[starts]
                nnz = int(starts.size)
    elif sum_duplicates and nnz > 1:
        raise ValueError("sum_duplicates requires sort=True")
    npad = pad_to_len if pad_to_len is not None else max(LANE, round_up(nnz, LANE))
    M = COO(
        row=jnp.asarray(pad_to(row, npad, fill=m)),
        col=jnp.asarray(pad_to(col, npad, fill=0)),
        val=jnp.asarray(pad_to(val, npad, fill=0)),
        shape=(m, n),
        nnz=nnz,
    )
    # host mirror: construction ran on host arrays, so stash the trimmed
    # triplets — setup-time consumers (converters, kernel planners, the
    # scipy oracle) read them back constantly, and each device->host pull
    # costs a device round trip (ops/convert._coo_arrays consults this)
    object.__setattr__(M, "_host_coo",
                       (np.asarray(row), np.asarray(col), np.asarray(val),
                        (m, n)))
    return M


def coo_from_scipy(sp, dtype=None) -> COO:
    sp = sp.tocoo()
    return coo_matrix(sp.row, sp.col, sp.data, sp.shape, dtype=dtype)
