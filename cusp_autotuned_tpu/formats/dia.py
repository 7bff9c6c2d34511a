"""DIA (diagonal) sparse matrix — the format structured stencils love.

Parity target: cusp::dia_matrix (cusp/dia_matrix.h:120, members
diagonal_offsets + col-major pitched values array2d at :130-131).

Layout: data has shape (num_diags, rows_pad) with rows on the minor axis,
so SpMV is num_diags fused multiply-adds of full row vectors against
shifted slices of x — unit-stride loads, no gathers.  data[d, i] = A[i, i + offsets[d]] when in range, else 0.

The offsets are *static metadata* (a tuple of Python ints), not a device
array: the diagonal structure is part of the compiled program — jit
specializes the shifted slices on it — while only the values are runtime
data.  This is the analogue of the reference baking the tuning space
into NVRTC-compiled kernel text.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax.numpy as jnp
import numpy as np

from cusp_autotuned_tpu.formats.base import (
    MatrixBase, register_matrix, static_field, as_index_array, as_value_array,
)
from cusp_autotuned_tpu.utils.padding import LANE, round_up


@register_matrix
@dataclasses.dataclass(frozen=True)
class DIA(MatrixBase):
    data: jnp.ndarray                    # (num_diags, rows_pad) values
    offsets: Tuple[int, ...] = static_field()  # sorted ascending
    shape: Tuple[int, int] = static_field()
    nnz: int = static_field()

    format = "dia"

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def num_diagonals(self) -> int:
        return self.data.shape[0]

    @property
    def rows_padded(self) -> int:
        return self.data.shape[1]


def dia_matrix(offsets, data, shape, *, nnz=None, dtype=None) -> DIA:
    """Build from explicit diagonals. data[d, i] = A[i, i + offsets[d]]."""
    offsets = as_index_array(offsets)
    data = as_value_array(data, dtype)
    m, n = int(shape[0]), int(shape[1])
    k = int(offsets.shape[0])
    if data.shape[0] != k:
        raise ValueError("data must have one row per diagonal offset")
    rows_pad = max(LANE, round_up(m, LANE))
    if data.shape[1] < rows_pad:
        buf = np.zeros((k, rows_pad), dtype=data.dtype)
        buf[:, : data.shape[1]] = data
        data = buf
    # zero out-of-matrix slots so padded lanes never contribute
    i = np.arange(data.shape[1])
    j = i[None, :] + offsets[:, None]
    valid = (i[None, :] < m) & (j >= 0) & (j < n)
    data = np.where(valid, data, 0)
    if nnz is None:
        nnz = int(np.count_nonzero(valid))
    return DIA(
        data=jnp.asarray(data),
        offsets=tuple(int(o) for o in offsets),
        shape=(m, n),
        nnz=int(nnz),
    )
