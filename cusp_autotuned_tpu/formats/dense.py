"""Dense containers: pitched array2d + array1d views.

Parity targets:
  - cusp::array1d / array1d_view (cusp/array1d.h:98,361) — 1-D vector and
    non-owning subrange views; counting/constant arrays.
  - cusp::array2d / array2d_view (cusp/array2d.h:144,162) — 2-D dense
    matrix with row/column orientation and PITCH padding (the physical
    minor dimension may exceed the logical one), plus row()/column() views
    (cusp/detail/array2d_format_utils.h).

Design: the reference pads the pitch to 32 elements for coalesced warp
access; here the pitch defaults to a multiple of 128 elements, so every
major line starts aligned and XLA tiles the buffer without re-layout.  Containers are pytree dataclasses (flow
through jit / grad / vmap); "views" are functional windows — they
materialize lazily as jnp slices of the padded buffer (XLA fuses the
slice into consumers; there is no aliasing mutation, matching JAX
semantics rather than Thrust's).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax.numpy as jnp
import numpy as np

from cusp_autotuned_tpu.formats.base import register_matrix, static_field
from cusp_autotuned_tpu.utils.padding import LANE, round_up


@register_matrix
@dataclasses.dataclass(frozen=True)
class Array2d:
    """Pitch-padded dense matrix.

    `values` is the physical buffer: (num_rows, pitch) for row-major
    ("c") orientation, (num_cols, pitch) for column-major ("f");
    pitch >= logical minor dimension.  Parity: cusp::array2d's
    pitch member (cusp/array2d.h:144; default pitch = minor dim :162),
    rebuilt with a lane-aligned default.
    """

    values: jnp.ndarray
    shape: tuple = static_field(default=(0, 0))
    orientation: str = static_field(default="c")   # "c" row-major, "f" col
    format: str = static_field(default="array2d")

    # -- construction --------------------------------------------------------

    @staticmethod
    def from_dense(a, orientation: str = "c", pitch: Optional[int] = None):
        a = jnp.asarray(a)
        if a.ndim != 2:
            raise ValueError("array2d expects a 2-D source")
        m, n = a.shape
        minor = n if orientation == "c" else m
        if pitch is None:
            pitch = round_up(max(minor, 1), LANE)
        if pitch < minor:
            raise ValueError(f"pitch {pitch} < minor dimension {minor}")
        body = a if orientation == "c" else a.T
        buf = jnp.pad(body, ((0, 0), (0, pitch - minor)))
        return Array2d(values=buf, shape=(m, n), orientation=orientation)

    @property
    def num_rows(self) -> int:
        return self.shape[0]

    @property
    def num_cols(self) -> int:
        return self.shape[1]

    @property
    def num_entries(self) -> int:
        return self.shape[0] * self.shape[1]

    @property
    def pitch(self) -> int:
        return self.values.shape[1]

    @property
    def dtype(self):
        return self.values.dtype

    # -- views ----------------------------------------------------------------

    def row(self, i):
        """Row view (cusp::array2d row view, array2d_format_utils.h)."""
        if self.orientation == "c":
            return self.values[i, : self.shape[1]]
        return self.values[:, i][: self.shape[1]]

    def column(self, j):
        """Column view."""
        if self.orientation == "c":
            return self.values[:, j][: self.shape[0]]
        return self.values[j, : self.shape[0]]

    def view(self, rows: slice, cols: slice):
        """Sub-matrix view as a new Array2d sharing no mutation (functional
        analogue of make_array2d_view, cusp/array2d.h)."""
        sub = self.to_dense()[rows, cols]
        return Array2d.from_dense(sub, orientation=self.orientation)

    # -- interop ---------------------------------------------------------------

    def to_dense(self) -> jnp.ndarray:
        m, n = self.shape
        if self.orientation == "c":
            return self.values[:m, :n]
        return self.values[:n, :m].T

    def __array__(self, dtype=None):
        a = np.asarray(self.to_dense())
        return a.astype(dtype) if dtype is not None else a

    def __getitem__(self, ij):
        i, j = ij
        return self.to_dense()[i, j]

    def transpose(self):
        """O(1) transpose: flip orientation, swap logical dims."""
        return Array2d(values=self.values, shape=(self.shape[1], self.shape[0]),
                       orientation="f" if self.orientation == "c" else "c")

    @property
    def T(self):
        return self.transpose()

    def __matmul__(self, other):
        from cusp_autotuned_tpu.ops.multiply import multiply
        return multiply(self.to_dense(), other)


def array2d(num_rows: int, num_cols: int, fill=0, dtype=jnp.float32,
            orientation: str = "c", pitch: Optional[int] = None) -> Array2d:
    """Construct a filled pitched array2d (cusp::array2d(m, n, value))."""
    a = jnp.full((num_rows, num_cols), fill, dtype=dtype)
    return Array2d.from_dense(a, orientation=orientation, pitch=pitch)


def make_array2d_view(buffer, num_rows: int, num_cols: int,
                      orientation: str = "c") -> Array2d:
    """Wrap an existing padded physical buffer (major, pitch) as an
    Array2d without copying (cusp::make_array2d_view)."""
    buffer = jnp.asarray(buffer)
    if buffer.ndim != 2:
        raise ValueError("buffer must be 2-D (major, pitch)")
    major = num_rows if orientation == "c" else num_cols
    minor = num_cols if orientation == "c" else num_rows
    if buffer.shape[0] != major or buffer.shape[1] < minor:
        raise ValueError(
            f"buffer {buffer.shape} cannot view a {num_rows}x{num_cols} "
            f"{orientation}-major matrix")
    return Array2d(values=buffer, shape=(num_rows, num_cols),
                   orientation=orientation)


# -- array1d ---------------------------------------------------------------------

def array1d(n: int, fill=0, dtype=jnp.float32) -> jnp.ndarray:
    """cusp::array1d(n, value) — dense vectors ARE jnp arrays here; this
    constructor exists for API parity (cusp/array1d.h:98)."""
    return jnp.full((n,), fill, dtype=dtype)


def array1d_view(a, start: int = 0, stop: Optional[int] = None,
                 stride: int = 1) -> jnp.ndarray:
    """Subrange view of a vector (cusp::array1d_view, cusp/array1d.h:361).
    Functional: returns the strided window (XLA fuses it into consumers)."""
    a = jnp.asarray(a)
    return a[start:stop:stride]
