"""Container base machinery.

Replaces the reference's type machinery — cusp::detail::matrix_base
(cusp/detail/matrix_base.h:30-36) and the compile-time format tag hierarchy
(cusp/detail/format.h) — with Python dataclasses registered as JAX pytrees.
Array members are pytree leaves (so containers flow through jit / grad /
shard_map); shape and nnz are static metadata (so jit specializes on them,
the analogue of CUSP's compile-time dispatch on format tags).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np


def register_matrix(cls):
    """Register a dataclass as a pytree: fields marked static=True in their
    metadata become aux data, all others are leaves."""
    fields = dataclasses.fields(cls)
    data_fields = [f.name for f in fields if not f.metadata.get("static", False)]
    meta_fields = [f.name for f in fields if f.metadata.get("static", False)]
    jax.tree_util.register_dataclass(cls, data_fields=data_fields, meta_fields=meta_fields)
    return cls


def static_field(**kwargs):
    return dataclasses.field(metadata={"static": True}, **kwargs)


class MatrixBase:
    """Common interface: num_rows / num_cols / num_entries (parity with
    cusp/detail/matrix_base.h), plus JAX-side conveniences."""

    format: str = "unknown"

    @property
    def num_rows(self) -> int:
        return self.shape[0]

    @property
    def num_cols(self) -> int:
        return self.shape[1]

    @property
    def num_entries(self) -> int:
        return self.nnz

    @property
    def dtype(self):
        return self.val.dtype

    @property
    def index_dtype(self):
        return jnp.int32

    # -- interop ------------------------------------------------------------

    def to_dense(self):
        """Dense jnp array (small matrices / tests only)."""
        from cusp_autotuned_tpu.ops.convert import to_dense
        return to_dense(self)

    def to_scipy(self):
        from cusp_autotuned_tpu.backend.reference import to_scipy
        return to_scipy(self)

    def asformat(self, fmt: str):
        from cusp_autotuned_tpu.ops.convert import convert
        return convert(self, fmt)

    # -- operators ----------------------------------------------------------

    def __matmul__(self, other):
        from cusp_autotuned_tpu.ops.multiply import multiply
        return multiply(self, other)

    def __call__(self, x):
        """Containers are linear operators (parity: cusp/linear_operator.h)."""
        from cusp_autotuned_tpu.ops.multiply import multiply
        return multiply(self, x)


def as_index_array(a) -> np.ndarray:
    return np.asarray(a, dtype=np.int32)


def as_value_array(a, dtype=None) -> np.ndarray:
    a = np.asarray(a)
    if dtype is not None:
        a = a.astype(dtype)
    elif a.dtype == np.float64 and not jax.config.jax_enable_x64:
        a = a.astype(np.float32)
    return a
