"""Diagonal (Jacobi) preconditioner: M = diag(A)^-1
(parity: cusp/precond/diagonal.h:85-107)."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax.numpy as jnp

from cusp_autotuned_tpu.formats.base import MatrixBase, register_matrix, static_field
from cusp_autotuned_tpu.ops.format_utils import extract_diagonal


@register_matrix
@dataclasses.dataclass(frozen=True)
class DiagonalPreconditioner(MatrixBase):
    diag_inv: jnp.ndarray
    shape: Tuple[int, int] = static_field(default=(0, 0))

    format = "diagonal_preconditioner"

    def __call__(self, x):
        return self.diag_inv * x


def diagonal(A) -> DiagonalPreconditioner:
    from cusp_autotuned_tpu.ops.format_utils import diagonal_host
    import numpy as np
    dh = diagonal_host(A)
    if dh is not None:
        # host arithmetic + one upload (each eager jnp elementwise op is
        # an XLA compile per shape)
        dinv = np.where(dh != 0, 1.0 / np.where(dh != 0, dh, 1), 0)
        return DiagonalPreconditioner(
            diag_inv=jnp.asarray(dinv.astype(np.dtype(A.dtype))),
            shape=A.shape)
    d = extract_diagonal(A)
    return DiagonalPreconditioner(
        diag_inv=jnp.where(d != 0, 1.0 / jnp.where(d != 0, d, 1), 0),
        shape=A.shape)
