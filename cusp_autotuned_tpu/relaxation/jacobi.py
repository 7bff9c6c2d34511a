"""Weighted Jacobi relaxation.

Parity: cusp::relaxation::jacobi (cusp/relaxation/jacobi.h:95-157) —
x <- x + omega * D^-1 (b - A x) with the diagonal extracted at setup."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax.numpy as jnp

from cusp_autotuned_tpu.formats.base import MatrixBase, register_matrix, static_field
from cusp_autotuned_tpu.ops.format_utils import extract_diagonal
from cusp_autotuned_tpu.ops.multiply import multiply


@register_matrix
@dataclasses.dataclass(frozen=True)
class Jacobi(MatrixBase):
    diag_inv: jnp.ndarray
    default_omega: jnp.ndarray
    shape: Tuple[int, int] = static_field(default=(0, 0))

    format = "jacobi_relaxation"

    def __call__(self, A, b, x, omega=None):
        omega = self.default_omega if omega is None else omega
        return x + omega * self.diag_inv * (b - multiply(A, x))


def jacobi(A, omega: float = 1.0) -> Jacobi:
    from cusp_autotuned_tpu.ops.format_utils import diagonal_host
    import numpy as np
    dh = diagonal_host(A)
    if dh is not None:
        # host arithmetic + ONE upload: the eager jnp spelling costs four
        # XLA compiles per level shape
        dinv = np.where(dh != 0, 1.0 / np.where(dh != 0, dh, 1), 0)
        dt = np.dtype(A.dtype)
        return Jacobi(diag_inv=jnp.asarray(dinv.astype(dt)),
                      default_omega=jnp.asarray(np.asarray(omega, dt)),
                      shape=A.shape)
    d = extract_diagonal(A)
    return Jacobi(diag_inv=jnp.where(d != 0, 1.0 / jnp.where(d != 0, d, 1), 0),
                  default_omega=jnp.asarray(omega, d.dtype),
                  shape=A.shape)
