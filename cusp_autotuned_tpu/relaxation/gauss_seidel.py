"""Multicolor Gauss-Seidel relaxation.

Parity: cusp::relaxation::gauss_seidel — setup computes a vertex coloring and
groups rows by color (relaxation/detail/gauss_seidel.inl:40-53); each sweep
visits color classes in order, updating all rows of a class in parallel
(rows of one color are independent, so the batched update is exact GS — the
replacement for the warp-per-row color-class kernel,
cuda/detail/relaxation/gauss_seidel.h:38-80).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp

from cusp_autotuned_tpu.formats.base import MatrixBase, register_matrix, static_field
from cusp_autotuned_tpu.ops.format_utils import extract_diagonal
from cusp_autotuned_tpu.ops.multiply import multiply

FORWARD = "forward"
BACKWARD = "backward"
SYMMETRIC = "symmetric"


@register_matrix
@dataclasses.dataclass(frozen=True)
class GaussSeidel(MatrixBase):
    diag_inv: jnp.ndarray
    colors: jnp.ndarray                 # (n,) int32 color class per row
    num_colors: int = static_field(default=1)
    default_direction: str = static_field(default=FORWARD)
    shape: Tuple[int, int] = static_field(default=(0, 0))

    format = "gauss_seidel_relaxation"

    def _one_color(self, A, b, x, c):
        t = multiply(A, x)
        upd = x + self.diag_inv * (b - t)
        return jnp.where(self.colors == c, upd, x)

    def __call__(self, A, b, x, direction: str | None = None):
        direction = direction or self.default_direction
        # num_colors is static: unroll the color sweep (small k; avoids
        # device-loop scheduling entirely)
        order = list(range(self.num_colors))
        if direction == BACKWARD:
            order = order[::-1]
        elif direction == SYMMETRIC:
            order = order + order[::-1]
        for c in order:
            x = self._one_color(A, b, x, c)
        return x


def gauss_seidel(A, default_direction: str = FORWARD, seed: int = 0) -> GaussSeidel:
    from cusp_autotuned_tpu.graph.coloring import vertex_coloring
    d = extract_diagonal(A)
    ncolors, colors = vertex_coloring(A, seed=seed)
    return GaussSeidel(
        diag_inv=jnp.where(d != 0, 1.0 / jnp.where(d != 0, d, 1), 0),
        colors=colors,
        num_colors=int(ncolors),
        default_direction=default_direction,
        shape=A.shape)
