"""Gram-Schmidt orthogonalization (parity: cusp/eigen/gram_schmidt.h)."""

from __future__ import annotations

import jax
import jax.numpy as jnp


@jax.jit
def gram_schmidt(V):
    """Orthonormalize the columns of V (n, k) by re-orthogonalized classical
    Gram-Schmidt (two matvec passes at full precision — a TF32 product
    would lose orthogonality)."""
    V = jnp.asarray(V)
    n, k = V.shape

    def body(i, Q):
        v = V[:, i]
        mask = (jnp.arange(k) < i).astype(V.dtype)
        for _ in range(2):
            hi = jax.lax.Precision.HIGHEST
            coeffs = jnp.matmul(Q.T, v, precision=hi) * mask
            v = v - jnp.matmul(Q, coeffs, precision=hi)
        norm = jnp.linalg.norm(v)
        v = v / jnp.where(norm > 0, norm, 1)
        return Q.at[:, i].set(v)

    return jax.lax.fori_loop(0, k, body, jnp.zeros_like(V))
