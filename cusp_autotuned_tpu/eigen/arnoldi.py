"""Arnoldi factorization (parity: cusp/eigen/arnoldi.h:83 —
arnoldi(A, H, k=10) builds the k-step upper Hessenberg)."""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from cusp_autotuned_tpu.ops.multiply import multiply


import functools


@functools.partial(jax.jit, static_argnames=("k",))
def _arnoldi_device(A, q0, k):
    """k-step Arnoldi (modified Gram-Schmidt via a masked matmul) as ONE
    jitted fori_loop program."""
    n = q0.shape[0]
    dtype = q0.dtype
    Q = jnp.zeros((k + 1, n), dtype).at[0].set(q0 / jnp.linalg.norm(q0))
    H = jnp.zeros((k + 1, k), dtype)

    def body(j, st):
        Q, H = st
        w = multiply(A, Q[j])
        # classical GS twice (numerically ~ modified GS) against rows <= j;
        # rows beyond j are zero so the matmul form is exact
        # full precision: a TF32 product would lose orthogonality
        hi = jax.lax.Precision.HIGHEST
        h1 = jnp.matmul(Q, w, precision=hi)
        w = w - jnp.matmul(Q.T, h1, precision=hi)
        h2 = jnp.matmul(Q, w, precision=hi)
        w = w - jnp.matmul(Q.T, h2, precision=hi)
        h = h1 + h2
        beta = jnp.linalg.norm(w)
        Q = Q.at[j + 1].set(jnp.where(beta > 1e-12,
                                      w / jnp.maximum(beta, 1e-30),
                                      jnp.zeros_like(w)))
        H = H.at[:, j].set(h.at[j + 1].set(beta))
        return (Q, H)

    Q, H = jax.lax.fori_loop(0, k, body, (Q, H))
    return H, Q


def _arnoldi_factor(A, k: int, seed: int = 0):
    n = A.num_rows
    rng = np.random.RandomState(seed)
    dtype = np.float32 if "32" in str(A.dtype) else np.float64
    q = rng.rand(n).astype(dtype)
    k = min(k, n)
    H, Q = _arnoldi_device(A, jnp.asarray(q), k)
    H = np.asarray(H)
    Q = np.asarray(Q)
    sub = np.abs(np.diag(H, -1))
    small = np.nonzero(sub < 1e-12)[0]
    m = int(small[0]) + 1 if small.size else k
    return H[: m + 1, : m], Q[: m + 1]


def arnoldi(A, k: int = 10, seed: int = 0):
    """Returns the (m+1, m) Hessenberg H of a k-step Arnoldi factorization
    (functional version of the reference's arnoldi(A, H, k))."""
    H, _ = _arnoldi_factor(A, k, seed)
    return jnp.asarray(H)
