"""Spectral radius estimators.

Parity: cusp/eigen/spectral_radius.h:79 — disks_spectral_radius (Gershgorin
disks), ritz_spectral_radius (k-step Lanczos Ritz value),
estimate_spectral_radius.  Consumed by AMG prolongator smoothing
(rho_DinvA, cusp/precond/aggregation/smoothed_aggregation.h:45-68) and
polynomial relaxation."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from cusp_autotuned_tpu.ops.multiply import multiply


def disks_spectral_radius(A) -> float:
    """Gershgorin bound: max row sum of |a_ij|."""
    from cusp_autotuned_tpu.ops.multiply import _coo_view
    row, col, val, valid = _coo_view(A)
    absval = jnp.where(valid, jnp.abs(val), 0)
    sums = jax.ops.segment_sum(absval, row, num_segments=A.num_rows)
    return float(jnp.max(sums))


def ritz_spectral_radius(A, k: int = 10, symmetric: bool = True,
                         seed: int = 0) -> float:
    """Largest Ritz value of a k-step Lanczos (symmetric) / Arnoldi
    factorization."""
    if symmetric:
        alphas, betas, _ = _lanczos_tridiag(A, k, seed)
        import scipy.linalg as sla
        m = len(alphas)
        if m == 0:
            return 0.0
        w = sla.eigh_tridiagonal(np.asarray(alphas), np.asarray(betas[:m - 1]),
                                 eigvals_only=True)
        return float(np.max(np.abs(w)))
    from cusp_autotuned_tpu.eigen.arnoldi import _arnoldi_factor
    H, _ = _arnoldi_factor(A, k, seed)
    m = H.shape[1]
    return float(np.max(np.abs(np.linalg.eigvals(np.asarray(H[:m, :m])))))


def estimate_spectral_radius(A, k: int = 20, seed: int = 0) -> float:
    """Power-method estimate with k iterations."""
    n = A.num_rows
    rng = np.random.RandomState(seed)
    x = jnp.asarray(rng.rand(n).astype(np.float32 if "32" in str(A.dtype)
                                       else np.float64))

    @jax.jit
    def run(A, x):
        def body(_, x):
            y = multiply(A, x)
            return y / jnp.maximum(jnp.linalg.norm(y), 1e-30)
        x = jax.lax.fori_loop(0, k, body, x)
        y = multiply(A, x)
        return jnp.linalg.norm(y) / jnp.maximum(jnp.linalg.norm(x), 1e-30)

    return float(run(A, x))


import functools


@functools.partial(jax.jit, static_argnames=("k",))
def _lanczos_device(A, v0, k):
    """k-step Lanczos with full reorthogonalization as ONE jitted fori_loop
    program — no host round trip per step."""
    n = v0.shape[0]
    dtype = v0.dtype
    V = jnp.zeros((k + 1, n), dtype).at[0].set(v0 / jnp.linalg.norm(v0))
    alphas = jnp.zeros(k, dtype)
    betas = jnp.zeros(k, dtype)

    def body(j, st):
        V, alphas, betas = st
        v = V[j]
        w = multiply(A, v)
        alpha = jnp.dot(v, w)
        w = w - alpha * v
        # full reorthogonalization against the basis built so far (masked
        # rows beyond j are zero, so the matmul form is exact)
        coeff = V @ w
        w = w - V.T @ coeff
        beta = jnp.linalg.norm(w)
        V = V.at[j + 1].set(jnp.where(beta > 1e-12, w / jnp.maximum(
            beta, 1e-30), jnp.zeros_like(w)))
        return (V, alphas.at[j].set(alpha), betas.at[j].set(beta))

    V, alphas, betas = jax.lax.fori_loop(0, k, body, (V, alphas, betas))
    return alphas, betas, V


def _lanczos_tridiag(A, k: int, seed: int = 0, v0=None):
    """k-step Lanczos with full reorthogonalization; returns (alphas, betas,
    V) as host arrays (alphas m, betas m, V (m+1, n)), trimmed at the first
    breakdown like the reference's sequential loop."""
    n = A.num_rows
    rng = np.random.RandomState(seed)
    dtype = np.float32 if "32" in str(A.dtype) else np.float64
    v = np.asarray(v0, dtype) if v0 is not None else rng.rand(n).astype(dtype)
    k = min(k, n)
    alphas, betas, V = _lanczos_device(A, jnp.asarray(v), k)
    alphas = np.asarray(alphas)
    betas = np.asarray(betas)
    V = np.asarray(V)
    small = np.nonzero(betas < 1e-12)[0]
    m = int(small[0]) + 1 if small.size else k
    return alphas[:m], betas[:m], V[: m + 1]
