"""Multi-shift CG: solve (A + sigma_s I) x_s = b for all shifts from one
Krylov space.

Parity target: cusp::krylov::cg_m (cusp/krylov/detail/cg_m.inl — the
Jegerlehner CG-M recurrences: shifted zeta/beta/alpha transfer functions
KERNEL_ZB/KERNEL_A/KERNEL_XP, x0 = 0 required, no preconditioner).

Design: all shifts update in one (n_sigma, n) batched pass per iteration
— the per-shift axpys become a single rank-2 op — inside one jitted
lax.while_loop.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from cusp_autotuned_tpu.ops import blas
from cusp_autotuned_tpu.ops.multiply import multiply
from cusp_autotuned_tpu.solvers.monitor import (
    Monitor, default_monitor, monitor_init, monitor_record,
)


@functools.partial(jax.jit, static_argnums=(3, 4, 5))
def _cg_m_loop(A, b, sigma, limit, rtol, atol):
    state0 = monitor_init(b, limit, rtol, atol)
    n = b.shape[0]
    ns = sigma.shape[0]
    dtype = b.dtype

    r = b
    rsq = blas.dotc(r, r)
    p = b
    p_s = jnp.broadcast_to(b, (ns, n)).astype(dtype)
    x_s = jnp.zeros((ns, n), dtype)

    z_m1 = jnp.ones(ns, dtype)
    z_0 = jnp.ones(ns, dtype)
    alpha_s = jnp.zeros(ns, dtype)
    beta_0 = jnp.asarray(1.0, dtype)
    alpha_0 = jnp.asarray(0.0, dtype)

    state = monitor_record(state0, blas.nrm2(r))

    def cond(carry):
        return carry[-1].keep_going()

    def body(carry):
        (x_s, p_s, p, r, rsq, z_m1, z_0, beta_0, alpha_0, state) = carry
        beta_m1 = beta_0
        rsq_0 = rsq
        Ap = multiply(A, p)
        pAp = blas.dotc(p, Ap)
        beta_0 = -rsq_0 / pAp
        r = r + beta_0 * Ap
        # shifted zeta/beta (KERNEL_ZB, cg_m.inl:86-91).  The zeta
        # transfer function decays geometrically for well-conditioned
        # shifts; in f32 it underflows to 0 well before the seed system
        # converges and the raw recurrence then divides 0/0.  The
        # reference runs f64 and never guards; here a dead zeta FREEZES
        # its shift (z, b_s, a_s = 0 → x_s/p_s stop updating), which is
        # exact: a zero zeta means that shifted residual is already 0 to
        # working precision.
        den = (beta_0 * alpha_0 * (z_m1 - z_0)
               + beta_m1 * z_m1 * (1 - beta_0 * sigma))
        alive = (z_0 != 0) & (den != 0)
        z_1 = jnp.where(alive, z_0 * z_m1 * beta_m1
                        / jnp.where(den == 0, 1, den), 0)
        z_0_safe = jnp.where(alive, z_0, 1)
        b_s = jnp.where(alive, beta_0 * z_1 / z_0_safe, 0)
        rsq_1 = blas.dotc(r, r)
        alpha_0_new = rsq_1 / rsq_0
        p_new = r + alpha_0_new * p
        # shifted alpha (KERNEL_A, cg_m.inl:116-118)
        a_s = jnp.where(alive,
                        (alpha_0_new / beta_0) * z_1 * b_s / z_0_safe, 0)
        # batched per-shift x/p updates (KERNEL_XP, cg_m.inl:149-150)
        x_s = x_s - b_s[:, None] * p_s
        p_s = z_1[:, None] * r[None, :] + a_s[:, None] * p_s
        state = monitor_record(state, jnp.sqrt(jnp.real(rsq_1)))
        return (x_s, p_s, p_new, r, rsq_1, z_0, z_1, beta_0, alpha_0_new, state)

    carry = (x_s, p_s, p, r, rsq, z_m1, z_0, beta_0, alpha_0, state)
    out = jax.lax.while_loop(cond, body, carry)
    return out[0], out[-1]


def cg_m(A, b, sigma, monitor: Monitor | None = None, mesh=None):
    """Returns (X, monitor) with X[s] solving (A + sigma[s] I) X[s] = b.
    Convergence is monitored on the undeformed (sigma = 0) system, like the
    reference.  mesh: distribute the solve over a jax.sharding.Mesh."""
    import contextlib
    b = jnp.asarray(b)
    sigma = jnp.asarray(sigma, b.dtype)
    if monitor is None:
        monitor = default_monitor(b)
    if mesh is not None:
        from cusp_autotuned_tpu.parallel.sharded import distribute_for_solve
        A, b = distribute_for_solve(A, mesh, b)
    with (mesh if mesh is not None else contextlib.nullcontext()):
        X, state = _cg_m_loop(A, b, sigma, *monitor.spec())
    monitor.absorb_state(state)
    return X, monitor
