"""BiCG (parity: cusp::krylov::bicg, cusp/krylov/detail/bicg.inl — dual
recurrence on (r, r*) with A/A^T and M/M^T applies, breakdown exit on
rho == 0).  A^T / M^T are materialized once at setup (host transpose) and the
loop runs as one jitted lax.while_loop."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from cusp_autotuned_tpu.ops import blas
from cusp_autotuned_tpu.ops.multiply import multiply
from cusp_autotuned_tpu.ops.transpose import transpose as transpose_op
from cusp_autotuned_tpu.operators import as_operator, IdentityOperator
from cusp_autotuned_tpu.solvers.monitor import (
    Monitor, default_monitor, monitor_init, monitor_record,
)


@functools.partial(jax.jit, static_argnums=(6, 7, 8))
def _bicg_loop(A, At, M, Mt, b, x0, limit, rtol, atol):
    if x0 is None:
        x0 = jnp.zeros_like(b)
    state0 = monitor_init(b, limit, rtol, atol)
    r = b - multiply(A, x0)
    state = monitor_record(state0, blas.nrm2(r))
    r_star = r
    z = M(r)
    z_star = Mt(r_star)
    rho = blas.dotc(z, r_star)
    p = z
    p_star = z_star

    def cond(carry):
        x, r, r_star, p, p_star, rho, state, done = carry
        return jnp.logical_and(jnp.logical_not(done), state.keep_going())

    def body(carry):
        x, r, r_star, p, p_star, rho, state, done = carry
        q = multiply(A, p)
        q_star = multiply(At, p_star)
        alpha = rho / blas.dotc(p_star, q)
        x = x + alpha * p
        r = r - alpha * q
        r_star = r_star - alpha * q_star
        state = monitor_record(state, blas.nrm2(r))
        z = M(r)
        z_star = Mt(r_star)
        rho_new = blas.dotc(z, r_star)
        breakdown = rho_new == 0
        p = z + (rho_new / rho) * p
        p_star = z_star + (rho_new / rho) * p_star
        return (x, r, r_star, p, p_star, rho_new, state, breakdown)

    init = (x0, r, r_star, p, p_star, rho, state, jnp.asarray(False))
    out = jax.lax.while_loop(cond, body, init)
    return out[0], out[6]


def bicg(A, b, x0=None, monitor: Monitor | None = None, M=None,
         At=None, Mt=None, mesh=None):
    """mesh: a jax.sharding.Mesh distributes the solve.  The A^T apply the
    dual recurrence needs (bicg.inl:42-157) is materialized at setup — the
    same move as the single-chip path — and BOTH A and A^T are row-sharded
    over the mesh (row-aligned for COO/CSR), so each operator's segment
    reductions stay shard-local and the dot products become all-reduces
    under GSPMD."""
    b = jnp.asarray(b)
    if monitor is None:
        monitor = default_monitor(b)
    if At is None:
        At = transpose_op(A)
    Mop = as_operator(M)
    Mtop = as_operator(Mt) if Mt is not None else (
        Mop if isinstance(Mop, IdentityOperator) else as_operator(transpose_op(M)))
    if mesh is not None:
        from cusp_autotuned_tpu.parallel.sharded import distribute_for_solve
        if x0 is None:
            x0 = jnp.zeros_like(b)
        A, b, x0 = distribute_for_solve(A, mesh, b, x0)
        At, = distribute_for_solve(At, mesh)
        with mesh:
            x, state = _bicg_loop(A, At, Mop, Mtop, b, jnp.asarray(x0),
                                  *monitor.spec())
    else:
        x0 = None if x0 is None else jnp.asarray(x0)
        x, state = _bicg_loop(A, At, Mop, Mtop, b, x0, *monitor.spec())
    monitor.absorb_state(state)
    return x, monitor
