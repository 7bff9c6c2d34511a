"""Preconditioned conjugate gradients.

Parity target: cusp::krylov::cg (cusp/krylov/detail/cg.inl:41-107) with the
same default ladder — no monitor → default monitor (500 iters, rtol 1e-5), no
M → identity (cg.inl:151-180).

Design: the whole solve is one jitted lax.while_loop; the SpMV, the
preconditioner apply, and the BLAS-1 updates fuse into a single XLA program
per iteration — no host round-trips until the loop exits.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from cusp_autotuned_tpu.ops import blas
from cusp_autotuned_tpu.ops.multiply import multiply
from cusp_autotuned_tpu.operators import as_operator
from cusp_autotuned_tpu.solvers.monitor import (
    Monitor, default_monitor, monitor_init, monitor_record,
)


@functools.partial(jax.jit, static_argnums=(4, 5, 6))
def _cg_loop(A, M, b, x0, limit, rtol, atol):
    # x0 default and the monitor state are built INSIDE the jit: each
    # eager op here would cost a full dispatch round trip per solve call
    if x0 is None:
        x0 = jnp.zeros_like(b)
    state0 = monitor_init(b, limit, rtol, atol)
    y = multiply(A, x0)
    r = b - y
    z = M(r)
    p = z
    rz = blas.dotc(r, z)
    state = monitor_record(state0, blas.nrm2(r))

    def cond(carry):
        return carry[-1].keep_going()

    def body(carry):
        x, r, p, rz, state = carry
        y = multiply(A, p)
        alpha = rz / blas.dotc(y, p)
        x = x + alpha * p
        r = r - alpha * y
        z = M(r)
        rz_new = blas.dotc(r, z)
        beta = rz_new / rz
        p = z + beta * p
        state = monitor_record(state, blas.nrm2(r))
        return (x, r, p, rz_new, state)

    x, r, p, rz, state = jax.lax.while_loop(cond, body, (x0, r, p, rz, state))
    return x, state


def cg(A, b, x0=None, monitor: Monitor | None = None, M=None, mesh=None):
    """Solve A x = b.  Returns (x, monitor) — functional in/out instead of the
    reference's in-place x.

    mesh: a jax.sharding.Mesh distributes the solve — A is row-sharded over
    the mesh (row-aligned placement for COO/CSR), b/x0 replicated, and the
    same jitted loop runs under GSPMD with the dot products becoming
    all-reduces.  The reference has no distributed path (SURVEY §2.6); this
    is the extension."""
    b = jnp.asarray(b)
    if monitor is None:
        monitor = default_monitor(b)
    Mop = as_operator(M)
    if mesh is not None:
        from cusp_autotuned_tpu.parallel.sharded import (
            distribute_for_solve, distribute_multilevel,
        )
        if hasattr(Mop, "levels"):      # AMG hierarchy: shard fine levels
            Mop = distribute_multilevel(Mop, mesh)
        if x0 is None:
            x0 = jnp.zeros_like(b)
        A, b, x0 = distribute_for_solve(A, mesh, b, x0)
        with mesh:
            x, state = _cg_loop(A, Mop, b, jnp.asarray(x0),
                                *monitor.spec())
    else:
        x0 = None if x0 is None else jnp.asarray(x0)
        x, state = _cg_loop(A, Mop, b, x0, *monitor.spec())
    monitor.absorb_state(state)
    return x, monitor
