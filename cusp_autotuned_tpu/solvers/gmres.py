"""Restarted GMRES with Givens rotations.

Parity target: cusp::krylov::gmres (cusp/krylov/detail/gmres.inl — left
preconditioning, restart-R Arnoldi, plane rotations, host Hessenberg
back-substitution).

Redesign: one restart cycle is a single jitted program.  The
Arnoldi orthogonalization uses re-orthogonalized *classical* Gram-Schmidt
(CGS2): both passes are (R+1, n) matrix-vector products at full precision,
replacing the reference's sequential modified-GS dot/axpy chain — better
hardware fit and better orthogonality.  The Hessenberg, rotations, and
triangular solve stay on-device in small arrays; inner iterations after
convergence are masked out rather than branched.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from cusp_autotuned_tpu.ops import blas
from cusp_autotuned_tpu.ops.multiply import multiply
from cusp_autotuned_tpu.operators import as_operator
from cusp_autotuned_tpu.solvers.monitor import Monitor, default_monitor, monitor_record


def _dot(a, b):
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


@functools.partial(jax.jit, static_argnames=("R",))
def _gmres_cycle(A, M, b, x, state, R):
    n = b.shape[0]
    dtype = b.dtype

    r = M(b - multiply(A, x))
    beta = blas.nrm2(r)
    state = monitor_record(state, beta)

    V = jnp.zeros((R + 1, n), dtype).at[0].set(r / jnp.where(beta > 0, beta, 1))
    H = jnp.zeros((R + 1, R), dtype)
    cs = jnp.zeros(R, dtype)
    sn = jnp.zeros(R, dtype)
    g = jnp.zeros(R + 1, dtype).at[0].set(beta)

    def inner(i, carry):
        V, H, cs, sn, g, m_eff, state, done = carry

        def skip(op):
            return op

        def step(op):
            V, H, cs, sn, g, m_eff, state, done = op
            w = M(multiply(A, V[i]))
            # CGS2: two classical Gram-Schmidt passes, each a matvec at
            # full precision (a TF32 product would lose orthogonality);
            # conjugated projections so complex systems stay orthogonal
            mask = jnp.arange(R + 1) <= i
            h1 = jnp.where(mask, _dot(jnp.conj(V), w), 0)
            w = w - _dot(h1, V)
            h2 = jnp.where(mask, _dot(jnp.conj(V), w), 0)
            w = w - _dot(h2, V)
            hs = h1 + h2
            hnorm = blas.nrm2(w).astype(dtype)
            breakdown = jnp.abs(hnorm) <= 1e-30
            V = V.at[i + 1].set(w / jnp.where(breakdown, 1, hnorm))

            col = jnp.where(jnp.arange(R + 1) == i + 1, hnorm, hs)

            # apply previous rotations j < i (complex-safe Givens, the
            # reference's ApplyPlaneRotation: dy' = -conj(sn) dx + cs dy)
            def rot(j, col):
                a, c2 = col[j], col[j + 1]
                use = j < i
                na = jnp.where(use, cs[j] * a + sn[j] * c2, a)
                nb = jnp.where(use, -jnp.conj(sn[j]) * a + cs[j] * c2, c2)
                return col.at[j].set(na).at[j + 1].set(nb)

            col = jax.lax.fori_loop(0, R, rot, col)

            # generate the new rotation (GeneratePlaneRotation parity:
            # cs = |dx|/nrm, sn = (dx/|dx|) conj(dy)/nrm; dx==0 -> cs=0)
            dx, dy = col[i], col[i + 1]
            adx = jnp.abs(dx)
            denom = jnp.sqrt(adx * adx + jnp.abs(dy) ** 2)
            safe = jnp.where(denom > 0, denom, 1)
            sgn = jnp.where(adx > 0, dx / jnp.where(adx > 0, adx, 1), 1)
            c = jnp.where(denom > 0, adx / safe, 1).astype(dtype)
            s = jnp.where(denom > 0, sgn * jnp.conj(dy) / safe, 0).astype(dtype)
            col = col.at[i].set(c * dx + s * dy).at[i + 1].set(0)
            gi = g[i]
            g = g.at[i].set(c * gi).at[i + 1].set(-jnp.conj(s) * gi)
            H = H.at[:, i].set(col)
            cs = cs.at[i].set(c)
            sn = sn.at[i].set(s)

            resid = jnp.abs(g[i + 1])
            state = monitor_record(state, resid)
            m_eff = jnp.asarray(i + 1, jnp.int32)
            done = jnp.logical_or(jnp.logical_not(state.keep_going()), breakdown)
            return (V, H, cs, sn, g, m_eff, state, done)

        return jax.lax.cond(done, skip, step, carry)

    carry = (V, H, cs, sn, g, jnp.asarray(0, jnp.int32), state,
             jnp.logical_not(state.keep_going()))
    V, H, cs, sn, g, m_eff, state, done = jax.lax.fori_loop(0, R, inner, carry)

    # back-substitution on the R×R system, padded with an identity tail so
    # the unused iterations solve to y = 0
    idx = jnp.arange(R)
    Hsq = H[:R, :R] + jnp.diag(jnp.where(idx < m_eff, 0, 1).astype(dtype))
    rhs = jnp.where(idx < m_eff, g[:R], 0)
    y = jax.scipy.linalg.solve_triangular(Hsq, rhs, lower=False)
    x = x + _dot(y, V[:R])
    return x, state


def gmres(A, b, x0=None, restart: int = 50, monitor: Monitor | None = None,
          M=None, mesh=None):
    """Solve A x = b with restarted GMRES(restart).  Returns (x, monitor).
    mesh: distribute the solve over a jax.sharding.Mesh (row-sharded A,
    GSPMD collectives inside the jitted cycle)."""
    import contextlib
    b = jnp.asarray(b)
    x = jnp.asarray(x0) if x0 is not None else jnp.zeros_like(b)
    if monitor is None:
        monitor = default_monitor(b)
    if mesh is not None:
        from cusp_autotuned_tpu.parallel.sharded import distribute_for_solve
        A, b, x = distribute_for_solve(A, mesh, b, x)
    Mop = as_operator(M)
    state = monitor.to_state(b)
    R = int(min(restart, max(1, monitor.iteration_limit())))
    with (mesh if mesh is not None else contextlib.nullcontext()):
        while True:
            x, state = _gmres_cycle(A, Mop, b, x, state, R=R)
            # one batched fetch per restart cycle (converged()/k read
            # separately would each pay a device round trip)
            k, r_norm, b_norm = jax.device_get(
                (state.k, state.r_norm, state.b_norm))
            tol = (state.absolute_tolerance
                   + state.relative_tolerance * float(b_norm))
            if float(r_norm) <= tol or int(k) >= monitor.iteration_limit():
                break
    monitor.absorb_state(state)
    return x, monitor
