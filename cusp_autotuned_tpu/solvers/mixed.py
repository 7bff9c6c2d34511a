"""Mixed-precision iterative refinement (defect correction).

An extension with no reference analogue (the idiom is LAPACK's
dsgesv-style mixed-precision refinement, applied to Krylov solves): the
inner solver runs on a `value_dtype='bfloat16'` planned operator — the
matrix entry stream, which dominates device-memory traffic on the
bandwidth-bound SpMV path, is stored at half width — while a
full-precision outer loop restores f32-level accuracy through classic
defect correction:

    r_k = b - A_hi x_k            (full-precision residual)
    d_k = solve_lo(A_lo, r_k)     (bf16-operator inner Krylov solve,
                                   loose tolerance)
    x_{k+1} = x_k + d_k

Each outer sweep contracts the error by roughly the inner solve's
relative tolerance until the bf16 operator's own backward error
(~2^-8 * sqrt(row_nnz)) floors further progress; inner_rtol defaults
well above that floor.  The outer loop is host-driven — it runs a
handful of times and each inner solve is already a single jitted
while_loop dispatch.
"""

from __future__ import annotations

import jax.numpy as jnp

from cusp_autotuned_tpu.operators import as_operator, planned_operator
from cusp_autotuned_tpu.ops.multiply import multiply
from cusp_autotuned_tpu.solvers.cg import cg
from cusp_autotuned_tpu.solvers.monitor import Monitor, default_monitor


def refine(A, b, x0=None, monitor: Monitor | None = None, M=None,
           inner=cg, config=None, inner_rtol=1e-3, inner_limit=200,
           value_dtype="bfloat16"):
    """Solve A x = b by defect correction with a reduced-precision inner
    operator.  Returns (x, monitor) like every Krylov frontend.

    A         any container/operator accepted by `multiply` (full precision;
              used for the outer residuals).
    monitor   OUTER monitor: each finished() records one full-precision
              residual norm, so iteration_limit bounds outer sweeps and the
              tolerances have their usual meaning.
    inner     the inner Krylov frontend (cg by default; bicgstab/cr/gmres
              work for the nonsymmetric cases).
    config    kernel configuration for the inner planned operator (a tuned
              configuration from autotune.best_configuration, for example);
              `value_dtype` is added to it.
    inner_rtol/inner_limit
              the inner solve's relative tolerance and iteration cap.  The
              error contracts by ~inner_rtol per outer sweep, so rtol 1e-3
              reaches 1e-6 in two sweeps; keep it well above the bf16
              operator's backward-error floor (~4e-3 * sqrt(row_nnz) is a
              safe characterization — defect correction tolerates an
              inexact inner operator, it only shifts the contraction rate).
    """
    b = jnp.asarray(b)
    if monitor is None:
        monitor = default_monitor(b)
    cfg = dict(config) if config is not None else {}
    if value_dtype:
        cfg["value_dtype"] = value_dtype
    A_lo = planned_operator(A, cfg) if not callable(A) else as_operator(A)
    Mop = as_operator(M)

    x = jnp.zeros_like(b) if x0 is None else jnp.asarray(x0)
    monitor.reset(b)
    while True:
        r = b - multiply(A, x)
        if monitor.finished(r):
            break
        inner_monitor = Monitor(r, iteration_limit=inner_limit,
                                relative_tolerance=inner_rtol)
        d, _ = inner(A_lo, r, monitor=inner_monitor, M=Mop)
        x = x + d
    return x, monitor


def mixed_precision_cg(A, b, **kwargs):
    """CG-flavored alias for refine() (inner=cg)."""
    return refine(A, b, inner=cg, **kwargs)
