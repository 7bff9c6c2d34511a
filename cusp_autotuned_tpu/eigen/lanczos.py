"""Lanczos eigensolver (parity: cusp/eigen/lanczos.h + lanczos_options.h —
options carry the iteration count, which end of the spectrum, tolerance,
reorthogonalization strategy)."""

from __future__ import annotations

import dataclasses

import numpy as np
import jax.numpy as jnp

from cusp_autotuned_tpu.eigen.spectral_radius import _lanczos_tridiag


@dataclasses.dataclass
class LanczosOptions:
    iteration_limit: int = 100
    tolerance: float = 1e-6
    which: str = "LA"          # LA = largest algebraic, SA = smallest
    num_eigvals: int = 1
    reorthogonalize: bool = True
    seed: int = 0


def lanczos(A, options: LanczosOptions | None = None, *, return_eigvecs=False,
            mesh=None):
    """Returns eigenvalues (and optionally eigenvectors) of symmetric A via
    Lanczos tridiagonalization + host tridiagonal eig (lapack stev path).

    mesh: distribute over a jax.sharding.Mesh — A row-sharded, the Lanczos
    vectors replicated; the per-step matvec runs shard-local and every dot
    product becomes an all-reduce inserted by GSPMD (an extension beyond
    the single-GPU reference, SURVEY §2.6)."""
    options = options or LanczosOptions()
    k = min(options.iteration_limit, A.num_rows)
    if mesh is not None:
        from cusp_autotuned_tpu.parallel.sharded import distribute_for_solve
        A = distribute_for_solve(A, mesh)[0]
    alphas, betas, V = _lanczos_tridiag(A, k, options.seed)
    m = len(alphas)
    import scipy.linalg as sla
    w, S = sla.eigh_tridiagonal(alphas, betas[: m - 1])
    if options.which.upper() in ("LA", "LM"):
        order = np.argsort(w)[::-1]
    else:
        order = np.argsort(w)
    idx = order[: options.num_eigvals]
    eigvals = jnp.asarray(w[idx].copy())
    if not return_eigvecs:
        return eigvals
    eigvecs = jnp.asarray((V[:m].T @ S[:, idx]))
    return eigvals, eigvecs
