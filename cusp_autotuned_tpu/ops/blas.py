"""Dense BLAS verbs.

Parity target: cusp/blas/blas.h + cusp/detail/blas.inl:34-935 — the full
family amax asum axpy axpby axpbypcz xmy copy dot dotc nrm1 nrm2 nrmmax scal
gemv ger symv syr trmv trsv gemm symm syrk trmm trsm.

Stance: one implementation on jnp/XLA (replacing the reference's
generic/cblas/cublas triple dispatch — XLA *is* the vendor BLAS here), and
functional semantics: routines return results instead of mutating outputs,
so they compose with jit/grad and fuse into surrounding solver loops.
"""

from __future__ import annotations

import jax.numpy as jnp


def amax(x):
    """Index of the entry with largest absolute value."""
    return jnp.argmax(jnp.abs(jnp.asarray(x)))


def asum(x):
    return jnp.sum(jnp.abs(jnp.asarray(x)))


def axpy(x, y, alpha=1.0):
    """alpha*x + y."""
    return alpha * jnp.asarray(x) + jnp.asarray(y)


def axpby(x, y, alpha, beta):
    return alpha * jnp.asarray(x) + beta * jnp.asarray(y)


def axpbypcz(x, y, z, alpha, beta, gamma):
    return alpha * jnp.asarray(x) + beta * jnp.asarray(y) + gamma * jnp.asarray(z)


def xmy(x, y):
    """Elementwise x * y."""
    return jnp.asarray(x) * jnp.asarray(y)


def copy(x):
    return jnp.asarray(x)


def fill(n_or_like, value):
    """blas::fill — a constant vector (functional: returns a new array)."""
    if hasattr(n_or_like, "shape"):
        return jnp.full_like(jnp.asarray(n_or_like), value)
    return jnp.full(int(n_or_like), value)


def dot(x, y):
    return jnp.sum(jnp.asarray(x) * jnp.asarray(y))


def dotc(x, y):
    """Conjugated dot product <x, y> = sum(conj(x) * y)."""
    return jnp.sum(jnp.conj(jnp.asarray(x)) * jnp.asarray(y))


def nrm1(x):
    return jnp.sum(jnp.abs(jnp.asarray(x)))


def nrm2(x):
    x = jnp.asarray(x)
    return jnp.sqrt(jnp.real(jnp.sum(jnp.conj(x) * x)))


def nrmmax(x):
    return jnp.max(jnp.abs(jnp.asarray(x)))


def scal(x, alpha):
    return alpha * jnp.asarray(x)


# -- level 2 ------------------------------------------------------------------

def gemv(A, x, alpha=1.0, beta=0.0, y=None):
    r = alpha * jnp.dot(jnp.asarray(A), jnp.asarray(x),
                        preferred_element_type=jnp.asarray(A).dtype)
    return r if y is None or beta == 0.0 else r + beta * jnp.asarray(y)


def ger(x, y, A=None, alpha=1.0):
    """Rank-1 update alpha * x y^T (+ A)."""
    r = alpha * jnp.outer(jnp.asarray(x), jnp.asarray(y))
    return r if A is None else r + jnp.asarray(A)


def symv(A, x, alpha=1.0, beta=0.0, y=None):
    return gemv(A, x, alpha, beta, y)


def syr(x, A=None, alpha=1.0):
    return ger(x, x, A, alpha)


def trmv(A, x):
    return jnp.dot(jnp.asarray(A), jnp.asarray(x))


def trsv(A, b, lower=False, unit_diagonal=False):
    import jax.scipy.linalg as jsl
    return jsl.solve_triangular(jnp.asarray(A), jnp.asarray(b),
                                lower=lower, unit_diagonal=unit_diagonal)


# -- level 3 ------------------------------------------------------------------

def gemm(A, B, alpha=1.0, beta=0.0, C=None):
    r = alpha * jnp.dot(jnp.asarray(A), jnp.asarray(B),
                        preferred_element_type=jnp.asarray(A).dtype)
    return r if C is None or beta == 0.0 else r + beta * jnp.asarray(C)


def symm(A, B, alpha=1.0, beta=0.0, C=None):
    return gemm(A, B, alpha, beta, C)


def syrk(A, alpha=1.0, beta=0.0, C=None):
    A = jnp.asarray(A)
    r = alpha * jnp.dot(A, A.T, preferred_element_type=A.dtype)
    return r if C is None or beta == 0.0 else r + beta * jnp.asarray(C)


def trmm(A, B, alpha=1.0):
    return alpha * jnp.dot(jnp.asarray(A), jnp.asarray(B))


def trsm(A, B, lower=False, unit_diagonal=False):
    import jax.scipy.linalg as jsl
    return jsl.solve_triangular(jnp.asarray(A), jnp.asarray(B),
                                lower=lower, unit_diagonal=unit_diagonal)
