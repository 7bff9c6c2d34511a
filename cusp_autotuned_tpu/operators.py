"""Linear operators (parity: cusp/linear_operator.h — linear_operator base,
identity_operator, and operator adapters usable as preconditioners M).

Everything here is a pytree, so operators pass straight through jitted solver
loops as arguments; bare Python callables are wrapped with the callable held
as static metadata.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import jax.numpy as jnp

from cusp_autotuned_tpu.formats.base import MatrixBase, register_matrix, static_field


@register_matrix
@dataclasses.dataclass(frozen=True)
class IdentityOperator:
    shape: Tuple[int, int] = static_field(default=(0, 0))

    format = "identity_operator"

    def __call__(self, x):
        return x


@register_matrix
@dataclasses.dataclass(frozen=True)
class FunctionOperator:
    """Wraps y = fn(x) as an operator; fn is static (hashable) metadata."""
    fn: Callable = static_field()
    shape: Tuple[int, int] = static_field(default=(0, 0))

    format = "function_operator"

    def __call__(self, x):
        return self.fn(x)


@register_matrix
@dataclasses.dataclass(frozen=True)
class PlannedOperator:
    """A built kernel whose planned device arrays are pytree LEAVES.

    Solvers take the operator as a jit ARGUMENT, so the planned arrays ride
    the executable as parameters — not as constants embedded in the
    compiled program, which would copy the whole matrix into every
    executable that closes over it.  `build` is static apply logic:
    (arrays, x) -> y."""
    arrays: dict
    build: Callable = static_field()
    shape: Tuple[int, int] = static_field(default=(0, 0))
    impl: str = static_field(default="")   # kernel rail label (introspection)

    format = "planned_operator"

    def __call__(self, x):
        return self.build(self.arrays, x)


def planned_operator(A, config=None):
    """Build the configured SpMV kernel for A as a PlannedOperator (every
    variant exposes its planned arrays, kernels.variants).  config
    defaults to the format's default; pass a tuned configuration
    (autotune.best_configuration) for the fast kernels."""
    from cusp_autotuned_tpu.kernels.variants import build_spmv, default_config
    cfg = dict(config) if config is not None else default_config(A)
    fn = build_spmv(A, cfg)
    impl = (getattr(fn, "plan_stats", None) or {}).get(
        "impl", str(cfg.get("impl", "")))
    return PlannedOperator(arrays=fn.planned_arrays, build=fn.apply,
                           shape=tuple(A.shape), impl=impl)


def jit_operator(op):
    """jit an operator for standalone calls.  A PlannedOperator must NOT be
    passed to jax.jit directly: jit would treat it as a plain callable and
    close over the planned arrays as embedded constants (solvers avoid
    this by taking the operator as a pytree argument).  This helper jits
    the static `build` with the arrays as a traced argument instead."""
    import jax

    if isinstance(op, PlannedOperator):
        jb = jax.jit(op.build)
        arrays = op.arrays
        return lambda x: jb(arrays, x)
    if isinstance(op, (FactoredProlongator, FactoredRestriction,
                       StructuredTentative, StructuredTentativeT)):
        # the factored operators hold planned sub-operators as pytree
        # leaves; jit the APPLY with the operator as a traced argument so
        # those arrays ride as parameters, not embedded constants
        jf = jax.jit(lambda o, x: o(x))
        return lambda x: jf(op, x)
    if isinstance(op, FunctionOperator):
        return jax.jit(op.fn)
    return jax.jit(op)


@register_matrix
@dataclasses.dataclass(frozen=True)
class FactoredProlongator:
    """Smoothed-aggregation prolongator applied FACTORED:

        P e = T e - s * Dinv * (A (T e))

    (parity: P = (I - (omega/rho) D^-1 A) T,
    cusp/precond/aggregation/system/detail/generic/smooth_prolongator.h:52-151
    — the reference materializes P with an SpGEMM and applies it as a
    generic sparse matrix; the materialized P is a scattered 2.5-nnz/row
    pattern, while the factored form rides the level's structured A rail
    (via_dia at fine stencil levels) plus a 1-nnz/row tentative apply).
    Top/Aop are planned operator pytrees; dinv/scale ride as leaves."""
    Top: Any      # tentative prolongator apply (planned)
    Aop: Any      # level operator apply (planned)
    dinv: Any     # 1/diag(A)
    scale: Any    # omega / rho(D^-1 A), 0-d array
    shape: Tuple[int, int] = static_field(default=(0, 0))
    impl: str = static_field(default="factored")

    format = "factored_prolongator"

    def __call__(self, e):
        te = self.Top(e)
        d = self.dinv if te.ndim == 1 else self.dinv[:, None]
        return te - self.scale * (d * self.Aop(te))


@register_matrix
@dataclasses.dataclass(frozen=True)
class FactoredRestriction:
    """R = P^T applied factored (requires symmetric A):

        R r = T^T (r - s * A (Dinv * r))

    See FactoredProlongator; Ttop applies the transposed tentative
    operator (an aggregate segment-sum pattern, one column per fine row)."""
    Ttop: Any
    Aop: Any
    dinv: Any
    scale: Any
    shape: Tuple[int, int] = static_field(default=(0, 0))
    impl: str = static_field(default="factored")

    format = "factored_restriction"

    def __call__(self, r):
        d = self.dinv if r.ndim == 1 else self.dinv[:, None]
        return self.Ttop(r - self.scale * self.Aop(d * r))


@register_matrix
@dataclasses.dataclass(frozen=True)
class StructuredTentative:
    """Tentative prolongator over a grid-blocked aggregation, applied as

        T e = w * upsample(e)

    where upsample is the Kronecker expansion  U = Ey @ u @ Ex^T  with
    tiny 0/1 replication matrices Ey (ny x nby), Ex (nx x nbx) — two
    small matmuls instead of a gather.  Requires
    aggregates from structured_aggregate: fine row r = y*nx + x belongs
    to coarse id (y//py)*nbx + (x//px).  The reference applies T as a
    generic sparse matrix (cusp/precond/aggregation/detail/tentative.inl);
    this is the structured-interpolation rail of the factored R/P
    applies.  precision='highest' keeps the expansion exact in f32 (the
    E matrices are exact 0/1; a default-precision TF32 or bf16 product
    would round the coarse values)."""
    w: Any        # (ny*nx,) per-fine-row weight (T's single nnz per row)
    Ey: Any       # (ny, nby) 0/1 row-replication matrix
    Ex: Any       # (nx, nbx) 0/1 column-replication matrix
    grid: Tuple[int, int] = static_field(default=(0, 0))      # ny, nx
    block: Tuple[int, int] = static_field(default=(3, 3))     # py, px
    shape: Tuple[int, int] = static_field(default=(0, 0))
    impl: str = static_field(default="structured")

    format = "structured_tentative"

    def __call__(self, e):
        ny, nx = self.grid
        nby, nbx = self.Ey.shape[1], self.Ex.shape[1]
        if e.ndim == 1:
            u = e.reshape(nby, nbx)
            U = jnp.matmul(self.Ey,
                           jnp.matmul(u, self.Ex.T, precision="highest"),
                           precision="highest")
            return self.w * U.reshape(ny * nx)
        k = e.shape[1]
        u = e.reshape(nby, nbx, k)
        tmp = jnp.tensordot(self.Ex, u, axes=[[1], [1]],
                            precision="highest")          # (nx, nby, k)
        U = jnp.tensordot(self.Ey, tmp, axes=[[1], [1]],
                          precision="highest")            # (ny, nx, k)
        return self.w[:, None] * U.reshape(ny * nx, k)


@register_matrix
@dataclasses.dataclass(frozen=True)
class StructuredTentativeT:
    """Transpose of StructuredTentative:

        T^T z = Ey^T @ ((w * z) as (ny, nx)) @ Ex

    — multiply by the per-row weights, then block-sum each py x px block
    via the same two matmuls (matmul-as-scatter; see
    StructuredTentative)."""
    w: Any
    Ey: Any
    Ex: Any
    grid: Tuple[int, int] = static_field(default=(0, 0))
    block: Tuple[int, int] = static_field(default=(3, 3))
    shape: Tuple[int, int] = static_field(default=(0, 0))
    impl: str = static_field(default="structured")

    format = "structured_tentative_t"

    def __call__(self, z):
        ny, nx = self.grid
        nby, nbx = self.Ey.shape[1], self.Ex.shape[1]
        if z.ndim == 1:
            Z = (self.w * z).reshape(ny, nx)
            return jnp.matmul(self.Ey.T,
                              jnp.matmul(Z, self.Ex, precision="highest"),
                              precision="highest").reshape(nby * nbx)
        k = z.shape[1]
        Z = (self.w[:, None] * z).reshape(ny, nx, k)
        tmp = jnp.tensordot(self.Ex, Z, axes=[[0], [1]],
                            precision="highest")          # (nbx, ny, k)
        u = jnp.tensordot(self.Ey, tmp, axes=[[0], [1]],
                          precision="highest")            # (nby, nbx, k)
        return u.reshape(nby * nbx, k)


_OPERATOR_TYPES = (IdentityOperator, FunctionOperator, PlannedOperator,
                   FactoredProlongator, FactoredRestriction,
                   StructuredTentative, StructuredTentativeT)


def register_operator_type(cls):
    """Add an operator class to the apply-dispatch set (ops.multiply treats
    members as callables, not containers).  Used by modules that define
    operators outside this file (e.g. parallel.sharded_plans)."""
    global _OPERATOR_TYPES
    if cls not in _OPERATOR_TYPES:
        _OPERATOR_TYPES = _OPERATOR_TYPES + (cls,)
    return cls


def identity_operator(n: int = 0, dtype=None) -> IdentityOperator:
    return IdentityOperator(shape=(n, n))


def make_linear_operator(fn: Callable, shape=(0, 0)) -> FunctionOperator:
    return FunctionOperator(fn=fn, shape=tuple(shape))


def as_operator(M):
    """Normalize None / container / callable to a pytree operator."""
    import jax

    if M is None:
        return IdentityOperator()
    if isinstance(M, (IdentityOperator, FunctionOperator, MatrixBase)):
        return M
    if callable(M):
        leaves = jax.tree_util.tree_leaves(M)
        if len(leaves) == 1 and leaves[0] is M:
            # unregistered bare callable — hold it as static metadata
            return FunctionOperator(fn=M)
        # registered pytree with __call__ (e.g. an AMG hierarchy)
        return M
    raise TypeError(f"cannot use {type(M)} as a linear operator")
