"""Generic multilevel (V-cycle) hierarchy.

Parity: cusp/detail/multilevel.{h,inl} — per-level {R, A, P, smoother}
(multilevel.h:112-129), min_level_size=500 / max_levels=10 defaults (:142),
coarsest solve via dense LU (cusp/detail/lu.h default), operator() = one
V-cycle so the hierarchy is directly usable as a Krylov preconditioner
(multilevel.inl:139-140), standalone solve() loop (:156-165), recursive
pre-smooth → restrict → recurse → correct → post-smooth (:180-225), and the
print() hierarchy/complexity report (:227+).

The level list is static, so the recursive V-cycle unrolls into one jitted
XLA program; the whole preconditioner is a pytree.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Any, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from cusp_autotuned_tpu.formats.base import MatrixBase, register_matrix, static_field
from cusp_autotuned_tpu.ops.multiply import multiply
from cusp_autotuned_tpu.solvers.monitor import Monitor, default_monitor

MIN_LEVEL_SIZE = 500
MAX_LEVELS = 10


@register_matrix
@dataclasses.dataclass(frozen=True)
class Level:
    R: Any            # restriction operator (container)
    A: Any            # level operator (container: setup/reporting)
    P: Any            # prolongation operator
    smoother: Any     # presmooth/postsmooth adapter
    Aop: Any = None   # optional tuned apply operator (PlannedOperator);
                      # the V-cycle and smoothers multiply through it
    Rop: Any = None   # optional tuned restriction apply
    Pop: Any = None   # optional tuned prolongation apply

    @property
    def apply_op(self):
        return self.Aop if self.Aop is not None else self.A

    @property
    def restrict_op(self):
        return self.Rop if self.Rop is not None else self.R

    @property
    def prolong_op(self):
        return self.Pop if self.Pop is not None else self.P


@register_matrix
@dataclasses.dataclass(frozen=True)
class CoarseLU:
    """Coarse-grid direct solve.

    Parity: the reference's default coarse solver is a dense LU with
    back-substitution (cusp/detail/lu.h:81-152).  A triangular solve is a
    length-n sequential substitution — pure latency inside the V-cycle —
    so the factorization is inverted ONCE at setup (in f64, off the hot
    path) and the per-cycle coarse solve is a single dense matvec at full
    precision (never TF32).  The f64-inverse-then-cast application error
    is O(cond·eps_f32), the same order as an f32 back-substitution."""
    inv: jnp.ndarray

    @property
    def n(self) -> int:
        return self.inv.shape[0]

    def __call__(self, b):
        return jnp.matmul(self.inv, b, precision=jax.lax.Precision.HIGHEST)


@register_matrix
@dataclasses.dataclass(frozen=True)
class Multilevel(MatrixBase):
    levels: Tuple[Level, ...]
    coarse: CoarseLU
    shape: Tuple[int, int] = static_field(default=(0, 0))

    format = "multilevel"

    # -- V-cycle ----------------------------------------------------------

    def _cycle(self, i: int, b):
        if i == len(self.levels):
            return self.coarse(b)
        lvl = self.levels[i]
        op = lvl.apply_op
        x = lvl.smoother.presmooth(op, b)
        r = b - multiply(op, x, use_autotuning=False)
        rc = multiply(lvl.restrict_op, r, use_autotuning=False)
        ec = self._cycle(i + 1, rc)
        x = x + multiply(lvl.prolong_op, ec, use_autotuning=False)
        return lvl.smoother.postsmooth(op, b, x)

    def __call__(self, b):
        """One V-cycle from a zero initial guess — usable as M in any
        Krylov solver."""
        return self._cycle(0, jnp.asarray(b))

    # -- standalone solve ----------------------------------------------------

    def solve(self, b, x0=None, monitor: Monitor | None = None):
        b = jnp.asarray(b)
        x = jnp.asarray(x0) if x0 is not None else jnp.zeros_like(b)
        if monitor is None:
            monitor = default_monitor(b)
        r = b - multiply(self.levels[0].apply_op, x)
        while not monitor.finished(np.asarray(r)):
            x, r = _vcycle_step(self, x, b, r)
        return x, monitor

    # -- reporting --------------------------------------------------------------


    def operator_complexity(self) -> float:
        nnz = [lvl.A.num_entries for lvl in self.levels]
        nnz.append(self.coarse.n ** 2)
        return float(sum(nnz)) / max(1, self.levels[0].A.num_entries)

    def grid_complexity(self) -> float:
        rows = [lvl.A.num_rows for lvl in self.levels]
        rows.append(self.coarse.n)
        return float(sum(rows)) / max(1, self.levels[0].A.num_rows)

    def print(self, stream=None) -> None:
        stream = stream or sys.stdout
        stream.write(f"multilevel hierarchy: {len(self.levels) + 1} levels\n")
        stream.write(f"  operator complexity: {self.operator_complexity():.3f}\n")
        stream.write(f"  grid complexity:     {self.grid_complexity():.3f}\n")
        stream.write("  level       rows        entries\n")
        for i, lvl in enumerate(self.levels):
            stream.write(f"  {i:>5} {lvl.A.num_rows:>10} {lvl.A.num_entries:>14}\n")
        n = self.coarse.n
        stream.write(f"  {len(self.levels):>5} {n:>10} {n * n:>14} (dense LU)\n")


@jax.jit
def _vcycle_step(M: Multilevel, x, b, r):
    """x <- x + V(r); returns (x, new residual) — the caller feeds the
    residual back in, so each iteration costs exactly one top-level SpMV."""
    A = M.levels[0].apply_op
    x = x + M(r)
    return x, b - multiply(A, x, use_autotuning=False)
