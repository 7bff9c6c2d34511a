"""Convergence monitor.

Parity target: cusp::monitor (cusp/monitor.h:100-176 + detail/monitor.inl) —
finished(r) computes ||r||_2 and appends to the residual history; converged()
tests ||r|| <= absolute_tolerance + relative_tolerance * ||b||; rate
statistics immediate/geometric/average_rate (monitor.inl:223-251); verbose
iteration printing.

Split: MonitorState is a pytree carried through lax.while_loop
solver bodies (residual history preallocated to iteration_limit+1), and
Monitor is the host-facing object with the reference's full API, usable both
eagerly (user-written loops) and as the configuration/result wrapper around
jitted solves.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Tuple

import jax.numpy as jnp
import numpy as np

from cusp_autotuned_tpu.formats.base import register_matrix, static_field
from cusp_autotuned_tpu.ops import blas


@register_matrix
@dataclasses.dataclass(frozen=True)
class MonitorState:
    k: jnp.ndarray                     # iterations recorded so far (int32)
    r_norm: jnp.ndarray                # last residual norm
    b_norm: jnp.ndarray                # ||b||
    residuals: jnp.ndarray             # (limit + 1,) history, NaN-filled
    relative_tolerance: float = static_field(default=1e-5)
    absolute_tolerance: float = static_field(default=0.0)
    iteration_limit: int = static_field(default=500)

    @property
    def tolerance(self):
        return self.absolute_tolerance + self.relative_tolerance * self.b_norm

    def converged(self):
        return self.r_norm <= self.tolerance

    def keep_going(self):
        return jnp.logical_and(jnp.logical_not(self.converged()),
                               self.k < self.iteration_limit)


def monitor_init(b, iteration_limit=500, relative_tolerance=1e-5,
                 absolute_tolerance=0.0) -> MonitorState:
    b = jnp.asarray(b)
    b_norm = blas.nrm2(b)
    residuals = jnp.full(iteration_limit + 1, jnp.nan, dtype=b_norm.dtype)
    return MonitorState(
        k=jnp.asarray(-1, jnp.int32),
        r_norm=jnp.asarray(jnp.inf, b_norm.dtype),
        b_norm=b_norm,
        residuals=residuals,
        relative_tolerance=float(relative_tolerance),
        absolute_tolerance=float(absolute_tolerance),
        iteration_limit=int(iteration_limit),
    )


def monitor_record(state: MonitorState, r_norm) -> MonitorState:
    """Append one residual norm (the state-passing analogue of finished())."""
    k = state.k + 1
    return dataclasses.replace(
        state,
        k=k,
        r_norm=r_norm,
        residuals=state.residuals.at[k].set(r_norm.astype(state.residuals.dtype)))


class Monitor:
    """Host-facing monitor with the reference's API (cusp/monitor.h)."""

    def __init__(self, b, iteration_limit: int = 500,
                 relative_tolerance: float = 1e-5,
                 absolute_tolerance: float = 0.0,
                 verbose: bool = False):
        self._iteration_limit = int(iteration_limit)
        self._relative_tolerance = float(relative_tolerance)
        self._absolute_tolerance = float(absolute_tolerance)
        self.verbose = bool(verbose)
        self.reset(b)

    # -- configuration ------------------------------------------------------

    def iteration_limit(self) -> int:
        return self._iteration_limit

    def relative_tolerance(self) -> float:
        return self._relative_tolerance

    def absolute_tolerance(self) -> float:
        return self._absolute_tolerance

    def tolerance(self) -> float:
        return self._absolute_tolerance + self._relative_tolerance * self.b_norm

    @property
    def b_norm(self) -> float:
        if self._b_norm is None:
            self._b_norm = float(np.linalg.norm(np.asarray(self._b_ref)))
        return self._b_norm

    def spec(self) -> Tuple[int, float, float]:
        """(iteration_limit, rtol, atol) — static arguments for the jitted
        solver loops, which build the MonitorState ON DEVICE (monitor_init
        traced inside the jit) instead of paying eager dispatches and a
        ||b|| round trip on every solve call."""
        return (self._iteration_limit, self._relative_tolerance,
                self._absolute_tolerance)

    # -- driving (eager use) --------------------------------------------------

    def reset(self, b) -> None:
        # b_norm is computed LAZILY: pulling ||b|| eagerly costs a
        # device->host round trip per solve call (the jitted solvers
        # compute it on device and absorb_state hands it back)
        self._b_ref = b
        self._b_norm: float | None = None
        self.residuals: list = []
        if self.verbose:
            print(f"Solver will continue until residual norm {self.tolerance():.6g}"
                  f" or reaching {self._iteration_limit} iterations")
            print("  Iteration Number  | Residual Norm")

    def finished(self, r) -> bool:
        """Record ||r|| and report whether iteration should stop."""
        r_norm = float(np.linalg.norm(np.asarray(r)))
        self.residuals.append(r_norm)
        if self.verbose:
            print(f"  {self.iteration_count():10d}        {r_norm:14.6e}")
            if self.converged():
                print(f"Successfully converged after {self.iteration_count()}"
                      " iterations.")
            elif self.iteration_count() >= self._iteration_limit:
                print(f"Failed to converge after {self.iteration_count()}"
                      " iterations.")
        return self.converged() or self.iteration_count() >= self._iteration_limit

    def __iadd__(self, n: int):
        # parity with `++monitor`; history length already tracks iterations
        return self

    # -- results ----------------------------------------------------------------

    def iteration_count(self) -> int:
        return max(0, len(self.residuals) - 1)

    def residual_norm(self) -> float:
        return self.residuals[-1] if self.residuals else float("inf")

    def converged(self) -> bool:
        return self.residuals != [] and self.residual_norm() <= self.tolerance()

    def immediate_rate(self) -> float:
        r = self.residuals
        return r[-1] / r[-2] if len(r) >= 2 else float("nan")

    def geometric_rate(self) -> float:
        r = self.residuals
        if len(r) < 2 or r[0] == 0:
            return float("nan")
        return (r[-1] / r[0]) ** (1.0 / (len(r) - 1))

    def average_rate(self) -> float:
        r = self.residuals
        if len(r) < 2:
            return float("nan")
        rates = [b / a for a, b in zip(r[:-1], r[1:]) if a != 0]
        return float(np.mean(rates)) if rates else float("nan")

    def print(self, stream=None) -> None:
        stream = stream or sys.stdout
        stream.write(f"monitor: {self.iteration_count()} iterations, "
                     f"residual {self.residual_norm():.6e} "
                     f"(tolerance {self.tolerance():.6e}), "
                     f"{'converged' if self.converged() else 'not converged'}\n")
        if self.iteration_count() >= 1:
            stream.write(f"  immediate rate: {self.immediate_rate():.6f}\n")
            stream.write(f"  geometric rate: {self.geometric_rate():.6f}\n")
            stream.write(f"  average rate:   {self.average_rate():.6f}\n")

    # -- glue to the jitted solvers ------------------------------------------

    def to_state(self, b) -> MonitorState:
        return monitor_init(b, self._iteration_limit,
                            self._relative_tolerance, self._absolute_tolerance)

    def absorb_state(self, state: MonitorState) -> "Monitor":
        """Fill this monitor's history from a solver's final MonitorState."""
        import jax
        # one batched fetch instead of three sequential round trips
        k, b_norm, hist = jax.device_get(
            (state.k, state.b_norm, state.residuals))
        self._b_norm = float(b_norm)
        hist = hist[: int(k) + 1]
        self.residuals = [float(v) for v in hist]
        if self.verbose:
            for i, v in enumerate(self.residuals):
                print(f"  {i:10d}        {v:14.6e}")
            if self.converged():
                print(f"Successfully converged after {self.iteration_count()}"
                      " iterations.")
            else:
                print(f"Failed to converge after {self.iteration_count()}"
                      " iterations.")
        return self


def default_monitor(b) -> Monitor:
    """The reference's default monitor (cusp/krylov/detail/cg.inl:151-166):
    500 iterations, relative tolerance 1e-5."""
    return Monitor(b, iteration_limit=500, relative_tolerance=1e-5)
