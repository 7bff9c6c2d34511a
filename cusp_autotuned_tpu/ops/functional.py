"""Named math functors (parity: cusp/functional.h + detail/functional.inl —
divide_value, modulus_value, sum_pair_functor, constant_functor,
valid_index_functor).

Stance: functors are plain Python callables closing over jnp
ops; jit inlines them, so these exist for API parity and for passing into
the semiring verbs (generalized_spmv / generalized_spgemm)."""

from __future__ import annotations

import jax.numpy as jnp


def divide_value(v):
    """x -> x / v (cusp::divide_value)."""
    def f(x):
        return jnp.asarray(x) / v
    return f


def modulus_value(v):
    """x -> x % v (cusp::modulus_value)."""
    def f(x):
        return jnp.asarray(x) % v
    return f


def sum_pair(a, b):
    """(a, b) -> a + b over pair-like tuples (cusp::sum_pair_functor)."""
    return tuple(jnp.asarray(x) + jnp.asarray(y) for x, y in zip(a, b))


def constant_functor(value):
    """x -> value (cusp::constant_functor)."""
    def f(x):
        return jnp.full_like(jnp.asarray(x), value)
    return f


def valid_index(n):
    """x -> 0 <= x < n (cusp::valid_index_functor — the ELL padding test)."""
    def f(x):
        x = jnp.asarray(x)
        return (x >= 0) & (x < n)
    return f
