"""Sorting building blocks (parity: cusp/sort.h:38-302 — counting_sort,
counting_sort_by_key, sort_by_row, sort_by_row_and_column).

All traceable via jax.lax.sort's multi-operand lexicographic
sort — the deterministic replacement for the reference's thrust radix sorts.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def counting_sort(keys, kmin=None, kmax=None):
    """Sorted copy of integer keys (bounds accepted for API parity; XLA's
    sort does not need them)."""
    return jnp.sort(jnp.asarray(keys))


def counting_sort_by_key(keys, vals, kmin=None, kmax=None):
    keys = jnp.asarray(keys)
    vals = jnp.asarray(vals)
    return jax.lax.sort((keys, vals), num_keys=1, is_stable=True)


def sort_by_row(row, col, val):
    """Sort COO triplets by row (stable in column order)."""
    return jax.lax.sort((jnp.asarray(row), jnp.asarray(col), jnp.asarray(val)),
                        num_keys=1, is_stable=True)


def sort_by_row_and_column(row, col, val):
    return jax.lax.sort((jnp.asarray(row), jnp.asarray(col), jnp.asarray(val)),
                        num_keys=2, is_stable=True)
