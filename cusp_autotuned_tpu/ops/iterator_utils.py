"""Array-building utilities replacing the reference's fancy iterators.

Parity target: cusp/iterator/ — join_iterator (join_iterator.h:141),
strided_iterator (strided_iterator.h:78), random_iterator
(random_iterator.h:81), plus counting/constant arrays (cusp/array1d.h).

In JAX there is no lazy iterator machinery: XLA fuses the materializing
expressions below into their consumers, which is what the Thrust iterators
achieved at compile time.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def counting_array(n: int, start: int = 0, dtype=jnp.int32):
    """cusp::counting_array — [start, start+1, ...)."""
    return jnp.arange(start, start + n, dtype=dtype)


def constant_array(n: int, value, dtype=None):
    """cusp::constant_array — n copies of value."""
    return jnp.full(n, value, dtype=dtype)


def join(*arrays):
    """join_iterator — view several arrays as one concatenated sequence."""
    return jnp.concatenate([jnp.asarray(a) for a in arrays])


def strided(array, stride: int, start: int = 0):
    """strided_iterator — every `stride`-th element."""
    return jnp.asarray(array)[start::stride]


def strided_range(n: int, stride: int, dtype=jnp.int32):
    """The reference's common strided-counting idiom: 0, s, 2s, ..."""
    return jnp.arange(0, n, stride, dtype=dtype)


def random_array(n: int, seed: int = 0, dtype=jnp.float32):
    """random_iterator — a deterministic pseudorandom sequence; same seed,
    same sequence (uniform in [0, 1) for floats, full range for ints)."""
    key = jax.random.PRNGKey(seed)
    if jnp.issubdtype(dtype, jnp.integer):
        info = jnp.iinfo(dtype)
        return jax.random.randint(key, (n,), info.min, info.max, dtype=dtype)
    return jax.random.uniform(key, (n,), dtype=dtype)
