"""Segmented reductions — the replacement for the reference's
atomics/warp-scan segmented kernels (cusp/system/cuda/detail/multiply/
coo_flat_spmv.h): deterministic, sort-order-based reductions that XLA can
fuse, with an associative-scan path for arbitrary semiring reduce operators
(used by generalized_spmv, cusp/multiply.h:106-120)."""

from __future__ import annotations

import jax
import jax.numpy as jnp


def segment_sum(vals, rows, num_segments, indices_are_sorted=True):
    return jax.ops.segment_sum(vals, rows, num_segments=num_segments,
                               indices_are_sorted=indices_are_sorted)


def segment_reduce(vals, rows, num_segments, reduce_fn):
    """Generic segmented reduction over entries sorted by `rows`.

    vals: (E, ...) values; rows: (E,) sorted int32; entries with
    rows >= num_segments are padding and are dropped.

    Returns (contrib, mask): contrib[r] holds the reduce_fn-reduction of
    segment r where mask[r] is True; rows with no entries have mask False
    and unspecified contrib.

    Implementation: inclusive segmented associative scan — flags mark segment
    starts, so the last element of each segment carries the full reduction —
    then a scatter of the segment-end elements.
    """
    prev = jnp.concatenate([jnp.full((1,), -1, rows.dtype), rows[:-1]])
    starts = rows != prev

    def comb(a, b):
        fa, va = a
        fb, vb = b
        v = jnp.where(_bcast(fb, vb), vb, reduce_fn(va, vb))
        return jnp.logical_or(fa, fb), v

    _, scanned = jax.lax.associative_scan(comb, (starts, vals))

    nxt = jnp.concatenate([rows[1:], jnp.full((1,), -2, rows.dtype)])
    ends = rows != nxt
    target = jnp.where(ends, rows, num_segments)

    out_shape = (num_segments,) + vals.shape[1:]
    contrib = jnp.zeros(out_shape, vals.dtype).at[target].set(scanned, mode="drop")
    mask = jnp.zeros(num_segments, bool).at[target].set(True, mode="drop")
    return contrib, mask


def _bcast(flag, like):
    """Broadcast a (E,) bool against (E, ...) values."""
    extra = like.ndim - flag.ndim
    return flag.reshape(flag.shape + (1,) * extra)
