"""BFS and connected components as semiring SpMV sweeps.

Parity: cusp::graph::breadth_first_search (cusp/graph/breadth_first_search.h
— labels are levels, or predecessors when mark_levels=False) and
cusp::graph::connected_components (returns component count + labels).
The reference's CUDA backend used the vendored b40c BFS
(cusp/system/cuda/detail/graph/b40c/); the rebuild replaces those
hand-scheduled kernels with masked semiring sweeps whose fixpoint runs
as ONE jitted lax.while_loop program on device — a full traversal is a
single dispatch.

On the CPU backend the outer loops run host-side instead (jitted step per
round): while_loop + segment reductions deadlock XLA-CPU on oversubscribed
hosts, and CPU is only the test oracle.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from cusp_autotuned_tpu.ops.multiply import generalized_spmv, multiply
from cusp_autotuned_tpu.utils.exceptions import InvalidInputException


def _device_loops() -> bool:
    """lax.while_loop fixpoints everywhere except the XLA-CPU oracle."""
    return jax.default_backend() != "cpu"


def _id_dtype(n: int):
    """Float dtype that represents vertex ids 0..n exactly (ids ride the
    max-semiring as floats; f32 is exact only below 2^24)."""
    if n < (1 << 24):
        return jnp.float32
    import jax
    if jax.config.jax_enable_x64:
        return jnp.float64
    raise InvalidInputException(
        "graphs with >= 2^24 vertices need jax_enable_x64 for exact "
        "id propagation")


def _neighbor_max(A, x):
    """y[i] = max over neighbors j of x[j] (0 where no neighbor)."""
    y0 = jnp.zeros(A.num_rows, x.dtype)
    return generalized_spmv(A, x, y0, lambda y: y,
                            lambda a, xj: xj, jnp.maximum)


def strip_diagonal(G):
    """The off-diagonal pattern of G as CSR — matrices carry self-loops
    (diagonal entries) that must not count as graph edges in MIS/coloring."""
    import numpy as np
    from cusp_autotuned_tpu.ops.convert import _coo_arrays, convert
    from cusp_autotuned_tpu.formats.coo import coo_matrix
    row, col, val, shape = _coo_arrays(G)
    keep = row != col
    C = coo_matrix(row[keep], col[keep], val[keep], shape, sort=False)
    return convert(C, "csr")


@jax.jit
def _bfs_level_step(A, frontier, levels, lvl):
    reach = multiply(A, frontier, use_autotuning=False) > 0
    new = jnp.logical_and(reach, levels < 0)
    levels = jnp.where(new, lvl + 1, levels)
    return new.astype(frontier.dtype), levels


@jax.jit
def _bfs_levels_device(A, frontier, levels):
    def cond(state):
        f, _, _ = state
        return jnp.any(f > 0)

    def body(state):
        f, lab, lvl = state
        reach = multiply(A, f, use_autotuning=False) > 0
        new = jnp.logical_and(reach, lab < 0)
        lab = jnp.where(new, lvl + 1, lab)
        return new.astype(f.dtype), lab, lvl + 1

    _, levels, _ = jax.lax.while_loop(
        cond, body, (frontier, levels, jnp.int32(0)))
    return levels


@jax.jit
def _bfs_pred_step(A, frontier, pred, ids):
    src_ids = jnp.where(frontier > 0, ids + 1, 0.0)
    best = _neighbor_max(A, src_ids)
    new = jnp.logical_and(best > 0, pred < 0)
    pred = jnp.where(new, best.astype(jnp.int32) - 1, pred)
    return new.astype(frontier.dtype), pred


@jax.jit
def _bfs_pred_device(A, frontier, pred, ids):
    def cond(state):
        f, _ = state
        return jnp.any(f > 0)

    def body(state):
        f, p = state
        return _bfs_pred_step(A, f, p, ids)

    _, pred = jax.lax.while_loop(cond, body, (frontier, pred))
    return pred


def breadth_first_search(G, src: int, mark_levels: bool = True):
    """labels[v] = BFS level of v (or predecessor when mark_levels=False);
    -1 for unreachable vertices.  One jitted while_loop program on device."""
    n = G.num_rows
    src = int(src)
    frontier = jnp.zeros(n, jnp.float32).at[src].set(1.0)
    if mark_levels:
        labels = jnp.full(n, -1, jnp.int32).at[src].set(0)
        if _device_loops():
            return _bfs_levels_device(G, frontier, labels)
        lvl = 0
        while bool(jnp.any(frontier > 0)):
            frontier, labels = _bfs_level_step(G, frontier, labels,
                                               jnp.asarray(lvl, jnp.int32))
            lvl += 1
        return labels
    labels = jnp.full(n, -1, jnp.int32).at[src].set(src)
    ids = jnp.arange(n, dtype=_id_dtype(n))
    if _device_loops():
        return _bfs_pred_device(G, frontier, labels, ids)
    while bool(jnp.any(frontier > 0)):
        frontier, labels = _bfs_pred_step(G, frontier, labels, ids)
    return labels


@jax.jit
def _cc_step(A, labels):
    best = _neighbor_max(A, labels + 1.0)
    new = jnp.maximum(labels, best - 1.0)
    # pointer jumping: adopt the label of the vertex whose id equals your
    # current label — halves the propagation distance every round, so the
    # fixpoint takes O(log diameter) rounds instead of O(diameter)
    new = jnp.maximum(new, new[new.astype(jnp.int32)])
    return new, jnp.any(new != labels)


@jax.jit
def _cc_device(A, labels):
    def cond(state):
        _, changed = state
        return changed

    def body(state):
        lab, _ = state
        return _cc_step(A, lab)

    labels, _ = jax.lax.while_loop(cond, body, (labels, jnp.bool_(True)))
    return labels


def connected_components(G):
    """Returns (num_components, labels) with labels renumbered 0..count-1.
    The label-propagation fixpoint is one jitted while_loop program."""
    labels = jnp.arange(G.num_rows, dtype=_id_dtype(G.num_rows))
    if _device_loops():
        labels = _cc_device(G, labels)
    else:
        changed = True
        while changed:
            labels, ch = _cc_step(G, labels)
            changed = bool(ch)
    raw = np.asarray(labels.astype(jnp.int32))
    uniq, out = np.unique(raw, return_inverse=True)
    return int(uniq.size), jnp.asarray(out.astype(np.int32))
