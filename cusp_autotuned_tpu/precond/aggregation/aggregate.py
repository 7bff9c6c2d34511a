"""Aggregation: standard (greedy Vanek) and MIS(2)-based.

Parity: cusp/precond/aggregation/system/detail/generic/
{standard_aggregate, mis_aggregate}.h — returns (aggregate ids, roots)."""

from __future__ import annotations

import numpy as np

def _adj(C):
    """Host CSR adjacency of the strength graph.  Goes through the
    to_scipy host-mirror cache: setup-time planning must NEVER pull
    container arrays back from the device."""
    from cusp_autotuned_tpu.backend.reference import to_scipy
    S = to_scipy(C)
    if not hasattr(S, "tocsr"):  # dense container
        import scipy.sparse as sp
        S = sp.csr_matrix(S)
    else:
        S = S.tocsr()
    return np.asarray(S.indptr), np.asarray(S.indices)


def standard_aggregate(C):
    """Vanek's three-pass greedy aggregation over the strength graph C.
    Returns (aggregates (n,), roots (n_agg,)).  Uses the native C++
    implementation when available."""
    n = C.num_rows
    indptr, col = _adj(C)
    from cusp_autotuned_tpu import native
    nat = native.standard_aggregate(indptr, col)
    if nat is not None:
        agg, roots = nat
        return np.asarray(agg), np.asarray(roots)
    agg = np.full(n, -1, np.int64)
    roots = []
    # pass 1: nodes whose whole neighborhood is unaggregated seed aggregates
    for i in range(n):
        nbrs = col[indptr[i]: indptr[i + 1]]
        nbrs = nbrs[nbrs != i]
        if agg[i] == -1 and np.all(agg[nbrs] == -1):
            a = len(roots)
            agg[i] = a
            agg[nbrs] = a
            roots.append(i)
    # pass 2: attach remaining nodes to an adjacent aggregate
    attach = agg.copy()
    for i in range(n):
        if agg[i] != -1:
            continue
        nbrs = col[indptr[i]: indptr[i + 1]]
        hit = nbrs[agg[nbrs] != -1]
        if hit.size:
            attach[i] = agg[hit[0]]
    agg = attach
    # pass 3: leftovers become their own aggregates (with their unaggregated
    # neighbors)
    for i in range(n):
        if agg[i] != -1:
            continue
        a = len(roots)
        agg[i] = a
        roots.append(i)
        nbrs = col[indptr[i]: indptr[i + 1]]
        for j in nbrs:
            if agg[j] == -1:
                agg[j] = a
    return agg.astype(np.int32), np.asarray(roots, np.int32)


def detect_grid(A, max_radius: int = 3):
    """Infer a 2-D grid (ny, nx) in raster (row-major) order from the band
    structure of A's host mirror, or None.

    A grid-ordered stencil matrix has every nonzero at offset
    o = col - row = dy * nx + dx with small |dy|, |dx| (5-pt: dx in
    {-1,0,1}, dy in {-1,0,1}; the Galerkin coarse 9-pt likewise on the
    coarse grid).  nx is recovered as the dominant offset > max_radius and
    validated by requiring EVERY offset to decompose within the radius.
    No reference analog — the reference never specializes on geometry; this
    feeds the structured tentative rail (VERDICT r3 item 3)."""
    from cusp_autotuned_tpu.precond.aggregation.structured_rap import (
        get_band)
    band = get_band(A)   # cached; shared with rho and the structured RAP
    if band is None:
        return None      # not square / not host-mirrored / > MAX_BAND diags
    offs_l, data = band
    offs = np.asarray(offs_l, np.int64)
    n = data[0].shape[0]
    if offs.size == 0 or offs.size > (2 * max_radius + 1) ** 2:
        return None      # a radius-r stencil has at most (2r+1)^2 offsets
    counts = np.array([np.count_nonzero(d) for d in data])
    big_mask = offs > max_radius
    if not big_mask.any():
        return None
    # dominant large offset = the grid width candidate
    nx = int(offs[big_mask][np.argmax(counts[big_mask])])
    if nx <= max_radius or n % nx:
        return None
    ny = n // nx
    if ny < 2 or nx < 2:
        return None
    # every offset must be dy*nx + dx with |dy|, |dx| <= max_radius
    dy = np.rint(offs / nx).astype(np.int64)
    dx = offs - dy * nx
    if (np.abs(dy) > max_radius).any() or (np.abs(dx) > max_radius).any():
        return None
    # row-boundary validation: on a true ny x nx raster grid an entry at
    # offset dy*nx + dx connects (y, x) -> (y+dy, x+dx), so x+dx must
    # stay inside [0, nx) for EVERY entry.  A 1-D multi-band chain (e.g.
    # offsets {-4,-1,0,1,4}) decomposes arithmetically but has +1 entries
    # at x == nx-1 — this check rejects it (found by review; 'auto' is
    # the default aggregator, so misdetection silently changes AMG).  In
    # band form the per-entry check collapses to per-offset STRIPE checks:
    # the rows whose x + dx leaves the grid are contiguous x-columns of
    # the (ny, nx) raster view, which must hold only zeros.  (y + dy
    # range needs no check: x in range forces y + dy = (i + o) // nx in
    # [0, ny) because i + o = col is in [0, n).)
    for k in range(offs.size):
        dxk = int(dx[k])
        if dxk == 0:
            continue
        grid_view = data[k].reshape(ny, nx)
        bad = grid_view[:, nx - dxk:] if dxk > 0 else grid_view[:, :-dxk]
        if np.any(bad):
            return None
    return ny, nx


def structured_aggregate(C, block=(3, 3), grid=None):
    """Grid-blocked aggregation: when the operator is a raster-ordered 2-D
    stencil (detect_grid), aggregate exact py x px blocks with coarse ids
    in coarse raster order.

    The payoff is the apply structure: the tentative prolongator becomes
    w * upsample(e) (pure broadcast/reshape — no gather) and its transpose
    a reshape/fold-sum, so the AMG R/P hot path runs at stream rate instead
    of the scattered-kernel rate; the Galerkin coarse operator comes out
    banded on the (nby, nbx) raster grid, so the structure recurses down
    the hierarchy.  Raises ValueError when no grid is detected (callers
    using 'auto' fall back to standard_aggregate).  Quality: py=px=3
    matches the smoothed-aggregation diameter-3 aggregate ideal (Vanek);
    measured iteration counts vs standard_aggregate are in
    tests/test_precond.py."""
    g = grid or detect_grid(C)
    if g is None:
        raise ValueError("no raster grid structure detected")
    ny, nx = g
    py, px = block
    nby, nbx = -(-ny // py), -(-nx // px)
    yy, xx = np.divmod(np.arange(ny * nx, dtype=np.int64), nx)
    agg = (yy // py) * nbx + (xx // px)
    # root = the first (top-left) member of each block
    by, bx = np.divmod(np.arange(nby * nbx, dtype=np.int64), nbx)
    roots = (by * py) * nx + bx * px
    return agg.astype(np.int32), roots.astype(np.int32)


def mis_aggregate(C, seed: int = 0):
    """MIS(2)-rooted aggregation (parity: generic/mis_aggregate.h:117-197):
    roots form an MIS(2) of the strength graph; every other vertex joins the
    nearest root (two rounds of propagation)."""
    from cusp_autotuned_tpu.graph.mis import maximal_independent_set
    n = C.num_rows
    count, stencil = maximal_independent_set(C, k=2, seed=seed)
    stencil = np.asarray(stencil)
    roots = np.nonzero(stencil)[0]
    indptr, col = _adj(C)
    agg = np.full(n, -1, np.int64)
    agg[roots] = np.arange(roots.size)
    # two propagation rounds (every vertex is within 2 hops of a root)
    for _ in range(2):
        newagg = agg.copy()
        for i in range(n):
            if agg[i] != -1:
                continue
            nbrs = col[indptr[i]: indptr[i + 1]]
            hit = nbrs[agg[nbrs] != -1]
            if hit.size:
                newagg[i] = agg[hit[0]]
        agg = newagg
    # safety: stragglers become singletons
    stray = np.nonzero(agg == -1)[0]
    if stray.size:
        extra = np.arange(stray.size) + roots.size
        agg[stray] = extra
        roots = np.concatenate([roots, stray])
    return agg.astype(np.int32), roots.astype(np.int32)
