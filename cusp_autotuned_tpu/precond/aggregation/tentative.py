"""Tentative prolongator from aggregates + near-nullspace candidates.

Parity: cusp::precond::aggregation::fit_candidates
(cusp/precond/aggregation/detail/tentative.inl) — T has one block column per
aggregate holding the orthonormalized restriction of B; returns (T, B_coarse).
Supports a single candidate vector (the reference's default B = ones)."""

from __future__ import annotations

import numpy as np

from cusp_autotuned_tpu.formats.coo import coo_matrix
from cusp_autotuned_tpu.ops.convert import convert


def fit_candidates(aggregates, B):
    """aggregates: (n,) int32 aggregate id per row (-1 = unaggregated);
    B: (n,) single near-nullspace candidate.  Returns (T csr, B_c)."""
    agg = np.asarray(aggregates).astype(np.int64)
    B_np = np.asarray(B)
    b = B_np.astype(np.float64)
    n = agg.shape[0]
    n_agg = int(agg.max()) + 1 if agg.size else 0

    norms_sq = np.zeros(n_agg)
    valid = agg >= 0
    np.add.at(norms_sq, agg[valid], b[valid] ** 2)
    norms = np.sqrt(norms_sq)
    safe = np.where(norms > 0, norms, 1.0)

    rows = np.nonzero(valid)[0]
    cols = agg[valid]
    vals = b[valid] / safe[cols]
    out_dt = B_np.dtype
    if not np.issubdtype(out_dt, np.floating):
        out_dt = np.float64
    T = coo_matrix(rows.astype(np.int32), cols.astype(np.int32),
                   vals.astype(out_dt), (n, n_agg), sort=True)
    # B_coarse stays HOST-side: it feeds the next level's strength /
    # fit_candidates only (setup-time planning stays on the host)
    return convert(T, "csr"), norms.astype(out_dt)
