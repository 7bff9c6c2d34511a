"""Row-sharded sparse operators and distributed Krylov solves.

Design (scaling-book recipe): pick a 1-D mesh over the 'rows' axis, place the
row-blocked halves of the matrix on it (DIA data along its rows axis; ELL
slot arrays along rows; COO/CSR by padded-nnz blocks), replicate x, and let
GSPMD insert the collectives — dot products inside the solver loop become
all-reduces over the interconnect.  The containers' static-metadata design means the SAME
jitted spmv/solver code runs sharded: only the array placements change.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from cusp_autotuned_tpu import formats as F


def make_row_mesh(devices=None, axis: str = "rows") -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (axis,))


def replicate(x, mesh: Mesh):
    return jax.device_put(x, NamedSharding(mesh, P()))


def shard_rows(A, mesh: Mesh, axis: str = "rows"):
    """Place a container's row-parallel arrays across the mesh rows axis.
    Row counts are padded to LANE (128), so they divide typical mesh sizes."""
    row_sharded = NamedSharding(mesh, P(None, axis))
    vec_sharded = NamedSharding(mesh, P(axis))
    repl = NamedSharding(mesh, P())
    if isinstance(A, F.DIA):
        return jax.tree_util.tree_map(
            lambda leaf: jax.device_put(leaf, row_sharded), A)
    if isinstance(A, (F.ELL, F.ELLR)):
        def place(leaf):
            if leaf.ndim == 2:
                return jax.device_put(leaf, row_sharded)
            return jax.device_put(leaf, vec_sharded)
        return jax.tree_util.tree_map(place, A)
    if isinstance(A, (F.COO, F.CSR)):
        # nnz-blocked placement; segment reductions cross shard boundaries,
        # GSPMD resolves them with collectives
        def place(leaf):
            if leaf.shape[0] % mesh.devices.size == 0:
                return jax.device_put(leaf, vec_sharded)
            return jax.device_put(leaf, repl)
        return jax.tree_util.tree_map(place, A)
    if isinstance(A, F.HYB):
        return F.HYB(ell=shard_rows(A.ell, mesh, axis),
                     coo=shard_rows(A.coo, mesh, axis), shape=A.shape)
    raise TypeError(f"cannot shard {type(A)}")


def shard_rows_aligned(A, mesh: Mesh, axis: str = "rows"):
    """Row-ALIGNED placement for COO/CSR: entries are re-padded on the host
    so each device owns a contiguous row range with an equal padded entry
    count — segment reductions then never cross shard boundaries (the
    nnz-blocked placement in shard_rows splits rows across devices and
    forces GSPMD to insert cross-device combines).  Returns a sharded COO."""
    from cusp_autotuned_tpu.ops.convert import _coo_arrays
    from cusp_autotuned_tpu.formats.coo import coo_matrix
    from cusp_autotuned_tpu.utils.padding import round_up

    n_dev = mesh.devices.size
    row, col, val, (m, n) = _coo_arrays(A)
    m_pad = round_up(max(m, 1), 128 * n_dev)
    rows_per_dev = m_pad // n_dev
    cuts = np.searchsorted(row, np.arange(1, n_dev) * rows_per_dev)
    chunks = np.split(np.arange(row.size), cuts)
    width = round_up(max(max(len(c) for c in chunks), 1), 128)
    rr = np.zeros(n_dev * width, np.int32)
    cc = np.zeros(n_dev * width, np.int32)
    vv = np.zeros(n_dev * width, np.asarray(val).dtype)
    for d, idx in enumerate(chunks):
        s = d * width
        rr[s:s + idx.size] = row[idx]
        cc[s:s + idx.size] = col[idx]
        vv[s:s + idx.size] = val[idx]
        # padding entries carry val 0 on a row the device owns
        rr[s + idx.size:s + width] = min(d * rows_per_dev, m - 1)
    C = coo_matrix(rr, cc, vv, (m, n), sort=False)
    vec = NamedSharding(mesh, P(axis))
    repl = NamedSharding(mesh, P())

    def place(leaf):
        if leaf.ndim == 1 and leaf.shape[0] == n_dev * width:
            return jax.device_put(leaf, vec)
        return jax.device_put(leaf, repl)
    return jax.tree_util.tree_map(place, C)


def sharded_spmv(A, x):
    """y = A @ x under GSPMD — same traceable kernel as single-chip."""
    from cusp_autotuned_tpu.ops.multiply import multiply
    return multiply(A, x)


def distribute_for_solve(A, mesh: Mesh, *vectors, aligned: bool = True):
    """Shard the operator's rows over the mesh and replicate the given
    vectors — the preparation step behind the solvers' public `mesh=`
    argument.  COO/CSR take the row-aligned placement (shard-local segment
    sums) unless aligned=False; returns (A_sharded, *vectors_replicated)."""
    if getattr(A, "format", None) in ("coo", "csr") and aligned:
        A = shard_rows_aligned(A, mesh)
    elif F.is_sparse(A):
        A = shard_rows(A, mesh)
    out = [A]
    for v in vectors:
        out.append(None if v is None else replicate(jnp.asarray(v), mesh))
    return tuple(out)


def distributed_cg(A, b, mesh: Mesh, iterations: int = 25):
    """Fixed-iteration CG with the matrix row-sharded over the mesh; the
    per-iteration dot products become all-reduces.  Returns (x, r_norm)."""
    from cusp_autotuned_tpu.ops.multiply import multiply

    A = shard_rows(A, mesh)
    b = replicate(jnp.asarray(b), mesh)

    @jax.jit
    def solve(A, b):
        def body(_, carry):
            x, r, p, rz = carry
            y = multiply(A, p)
            alpha = rz / jnp.vdot(y, p)
            x = x + alpha * p
            r = r - alpha * y
            rz_new = jnp.vdot(r, r)
            p = r + (rz_new / rz) * p
            return (x, r, p, rz_new)

        x0 = jnp.zeros_like(b)
        r0 = b
        carry = (x0, r0, r0, jnp.vdot(r0, r0))
        x, r, p, rz = jax.lax.fori_loop(0, iterations, body, carry)
        return x, jnp.sqrt(jnp.real(rz))

    with mesh:
        return solve(A, b)


def distributed_bicgstab(A, b, mesh: Mesh, iterations: int = 25,
                         aligned: bool = True):
    """Fixed-iteration BiCGstab with the matrix sharded over the mesh —
    the nonsymmetric companion to distributed_cg (parity target:
    cusp/krylov/detail/bicgstab.inl recurrences).  aligned=True uses the
    row-aligned COO placement so segment sums stay shard-local.
    Returns (x, r_norm)."""
    from cusp_autotuned_tpu.ops.multiply import multiply

    A = (shard_rows_aligned(A, mesh) if aligned and A.format in ("coo", "csr")
         else shard_rows(A, mesh))
    b = replicate(jnp.asarray(b), mesh)

    @jax.jit
    def solve(A, b):
        def body(_, carry):
            x, r, p, v, r0h, rho, alpha, omega = carry
            rho_new = jnp.vdot(r0h, r)
            beta = (rho_new / rho) * (alpha / omega)
            p = r + beta * (p - omega * v)
            v = multiply(A, p)
            alpha = rho_new / jnp.vdot(r0h, v)
            s = r - alpha * v
            t = multiply(A, s)
            omega = jnp.vdot(t, s) / jnp.vdot(t, t)
            x = x + alpha * p + omega * s
            r = s - omega * t
            return (x, r, p, v, r0h, rho_new, alpha, omega)

        x0 = jnp.zeros_like(b)
        one = jnp.ones((), b.dtype)
        carry = (x0, b, jnp.zeros_like(b), jnp.zeros_like(b), b,
                 one, one, one)
        x, r, *_ = jax.lax.fori_loop(0, iterations, body, carry)
        return x, jnp.sqrt(jnp.real(jnp.vdot(r, r)))

    with mesh:
        return solve(A, b)


def distribute_multilevel(M, mesh: Mesh, cutoff: int = 2048):
    """Mesh-aware AMG hierarchy (SURVEY §2.6 extension; the reference's
    multilevel is single-GPU): every level operator with at least `cutoff`
    rows is row-sharded over the mesh — the V-cycle's SpMVs then run
    row-parallel with GSPMD inserting the collectives — while smaller
    levels, the smoothers' vectors, and the coarse LU are replicated
    (coarse grids are latency-bound; replication beats sharding there).

    TUNED operators shard too: a via_dia PlannedOperator rebuilds as a
    row-banded ShardedPlannedOperator (each device holds only its band's
    diagonal data — parallel/sharded_plans.py); a container-backed
    planned rail shards its container; and the factored R/P applies
    shard their structured-tentative weights and inner A operator."""
    import dataclasses
    from cusp_autotuned_tpu.parallel.sharded_plans import (
        shard_planned_dia, shard_planned_operator,
        shard_structured_tentative, _place_vec)
    from cusp_autotuned_tpu.operators import (
        PlannedOperator, FactoredProlongator, FactoredRestriction,
        StructuredTentative, StructuredTentativeT)

    def repl_tree(obj):
        if obj is None:
            return None
        return jax.tree_util.tree_map(lambda l: replicate(l, mesh), obj)

    def place(op):
        if op is None:
            return None
        if F.is_sparse(op) and op.num_rows >= cutoff:
            return shard_rows(op, mesh)
        return repl_tree(op)

    def shard_aop(lvl):
        op = lvl.Aop
        from cusp_autotuned_tpu.parallel.sharded_plans import (
            ShardedPlannedOperator)
        if isinstance(op, ShardedPlannedOperator):   # idempotent re-entry
            return op
        if not (isinstance(op, PlannedOperator)
                and lvl.A.num_rows >= cutoff):
            return repl_tree(op)
        if op.impl == "via_dia":
            from cusp_autotuned_tpu.ops.convert import convert
            # carry the tuned storage dtype over: a via_dia-bf16 plan
            # must not silently revert to f32 data when banded
            leaves = jax.tree_util.tree_leaves(op.arrays)
            cfg = ({"value_dtype": "bfloat16"}
                   if leaves and leaves[0].dtype == jnp.bfloat16 else {})
            return shard_planned_dia(convert(lvl.A, "dia"), mesh,
                                     config=cfg)
        if set(op.arrays) == {"A"}:
            return shard_planned_operator(op, mesh)
        return repl_tree(op)

    def place_t(top):
        if isinstance(top, (StructuredTentative, StructuredTentativeT)):
            return shard_structured_tentative(top, mesh)
        return repl_tree(top)

    def place_rp(op, Aop_s, big):
        if op is None:
            return None
        if isinstance(op, FactoredProlongator) and big:
            return dataclasses.replace(
                op, Top=place_t(op.Top), Aop=Aop_s,
                dinv=_place_vec(op.dinv, mesh, "rows"),
                scale=replicate(op.scale, mesh))
        if isinstance(op, FactoredRestriction) and big:
            return dataclasses.replace(
                op, Ttop=place_t(op.Ttop), Aop=Aop_s,
                dinv=_place_vec(op.dinv, mesh, "rows"),
                scale=replicate(op.scale, mesh))
        return repl_tree(op)

    new_levels = []
    for lvl in M.levels:
        big = lvl.A.num_rows >= cutoff
        Aop_s = shard_aop(lvl)
        new_levels.append(dataclasses.replace(
            lvl, A=place(lvl.A), R=place(lvl.R), P=place(lvl.P),
            smoother=repl_tree(lvl.smoother), Aop=Aop_s,
            Rop=place_rp(lvl.Rop, Aop_s, big),
            Pop=place_rp(lvl.Pop, Aop_s, big)))
    return dataclasses.replace(M, levels=tuple(new_levels),
                               coarse=repl_tree(M.coarse))
