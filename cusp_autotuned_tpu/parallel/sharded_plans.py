"""Shard-partitionable PLANNED operators.

The tuned rails' planned arrays are row-blocked, so a plan partitions
cleanly into per-device row bands: each device holds ONLY its band's
planned arrays (memory scaling) and computes ONLY its band's output rows
(compute scaling), with x replicated — the scaling-book 1-D row-sharded
SpMV recipe applied to the tuned path instead of the untuned containers.

`shard_planned_dia` builds the banded form of the via_dia rail: the DIA
data (k diagonals x rows) splits along rows into equal bands, and a
`shard_map` apply slices each device's x window out of the replicated,
pre-shifted x with `axis_index` and sums the k shifted products — the
same shifted reads as the single-device slices rail
(`ops.multiply.spmv_dia`), zero collectives on the forward apply.
`shard_planned_operator` places the container of a container-backed rail
(segsum, gather, slices, ...) over the mesh and lets GSPMD partition it.

No reference analog: the reference is single-GPU (SURVEY §2.6); this is
the distributed extension's tuned path.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from cusp_autotuned_tpu.formats.base import register_matrix, static_field
from cusp_autotuned_tpu.operators import register_operator_type
from cusp_autotuned_tpu.utils.exceptions import NotImplementedException


@register_operator_type
@register_matrix
@dataclasses.dataclass(frozen=True)
class ShardedPlannedOperator:
    """A planned kernel whose plan arrays are banded over a mesh axis.

    `arrays` leaves carry a leading device axis sharded over `axis`;
    `band_apply(local_arrays, x2)` runs inside shard_map on one band;
    `x_prep(x)` builds the replicated padded x block the bands slice."""
    arrays: dict
    x_prep: Callable = static_field()
    band_apply: Callable = static_field()
    finish: Callable = static_field()       # (y_stacked, x) -> y
    mesh: Mesh = static_field()
    axis: str = static_field(default="rows")
    shape: Tuple[int, int] = static_field(default=(0, 0))
    impl: str = static_field(default="sharded")
    format = "sharded_planned_operator"

    def __call__(self, x):
        specs = jax.tree_util.tree_map(lambda _: P(self.axis), self.arrays)
        if x.ndim == 2:
            # block vectors (lobpcg, cg_m, SpMM): ONE shard_map dispatch —
            # columns ride a vmap over the band apply, so the k-column
            # apply costs one executable instead of k dispatches.
            # Contract: band_apply/x_prep/finish must be vmap-compatible.
            xstack = jax.vmap(self.x_prep, in_axes=1)(x)
            body = (lambda arrs, xs:
                    jax.vmap(lambda x2: self.band_apply(arrs, x2))(xs))
            fn = jax.shard_map(body, mesh=self.mesh,
                               in_specs=(specs, P()),
                               out_specs=P(None, self.axis))
            ys = fn(self.arrays, xstack)
            return jax.vmap(self.finish, in_axes=(0, 1), out_axes=1)(ys, x)
        if x.ndim != 1:
            raise NotImplementedException(
                "sharded planned operators take 1-D/2-D x")
        fn = jax.shard_map(self.band_apply, mesh=self.mesh,
                           in_specs=(specs, P()), out_specs=P(self.axis))
        return self.finish(fn(self.arrays, self.x_prep(x)), x)


def shard_planned_dia(D, mesh: Mesh, config=None, axis: str = "rows"):
    """Row-banded via_dia planned operator over `mesh`.

    D: a DIA container (use ops.convert on the level matrix).  Each
    device holds its band of the (k, rows) diagonal data (bands are padded
    to equal size) and slices its x window from the replicated
    pre-shifted x by mesh position.  config: `value_dtype` (bf16 storage
    of the diagonals)."""
    from cusp_autotuned_tpu.utils.config import plan_value_dtype

    store = plan_value_dtype(dict(config or {}), D.dtype)
    offsets = [int(o) for o in np.asarray(D.offsets)]
    k = len(offsets)
    m, n = D.shape
    nd = int(mesh.devices.size)
    band = -(-int(D.rows_padded) // nd)
    mp = band * nd
    left = -min(0, min(offsets))
    x_band = band + left + max(0, max(offsets))
    x_glob = max((nd - 1) * band + x_band, n + left)

    data = jnp.asarray(D.data)
    if data.shape[1] < mp:
        data = jnp.pad(data, ((0, 0), (0, mp - data.shape[1])))
    data3 = data[:, :mp].reshape(k, nd, band).transpose(1, 0, 2) \
        .astype(store)

    def x_prep(x):
        return jnp.pad(x, (left, x_glob - left - n))

    def band_apply(arrs, xp):
        i = jax.lax.axis_index(axis)
        xb = jax.lax.dynamic_slice_in_dim(xp, i * band, x_band, 0)
        dat = arrs["data"][0]
        acc = None
        for d, off in enumerate(offsets):
            term = dat[d] * xb[left + off: left + off + band]
            acc = term if acc is None else acc + term
        return acc

    def finish(y, _x):
        return y[:m]

    sharded = NamedSharding(mesh, P(axis))
    arrays = {"data": jax.device_put(data3, sharded)}
    return ShardedPlannedOperator(
        arrays=arrays, x_prep=x_prep, band_apply=band_apply, finish=finish,
        mesh=mesh, axis=axis, shape=(m, n), impl="via_dia_sharded")


def shard_planned_operator(op, mesh: Mesh):
    """A container-backed PlannedOperator (arrays == {"A": container})
    with its container row-sharded over `mesh` (parallel.sharded
    .distribute_for_solve); GSPMD partitions the apply."""
    from cusp_autotuned_tpu.parallel.sharded import distribute_for_solve
    if set(op.arrays) != {"A"}:
        raise NotImplementedException(
            f"{op.impl!r} plans carry no container to shard")
    (A,) = distribute_for_solve(op.arrays["A"], mesh)
    return dataclasses.replace(op, arrays={"A": A})


def _place_vec(v, mesh: Mesh, axis: str):
    """Shard a vector's leading dim when it divides the mesh, else
    replicate (coarse levels are small; replication is the right call)."""
    if v is None:
        return None
    nd = int(mesh.devices.size)
    if v.shape[0] % nd == 0:
        spec = P(axis) if v.ndim == 1 else P(axis, *([None] * (v.ndim - 1)))
        return jax.device_put(v, NamedSharding(mesh, spec))
    return jax.device_put(v, NamedSharding(mesh, P()))


def shard_structured_tentative(op, mesh: Mesh, axis: str = "rows"):
    """Place a StructuredTentative('s transpose) over the mesh: the fine
    weight vector and the fine-side replication matrix shard by rows (the
    fine dimension); the coarse-side matrix replicates.  GSPMD inserts
    the (tiny, coarse-sized) collectives in the transpose apply."""
    return dataclasses.replace(
        op,
        w=_place_vec(op.w, mesh, axis),
        Ey=_place_vec(op.Ey, mesh, axis),
        Ex=jax.device_put(op.Ex, NamedSharding(mesh, P())))
