"""Shard-partitionable planned operators: the tuned via_dia rail banded
over an 8-device mesh — each device holds ONLY its row band's plan arrays
— the container rails' containers row-sharded, and distribute_multilevel
using both for the AMG hierarchy's tuned path instead of replicating.

No reference analog (the reference is single-GPU, SURVEY §2.6)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from cusp_autotuned_tpu.gallery import poisson5pt, poisson9pt
from cusp_autotuned_tpu.ops.convert import convert
from cusp_autotuned_tpu.parallel.sharded import (
    make_row_mesh, distribute_multilevel)
from cusp_autotuned_tpu.parallel.sharded_plans import (
    shard_planned_dia, shard_structured_tentative, ShardedPlannedOperator)
from cusp_autotuned_tpu.backend.reference import reference_spmv
from cusp_autotuned_tpu.precond.aggregation import smoothed_aggregation
from cusp_autotuned_tpu.operators import StructuredTentative
from cusp_autotuned_tpu import solvers
from cusp_autotuned_tpu.solvers.monitor import Monitor


pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 2, reason="needs the 8-virtual-device conftest")


@pytest.mark.parametrize("gen,shape", [(poisson5pt, (64, 64)),
                                       (poisson9pt, (48, 80))])
def test_shard_planned_dia_matches_oracle(gen, shape):
    A = gen(*shape, format="csr", dtype=np.float32)
    mesh = make_row_mesh()
    op = shard_planned_dia(convert(A, "dia"), mesh)
    x = np.linspace(-1, 1, A.num_cols).astype(np.float32)
    y = np.asarray(op(jnp.asarray(x)))
    ref = reference_spmv(A, x)
    np.testing.assert_allclose(y, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


def test_each_device_holds_only_its_band():
    A = poisson5pt(64, 64, format="csr", dtype=np.float32)
    mesh = make_row_mesh()
    op = shard_planned_dia(convert(A, "dia"), mesh)
    leaf = op.arrays["data"]
    nd = mesh.devices.size
    assert leaf.shape[0] == nd
    for s in leaf.addressable_shards:
        assert s.data.shape[0] == 1          # one band per device
    # the bands tile the global plan exactly
    got = np.zeros(leaf.shape, np.dtype(leaf.dtype))
    for s in leaf.addressable_shards:
        got[s.index] = np.asarray(s.data)
    np.testing.assert_array_equal(got, np.asarray(leaf))


def test_shard_planned_dia_under_jit_as_argument():
    """The operator is a pytree: the banded arrays ride jit as parameters
    and the shard_map apply composes inside a jitted caller."""
    A = poisson5pt(48, 48, format="csr", dtype=np.float32)
    mesh = make_row_mesh()
    op = shard_planned_dia(convert(A, "dia"), mesh)
    x = jnp.asarray(np.linspace(0, 1, A.num_cols).astype(np.float32))
    jf = jax.jit(lambda o, v: o(v))
    np.testing.assert_allclose(np.asarray(jf(op, x)), np.asarray(op(x)),
                               rtol=1e-6)


def test_distribute_multilevel_shards_tuned_path(model_device):
    A = poisson5pt(96, 96, format="csr", dtype=np.float32)
    b = np.ones(A.num_rows, np.float32)
    M = smoothed_aggregation(A, spmv_config={})
    x1, mon1 = solvers.cg(A, b, M=M, monitor=Monitor(b, 60, 1e-6))
    mesh = make_row_mesh()
    Md = distribute_multilevel(M, mesh, cutoff=2048)
    lv0 = Md.levels[0]
    assert isinstance(lv0.Aop, ShardedPlannedOperator)
    assert lv0.Aop.impl == "via_dia_sharded"
    # the factored R/P share the sharded A and shard their tentative data
    assert isinstance(lv0.Pop.Aop, ShardedPlannedOperator)
    w = lv0.Pop.Top.w
    assert not w.sharding.is_fully_replicated
    x2, mon2 = solvers.cg(A, b, M=Md, monitor=Monitor(b, 60, 1e-6),
                          mesh=mesh)
    assert mon2.converged()
    assert mon2.iteration_count() == mon1.iteration_count()
    np.testing.assert_allclose(np.asarray(x2), np.asarray(x1),
                               rtol=1e-3, atol=1e-3)


def test_distribute_multilevel_idempotent(model_device):
    A = poisson5pt(96, 96, format="csr", dtype=np.float32)
    M = smoothed_aggregation(A, spmv_config={})
    mesh = make_row_mesh()
    Md = distribute_multilevel(M, mesh, cutoff=2048)
    Md2 = distribute_multilevel(Md, mesh, cutoff=2048)
    assert Md2.levels[0].Aop is Md.levels[0].Aop


def test_shard_structured_tentative_placement_and_result():
    A = poisson5pt(96, 96, format="csr", dtype=np.float32)
    M = smoothed_aggregation(A, spmv_config={}, aggregator="structured")
    Top = M.levels[0].Pop.Top
    assert isinstance(Top, StructuredTentative)
    mesh = make_row_mesh()
    Ts = shard_structured_tentative(Top, mesh)
    e = jnp.asarray(np.linspace(-1, 1, Top.shape[1]).astype(np.float32))
    with mesh:
        np.testing.assert_allclose(np.asarray(Ts(e)), np.asarray(Top(e)),
                                   rtol=1e-6)


def test_sharded_planned_dia_block_vectors():
    """2-D x (lobpcg / cg_m / factored AMG multi-rhs) applies column-wise
    — a regression from round 3's replicated operators that supported it
    (review finding)."""
    A = poisson5pt(48, 48, format="csr", dtype=np.float32)
    mesh = make_row_mesh()
    op = shard_planned_dia(convert(A, "dia"), mesh)
    X = np.random.RandomState(0).randn(A.num_cols, 3).astype(np.float32)
    got = np.asarray(op(jnp.asarray(X)))
    for j in range(3):
        np.testing.assert_allclose(got[:, j], reference_spmv(A, X[:, j]),
                                   rtol=1e-5, atol=1e-5)


def test_sharded_block_vector_k16_single_dispatch():
    """k=16 block-vector apply (the SpMM-rail scale) is ONE shard_map —
    columns batch through a vmap over the band apply instead of k
    separate dispatches."""
    A = poisson9pt(48, 48, format="csr", dtype=np.float32)
    mesh = make_row_mesh()
    op = shard_planned_dia(convert(A, "dia"), mesh)
    X = np.random.RandomState(1).randn(A.num_cols, 16).astype(np.float32)
    got = np.asarray(op(jnp.asarray(X)))
    assert got.shape == (A.num_rows, 16)
    for j in range(16):
        np.testing.assert_allclose(got[:, j], reference_spmv(A, X[:, j]),
                                   rtol=1e-4, atol=1e-4)
    jaxpr = jax.make_jaxpr(lambda o, v: o(v))(op, jnp.asarray(X))
    n_shmap = str(jaxpr).count("shard_map")
    assert n_shmap == 1, f"expected 1 shard_map dispatch, saw {n_shmap}"


def _power_law(n=1500, seed=0, fmt="csr"):
    import scipy.sparse as sp
    from cusp_autotuned_tpu.backend.reference import from_scipy
    rng = np.random.RandomState(seed)
    deg = np.clip((rng.pareto(1.3, n) * 3).astype(int) + 1, 1, 400)
    rows = np.repeat(np.arange(n), deg)
    cols = rng.randint(0, n, rows.size)
    vals = rng.randn(rows.size).astype(np.float32)
    S = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    S.sum_duplicates()
    return from_scipy(S, fmt)


def _container_case(kind):
    import scipy.sparse as sp
    from cusp_autotuned_tpu.backend.reference import from_scipy
    if kind == "csr_powerlaw":
        return _power_law(), {"impl": "segsum"}
    if kind == "coo_powerlaw":
        return _power_law(fmt="coo"), {"impl": "segsum"}
    if kind == "ell_poisson9":
        return poisson9pt(40, 40, format="ell", dtype=np.float32), \
            {"impl": "gather"}
    if kind == "ellr_random":
        S = sp.random(1200, 1200, density=0.004, random_state=7,
                      format="csr", dtype=np.float32)
        return from_scipy(S, "ellr"), {"impl": "rowlen"}
    return poisson5pt(48, 40, format="dia", dtype=np.float32), \
        {"impl": "slices"}


@pytest.mark.parametrize("kind", ["csr_powerlaw", "coo_powerlaw",
                                  "ell_poisson9", "ellr_random",
                                  "dia_poisson5"])
def test_shard_planned_operator_matches_oracle(kind):
    """A container-backed planned rail with its container row-sharded over
    the mesh (GSPMD partitions the apply) matches the host oracle, inside
    a jitted caller with the operator as an argument."""
    from cusp_autotuned_tpu.operators import planned_operator
    from cusp_autotuned_tpu.parallel.sharded_plans import (
        shard_planned_operator)
    A, cfg = _container_case(kind)
    mesh = make_row_mesh()
    op = shard_planned_operator(planned_operator(A, cfg), mesh)
    leaves = jax.tree_util.tree_leaves(op.arrays)
    assert any(not l.sharding.is_fully_replicated for l in leaves)
    x = np.random.RandomState(3).randn(A.num_cols).astype(np.float32)
    with mesh:
        got = np.asarray(jax.jit(lambda o, v: o(v))(op, jnp.asarray(x)))
    want = reference_spmv(A, x)
    np.testing.assert_allclose(got, want, rtol=2e-4,
                               atol=2e-4 * np.abs(want).max())


def test_shard_planned_operator_rejects_non_container_plans():
    from cusp_autotuned_tpu.operators import planned_operator
    from cusp_autotuned_tpu.parallel.sharded_plans import (
        shard_planned_operator)
    from cusp_autotuned_tpu.utils.exceptions import NotImplementedException
    A = poisson5pt(20, 20, format="csr", dtype=np.float32)
    op = planned_operator(A, {"impl": "rcm_dia"})
    with pytest.raises(NotImplementedException):
        shard_planned_operator(op, make_row_mesh())


def test_tuned_operator_mesh_shards_scattered():
    """tuned_operator(mesh=) shards the container when the best
    configuration on a scattered pattern is a container rail (segsum) —
    it never silently returns a single-device operator."""
    from cusp_autotuned_tpu.autotune.tuner import Tuner, matrix_signature
    import cusp_autotuned_tpu.autotune.tuner as tuner_mod
    from cusp_autotuned_tpu.autotune.result import ResultStatus, TuningResult
    from cusp_autotuned_tpu.operators import PlannedOperator

    A = _power_law(900, seed=5)
    t = Tuner()
    cfg = {"impl": "segsum"}
    from cusp_autotuned_tpu.autotune.space import config_key
    t.results[matrix_signature(A)] = {
        config_key(cfg): TuningResult(cfg, ResultStatus.Ok, duration_ms=1.0)}
    saved = tuner_mod._global_tuner
    tuner_mod._global_tuner = t
    try:
        mesh = make_row_mesh()
        op = tuner_mod.tuned_operator(A, mesh=mesh)
        assert isinstance(op, PlannedOperator) and op.impl == "segsum"
        assert any(not l.sharding.is_fully_replicated
                   for l in jax.tree_util.tree_leaves(op.arrays))
        x = np.linspace(-1, 1, A.num_cols).astype(np.float32)
        want = reference_spmv(A, x)
        with mesh:
            got = np.asarray(op(jnp.asarray(x)))
        np.testing.assert_allclose(got, want, rtol=2e-4,
                                   atol=2e-4 * np.abs(want).max())
    finally:
        tuner_mod._global_tuner = saved


def test_shard_aop_carries_bf16_storage(model_device):
    """A via_dia plan tuned to bfloat16 storage must keep bf16 data when
    banded over the mesh (review finding: config was dropped)."""
    import dataclasses as _dc
    from cusp_autotuned_tpu.operators import planned_operator
    A = poisson5pt(96, 96, format="csr", dtype=np.float32)
    M = smoothed_aggregation(A, spmv_config={})
    lv = M.levels[0]
    op_b = planned_operator(A, {"impl": "via_dia", "value_dtype": "bfloat16"})
    lvl_b = _dc.replace(lv, Aop=op_b)
    M_b = _dc.replace(M, levels=(lvl_b,) + M.levels[1:])
    mesh = make_row_mesh()
    Md = distribute_multilevel(M_b, mesh, cutoff=2048)
    assert isinstance(Md.levels[0].Aop, ShardedPlannedOperator)
    assert Md.levels[0].Aop.arrays["data"].dtype == jnp.bfloat16
