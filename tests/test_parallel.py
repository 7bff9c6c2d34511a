import numpy as np
import jax
import pytest

from cusp_autotuned_tpu import gallery
from cusp_autotuned_tpu.parallel import make_row_mesh, shard_rows, distributed_cg
from cusp_autotuned_tpu.ops.multiply import multiply
from cusp_autotuned_tpu.backend.reference import from_scipy, reference_spmv
import jax.numpy as jnp


def test_virtual_mesh_available():
    assert len(jax.devices()) == 8


def test_sharded_spmv_dia_matches():
    mesh = make_row_mesh(jax.devices())
    A = gallery.poisson5pt(32, 32, format="dia", dtype=np.float32)
    x = np.linspace(0, 1, A.num_cols).astype(np.float32)
    y_ref = np.asarray(multiply(A, x))
    As = shard_rows(A, mesh)
    with mesh:
        y = np.asarray(multiply(As, jax.device_put(x)))
    np.testing.assert_allclose(y, y_ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("fmt", ["dia", "ell"])
def test_distributed_cg(fmt):
    mesh = make_row_mesh(jax.devices())
    A = gallery.poisson5pt(16, 64, format=fmt, dtype=np.float32)
    b = np.ones(A.num_rows, np.float32)
    x, r_norm = distributed_cg(A, b, mesh, iterations=60)
    r = b - np.asarray(multiply(A, np.asarray(x)))
    assert np.linalg.norm(r) <= 1e-3 * np.linalg.norm(b)


def test_dryrun_entrypoints():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "__graft_entry__", "/root/repo/__graft_entry__.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    fn, args = mod.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    mod.dryrun_multichip(8)


def test_shardmap_spmv_matches():
    from cusp_autotuned_tpu.parallel import sharded_spmv_dia_shardmap
    mesh = make_row_mesh(jax.devices())
    A = gallery.poisson5pt(16, 64, format="dia", dtype=np.float32)
    x = np.linspace(0, 1, A.num_cols).astype(np.float32)
    fn = sharded_spmv_dia_shardmap(A, mesh)
    with mesh:
        y = np.asarray(jax.jit(fn)(jax.device_put(x)))
    np.testing.assert_allclose(y, np.asarray(multiply(A, x)),
                               rtol=1e-5, atol=1e-6)


def test_shardmap_cg_converges():
    from cusp_autotuned_tpu.parallel import distributed_cg_shardmap
    mesh = make_row_mesh(jax.devices())
    A = gallery.poisson5pt(16, 64, format="dia", dtype=np.float32)
    b = np.ones(A.num_rows, np.float32)
    x, r_norm = distributed_cg_shardmap(A, b, mesh, iterations=60)
    r = b - np.asarray(multiply(A, np.asarray(x)))
    assert np.linalg.norm(r) <= 1e-3 * np.linalg.norm(b)


def test_monitored_cg_runs_sharded_unchanged():
    """The standard jitted solvers (monitor and all) run on sharded
    containers via GSPMD with no code changes."""
    from cusp_autotuned_tpu import solvers
    mesh = make_row_mesh(jax.devices())
    A = gallery.poisson5pt(16, 64, format="dia", dtype=np.float32)
    As = shard_rows(A, mesh)
    from cusp_autotuned_tpu.parallel import replicate
    b_host = np.ones(A.num_rows, np.float32)
    b = replicate(b_host, mesh)
    with mesh:
        x, mon = solvers.cg(As, b, monitor=solvers.Monitor(b_host, 300, 1e-5))
    assert mon.converged()
    # the monitor tracks the recursive residual; the true residual can drift
    # a little above the f32 recurrence tolerance
    r = b_host - np.asarray(multiply(A, np.asarray(x)))
    assert np.linalg.norm(r) <= 1e-4 * np.linalg.norm(b_host)


def test_distributed_bicgstab_aligned_csr():
    """BiCGstab over the mesh with row-aligned CSR placement matches the
    single-device solve."""
    from cusp_autotuned_tpu.parallel import distributed_bicgstab, make_row_mesh
    import scipy.sparse as sp
    mesh = make_row_mesh()
    rng = np.random.RandomState(3)
    n = 8 * 128
    S = (sp.diags([np.full(n - 1, -1.0), np.full(n, 2.5),
                   np.full(n - 1, -0.7)], [-1, 0, 1])).tocsr().astype(np.float32)
    A = from_scipy(S.tocoo(), "csr")
    b = np.ones(n, np.float32)
    x, r = distributed_bicgstab(A, b, mesh, iterations=20)
    assert np.all(np.isfinite(np.asarray(x)))
    resid = np.linalg.norm(S @ np.asarray(x, np.float64) - b)
    assert resid < 1e-2 * np.linalg.norm(b), resid


def test_shard_rows_aligned_spmv_matches():
    from cusp_autotuned_tpu.parallel import shard_rows_aligned, make_row_mesh
    from cusp_autotuned_tpu.ops.multiply import multiply
    mesh = make_row_mesh()
    A = gallery.poisson5pt(32, 32, format="csr", dtype=np.float32)
    As = shard_rows_aligned(A, mesh)
    x = np.random.RandomState(0).randn(A.num_cols).astype(np.float32)
    with mesh:
        y = np.asarray(jax.jit(multiply)(As, jnp.asarray(x)))
    ref = reference_spmv(A, x)
    np.testing.assert_allclose(y, ref, rtol=1e-5, atol=1e-5)


def test_distributed_cg_halo_matches_allgather():
    """Halo-exchange CG (two ppermutes of bandwidth-sized edges per
    iteration) agrees with the all-gather shard_map path and with GSPMD."""
    from cusp_autotuned_tpu.parallel import (
        distributed_cg_halo, distributed_cg_shardmap, distributed_cg,
        make_row_mesh)
    mesh = make_row_mesh()
    A = gallery.poisson5pt(16, 64, format="dia", dtype=np.float32)
    b = np.ones(A.num_rows, np.float32)
    x1, r1 = distributed_cg_halo(A, b, mesh, iterations=8)
    x2, r2 = distributed_cg_shardmap(A, b, mesh, iterations=8)
    x3, r3 = distributed_cg(A, b, mesh, iterations=8)
    np.testing.assert_allclose(np.asarray(x1), np.asarray(x2),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(x1), np.asarray(x3),
                               rtol=1e-4, atol=1e-5)


# -- public solver mesh= argument -------------------------------------------------

@pytest.mark.parametrize("fmt", ["dia", "csr"])
def test_solver_mesh_arg_cg(fmt):
    from cusp_autotuned_tpu import solvers
    mesh = make_row_mesh(jax.devices())
    A = gallery.poisson5pt(16, 64, format=fmt, dtype=np.float32)
    b = np.ones(A.num_rows, np.float32)
    x, mon = solvers.cg(A, b, mesh=mesh)
    x1, mon1 = solvers.cg(A, b)
    assert mon.converged()
    np.testing.assert_allclose(np.asarray(x), np.asarray(x1),
                               rtol=1e-3, atol=1e-4)


def test_solver_mesh_arg_bicg():
    """bicg(mesh=) row-shards BOTH A and the setup-time A^T (parity:
    bicg.inl:42-157 dual recurrence, distributed per SURVEY §2.6)."""
    from cusp_autotuned_tpu import solvers
    mesh = make_row_mesh(jax.devices())
    A = gallery.poisson5pt(16, 48, format="csr", dtype=np.float32)
    b = np.ones(A.num_rows, np.float32)
    x, mon = solvers.bicg(A, b, mesh=mesh)
    x1, mon1 = solvers.bicg(A, b)
    assert mon.converged()
    np.testing.assert_allclose(np.asarray(x), np.asarray(x1),
                               rtol=1e-3, atol=1e-4)


def test_solver_mesh_arg_bicgstab_gmres_cr():
    from cusp_autotuned_tpu import solvers
    mesh = make_row_mesh(jax.devices())
    A = gallery.poisson5pt(16, 48, format="csr", dtype=np.float32)
    b = np.ones(A.num_rows, np.float32)
    for solve in (solvers.bicgstab, solvers.cr, solvers.gmres):
        x, mon = solve(A, b, mesh=mesh)
        assert mon.converged(), solve.__name__
        r = b - np.asarray(multiply(A, np.asarray(x)))
        assert np.linalg.norm(r) <= 2e-3 * np.linalg.norm(b), solve.__name__


def test_solver_mesh_arg_multishift():
    from cusp_autotuned_tpu import solvers
    mesh = make_row_mesh(jax.devices())
    A = gallery.poisson5pt(16, 48, format="dia", dtype=np.float32)
    b = np.ones(A.num_rows, np.float32)
    sigma = np.array([0.0, 0.5, 2.0], np.float32)
    X, mon = solvers.cg_m(A, b, sigma, mesh=mesh)
    assert mon.converged()
    for s, sig in enumerate(sigma):
        r = b - (np.asarray(multiply(A, np.asarray(X[s])))
                 + sig * np.asarray(X[s]))
        assert np.linalg.norm(r) <= 5e-3 * np.linalg.norm(b), s


def test_distributed_amg_cg_matches_single_device():
    """AMG-preconditioned cg(mesh=) — fine levels row-sharded, coarse
    replicated (SURVEY §2.6 extension; VERDICT r2 item 5)."""
    from cusp_autotuned_tpu import solvers
    from cusp_autotuned_tpu.precond.aggregation import smoothed_aggregation
    from cusp_autotuned_tpu.solvers.monitor import Monitor
    A = gallery.poisson5pt(32, 32, format="csr", dtype=np.float32)
    b = np.ones(A.num_rows, np.float32)
    M = smoothed_aggregation(A, min_level_size=100)
    mesh = make_row_mesh(jax.devices())
    x1, m1 = solvers.cg(A, b, M=M, monitor=Monitor(b, 100, 1e-8))
    x2, m2 = solvers.cg(A, b, M=M, monitor=Monitor(b, 100, 1e-8), mesh=mesh)
    assert m2.converged()
    assert m2.iteration_count() <= m1.iteration_count() + 2
    np.testing.assert_allclose(np.asarray(x2), np.asarray(x1),
                               rtol=1e-4, atol=1e-5)


def test_distribute_multilevel_placement():
    from cusp_autotuned_tpu.parallel import distribute_multilevel
    from cusp_autotuned_tpu.precond.aggregation import smoothed_aggregation
    A = gallery.poisson5pt(40, 40, format="csr", dtype=np.float32)
    M = smoothed_aggregation(A, min_level_size=100)
    mesh = make_row_mesh(jax.devices())
    Md = distribute_multilevel(M, mesh, cutoff=1000)
    fine = Md.levels[0].A
    leaves = jax.tree_util.tree_leaves(fine)
    assert any(not leaf.sharding.is_fully_replicated for leaf in leaves)
    coarse_inv = Md.coarse.inv
    assert coarse_inv.sharding.is_fully_replicated


def test_lanczos_mesh_matches_single_device():
    from cusp_autotuned_tpu.eigen import lanczos
    from cusp_autotuned_tpu.eigen.lanczos import LanczosOptions
    A = gallery.poisson5pt(24, 24, format="csr", dtype=np.float32)
    opts = LanczosOptions(iteration_limit=40, seed=3)
    ev1 = np.asarray(lanczos(A, opts))
    mesh = make_row_mesh(jax.devices())
    ev2 = np.asarray(lanczos(A, opts, mesh=mesh))
    np.testing.assert_allclose(ev2, ev1, rtol=1e-4, atol=1e-5)


def test_distributed_spmm_row_sharded():
    """SpMM with the operator row-sharded and the dense block replicated:
    GSPMD keeps the multiply shard-local per row block (no gather of A),
    and the result matches the single-device product."""
    from cusp_autotuned_tpu.ops.multiply import multiply
    from cusp_autotuned_tpu.parallel import distribute_for_solve
    A = gallery.poisson5pt(16, 16, format="csr", dtype=np.float32)
    rng = np.random.RandomState(4)
    X = jnp.asarray(rng.randn(A.num_cols, 8).astype(np.float32))
    ref = np.asarray(jax.jit(multiply, static_argnums=())(A, X))
    mesh = make_row_mesh(jax.devices())
    As = distribute_for_solve(A, mesh)[0]
    Y = jax.jit(multiply)(As, X)
    np.testing.assert_allclose(np.asarray(Y), ref, rtol=1e-5, atol=1e-5)
