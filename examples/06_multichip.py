"""Multi-device row-sharded solve over a device mesh — the extension
beyond the single-GPU reference (run on several GPUs, or rehearse with
JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import jax

from cusp_autotuned_tpu import gallery
from cusp_autotuned_tpu.parallel import (
    make_row_mesh, distributed_cg, distributed_cg_shardmap,
)


def main():
    mesh = make_row_mesh(jax.devices())
    n_dev = mesh.devices.size
    A = gallery.poisson5pt(64, 16 * n_dev, format="dia", dtype=np.float32)
    b = np.ones(A.num_rows, np.float32)

    x1, r1 = distributed_cg(A, b, mesh, iterations=50)           # GSPMD
    x2, r2 = distributed_cg_shardmap(A, b, mesh, iterations=50)  # shard_map
    print(f"{n_dev}-device CG: ||r|| = {float(r1):.3e} (gspmd), "
          f"{float(r2):.3e} (shard_map)")

    # the public solver API distributes with a mesh argument: the monitored
    # while_loop runs under GSPMD, dot products become all-reduces
    from cusp_autotuned_tpu import solvers
    x3, mon = solvers.cg(A, b, mesh=mesh)
    print(f"public cg(mesh=): converged={mon.converged()} in "
          f"{mon.iteration_count()} iterations")

    Ac = gallery.poisson5pt(64, 16 * n_dev, format="csr", dtype=np.float32)
    x4, mon4 = solvers.bicgstab(Ac, b, mesh=mesh)
    print(f"public bicgstab(mesh=) on row-aligned CSR: "
          f"converged={mon4.converged()}")

    # bicg distributes too: the setup-time A^T is row-sharded alongside A
    x5, mon5 = solvers.bicg(Ac, b, mesh=mesh)
    print(f"public bicg(mesh=): converged={mon5.converged()}")

    # distributed AMG: fine levels row-sharded, coarse levels and the LU
    # replicated; one V-cycle per CG iteration, all under GSPMD
    from cusp_autotuned_tpu.precond.aggregation import smoothed_aggregation
    from cusp_autotuned_tpu.solvers.monitor import Monitor
    M = smoothed_aggregation(Ac, min_level_size=100)
    x6, mon6 = solvers.cg(Ac, b, M=M, monitor=Monitor(b, 100, 1e-8),
                          mesh=mesh)
    print(f"AMG-preconditioned cg(mesh=): converged={mon6.converged()} in "
          f"{mon6.iteration_count()} iterations")

    # TUNED operators shard too: a planned hierarchy's via_dia plans band
    # over the mesh (each device holds only its row band's diagonal data)
    # and the factored R/P shard their structured-tentative weights
    from cusp_autotuned_tpu.parallel.sharded import distribute_multilevel
    A2 = gallery.poisson5pt(64, 64, format="csr", dtype=np.float32)
    b2 = np.ones(A2.num_rows, np.float32)
    Mp = smoothed_aggregation(A2, spmv_config={}, min_level_size=400)
    Mpd = distribute_multilevel(Mp, mesh, cutoff=2048)
    x7, mon7 = solvers.cg(A2, b2, M=Mpd, monitor=Monitor(b2, 100, 1e-8),
                          mesh=mesh)
    lv0 = Mpd.levels[0]
    print(f"sharded-plan AMG-CG: converged={mon7.converged()} in "
          f"{mon7.iteration_count()} iterations "
          f"(fine Aop = {getattr(lv0.Aop, 'impl', '?')})")

    # a container-rail tuned operator shards its container: tuned_operator
    # (mesh=) never falls back to a single-device operator
    import scipy.sparse as sp
    import jax.numpy as jnp
    from cusp_autotuned_tpu.autotune import tuned_operator
    from cusp_autotuned_tpu.backend.reference import (from_scipy,
                                                      reference_spmv)
    rng = np.random.RandomState(0)
    Ssc = (sp.random(2000, 2000, density=2e-3, random_state=rng,
                     dtype=np.float32)
           + sp.eye(2000, dtype=np.float32)).tocsr()
    Asc = from_scipy(Ssc, "csr")
    op = tuned_operator(Asc, mesh=mesh)
    xs = rng.randn(2000).astype(np.float32)
    with mesh:
        ys = np.asarray(op(jnp.asarray(xs)))
    err = float(np.abs(ys - reference_spmv(Asc, xs)).max())
    print(f"sharded scattered operator ({op.impl}): max |err| = {err:.2e}")

if __name__ == "__main__":
    main()
