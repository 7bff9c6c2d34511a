#!/usr/bin/env python
"""Headline benchmark: DIA SpMV throughput on the 2-D 5-point Poisson
operator (the reference's flagship autotuned format/workload —
performance/spmv + cusp/system/cuda/ktt/dia_multiply.h), plus a compact
sweep of the other SpMV, SpMM, AMG and CG cells.

Prints ONE JSON line.  value = effective GB/s against the per-format
useful-byte model (analogue of performance/spmv/bytes_per_spmv.h), from
the device time of the profiler trace.  vs_baseline = that rate over a
plain copy's stream rate measured on the same device in the same process
(1.0 = memory-bound optimum).  Every line names the device it ran on.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from benchmarks.harness import time_fn_device, stream_bandwidth_gbps


def _sweep():
    import jax
    import jax.numpy as jnp
    from cusp_autotuned_tpu.gallery.suite import _powerlaw, _scattered
    from cusp_autotuned_tpu.gallery import poisson9pt, poisson5pt
    from cusp_autotuned_tpu.backend.reference import from_scipy
    from cusp_autotuned_tpu.operators import jit_operator, planned_operator

    out = {}

    def put_rate(key, fn, x, numer):
        """numer / device time under key, numer / wall time under
        key + '_wall'."""
        t_dev, t_wall = time_fn_device(fn, x)
        out[key] = round(numer / t_dev / 1e9, 2)
        out[key + "_wall"] = round(numer / t_wall / 1e9, 2)

    def planned(A, cfg):
        return jit_operator(planned_operator(A, cfg))

    # CSR segment-sum on poisson9pt, 1M nnz
    A = poisson9pt(333, 333, format="csr", dtype=np.float32)
    x = jnp.asarray(np.random.RandomState(0).randn(A.num_cols)
                    .astype(np.float32))
    put_rate("csr_segsum_p9_1m_gbps", planned(A, {"impl": "segsum"}), x,
             A.nnz * 8 + A.num_rows * 8)

    # power-law matrix (hub rows) through the segment-sum rail
    S = _powerlaw(100_000, 1_000_000, a=1.7, seed=0)
    P = from_scipy(S.tocoo().astype(np.float32), "csr")
    xp = jnp.asarray(np.random.RandomState(1).randn(P.num_cols)
                     .astype(np.float32))
    put_rate("csr_segsum_powerlaw_1m_gbps", planned(P, {"impl": "segsum"}),
             xp, S.nnz * 8 + S.shape[0] * 8)

    # DIA SpMM k=128
    D = poisson5pt(300, 300, format="dia", dtype=np.float32)
    X = jnp.asarray(np.random.RandomState(2).randn(D.num_cols, 128)
                    .astype(np.float32))
    put_rate("dia_spmm_k128_gflops", planned(D, {"impl": "slices"}), X,
             2 * D.nnz * 128)

    # structured SpMM at k=16: the via_dia move serves CSR inputs through
    # the DIA slices rail
    Xk = jnp.asarray(np.random.RandomState(3).randn(A.num_cols, 16)
                     .astype(np.float32))
    put_rate("spmm_p9_k16_via_dia_gflops",
             planned(A, {"impl": "via_dia"}), Xk,
             2 * A.nnz * 16)

    # scattered SpMM (Economics-like pattern) through segment-sum
    Ss = _scattered(120_000, 6, seed=8)
    Ps = from_scipy(Ss.tocoo().astype(np.float32), "csr")
    Xp = jnp.asarray(np.random.RandomState(4).randn(Ps.num_cols, 16)
                     .astype(np.float32) * 0.1)
    put_rate("segsum_spmm_scattered_k16_gflops",
             planned(Ps, {"impl": "segsum"}), Xp, 2 * Ss.nnz * 16)

    # exhaustive DIA-space walk, every configuration validated against the
    # host oracle on the device
    from cusp_autotuned_tpu import gallery as _g
    from cusp_autotuned_tpu.autotune.tuner import Tuner
    from cusp_autotuned_tpu.autotune.result import ResultStatus
    from cusp_autotuned_tpu.backend.reference import reference_spmv
    Aw = _g.make_diagonal_symmetric_matrix(512, 512, 2, 5)
    xw = np.linspace(0, 1, 512).astype(np.float32)
    res = Tuner().tune(Aw, xw, reference_computation=reference_spmv)
    ok = sum(r.status == ResultStatus.Ok for r in res)
    out["walk_dia"] = f"{ok}/{len(res)} ok, rest skippable"
    bad = [r for r in res
           if r.status not in (ResultStatus.Ok,
                               ResultStatus.DeviceLimitsExceeded)]
    if bad:
        out["walk_dia_bad"] = len(bad)

    # cost-model constants measured on this device
    from cusp_autotuned_tpu.autotune.calibrate import calibrate
    out["calibration"] = {k: round(v, 4) for k, v in
                          calibrate(persist=False, apply=True).items()}

    # AMG-CG wall clock (warm)
    from cusp_autotuned_tpu import solvers
    from cusp_autotuned_tpu.precond.aggregation import smoothed_aggregation
    from cusp_autotuned_tpu.solvers.monitor import Monitor
    Aa = poisson5pt(150, 150, format="csr", dtype=np.float64)
    ba = np.ones(Aa.num_rows, np.float64)
    Ma = smoothed_aggregation(Aa)
    solvers.cg(Aa, ba, M=Ma, monitor=Monitor(ba, 100, 1e-10))  # compile
    t0 = time.perf_counter()
    xa, mona = solvers.cg(Aa, ba, M=Ma, monitor=Monitor(ba, 100, 1e-10))
    jax.block_until_ready(xa)
    out["amg_cg_150sq_warm_s"] = round(time.perf_counter() - t0, 4)
    out["amg_cg_iters"] = mona.iteration_count()

    # SA-AMG setup wall at 1M unknowns: warm = second build in-process
    A1m = poisson5pt(1000, 1000, format="csr", dtype=np.float32)
    t0 = time.perf_counter()
    smoothed_aggregation(A1m, spmv_config={})
    out["amg_setup_1m_cold_s"] = round(time.perf_counter() - t0, 3)
    t0 = time.perf_counter()
    smoothed_aggregation(A1m, spmv_config={})
    out["amg_setup_1m_warm_s"] = round(time.perf_counter() - t0, 3)
    del A1m

    # planned-hierarchy V-cycle: the AMG hot path
    Av = poisson5pt(500, 500, format="csr", dtype=np.float32)
    Mv = smoothed_aggregation(Av, spmv_config={})
    bv = jnp.asarray(np.random.RandomState(5)
                     .randn(Av.num_rows).astype(np.float32))
    t_dev, _ = time_fn_device(jax.jit(lambda b_, M_: M_(b_)), bv, Mv)
    out["vcycle_500sq_us"] = round(t_dev * 1e6, 2)
    out["vcycle_rp"] = getattr(Mv.levels[0].Pop, "impl", "?")

    # the reference cg.cu headline config (performance/solver/cg.cu:14-42:
    # poisson5pt 1000x1000, rel-tol 1e-5, <=2000 iters) through
    # autotune.tuned_operator with NOTHING tuned — the analytic cost
    # model's zero-compile pick carries the whole monitored solve in one
    # while_loop dispatch
    from cusp_autotuned_tpu import autotune
    Ac = poisson5pt(1000, 1000, format="csr", dtype=np.float32)
    out["cgcu_impl"] = autotune.get_tuner().best_configuration(Ac) \
        .get("impl", "?")
    opc = autotune.tuned_operator(Ac)
    bc = jnp.asarray(np.random.RandomState(3).randn(Ac.num_rows)
                     .astype(np.float32))
    xc, monc = solvers.cg(opc, bc, monitor=Monitor(bc, 2000, 1e-5))
    jax.block_until_ready(xc)   # compile + warm
    t0 = time.perf_counter()
    xc, monc = solvers.cg(opc, bc, monitor=Monitor(bc, 2000, 1e-5))
    jax.block_until_ready(xc)
    dt = time.perf_counter() - t0
    itc = max(1, int(monc.iteration_count()))
    out["cgcu_1m_iters"] = itc
    out["cgcu_1m_s"] = round(dt, 4)
    out["cgcu_1m_ms_per_iter"] = round(1e3 * dt / itc, 4)
    return out


def main():
    import jax
    import jax.numpy as jnp
    from cusp_autotuned_tpu import gallery
    from cusp_autotuned_tpu.operators import jit_operator, planned_operator
    from cusp_autotuned_tpu.utils.config import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py measures the GPU; JAX found {dev.platform!r} "
                 f"devices")
    grid = 1000
    A = gallery.poisson5pt(grid, grid, format="dia", dtype=np.float32)
    n = A.num_rows
    x = jnp.asarray(np.random.RandomState(0).randn(n).astype(np.float32))
    spmv = jit_operator(planned_operator(A))
    t_dev, t_wall = time_fn_device(spmv, x)
    useful = (A.num_diagonals * A.rows_padded + 2 * n) * 4
    gbps = useful / t_dev / 1e9
    stream_gbps = stream_bandwidth_gbps()
    sweep = _sweep()
    sweep["dia_wall_gbps"] = round(useful / t_wall / 1e9, 2)
    print(json.dumps({
        "metric": f"SpMV DIA poisson5pt({grid}x{grid}) bandwidth "
                  f"(stream baseline {stream_gbps:.0f} GB/s)",
        "value": round(gbps, 2),
        "unit": "GB/s",
        "vs_baseline": round(gbps / stream_gbps, 4),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "sweep": sweep,
    }), flush=True)


if __name__ == "__main__":
    main()
