#!/usr/bin/env python
"""Smoke run of the library's main path on one NVIDIA GPU.

    python chip_smoke.py              # every one-card phase
    python chip_smoke.py --multichip  # only the four-card phase and the
                                      # one-card solves it is compared with

Phases, each printing one line:

  1. device     — JAX runs on a GPU (never falls back to the CPU); the
                  card's name and power limit; the cost model's constants
                  measured on the card by autotune.calibrate;
  2. cg.cu      — the reference's performance/solver/cg.cu configuration:
                  poisson5pt(1000, 1000) float32 through
                  autotune.tuned_operator with nothing tuned, CG to rtol
                  1e-5 in at most 2000 iterations, its iteration count
                  against a float64 CG on the host, its true residual
                  (float64, on the host) <= 2e-3; then the same float32
                  solve refined in float64 (phase_refine) to a true
                  residual <= 1e-5 in at most 2 sweeps;
  3. cg f64     — the same solve in float64 to rtol 1e-10;
  4. sa-amg     — smoothed_aggregation(A, spmv_config={}) and AMG-CG to
                  1e-5, iteration count within 1 of the container
                  hierarchy (spmv_config=None), true residual <= 2e-4;
  5. walks      — autotune.tune over the full space, validated against the
                  host oracle, on poisson5pt 1000^2 (DIA and CSR) and the
                  Williams Economics stand-in: every configuration Ok or a
                  guard-raised skip;
  6. kernels    — device times (profiler trace) of the SpMV rails at
                  working sets of at least 4x the 50 MB L2: the DIA slices
                  and gather rails, and segsum against the vendor bcoo.

The last line of standard output is one JSON object naming the device.
Any failed phase raises, so the script exits non-zero and prints no JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# Limits on the float64 host-checked true residual of float32 iterates,
# which cannot reach the solves' 1e-5 (phase_refine's docstring).  Each is
# about 4x the reading on an H100 80GB HBM3 (cg.cu CG 4.9e-4, AMG-CG
# 4.1e-5), so a regression in the rails' accuracy fails the run.
CG32_RESIDUAL_LIMIT = 2e-3
AMG_RESIDUAL_LIMIT = 2e-4


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def card_line() -> str:
    """Name and power limit of the cards, read by a child process that
    never imports JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def require_gpu(count: int):
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke needs a GPU; JAX found "
                         f"{devs[0].platform!r} devices")
    if len(devs) < count:
        raise SystemExit(f"chip_smoke needs {count} GPUs, found {len(devs)}")
    return devs


def host_cg_iterations(S, b, rtol: float, limit: int) -> int:
    """Plain float64 CG on the host (scipy CSR SpMV): iterations until
    ||r|| <= rtol * ||b||, the Monitor's stopping rule."""
    x = np.zeros_like(b)
    r = b.copy()
    p = r.copy()
    rr = r @ r
    stop = rtol * np.linalg.norm(b)
    for it in range(1, limit + 1):
        q = S @ p
        alpha = rr / (p @ q)
        x += alpha * p
        r -= alpha * q
        rr_new = r @ r
        if np.sqrt(rr_new) <= stop:
            return it
        p = r + (rr_new / rr) * p
        rr = rr_new
    return limit


def true_residual(S, x, b) -> float:
    x = np.asarray(x, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(b - S @ x) / np.linalg.norm(b))


def phase_device(devs):
    from cusp_autotuned_tpu import native
    from cusp_autotuned_tpu.autotune import calibrate, cost_model
    kind = devs[0].device_kind
    say("device", f"platform gpu, kind {kind!r}, count {len(devs)}, native "
        f"host library {'loaded' if native.available() else 'NOT loaded'}")
    committed = cost_model.DEVICE_MODELS.get(kind)
    measured = calibrate.calibrate(persist=False, apply=True)
    say("device", "cost-model constants measured here: "
        + json.dumps({k: round(v, 5) for k, v in measured.items()})
        + f"; committed row: {json.dumps(committed)}")


def phase_cg(A, S, b, rtol, limit, tag, residual_limit=None):
    """CG through tuned_operator; the host-checked true residual must be
    <= residual_limit (default rtol)."""
    import jax
    from cusp_autotuned_tpu import autotune, solvers
    from cusp_autotuned_tpu.operators import IdentityOperator
    from cusp_autotuned_tpu.solvers.cg import _cg_loop
    from cusp_autotuned_tpu.solvers.monitor import Monitor

    op = autotune.tuned_operator(A)
    mon = Monitor(b, limit, rtol)
    x, mon = solvers.cg(op, b, monitor=mon)
    jax.block_until_ready(x)
    t0 = time.perf_counter()
    x, mon = solvers.cg(op, b, monitor=Monitor(b, limit, rtol))
    jax.block_until_ready(x)
    wall = time.perf_counter() - t0
    its = mon.iteration_count()
    res = true_residual(S, x, b)
    ref_its = host_cg_iterations(S, np.asarray(b, np.float64), rtol, limit)
    mem = _cg_loop.lower(op, IdentityOperator(), b, None,
                         *mon.spec()).compile().memory_analysis()
    say(tag, f"{np.dtype(A.dtype).name} rail {op.impl!r}, {its} iterations "
        f"in {wall:.4f} s warm ({wall / max(its, 1) * 1e6:.2f} us/iter), "
        f"true residual {res:.3e} (float64 host, tolerance "
        f"{residual_limit or rtol:g}), host float64 CG {ref_its} "
        f"iterations (tolerance 10 %); "
        f"jitted loop: arguments {mem.argument_size_in_bytes} B, "
        f"temporaries {mem.temp_size_in_bytes} B, generated code "
        f"{mem.generated_code_size_in_bytes} B")
    if not mon.converged():
        raise AssertionError(f"{tag}: CG did not converge in {limit}")
    if res > (residual_limit or rtol):
        raise AssertionError(f"{tag}: true residual {res:.3e} > "
                             f"{residual_limit or rtol:g}")
    if abs(its - ref_its) > 0.1 * ref_its:
        raise AssertionError(f"{tag}: {its} iterations vs host {ref_its}")
    return op


def phase_refine(op, S, b, rtol, limit, tag, sweeps=2):
    """Defect correction around the float32 solve: the residual of the
    float64 iterate is formed on the host in float64, and each sweep
    solves for the correction with the float32 operator on the card.  It
    must reach rtol within `sweeps` sweeps: each float32 solve cuts the
    error by about the float32 solve's own true residual (~5e-4).

    A float32 iterate cannot reach a true relative residual of 1e-5 on
    this system: rounding x to float32 alone leaves ||A dx|| / ||b|| of
    about 4.5 * 6e-8 * ||x|| / ||b||, and ||x|| / ||b|| is about 60 for a
    random b on the 1000^2 grid."""
    import jax.numpy as jnp
    from cusp_autotuned_tpu import solvers
    from cusp_autotuned_tpu.solvers.monitor import Monitor

    b64 = np.asarray(b, np.float64)
    x = np.zeros_like(b64)
    counts = []
    for _ in range(sweeps):
        r = b64 - S @ x
        if np.linalg.norm(r) <= rtol * np.linalg.norm(b64):
            break
        r32 = jnp.asarray(r.astype(np.float32))
        d, mon = solvers.cg(op, r32, monitor=Monitor(r32, limit, rtol))
        counts.append(mon.iteration_count())
        x = x + np.asarray(d, np.float64)
    res = true_residual(S, x, b64)
    say(tag, f"float32 solves refined in float64 on the host: "
        f"{len(counts)} sweeps of {counts} iterations, true residual "
        f"{res:.3e} (float64 host, tolerance {rtol:g})")
    if res > rtol:
        raise AssertionError(f"{tag}: refined residual {res:.3e} > {rtol}")


def phase_amg(A, S, b):
    import jax
    from cusp_autotuned_tpu import solvers
    from cusp_autotuned_tpu.autotune import tuned_operator
    from cusp_autotuned_tpu.precond.aggregation import smoothed_aggregation
    from cusp_autotuned_tpu.solvers.monitor import Monitor

    out = {}
    for label, cfg in (("planned", {}), ("container", None)):
        t0 = time.perf_counter()
        M = smoothed_aggregation(A, spmv_config=cfg)
        setup = time.perf_counter() - t0
        Aop = tuned_operator(A) if cfg is not None else A
        x, mon = solvers.cg(Aop, b, M=M, monitor=Monitor(b, 500, 1e-5))
        jax.block_until_ready(x)
        t0 = time.perf_counter()
        x, mon = solvers.cg(Aop, b, M=M, monitor=Monitor(b, 500, 1e-5))
        jax.block_until_ready(x)
        out[label] = (setup, mon.iteration_count(),
                      time.perf_counter() - t0, true_residual(S, x, b),
                      mon.converged(), len(M.levels))
    for label, (setup, its, wall, res, conv, nl) in out.items():
        # a float32 iterate cannot reach 1e-5 here (phase_refine's
        # docstring); AMG-CG's ten iterations leave ~4e-5
        say("sa-amg", f"{label} hierarchy ({nl} levels + coarse): setup "
            f"{setup:.3f} s, AMG-CG {its} iterations in {wall:.4f} s warm, "
            f"true residual {res:.3e} (float64 host, tolerance "
            f"{AMG_RESIDUAL_LIMIT:g})")
        if not conv:
            raise AssertionError(f"sa-amg {label}: not converged")
        if res > AMG_RESIDUAL_LIMIT:
            raise AssertionError(f"sa-amg {label}: true residual {res:.3e}"
                                 f" > {AMG_RESIDUAL_LIMIT:g}")
    say("sa-amg", "iteration counts agree within 1 (tolerance)")
    if abs(out["planned"][1] - out["container"][1]) > 1:
        raise AssertionError("sa-amg: planned and container iteration "
                             "counts differ by more than 1")


def phase_walks(cases):
    """cases: {name: container}."""
    from cusp_autotuned_tpu import autotune
    from cusp_autotuned_tpu.autotune.result import ResultStatus
    from cusp_autotuned_tpu.backend.reference import reference_spmv

    allowed = (ResultStatus.Ok, ResultStatus.DeviceLimitsExceeded)
    for name, A in cases.items():
        x = np.random.RandomState(0).randn(A.num_cols).astype(np.float32)
        res = autotune.tune(A, x, reference_computation=reference_spmv)
        counts = {}
        for r in res:
            counts[r.status.value] = counts.get(r.status.value, 0) + 1
        bad = [r for r in res if r.status not in allowed]
        if bad:
            raise AssertionError(f"walks {name}: {counts}: " + "; ".join(
                f"{r.status.value} {r.configuration}: {r.error}"
                for r in bad))
        best = min((r for r in res if r.status == ResultStatus.Ok),
                   key=lambda r: r.ranking_ms())
        say("walks", f"{name}: {len(res)} configurations, {counts}; best "
            f"{best.configuration} at {best.device_us} us device time "
            f"(tolerance: relative 2-norm error <= 1e-4 against the float64 "
            f"host oracle, float32 rails)")


def phase_kernels():
    import jax
    import jax.numpy as jnp
    from cusp_autotuned_tpu import gallery
    from cusp_autotuned_tpu.backend.reference import from_scipy
    from cusp_autotuned_tpu.gallery.suite import _fem_band, _scattered
    from cusp_autotuned_tpu.kernels.variants import build_spmv
    from cusp_autotuned_tpu.ops.convert import convert
    from cusp_autotuned_tpu.utils.device_time import device_us_per_call

    def timed(A, cfg, x):
        fn = build_spmv(A, cfg)
        ja = jax.jit(fn.apply)
        y = ja(fn.planned_arrays, x)
        return device_us_per_call(ja, fn.planned_arrays, x, reps=20), y

    dia_cases = [
        ("DIA k=5 poisson5pt 2000^2", lambda: gallery.poisson5pt(
            2000, 2000, format="dia", dtype=np.float32)),
        ("DIA k=27 poisson27pt 128^3", lambda: gallery.poisson27pt(
            128, 128, 128, format="dia", dtype=np.float32)),
        # the Protein stand-in of gallery.suite.williams_suite, 26x its
        # rows: ~160 diagonals, past 200 MB as DIA
        ("via_dia Protein x26", lambda: convert(from_scipy(_fem_band(
            12_000 * 26, 100, block=8, jitter=0.5, seed=1)
            .astype(np.float32), "csr"), "dia")),
    ]
    for name, make in dia_cases:
        A = make()
        x = jnp.asarray(np.random.RandomState(0).randn(A.num_cols)
                        .astype(np.float32))
        nbytes = (A.num_diagonals * A.rows_padded + A.num_rows
                  + A.num_cols) * 4
        us_s, ys = timed(A, {"impl": "slices"}, x)
        us_g, yg = timed(A, {"impl": "gather"}, x)
        err = float(jnp.max(jnp.abs(yg - ys)) / jnp.max(jnp.abs(ys)))
        line = (f"{name}: {nbytes / 1e6:.1f} MB, XLA slices {us_s:.2f} us "
                f"({nbytes / us_s / 1e3:.0f} GB/s), XLA gather "
                f"{us_g:.2f} us (max relative difference {err:.1e}, "
                f"float32, tolerance 1e-5)")
        if err > 1e-5:
            raise AssertionError(f"kernels {name}: rails differ by {err:.1e}")
        say("kernels", line)
        del A

    for scale in (1, 20):
        S = _scattered(120_000 * scale, 6, seed=8).astype(np.float32)
        A = from_scipy(S, "csr")
        x = jnp.asarray(np.random.RandomState(0).randn(A.num_cols)
                        .astype(np.float32))
        us_seg, y1 = timed(A, {"impl": "segsum"}, x)
        us_bcoo, y2 = timed(A, {"impl": "bcoo"}, x)
        err = float(jnp.max(jnp.abs(y1 - y2)) / jnp.max(jnp.abs(y1)))
        say("kernels", f"Economics x{scale} ({S.nnz} nnz, "
            f"{(S.nnz * 8 + 2 * S.shape[0] * 4) / 1e6:.1f} MB): segsum "
            f"{us_seg:.2f} us, bcoo {us_bcoo:.2f} us (max relative "
            f"difference {err:.1e}, float32, tolerance 1e-5)")
        if err > 1e-5:
            raise AssertionError(f"kernels Economics x{scale}: segsum and "
                                 f"bcoo differ by {err:.1e}")


def one_card():
    import jax.numpy as jnp
    from cusp_autotuned_tpu import gallery
    from cusp_autotuned_tpu.backend.reference import to_scipy

    devs = require_gpu(1)
    say("device", card_line())
    phase_device(devs)

    A32 = gallery.poisson5pt(1000, 1000, format="csr", dtype=np.float32)
    S = to_scipy(A32).astype(np.float64).tocsr()
    b32 = jnp.asarray(np.random.RandomState(3).randn(A32.num_rows)
                      .astype(np.float32))
    op32 = phase_cg(A32, S, b32, 1e-5, 2000, "cg.cu",
                    residual_limit=CG32_RESIDUAL_LIMIT)
    phase_refine(op32, S, b32, 1e-5, 2000, "cg.cu")

    A64 = gallery.poisson5pt(1000, 1000, format="csr", dtype=np.float64)
    b64 = jnp.asarray(np.asarray(b32, np.float64))
    phase_cg(A64, S, b64, 1e-10, 10000, "cg f64")

    phase_amg(A32, S, b32)
    from cusp_autotuned_tpu.backend.reference import from_scipy
    from cusp_autotuned_tpu.gallery.suite import _scattered
    phase_walks({
        "poisson5pt 1000^2 dia": gallery.poisson5pt(
            1000, 1000, format="dia", dtype=np.float32),
        "poisson5pt 1000^2 csr": A32,
        # gallery.suite.williams_suite()'s Economics entry
        "Economics csr": from_scipy(
            _scattered(120_000, 6, seed=8).astype(np.float32), "csr"),
    })
    phase_kernels()
    return devs


def four_cards(grid: int = 2000):
    import jax
    import jax.numpy as jnp
    from cusp_autotuned_tpu import gallery, solvers
    from cusp_autotuned_tpu.autotune import tuned_operator
    from cusp_autotuned_tpu.backend.reference import to_scipy
    from cusp_autotuned_tpu.parallel import (distribute_multilevel,
                                             make_row_mesh)
    from cusp_autotuned_tpu.precond.aggregation import smoothed_aggregation
    from cusp_autotuned_tpu.solvers.monitor import Monitor

    devs = require_gpu(4)
    say("device", card_line())
    say("device", f"platform gpu, kind {devs[0].device_kind!r}, count "
        f"{len(devs)}")
    mesh = make_row_mesh(devs[:4])
    # float64: four-way sums round in another order than one card's, and
    # float64 keeps that from moving the iteration at which CG stops
    A = gallery.poisson5pt(grid, grid, format="csr", dtype=np.float64)
    S = to_scipy(A).tocsr()
    b = jnp.asarray(np.random.RandomState(3).randn(A.num_rows))
    rtol = 1e-5

    def solve(op, M=None, mesh_=None):
        kw = {} if mesh_ is None else {"mesh": mesh_}
        x, mon = solvers.cg(op, b, M=M, monitor=Monitor(b, 10000, rtol),
                            **kw)
        jax.block_until_ready(x)
        t0 = time.perf_counter()
        x, mon = solvers.cg(op, b, M=M, monitor=Monitor(b, 10000, rtol),
                            **kw)
        jax.block_until_ready(x)
        return x, mon, time.perf_counter() - t0

    def compare(tag, one, four):
        (x1, m1, t1), (x4, m4, t4) = one, four
        diff = float(jnp.linalg.norm(x4 - x1) / jnp.linalg.norm(x1))
        say("multichip", f"{tag}: one card {m1.iteration_count()} "
            f"iterations in {t1:.4f} s, four cards "
            f"{m4.iteration_count()} iterations in {t4:.4f} s, relative "
            f"solution difference {diff:.2e} (tolerance 1e-6), true "
            f"residual four cards {true_residual(S, x4, b):.3e}")
        if not (m1.converged() and m4.converged()):
            raise AssertionError(f"{tag}: not converged")
        if m1.iteration_count() != m4.iteration_count():
            raise AssertionError(f"{tag}: iteration counts differ")
        if diff > 1e-6:
            raise AssertionError(f"{tag}: solutions differ by {diff:.2e}")

    op4 = tuned_operator(A, mesh=mesh)
    say("multichip", f"tuned_operator(mesh=) rail {op4.impl!r}")
    with mesh:
        four = solve(op4)
    compare(f"CG poisson5pt {grid}^2 float64", solve(tuned_operator(A)),
            four)

    # the hierarchy is distributed once: cg(mesh=) redistributes an
    # undistributed M on every call, and each redistribution builds new
    # band closures that recompile the solve
    M = smoothed_aggregation(A, spmv_config={})
    Md = distribute_multilevel(M, mesh)
    compare(f"AMG-CG poisson5pt {grid}^2 float64 (distribute_multilevel)",
            solve(A, M=M), solve(A, M=Md, mesh_=mesh))
    return devs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multichip", action="store_true",
                    help="run only the four-card phase and the one-card "
                    "solves it is compared with")
    args = ap.parse_args(argv)

    import jax
    jax.config.update("jax_enable_x64", True)
    from cusp_autotuned_tpu.utils.config import enable_compile_cache
    enable_compile_cache()

    devs = four_cards() if args.multichip else one_card()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
