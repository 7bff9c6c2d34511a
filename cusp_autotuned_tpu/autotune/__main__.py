"""Offline tuning driver: `python -m cusp_autotuned_tpu.autotune A.mtx`.

The front door the reference exposes through its profiling driver
(main.cu): load a matrix, run the exhaustive offline search with oracle
validation, report every configuration's status/time and the winner, and
leave the result in the persistent cache so later `multiply`/solver runs
dispatch the tuned kernel immediately.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cusp_autotuned_tpu.autotune",
        description="Offline-tune SpMV for a matrix (KTT tune() analogue)")
    ap.add_argument("matrix", help=".mtx/.bin path, poisson5pt:N[xM], "
                    "or suite:<Williams name>[:scale] (structure-matched "
                    "stand-in, e.g. suite:Economics)")
    ap.add_argument("--format", default="csr",
                    help="container format to tune (default csr)")
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--choose-format", action="store_true",
                    help="also search across formats and report the best")
    ap.add_argument("--json", action="store_true",
                    help="emit one JSON line instead of the table")
    ap.add_argument("--budget", type=float, default=None, metavar="SECONDS",
                    help="stop the walk after this much wall time "
                    "(TuningDuration stop condition); implies the "
                    "model-guided order so the likely winners are "
                    "measured before the long tail")
    ap.add_argument("--order", choices=["deterministic", "model", "random"],
                    default=None,
                    help="walk order (default: model when --budget is "
                    "set, else deterministic)")
    ap.add_argument("--channel", choices=["auto", "device", "wall"],
                    default="auto",
                    help="timing channel for ranking: profiler device "
                    "time ('auto' uses it on the GPU) or the wall "
                    "channel")
    args = ap.parse_args(argv)

    from cusp_autotuned_tpu import autotune, gallery, io
    from cusp_autotuned_tpu.backend.reference import reference_spmv
    from cusp_autotuned_tpu.utils.config import enable_compile_cache

    # offline walks are compile-dominated (one XLA compile per config);
    # the persistent executable cache makes re-walks execution-bound
    enable_compile_cache()

    # a full walk can run for a long time: always stream per-config
    # progress to stderr (the table/JSON stays on stdout)
    tuner = autotune.get_tuner()
    if tuner.log_fn is None:
        tuner.log_fn = lambda m: print(m, file=sys.stderr, flush=True)
    tuner.timing_channel = args.channel

    dtype = np.dtype(args.dtype)
    if args.matrix.startswith("poisson5pt:"):
        dims = args.matrix.split(":", 1)[1]
        nx, _, ny = dims.partition("x")
        A = gallery.poisson5pt(int(nx), int(ny or nx), format=args.format,
                               dtype=dtype)
    elif args.matrix.startswith("suite:"):
        from cusp_autotuned_tpu.backend.reference import from_scipy
        from cusp_autotuned_tpu.gallery.suite import williams_suite
        parts = args.matrix.split(":")
        name, scale = parts[1], float(parts[2]) if len(parts) > 2 else 1.0
        def norm(t):
            return t.lower().replace("/", "").replace(" ", "")
        suite = williams_suite(scale)
        match = [S for n, S in suite.items() if norm(n) == norm(name)]
        if not match:
            ap.error(f"unknown suite matrix {name!r}; "
                     f"one of {list(suite)}")
        S, = match
        A = from_scipy(S.tocoo().astype(dtype), args.format)
    elif args.matrix.endswith(".bin"):
        A = io.read_binary_file(args.matrix, format=args.format)
    else:
        A = io.read_matrix_market_file(args.matrix, format=args.format,
                                       dtype=dtype)

    rng = np.random.RandomState(0)
    x = rng.randn(A.num_cols).astype(dtype)

    searcher = stop = None
    order = args.order or ("model" if args.budget else None)
    if order == "model":
        from cusp_autotuned_tpu.autotune.search import ModelGuidedSearcher
        searcher = ModelGuidedSearcher(A)
    elif order == "random":
        from cusp_autotuned_tpu.autotune.search import RandomSearcher
        searcher = RandomSearcher()
    if args.budget:
        from cusp_autotuned_tpu.autotune.search import TuningDuration
        stop = TuningDuration(args.budget)

    results = autotune.tune(A, x, reference_computation=reference_spmv,
                            searcher=searcher, stop_condition=stop)
    best = autotune.get_tuner().best_configuration(A, x)
    rows = [{"config": r.configuration, "status": r.status.value,
             "time_ms": (round(r.duration_ms, 3)
                         if np.isfinite(r.duration_ms) else None),
             **({"device_us": round(r.device_us, 1)}
                if r.device_us is not None else {})}
            for r in results]
    out = {"matrix": args.matrix, "format": A.format,
           "shape": [A.num_rows, A.num_cols], "nnz": int(A.nnz),
           "configs": len(rows),
           "ok": sum(r["status"] == "Ok" for r in rows),
           "channel": ("device" if any("device_us" in r for r in rows)
                       else "wall"),
           "best": best,
           "results": rows}
    if args.budget:
        out["budget_s"] = args.budget
    if order:
        out["order"] = order
    # self-describing truncation (no silent caps): when a budget stopped
    # the walk early, record how much of the space went unwalked and what
    # the model predicts for the best unwalked configuration relative to
    # the walked region — a reader of the artifact alone can tell whether
    # the unwalked tail plausibly hides a winner
    from cusp_autotuned_tpu.autotune.space import (
        configurations_for, config_key)
    space = configurations_for(A)
    out["space_size"] = len(space)
    if len(rows) < len(space):
        walked = {config_key(r.configuration) for r in results}
        unwalked = [c for c in space if config_key(c) not in walked]
        note = {"unwalked": len(unwalked)}
        try:
            from cusp_autotuned_tpu.autotune.cost_model import (
                model_order_key)
            key = model_order_key(A)
            best_un = min(unwalked, key=key)
            walked_best_pred = min(key(r.configuration) for r in results
                                   if r.status.value == "Ok")
            note.update(
                model_best_unwalked=best_un,
                model_best_unwalked_us=round(key(best_un), 1),
                model_best_walked_us=round(walked_best_pred, 1),
                unwalked_predicted_worse=bool(
                    key(best_un) >= walked_best_pred))
        except Exception:  # noqa: BLE001 — the model is best-effort
            pass
        out["coverage"] = note
    if args.choose_format:
        B, cfg = autotune.choose_format(A, x)
        out["best_format"] = B.format
        out["best_format_config"] = cfg

    if args.json:
        print(json.dumps(out))
    else:
        for r in rows:
            t = f"{r['time_ms']:.3f} ms" if r["time_ms"] is not None else "-"
            print(f"{r['status']:24s} {t:>12s}  {r['config']}")
        print(f"\n{out['ok']}/{out['configs']} Ok; best: {best}")
        if args.choose_format:
            print(f"best format: {out['best_format']} "
                  f"({out['best_format_config']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
