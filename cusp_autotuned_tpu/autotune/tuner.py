"""The tuner engine.

Parity map to the fork:
  Tuner.tune_iteration   ← tuner.TuneIteration via cusp::ktt::multiply
                           (cusp/ktt/detail/ktt.inl:88-94): run the next
                           untried configuration once, record its time,
                           return its output; once the space is exhausted,
                           keep running the best configuration.
  Tuner.run              ← fixed-configuration tuner.Run
                           (cusp/system/cuda/ktt/multiply.h:80-103).
  Tuner.tune             ← offline tuner.Tune with optional reference
                           validation, searcher, and stop condition
                           (multiply.h:106-153); output is reset between
                           trials so validation stays honest (:134-141).
  reset_tuning           ← cusp::ktt::reset_tuning (ktt.inl:130-142).

Here a "configuration" is a dict of kernel meta-parameters
(kernels.variants); compiling one means jitting a closure that bakes the
config in.  XLA compiles are far costlier than NVRTC, so compiled callables
are cached per (matrix signature, config) and results persist to an on-disk
JSON cache keyed by matrix signature + device kind.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Callable, Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from cusp_autotuned_tpu.autotune.result import ResultStatus, TuningResult
from cusp_autotuned_tpu.autotune.search import DeterministicSearcher, Searcher, StopCondition
from cusp_autotuned_tpu.autotune.space import config_key

TUNABLE_FORMATS = ("dia", "ell", "ellr", "csr", "coo", "hyb")

_log = logging.getLogger(__name__)

_enabled = False
_global_tuner: Optional["Tuner"] = None

DEFAULT_CACHE_ENV = "CUSP_TPU_TUNING_CACHE"


def enable() -> None:
    """Route eligible multiplies through the tuner (cusp::ktt::enable)."""
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def is_enabled() -> bool:
    return _enabled


def get_tuner() -> "Tuner":
    """Lazy global tuner (cusp::ktt::get_tuner, ktt.inl:20-62)."""
    global _global_tuner
    if _global_tuner is None:
        from cusp_autotuned_tpu.utils.config import get_config
        cfg = get_config()
        _global_tuner = Tuner(cache_path=cfg.tuning_cache,
                              log_fn=cfg.log_fn())
    return _global_tuner


def _content_digest(A) -> str:
    """Cheap content fingerprint: exact nnz plus strided samples of the
    index/value arrays.  Compiled kernels close over the matrix data, so two
    same-shaped matrices must not share cache entries; sampling keeps the
    per-call device→host traffic to a few hundred bytes."""
    import hashlib

    h = hashlib.sha1()
    h.update(str(getattr(A, "nnz", 0)).encode())

    def eat(arr):
        arr = arr.reshape(-1)
        k = max(1, arr.shape[0] // 64)
        h.update(np.asarray(arr[::k][:64]).tobytes())

    for leaf in jax.tree_util.tree_leaves(A):
        eat(leaf)
    return h.hexdigest()[:16]


def matrix_signature(A, x=None) -> str:
    """Cache key: format + static layout + dtype + device kind + a content
    fingerprint (compiled kernels bake the matrix data in, so structurally
    identical matrices with different entries must key separately).  A 2-D
    right-hand side (SpMM) keys separately per k — the best kernel for a
    vector is rarely the best for a block of k vectors."""
    dev = jax.devices()[0].device_kind.replace(" ", "_")
    parts = [A.format, f"{A.shape[0]}x{A.shape[1]}", f"dtype={A.dtype}"]
    if x is not None and getattr(x, "ndim", 1) == 2:
        parts.append(f"k={x.shape[1]}")
    if A.format in ("coo", "csr"):
        parts.append(f"nnzp={A.nnz_padded}")
    elif A.format == "dia":
        parts.append(f"ndiag={A.num_diagonals}")
        parts.append(f"offs={hash(A.offsets) & 0xffffffff:x}")
    elif A.format in ("ell", "ellr"):
        parts.append(f"width={A.width}")
    elif A.format == "hyb":
        parts.append(f"w={A.ell.width},coo={A.coo.nnz_padded}")
    parts.append(_content_digest(A))
    parts.append(dev)
    return ":".join(parts)


class Tuner:
    def __init__(self, cache_path: Optional[str] = None,
                 warmup: int = 2, repeats: int = 5,
                 log_fn: Optional[Callable[[str], None]] = None,
                 measure: bool = True,
                 timing_channel: str = "auto"):
        self.cache_path = cache_path
        self.warmup = warmup
        self.repeats = repeats
        # measure=False: validation-only walks (the ktt.cu-style exhaustive
        # tests) record the single validated execution's wall time instead
        # of running the warmup+repeat measurement loop per configuration
        self.measure = measure
        # timing_channel: 'auto' (profiler device time on the GPU, wall
        # elsewhere), 'device' (require the profiler channel), or 'wall'.
        # The device channel is the busy time of the device planes of a
        # jax.profiler trace — free of host dispatch noise (reference
        # analog: per-config counter profiling, dia_multiply.h:168-173).
        if timing_channel not in ("auto", "device", "wall"):
            raise ValueError(f"timing_channel {timing_channel!r}")
        self.timing_channel = timing_channel
        # per-result logging sink (KTT log-redirection analogue,
        # testing/ktt.cu:189-199); None = silent
        self.log_fn = log_fn
        # signature -> {config_key: TuningResult}
        self.results: Dict[str, Dict[str, TuningResult]] = {}
        self._compiled: Dict[tuple, Callable] = {}
        # signature -> compiled best fn once the space is exhausted
        self._best_fn: Dict[str, Callable] = {}
        # signature -> model-ordered configuration walk (dynamic mode)
        self._walk_order: Dict[str, List[Dict[str, Any]]] = {}
        if cache_path and os.path.exists(cache_path):
            self.load(cache_path)

    # -- persistence ---------------------------------------------------------

    def save(self, path: Optional[str] = None) -> None:
        path = path or self.cache_path
        if not path:
            return
        payload = {sig: [r.to_json() for r in res.values()]
                   for sig, res in self.results.items()}
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=1)
        os.replace(tmp, path)

    def load(self, path: str) -> None:
        with open(path) as f:
            payload = json.load(f)
        for sig, results in payload.items():
            store = self.results.setdefault(sig, {})
            for r in results:
                tr = TuningResult.from_json(r)
                store[config_key(tr.configuration)] = tr

    # -- compilation + execution ---------------------------------------------

    def _get_fn(self, A, config: Dict[str, Any], x=None):
        from cusp_autotuned_tpu.kernels.variants import build_spmv
        key = (matrix_signature(A, x), config_key(config))
        fn = self._compiled.get(key)
        if fn is None:
            fn = jax.jit(build_spmv(A, config))
            self._compiled[key] = fn
        return fn

    def _execute(self, A, x, config, *, validate=None) -> TuningResult:
        """Compile + time one configuration; failures become skippable
        statuses (parity: KTT ResultStatus semantics)."""
        t0 = time.perf_counter()
        try:
            fn = self._get_fn(A, config, x)
            y = jax.block_until_ready(fn(x))
        except Exception as e:  # noqa: BLE001 — any compile/run error is a skippable result
            from cusp_autotuned_tpu.utils.exceptions import FormatConversionException
            status = (ResultStatus.DeviceLimitsExceeded
                      if ("RESOURCE_EXHAUSTED" in str(e)
                          or isinstance(e, FormatConversionException))
                      else ResultStatus.CompilationFailed)
            return TuningResult(dict(config), status, error=str(e)[:500])
        compile_ms = (time.perf_counter() - t0) * 1e3

        try:
            if not bool(np.all(np.isfinite(np.asarray(y)))):
                return TuningResult(dict(config), ResultStatus.ComputationFailed,
                                    compilation_ms=compile_ms,
                                    error="non-finite output")
            if validate is not None and not validate(y):
                return TuningResult(dict(config), ResultStatus.ValidationFailed,
                                    compilation_ms=compile_ms)
            device_us = None
            if self.measure:
                best = self._time(fn, x, y)
                device_us = self._time_device(fn, x)
            else:
                # validation-only mode (exhaustive ktt.cu-style walks): no
                # measurement loop at all — the recorded duration is the
                # single validated execution's wall time INCLUDING compile,
                # good enough for the Ok/skippable bookkeeping these walks
                # exist for, not for ranking
                best = compile_ms
        except Exception as e:  # noqa: BLE001
            return TuningResult(dict(config), ResultStatus.ComputationFailed,
                                compilation_ms=compile_ms, error=str(e)[:500])
        return TuningResult(dict(config), ResultStatus.Ok, duration_ms=best,
                            compilation_ms=compile_ms, device_us=device_us)

    def _time_device(self, fn, x) -> Optional[float]:
        """Measured device time per call (µs) from the profiler trace —
        the ranking channel when available.  None on the wall channel and
        where the backend has no device planes (the CPU oracle)."""
        if self.timing_channel == "wall":
            return None
        if self.timing_channel == "auto" and jax.default_backend() != "gpu":
            return None
        from cusp_autotuned_tpu.utils.device_time import device_us_per_call
        return device_us_per_call(fn, jnp.asarray(x), reps=6)

    def _time(self, fn, x, y) -> float:
        """Best wall milliseconds per call over `repeats` calls, after
        `warmup` calls, each ending in block_until_ready."""
        x = jnp.asarray(x)
        for _ in range(self.warmup):
            y = fn(x)
        jax.block_until_ready(y)
        best = float("inf")
        for _ in range(self.repeats):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(x))
            best = min(best, (time.perf_counter() - t0) * 1e3)
        return best

    # -- public engine ---------------------------------------------------------

    def _dynamic_order(self, A, sig) -> List[Dict[str, Any]]:
        """Configuration order for the dynamic walk: the analytic cost model
        puts predicted winners first (each TuneIteration runs on the caller's
        critical path, so trying a predicted-terrible config early costs real
        solve time — a refinement of KTT's searcher-order walk).
        Falls back to the deterministic space order if the model can't
        price this container."""
        order = self._walk_order.get(sig)
        if order is None:
            from cusp_autotuned_tpu.autotune.space import configurations_for
            configs = configurations_for(A)
            # the model needs host triplets; without a host mirror that is
            # a one-time O(nnz) device pull — only worth it while the pull
            # stays cheap next to the walk's XLA compiles
            have_host = (getattr(A, "_host_coo", None) is not None
                         or getattr(A, "_host_scipy", None) is not None)
            if have_host or getattr(A, "nnz", 0) <= 8_000_000:
                from cusp_autotuned_tpu.autotune.cost_model import (
                    model_order_key)
                configs = sorted(configs, key=model_order_key(A))
            order = self._walk_order[sig] = configs
        return order

    def tune_iteration(self, A, x):
        """Run the next untried configuration (or the known best once
        exhausted) and return y = A @ x."""
        sig = matrix_signature(A, x)
        fast = self._best_fn.get(sig)
        if fast is not None:
            return fast(x)
        store = self.results.setdefault(sig, {})
        for config in self._dynamic_order(A, sig):
            ck = config_key(config)
            if ck not in store:
                result = self._execute(A, x, config)
                store[ck] = result
                if result.is_valid():
                    return self._get_fn(A, config, x)(x)
                # failed config: fall through to the default implementation
                from cusp_autotuned_tpu.kernels.variants import default_config
                return self._get_fn(A, default_config(A), x)(x)
        best_fn = self._get_fn(A, self.best_configuration(A, x), x)
        self._best_fn[sig] = best_fn
        return best_fn(x)

    def run(self, A, x, configuration: Dict[str, Any]):
        """y = A @ x with a fixed configuration."""
        return self._get_fn(A, configuration, x)(x)

    def tune(self, A, x, reference_computation=None,
             searcher: Optional[Searcher] = None,
             stop_condition: Optional[StopCondition] = None) -> List[TuningResult]:
        """Offline search over the full constrained space; every configuration
        is timed and (when a reference is given) validated."""
        from cusp_autotuned_tpu.autotune.space import configurations_for
        configs = configurations_for(A)
        order = (searcher or DeterministicSearcher()).order(configs)
        validate = None
        if reference_computation is not None:
            expected = np.asarray(reference_computation(A, x), dtype=np.float64)
            scale = np.linalg.norm(expected) or 1.0

        sig = matrix_signature(A, x)
        store = self.results.setdefault(sig, {})
        out: List[TuningResult] = []
        if stop_condition is not None:
            stop_condition.initialize(len(order))
        for config in order:
            if stop_condition is not None and stop_condition.fulfilled():
                break
            if reference_computation is not None:
                # tolerance follows the configuration's PRECISION CLASS:
                # an opt-in bf16 value-storage config is judged at its own
                # class (~2e-2), f32 configs stay at 1e-4 — per-config
                # validation exactly as KTT does, with class-aware bars
                tol = _tolerance(config.get("value_dtype") or A.dtype)

                def validate(y, _tol=tol):
                    err = np.linalg.norm(
                        np.asarray(y, dtype=np.float64) - expected)
                    return err / scale <= _tol
            result = self._execute(A, x, config, validate=validate)
            store[config_key(config)] = result
            out.append(result)
            # evict the built kernel: each closure retains its planned
            # arrays and compiled executable (~100s of MB on a 1M-nnz
            # matrix), and an exhaustive walk holds the whole space — a
            # measured 38+ GB RSS leak.  Offline results are recorded; the
            # winner recompiles once on first use (the dynamic
            # TuneIteration path keeps its cache — reuse is its point).
            self._compiled.pop((sig, config_key(config)), None)
            if len(out) % 10 == 0:
                # long walks are compile-dominated — persist
                # incrementally so an interrupted walk keeps what it
                # measured
                self.save()
            if self.log_fn is not None:
                dev = (f" dev {result.device_us:.1f} us"
                       if result.device_us is not None else "")
                self.log_fn(
                    f"[tune {matrix_signature(A)}] {result.status.value} "
                    f"{result.duration_ms:.3f} ms{dev} {result.configuration}"
                    + (f" ({result.error})" if result.error else ""))
            if stop_condition is not None:
                stop_condition.update(result)
        self.save()
        return out

    def best_configuration(self, A, x=None) -> Dict[str, Any]:
        """Best MEASURED configuration; with nothing measured yet, the
        analytic cost model's zero-compile pick (the reference can only
        fall back to the static default kernel here — generic/multiply.inl
        dispatch; the rebuild has a model).  The model needs host
        triplets, so device-only containers above the one-time-pull bound
        keep the default, like the dynamic walk's ordering guard."""
        sig = matrix_signature(A, x)
        store = self.results.get(sig, {})
        ok = [r for r in store.values() if r.is_valid()]
        if ok:
            # rank on measured device time when captured, wall time
            # otherwise — TuningResult.ranking_ms
            return dict(min(ok, key=lambda r: r.ranking_ms()).configuration)
        from cusp_autotuned_tpu.kernels.variants import default_config
        have_host = (getattr(A, "_host_coo", None) is not None
                     or getattr(A, "_host_scipy", None) is not None)
        if have_host or getattr(A, "nnz", 0) <= 8_000_000:
            from cusp_autotuned_tpu.autotune.cost_model import (
                recommend_config)
            return recommend_config(A, x)[0]
        return default_config(A)

    def reset_tuning(self, A=None) -> None:
        if A is None:
            self.results.clear()
            self._compiled.clear()
            self._best_fn.clear()
            self._walk_order.clear()
        else:
            sig = matrix_signature(A)
            self.results.pop(sig, None)
            self._best_fn.pop(sig, None)
            self._walk_order.pop(sig, None)
            self._compiled = {k: v for k, v in self._compiled.items()
                              if k[0] != sig}


def _tolerance(dtype) -> float:
    name = str(dtype)
    if "64" in name:
        return 1e-10
    if "bfloat16" in name or "16" in name:
        return 2e-2
    return 1e-4


# -- module-level conveniences (cusp::ktt free functions) ----------------------

def multiply(A, x, configuration: Optional[Dict[str, Any]] = None):
    tuner = get_tuner()
    if configuration is not None:
        return tuner.run(A, x, configuration)
    return tuner.tune_iteration(A, x)


def tune(A, x, reference_computation=None, searcher=None, stop_condition=None):
    return get_tuner().tune(A, x, reference_computation=reference_computation,
                            searcher=searcher, stop_condition=stop_condition)


def reset_tuning(A=None):
    get_tuner().reset_tuning(A)


def tuned_operator(A, x=None, tune_first: bool = False, mesh=None):
    """The tuner's best known configuration for A, packaged as a solver
    operator whose planned arrays travel as jit parameters
    (operators.PlannedOperator) — use as the `A` of any Krylov solve.
    tune_first=True runs the offline search when no results exist yet.

    mesh: distribute the tuned plan over a jax.sharding.Mesh — row bands
    of the diagonal data for via_dia (parallel/sharded_plans), the
    row-sharded container for the XLA container rails.  A configuration
    with no sharded form is replaced by the format's default, with a log
    line."""
    from cusp_autotuned_tpu.kernels.variants import (
        CONTAINER_RAILS, default_config)
    from cusp_autotuned_tpu.operators import planned_operator
    tuner = get_tuner()
    if tune_first and not tuner.results.get(matrix_signature(A, x), {}):
        tuner.tune(A, x if x is not None else
                   np.ones(A.num_cols, np.dtype(A.dtype)))
    cfg = tuner.best_configuration(A, x)
    measured = any(r.is_valid() for r in
                   tuner.results.get(matrix_signature(A, x), {}).values())
    if mesh is not None:
        from cusp_autotuned_tpu.parallel.sharded_plans import (
            shard_planned_dia, shard_planned_operator)
        impl = str(cfg.get("impl", ""))
        if impl == "via_dia":
            from cusp_autotuned_tpu.ops.convert import convert
            sub = {k: v for k, v in cfg.items() if k == "value_dtype"}
            return shard_planned_dia(convert(A, "dia"), mesh, config=sub)
        if impl not in CONTAINER_RAILS:
            _log.warning("tuned_operator(mesh=): %r has no sharded form; "
                         "using the default configuration", impl)
            cfg = default_config(A)
        return shard_planned_operator(planned_operator(A, cfg), mesh)
    try:
        return planned_operator(A, cfg)
    except Exception as e:  # noqa: BLE001 — logged; default rail below
        if measured:     # a measured pick already planned once
            raise
        # an UNMEASURED (cost-model) pick can fail to plan on edge
        # patterns the model's guards don't see
        _log.warning("tuned_operator: model pick %s failed to build (%s: "
                     "%s); using the default configuration", cfg,
                     type(e).__name__, e)
        return planned_operator(A, default_config(A))


def choose_format(A, x=None, formats=TUNABLE_FORMATS,
                  reference_computation=None, tuner: Optional[Tuner] = None):
    """Per-matrix format selection: convert A to each candidate format, tune
    each space, and return (best_container, best_configuration) by measured
    time — the explicit version of what SURVEY.md §2.4 calls per-matrix
    format selection (the dynamic hook does this implicitly via the
    via_dia/rcm_dia moves)."""
    from cusp_autotuned_tpu.ops.convert import convert
    from cusp_autotuned_tpu.utils.exceptions import (
        FormatConversionException, NotImplementedException)

    tuner = tuner or get_tuner()
    if x is None:
        x = np.ones(A.num_cols, np.float32)
    best = None
    for fmt in formats:
        try:
            B = convert(A, fmt)
        except (FormatConversionException, NotImplementedException):
            continue
        tuner.tune(B, x, reference_computation=reference_computation)
        sig = matrix_signature(B)
        ok = [r for r in tuner.results.get(sig, {}).values() if r.is_valid()]
        if not ok:
            continue
        winner = min(ok, key=lambda r: r.duration_ms)
        if best is None or winner.duration_ms < best[2]:
            best = (B, dict(winner.configuration), winner.duration_ms)
    if best is None:
        raise NotImplementedException("no format produced a valid kernel")
    return best[0], best[1]
