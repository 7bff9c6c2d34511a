"""Measure the cost model's device constants on the CURRENT device.

The analytic pre-ranking (autotune.cost_model) prices strategy classes
with five measured rates — the device-memory stream, the DIA and dense
rails' share of it, XLA random gather and XLA sorted segment-sum.
`calibrate()` measures them in a few seconds, can persist them beside the
tuning cache keyed by `device_kind`, and can apply them to this process;
`load()` restores a persisted set, which cost_model.device_model prefers
over its committed table row.

There is no reference analog — the reference re-measures every candidate
config per matrix (KTT Tune, cusp/system/cuda/ktt/multiply.h:106-153) and
never needs a device model; the rebuild models because each candidate
costs an XLA compile.  The closest parity point is the measured-counter
calibration of main.cu:560-663 (dram_read_bytes vs an analytic model).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np


def default_path(device_kind: Optional[str] = None) -> str:
    """Persisted-calibration location: CUSP_TPU_CALIBRATION if set, else
    next to the tuning cache (CUSP_TPU_TUNING_CACHE), else the checkout's
    `.cusp_calibration/`."""
    explicit = os.environ.get("CUSP_TPU_CALIBRATION")
    if explicit:
        return explicit
    if device_kind is None:
        import jax
        device_kind = jax.devices()[0].device_kind
    kind = device_kind.replace(" ", "_").replace("/", "_")
    cache = os.environ.get("CUSP_TPU_TUNING_CACHE")
    base = (os.path.dirname(os.path.abspath(cache)) if cache else
            os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)))), ".cusp_calibration"))
    return os.path.join(base, f"device_model_{kind}.json")


def load(device_kind: Optional[str] = None,
         path: Optional[str] = None) -> Optional[Dict[str, float]]:
    """Constants persisted by a previous calibrate() on this device kind,
    or None.  A file written on a DIFFERENT device kind is ignored."""
    if device_kind is None:
        import jax
        device_kind = jax.devices()[0].device_kind
    path = path or default_path(device_kind)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        blob = json.load(f)
    if blob.get("device_kind") != device_kind:
        return None
    return {k: float(v) for k, v in blob["constants"].items()}


def _seconds_per_call(fn, *args, reps: int = 10) -> float:
    """Device busy time per call from the profiler trace; on the CPU
    backend, whose trace has no device plane, the best wall time of `reps`
    calls (device_us_per_call raises on any other backend without one)."""
    import jax
    from cusp_autotuned_tpu.utils.device_time import device_us_per_call

    us = device_us_per_call(fn, *args, reps=reps)
    if us is not None:
        return us * 1e-6
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def _default_nbytes() -> int:
    """256 MB — over 4x a 50 MB L2 — on an accelerator, 1 MB on the CPU."""
    import jax
    return (256 << 20) if jax.default_backend() != "cpu" else (1 << 20)


def stream_gbps(nbytes: Optional[int] = None) -> float:
    """Device-memory stream rate of a plain copy that XLA cannot elide
    (read + write bytes), over a working set of `nbytes`."""
    import jax
    import jax.numpy as jnp
    n = (nbytes or _default_nbytes()) // 4
    x = jnp.asarray(np.random.RandomState(3).randn(n).astype(np.float32))
    t = _seconds_per_call(jax.jit(lambda v: v * 1.0001), x)
    return 2 * n * 4 / t / 1e9


def measure() -> Dict[str, float]:
    """{stream_gbps, dia_eff, dense_eff, gather_ns, segsum_ns} on the
    current device.  The working sets are 256 MB — over 4x a 50 MB L2 —
    on an accelerator, and 1 MB on the CPU."""
    import jax
    import jax.numpy as jnp
    from cusp_autotuned_tpu import gallery
    from cusp_autotuned_tpu.ops.multiply import spmv_dia

    nbytes = _default_nbytes()
    rng = np.random.RandomState(1)
    stream = stream_gbps(nbytes)

    g = int(np.sqrt(nbytes / 28))     # 5 diagonals + x + y ~ nbytes
    D = gallery.poisson5pt(g, g, format="dia", dtype=np.float32)
    xd = jnp.asarray(rng.randn(D.num_cols).astype(np.float32))
    t = _seconds_per_call(jax.jit(spmv_dia), D, xd)
    dia_bytes = (D.num_diagonals * D.rows_padded + 2 * D.num_rows) * 4
    dia_eff = dia_bytes / t / 1e9 / stream

    side = int(np.sqrt(nbytes / 4))
    M = jnp.asarray(rng.randn(side, side).astype(np.float32))
    xv = jnp.asarray(rng.randn(side).astype(np.float32))
    t = _seconds_per_call(jax.jit(lambda a, v: jnp.matmul(
        a, v, precision=jax.lax.Precision.HIGHEST)), M, xv)
    dense_eff = (side * side + 2 * side) * 4 / t / 1e9 / stream

    ne = nbytes // 16
    gidx = jnp.asarray(rng.randint(0, ne, size=ne).astype(np.int32))
    seg = jnp.asarray(np.sort(rng.randint(0, ne, size=ne)).astype(np.int32))
    xe = jnp.asarray(rng.randn(ne).astype(np.float32))
    gather_s = _seconds_per_call(jax.jit(lambda v, i: v[i]), xe, gidx)
    segsum_s = _seconds_per_call(jax.jit(
        lambda v, s: jax.ops.segment_sum(v, s, num_segments=ne,
                                         indices_are_sorted=True)), xe, seg)
    return dict(stream_gbps=stream, dia_eff=dia_eff, dense_eff=dense_eff,
                gather_ns=gather_s / ne * 1e9, segsum_ns=segsum_s / ne * 1e9)


def calibrate(persist: bool = True, path: Optional[str] = None,
              apply: bool = True) -> Dict[str, float]:
    """Measure the constants on the current device (measure()), optionally
    persist them (JSON keyed by device_kind) and apply them to this
    process (cost_model.DEVICE_MODELS[device_kind])."""
    import jax

    consts = measure()
    kind = jax.devices()[0].device_kind
    if persist:
        p = path or default_path(kind)
        d = os.path.dirname(p)
        if d:   # bare filename = current directory, nothing to create
            os.makedirs(d, exist_ok=True)
        with open(p, "w") as f:
            json.dump({"device_kind": kind, "constants": consts,
                       "measured_at": time.strftime("%Y-%m-%d %H:%M:%S")},
                      f, indent=1)
    if apply:
        from cusp_autotuned_tpu.autotune import cost_model
        cost_model.DEVICE_MODELS[kind] = dict(consts)
    return consts
