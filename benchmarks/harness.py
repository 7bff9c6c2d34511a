"""Shared benchmark harness (parity: performance/timer.h +
performance/spmv/benchmark.h:85-178 — repeated timed runs reporting GFLOP/s,
GB/s, and L2 error vs the host oracle).

Timing: the device time of a call comes from a jax.profiler trace
(utils.device_time), on the CPU the wall time; the wall time is
the best of a few batches of asynchronously enqueued calls, each batch
ended by block_until_ready.  A same-process copy probe
(autotune.calibrate.stream_gbps) gives the stream bandwidth that roofline
fractions divide by."""

from __future__ import annotations

import time

import numpy as np


def time_fn(f, *args, reps: int = 20, outer: int = 3) -> float:
    """Wall seconds per call: `reps` calls enqueued back to back, ended by
    one block_until_ready, best of `outer` batches after one warm-up."""
    import jax
    jax.block_until_ready(f(*args))
    best = float("inf")
    for _ in range(outer):
        t0 = time.perf_counter()
        for _ in range(reps):
            out = f(*args)
        jax.block_until_ready(out)
        best = min(best, (time.perf_counter() - t0) / reps)
    return best


def time_fn_device(f, *args, reps: int = 20):
    """(device_s, wall_s) per call.  device_s is the device busy time from
    the profiler trace; only on the CPU backend, whose trace has no device
    plane, is it the wall time (device_us_per_call raises elsewhere)."""
    from cusp_autotuned_tpu.utils.device_time import device_us_per_call
    wall = time_fn(f, *args, reps=reps)
    us = device_us_per_call(f, *args, reps=reps)
    return (wall if us is None else us * 1e-6), wall


def stream_bandwidth_gbps(nbytes: int | None = None) -> float:
    """Device-memory stream rate of a plain copy for roofline calibration
    (autotune.calibrate.stream_gbps: 256 MB on an accelerator, over 4x a
    50 MB L2, so the copy streams from device memory)."""
    from cusp_autotuned_tpu.autotune.calibrate import stream_gbps
    return stream_gbps(nbytes)


def l2_error(y, expected) -> float:
    y = np.asarray(y, np.float64)
    expected = np.asarray(expected, np.float64)
    denom = np.linalg.norm(expected)
    return float(np.linalg.norm(y - expected) / (denom if denom else 1.0))
