"""Measured device time from a jax.profiler trace.

The trace's device planes (`/device:GPU:0`, one line per CUDA stream)
carry one event per kernel the card ran, with its start and duration in
nanoseconds — the rebuild's analog of the reference's per-config
hardware-counter profiling (cusp/system/cuda/ktt/dia_multiply.h:168-173).
Busy time is the union of those intervals, so overlapping kernels on two
streams are not counted twice.  On the CPU backend the trace has no device
plane and every reader returns None; on an accelerator a missing device
plane is an error, never a silent switch to wall time.  The Tuner ranks
walk configurations on this channel; the reduction from trace to busy time
is `busy_ns`, kept separate so a test can feed it a synthetic trace.
"""

from __future__ import annotations

import glob
import os
import tempfile
from typing import Iterable, Optional


def device_planes(planes) -> list:
    """The accelerator planes of a trace: `/device:<PLATFORM>:<id>`, never
    the host planes (`/host:CPU`, `/host:metadata`)."""
    return [p for p in planes if str(p.name).startswith("/device:")]


def busy_ns(planes: Iterable) -> Optional[int]:
    """Union of event intervals over the device planes' lines, in ns; None
    when the trace has no device plane.  Planes and lines follow
    `jax.profiler.ProfileData` (`.name`, `.lines`, `.events`, events with
    `.start_ns` and `.duration_ns`)."""
    dev = device_planes(planes)
    if not dev:
        return None
    spans = sorted((int(e.start_ns), int(e.start_ns) + int(e.duration_ns))
                   for p in dev for line in p.lines for e in line.events
                   if e.duration_ns > 0)
    total, cur_lo, cur_hi = 0, None, None
    for lo, hi in spans:
        if cur_hi is None or lo > cur_hi:
            if cur_hi is not None:
                total += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    if cur_hi is not None:
        total += cur_hi - cur_lo
    return total


def device_us_per_call(fn, *args, reps: int = 8) -> Optional[float]:
    """Device busy time (µs) of one `fn(*args)` call, averaged over `reps`
    calls traced after one untraced warm-up call.  None on the CPU backend,
    whose trace has no device plane; on any other backend a trace without
    one raises."""
    import jax
    from jax.profiler import ProfileData

    jax.block_until_ready(fn(*args))          # compile outside the trace
    with tempfile.TemporaryDirectory() as td:
        with jax.profiler.trace(td):
            for _ in range(reps):
                out = fn(*args)
            jax.block_until_ready(out)
        files = sorted(glob.glob(os.path.join(
            td, "plugins", "profile", "*", "*.xplane.pb")))
        ns = (busy_ns(ProfileData.from_file(files[-1]).planes)
              if files else None)
    if ns is not None:
        return ns / reps / 1e3
    if jax.default_backend() == "cpu":
        return None
    raise RuntimeError(f"the profiler trace on the "
                       f"{jax.default_backend()!r} backend has no device "
                       f"plane; refusing to stand wall time in for it")
