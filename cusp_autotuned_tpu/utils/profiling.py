"""Roofline profiling — the rebuild of the reference's KTT hardware-counter
path (main.cu:560-663: measured dram_read_bytes vs an analytic
min_read_bytes model).

Hardware counters aren't exposed here; instead the analytic byte model is
compared against a same-process measured stream bandwidth, the time is
the device time of a profiler trace, and jax.profiler traces can be
captured for deep dives.
"""

from __future__ import annotations

import contextlib
import dataclasses



@dataclasses.dataclass
class RooflineReport:
    time_us: float
    model_bytes: int
    achieved_gbps: float
    stream_gbps: float
    roofline_fraction: float
    gflops: float

    def __str__(self):
        return (f"{self.time_us:.1f} us, {self.achieved_gbps:.1f} GB/s vs "
                f"stream {self.stream_gbps:.1f} GB/s "
                f"({self.roofline_fraction:.1%} of roofline), "
                f"{self.gflops:.2f} GFLOP/s")


def min_read_bytes(A) -> int:
    """Analytic minimum HBM traffic for one SpMV (main.cu:560-580 analogue,
    without the 32-byte-transaction quantization)."""
    import sys
    sys.path.insert(0, ".")
    from benchmarks.bytes_per_spmv import bytes_per_spmv
    return bytes_per_spmv(A)


def profile_spmv(A, x, config=None) -> RooflineReport:
    import jax
    from benchmarks.harness import time_fn_device, stream_bandwidth_gbps
    from cusp_autotuned_tpu.kernels.variants import build_spmv, default_config

    fn = jax.jit(build_spmv(A, config or default_config(A)))
    x = jax.numpy.asarray(x)
    t, _ = time_fn_device(fn, x)
    model = min_read_bytes(A)
    stream = stream_bandwidth_gbps()
    return RooflineReport(
        time_us=t * 1e6,
        model_bytes=model,
        achieved_gbps=model / t / 1e9,
        stream_gbps=stream,
        roofline_fraction=(model / t / 1e9) / stream,
        gflops=2 * A.nnz / t / 1e9,
    )


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a jax.profiler trace (view with TensorBoard/XProf)."""
    import jax
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
