"""The platform seams: the device-plane filter of the profiler reduction
(utils.device_time) and the compile-cache location rule (utils.config).
All run on the CPU: the trace reduction is fed synthetic planes shaped
like jax.profiler.ProfileData's."""

import os
from types import SimpleNamespace as NS

import jax
import jax.numpy as jnp
import pytest

from cusp_autotuned_tpu.utils import config, device_time


def _ev(start, dur, name="k"):
    return NS(start_ns=start, duration_ns=dur, name=name)


def _plane(name, *lines):
    return NS(name=name, lines=[NS(name=f"line{i}", events=list(evs))
                                for i, evs in enumerate(lines)])


def test_device_planes_keep_only_devices():
    planes = [_plane("/host:CPU", [_ev(0, 100)]),
              _plane("/host:metadata"),
              _plane("/device:GPU:0", [_ev(0, 10)]),
              _plane("Task Environment"),
              _plane("/device:GPU:1", [_ev(5, 10)])]
    names = [p.name for p in device_time.device_planes(planes)]
    assert names == ["/device:GPU:0", "/device:GPU:1"]


def test_busy_ns_is_none_without_device_planes():
    """A CPU trace has host planes only: no device time, not zero."""
    planes = [_plane("/host:CPU", [_ev(0, 1000), _ev(2000, 500)]),
              _plane("/host:metadata")]
    assert device_time.busy_ns(planes) is None


def test_busy_ns_sums_disjoint_kernels():
    planes = [_plane("/device:GPU:0", [_ev(0, 100), _ev(300, 50)])]
    assert device_time.busy_ns(planes) == 150


def test_busy_ns_unions_overlapping_streams():
    """Kernels on two streams that overlap in time count once; host events
    never count."""
    planes = [_plane("/device:GPU:0",
                     [_ev(0, 100), _ev(500, 100)],      # stream A
                     [_ev(50, 100), _ev(550, 10)]),     # stream B
              _plane("/host:CPU", [_ev(0, 10_000)])]
    assert device_time.busy_ns(planes) == 150 + 100


def test_busy_ns_ignores_zero_length_markers():
    planes = [_plane("/device:GPU:0", [_ev(0, 0), _ev(10, 20), _ev(40, 0)])]
    assert device_time.busy_ns(planes) == 20


def test_device_us_per_call_is_none_on_cpu():
    f = jax.jit(lambda v: v * 2.0)
    assert device_time.device_us_per_call(f, jnp.ones(16), reps=2) is None


def test_device_us_per_call_refuses_a_gpu_trace_without_device_plane(
        monkeypatch):
    """Off the CPU, a trace without a device plane raises instead of
    letting a caller stand wall time in for device time."""
    f = jax.jit(lambda v: v * 2.0)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    with pytest.raises(RuntimeError, match="no device plane"):
        device_time.device_us_per_call(f, jnp.ones(16), reps=2)


def test_compile_cache_dir_honors_jax_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cc"))
    assert config.compile_cache_dir() == str(tmp_path / "cc")


def test_compile_cache_dir_defaults_into_the_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = config.compile_cache_dir()
    root = os.path.dirname(os.path.dirname(os.path.abspath(config.__file__)))
    assert path == os.path.join(os.path.dirname(root), ".xla_cache")


def test_enable_compile_cache_sets_jax_config(monkeypatch, tmp_path):
    old = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cc"))
    try:
        assert config.enable_compile_cache() == str(tmp_path / "cc")
        assert jax.config.jax_compilation_cache_dir == str(tmp_path / "cc")
        assert (tmp_path / "cc").is_dir()
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


@pytest.mark.parametrize("field", ["force_interpret", "vmem_budget_bytes",
                                   "plan_budget_bytes"])
def test_removed_config_knobs_stay_removed(field):
    """Interpret mode comes only from an explicit argument in a test; the
    device-memory budgets of the removed kernels are gone with them."""
    with pytest.raises(AttributeError):
        config.configure(**{field: 1})
