"""Test environment: CPU backend with 8 virtual devices (multi-device
sharding tests run on a virtual mesh), float64 enabled so the SciPy oracle
comparisons can be tight — mirroring the reference's host-backend test
strategy (SURVEY.md §4).  Nothing here needs a GPU; the checks only the
card can make are chip_smoke.py phases."""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

# persistent XLA compile cache, by the library's one rule
# (utils.config.compile_cache_dir): JAX_COMPILATION_CACHE_DIR when set,
# else the checkout's .xla_cache/.  The tuner walks compile one executable
# per configuration, which dominates test wall time; cached executables
# make repeat runs cheap (keyed on HLO hash, so stale entries are
# impossible).
from cusp_autotuned_tpu.utils.config import enable_compile_cache  # noqa: E402

enable_compile_cache(min_compile_secs=0.2)


# constants of a hypothetical device for tests of the cost model's picks:
# the CPU test backend has no row in cost_model.DEVICE_MODELS, and an
# unknown device gets no model pick at all (tests/test_calibrate.py)
_TEST_DEVICE = dict(stream_gbps=2000.0, dia_eff=1.0, dense_eff=1.0,
                    gather_ns=0.02, segsum_ns=0.04)


import pytest  # noqa: E402


@pytest.fixture
def model_device(monkeypatch):
    """Give this (CPU) device a row in the cost model's table."""
    from cusp_autotuned_tpu.autotune import cost_model
    monkeypatch.setenv("CUSP_TPU_CALIBRATION", "/nonexistent/model.json")
    monkeypatch.setitem(cost_model.DEVICE_MODELS,
                        jax.devices()[0].device_kind, dict(_TEST_DEVICE))
    return _TEST_DEVICE
