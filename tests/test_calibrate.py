"""Device-model calibration (autotune.calibrate) and the cost model's
per-device table.

The analytic cost model's constants must come from a measurement on the
device they describe: a row per device_kind, or a calibration persisted on
that device kind.  On the CPU test backend the measured values describe
the CPU, but the machinery — measure, persist keyed by device kind, load,
apply, refuse an unknown device — is fully checkable."""

import json

import numpy as np
import pytest

from cusp_autotuned_tpu.autotune import calibrate, cost_model
from cusp_autotuned_tpu.gallery import poisson5pt

_KEYS = {"stream_gbps", "dia_eff", "dense_eff", "gather_ns", "segsum_ns"}


def _kind():
    import jax
    return jax.devices()[0].device_kind


def test_calibrate_measures_and_persists(tmp_path, monkeypatch):
    path = str(tmp_path / "device_model.json")
    monkeypatch.setenv("CUSP_TPU_CALIBRATION", path)
    consts = calibrate.calibrate(persist=True, apply=False)
    assert set(consts) == _KEYS
    assert all(np.isfinite(v) and v > 0 for v in consts.values())
    with open(path) as f:
        blob = json.load(f)
    assert blob["constants"]["stream_gbps"] == consts["stream_gbps"]
    assert blob["device_kind"] == _kind()  # keyed by the measuring device

    loaded = calibrate.load(_kind(), path)
    assert loaded == pytest.approx(consts)


def test_load_rejects_other_device_kind(tmp_path):
    path = str(tmp_path / "device_model.json")
    with open(path, "w") as f:
        json.dump({"device_kind": "Some Other Card",
                   "constants": {"stream_gbps": 1.0}}, f)
    assert calibrate.load(_kind(), path) is None


def test_cost_model_auto_loads_calibration(tmp_path, monkeypatch):
    """device_model() prefers constants persisted on this device kind over
    the committed table."""
    path = str(tmp_path / "device_model.json")
    monkeypatch.setenv("CUSP_TPU_CALIBRATION", path)
    consts = {k: 1.0 for k in _KEYS}
    consts["stream_gbps"] = 123.25
    with open(path, "w") as f:
        json.dump({"device_kind": _kind(), "constants": consts}, f)
    monkeypatch.setitem(cost_model.DEVICE_MODELS, _kind(),
                        {k: 7.0 for k in _KEYS})
    assert cost_model.device_model()["stream_gbps"] == 123.25
    pred = cost_model.predict(poisson5pt(16, 16, format="csr",
                                         dtype=np.float32))
    assert "us" in pred["via_dia"]


def test_default_path_prefers_env(monkeypatch):
    monkeypatch.setenv("CUSP_TPU_CALIBRATION", "/tmp/x.json")
    assert calibrate.default_path() == "/tmp/x.json"
    monkeypatch.delenv("CUSP_TPU_CALIBRATION")
    monkeypatch.setenv("CUSP_TPU_TUNING_CACHE", "/tmp/cachedir/tuning.json")
    p = calibrate.default_path("NVIDIA H100 80GB HBM3")
    assert p.startswith("/tmp/cachedir/") and "NVIDIA_H100_80GB_HBM3" in p
    monkeypatch.delenv("CUSP_TPU_TUNING_CACHE")
    p = calibrate.default_path("NVIDIA H100 80GB HBM3")
    assert ".cusp_calibration" in p


def test_calibrate_persists_to_bare_filename(tmp_path, monkeypatch):
    """CUSP_TPU_CALIBRATION set to a bare filename writes to the CWD
    instead of crashing in os.makedirs('') (review finding)."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("CUSP_TPU_CALIBRATION", "model.json")
    calibrate.calibrate(persist=True, apply=False)
    assert (tmp_path / "model.json").exists()


def test_calibrate_apply_registers_this_device(monkeypatch):
    monkeypatch.setattr(cost_model, "DEVICE_MODELS", {})
    monkeypatch.setenv("CUSP_TPU_CALIBRATION", "/nonexistent/x.json")
    assert cost_model.device_model() is None
    consts = calibrate.calibrate(persist=False, apply=True)
    assert cost_model.DEVICE_MODELS[_kind()] == consts
    assert cost_model.device_model() == consts


def test_unknown_device_gets_default_config(monkeypatch, caplog):
    """No row and no persisted calibration: no model pick, the format's
    default configuration, and a log line — never assumed constants."""
    from cusp_autotuned_tpu.kernels.variants import default_config
    monkeypatch.setattr(cost_model, "DEVICE_MODELS", {})
    monkeypatch.setattr(cost_model, "_warned", set())
    monkeypatch.setenv("CUSP_TPU_CALIBRATION", "/nonexistent/x.json")
    A = poisson5pt(20, 20, format="csr", dtype=np.float32)
    assert cost_model.predict(A) == {}
    with caplog.at_level("WARNING"):
        cfg, us = cost_model.recommend_config(A)
    assert cfg == default_config(A) and us is None
    assert "no cost-model constants" in caplog.text
    key = cost_model.model_order_key(A)
    assert key({"impl": "via_dia"}) == key({"impl": "segsum"})


def test_committed_rows_are_complete():
    for kind, row in cost_model.DEVICE_MODELS.items():
        assert set(row) == _KEYS, kind
        assert all(v > 0 for v in row.values()), kind
