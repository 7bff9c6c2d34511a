"""Analytic per-strategy SpMV cost model (host-side, zero device time).

The reference selects kernels by MEASURING every configuration (KTT
TuneIteration / Tune — cusp/system/cuda/ktt/multiply.h:56-153); the only
analytic model it carries is the DIA DRAM roofline used to audit measured
counters (main.cu:560-580).  Here every configuration costs an XLA compile
(seconds), so the rebuild adds an analytic pre-ranking built from device
constants MEASURED on each card, so format/strategy selection can happen
before anything compiles.

Strategy classes and their prices:

  - default (the format's XLA gather + sorted segment-sum): nnz x
    (gather_ns + segsum_ns);
  - via_dia (DIA diagonals streamed once): stored bytes over
    dia_eff x stream;
  - via_dense (dense GEMV): dense bytes over dense_eff x stream.

The constants come from `autotune.calibrate.calibrate()` on the card, one
row per `device_kind` in DEVICE_MODELS.  A device with no row and no
persisted calibration gets no model pick: the default configuration, with
a log line — never constants assumed from another device.

Uses: `recommend_config(A)` — best predicted strategy without compiling
anything; `ModelGuidedSearcher` (autotune.search) — orders the tuner's
walk best-predicted-first so time-bounded tuning tries winners early.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Optional, Tuple

import numpy as np

_log = logging.getLogger(__name__)

# Device constants per jax device_kind, measured by autotune.calibrate()
# on the card named in the key (power limit noted beside each row).
DEVICE_MODELS: Dict[str, Dict[str, float]] = {
    # calibrate() in chip_smoke.py on an NVIDIA H100 80GB HBM3 at a 700 W
    # power limit (PERF.md, "Kernel decisions on the H100")
    "NVIDIA H100 80GB HBM3": dict(
        stream_gbps=3025.98,  # 256 MB jnp copy, read + write bytes
        dia_eff=1.0138,       # DIA slices rail useful bytes / stream
        dense_eff=1.0213,     # dense GEMV bytes / stream
        gather_ns=0.02277,    # XLA random gather, per element
        segsum_ns=0.15158,    # XLA sorted segment-sum, per element
    ),
}

_CONSTANT_KEYS = ("stream_gbps", "dia_eff", "dense_eff", "gather_ns",
                  "segsum_ns")
_warned: set = set()


def device_model(kind: Optional[str] = None) -> Optional[Dict[str, float]]:
    """The constants for `kind` (default: this process's first device): a
    calibration persisted on this device kind wins over the table row.
    None when neither exists."""
    if kind is None:
        import jax
        kind = jax.devices()[0].device_kind
    from cusp_autotuned_tpu.autotune.calibrate import load
    persisted = load(kind)
    if persisted is not None:
        return {k: persisted[k] for k in _CONSTANT_KEYS}
    row = DEVICE_MODELS.get(kind)
    return dict(row) if row is not None else None


def _host_triplets(A) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                               Tuple[int, int]]:
    """COO triplets on the host, preferring the container's mirror so no
    device pull happens."""
    mirror = getattr(A, "_host_coo", None)
    if mirror is not None:
        row, col, val, shape = mirror
        return (np.asarray(row), np.asarray(col), np.asarray(val),
                tuple(shape))
    from cusp_autotuned_tpu.backend.reference import to_scipy
    S = to_scipy(A)
    if not hasattr(S, "tocoo"):  # dense container
        import scipy.sparse as sp
        S = sp.coo_matrix(S)
    C = S.tocoo()
    return (np.asarray(C.row), np.asarray(C.col), np.asarray(C.data),
            tuple(C.shape))


def pattern_stats(A) -> Dict[str, Any]:
    """Host-side sparsity-pattern summary driving the model terms."""
    row, col, val, (m, n) = _host_triplets(A)
    nnz = int(row.size)
    out: Dict[str, Any] = dict(m=int(m), n=int(n), nnz=nnz,
                               density=nnz / max(m * n, 1))
    if nnz:
        # bincount histogram instead of np.unique: no O(nnz log nnz) sort
        off = col.astype(np.int64) - row.astype(np.int64) + (m - 1)
        num_diagonals = int(np.count_nonzero(
            np.bincount(off, minlength=m + n - 1)))
        deg = np.bincount(row, minlength=m)
        out.update(
            num_diagonals=num_diagonals,
            dia_fill=nnz / max(num_diagonals * m, 1),
            mean_degree=nnz / max(m, 1),
            max_degree=int(deg.max()),
        )
    else:
        out.update(num_diagonals=0, dia_fill=0.0, mean_degree=0.0,
                   max_degree=0)
    return out


def predict(A, x=None, device: Optional[Dict[str, float]] = None,
            allow_low_precision: bool = False) -> Dict[str, Dict[str, Any]]:
    """Predicted SpMV time per strategy class for A (1-D right-hand side).

    Returns {label: {"us": float, "config": dict}} for feasible strategies
    and {label: {"skip": reason}} where the builder's own guard would
    reject (mirroring the skippable-failure semantics the tuner records,
    KTT ResultStatus).  Labels: default, via_dense, via_dia, via_dia_bf16
    (only with allow_low_precision).  `device` gives the constants;
    without it, this device's (device_model).  Empty when the device has
    no constants."""
    from cusp_autotuned_tpu.kernels.variants import default_config
    from cusp_autotuned_tpu.ops.convert import MAX_FILL_RATIO, FILL_THRESHOLD

    dev = device if device is not None else device_model()
    if dev is None:
        return {}
    st = pattern_stats(A)
    m, n, nnz = st["m"], st["n"], st["nnz"]
    itemsize = np.dtype(A.dtype).itemsize
    stream = dev["stream_gbps"] * 1e9
    vec_bytes = (m + n) * itemsize
    out: Dict[str, Dict[str, Any]] = {}

    # XLA default (segment-sum/gather class)
    out["default"] = {
        "us": nnz * (dev["gather_ns"] + dev["segsum_ns"]) * 1e-3,
        "config": default_config(A),
    }

    # dense GEMV (guard mirrors kernels.variants._build_via_dense)
    dense_bytes = m * n * itemsize
    if st["density"] >= 0.25 and dense_bytes <= (32 << 20):
        out["via_dense"] = {
            "us": (dense_bytes + vec_bytes) / (dev["dense_eff"] * stream)
            * 1e6,
            "config": {"impl": "via_dense"},
        }
    else:
        out["via_dense"] = {"skip": "fill < 0.25 or dense data > 32 MB"}

    # DIA rail (guard mirrors ops.convert's fill guard)
    dia_size = st["num_diagonals"] * m
    fill_ratio = dia_size / max(1.0, float(nnz))
    if A.format == "dia" or not (fill_ratio > MAX_FILL_RATIO
                                 and dia_size > FILL_THRESHOLD):
        cfg = (default_config(A) if A.format == "dia"
               else {"impl": "via_dia"})
        stored = dia_size * itemsize
        out["via_dia"] = {
            "us": (stored + vec_bytes) / (dev["dia_eff"] * stream) * 1e6,
            "config": cfg,
        }
        if allow_low_precision and itemsize == 4:
            out["via_dia_bf16"] = {
                "us": (dia_size * 2 + vec_bytes) / (dev["dia_eff"] * stream)
                * 1e6,
                "config": {**cfg, "value_dtype": "bfloat16"},
            }
    else:
        out["via_dia"] = {
            "skip": f"DIA fill ratio {fill_ratio:.1f} > {MAX_FILL_RATIO}"}
    return out


def recommend_config(A, x=None, device: Optional[Dict[str, float]] = None,
                     allow_low_precision: bool = False
                     ) -> Tuple[Dict[str, Any], Optional[float]]:
    """(config, predicted_us) for the best-predicted strategy — strategy
    selection with zero compiles.  On a device with no constants:
    (the format's default config, None), and one log line per device
    kind.  With allow_low_precision the bf16 value-storage DIA rail
    competes (its validation tolerance class is ~1e-2 relative; see
    Tuner._tolerance)."""
    from cusp_autotuned_tpu.kernels.variants import default_config
    pred = predict(A, x, device=device,
                   allow_low_precision=allow_low_precision)
    feasible = {k: v for k, v in pred.items() if "us" in v}
    if not feasible:
        import jax
        kind = jax.devices()[0].device_kind
        if kind not in _warned:
            _warned.add(kind)
            _log.warning("no cost-model constants for device kind %r: "
                         "using the default SpMV configuration (run "
                         "autotune.calibrate.calibrate() on it)", kind)
        return default_config(A), None
    label = min(feasible, key=lambda k: feasible[k]["us"])
    return dict(feasible[label]["config"]), float(feasible[label]["us"])


def model_order_key(A, device: Optional[Dict[str, float]] = None):
    """A sort key over configurations: predicted class time (classes the
    model does not price, and every class on a device without constants,
    keep their relative order).  Used by ModelGuidedSearcher."""
    pred = predict(A, device=device, allow_low_precision=True)

    def us_of(label: str) -> float:
        return float(pred.get(label, {}).get("us", float("inf")))

    default_us = us_of("default")
    class_us = {
        "segsum": default_us, "gather": default_us, "rowlen": default_us,
        "default": default_us,
        "slices": us_of("via_dia") if A.format == "dia" else default_us,
        "via_dense": us_of("via_dense"),
        "via_dia": us_of("via_dia"), "rcm_dia": us_of("via_dia"),
    }

    def key(config: Dict[str, Any]) -> float:
        if not pred:
            return 0.0
        impl = config.get("impl", "default")
        us = class_us.get(impl, float("inf"))
        if config.get("value_dtype") == "bfloat16" and \
                impl in ("via_dia", "rcm_dia", "slices"):
            us = min(us, us_of("via_dia_bf16"))
        return us

    return key
