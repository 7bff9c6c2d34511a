"""Central runtime configuration.

Parity: the reference's configuration surface is compile-time — backend
selection macros (cusp/detail/config/device_system.h), the CUSP_PATH
compile definition locating runtime-compiled kernels (ktt utils.h:10-11),
and per-kernel tuning parameters.  The rebuild replaces those with one
runtime flag module: every knob is an env-var-backed field with a typed
accessor and a programmatic override, so tests and embedding applications
configure the library without touching the environment.

Env vars (all optional):
  CUSP_TPU_TUNING_CACHE    path of the persistent tuning-results JSON
  CUSP_TPU_AUTOTUNE        "1": enable the dynamic tuning hook at import
  CUSP_TPU_LOG             "1": tuner logs every result to stderr
  CUSP_TPU_TUNE_BF16       "1": tuning walks also search bf16 value storage
  JAX_COMPILATION_CACHE_DIR  JAX's own persistent compile cache location
                             (enable_compile_cache)
"""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import Optional


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return int(v) if v else default


def _env_bool(name: str) -> bool:
    return os.environ.get(name, "").strip() in ("1", "true", "yes", "on")


@dataclasses.dataclass
class Config:
    tuning_cache: Optional[str] = dataclasses.field(
        default_factory=lambda: os.environ.get("CUSP_TPU_TUNING_CACHE"))
    autotune_on_import: bool = dataclasses.field(
        default_factory=lambda: _env_bool("CUSP_TPU_AUTOTUNE"))
    log_tuning: bool = dataclasses.field(
        default_factory=lambda: _env_bool("CUSP_TPU_LOG"))
    # opt-in: the tuning walk also searches bf16 plan-value storage
    # (value_dtype axis), validated at its own precision-class tolerance
    # (~2e-2 relative, Tuner._tolerance) instead of the f32 1e-4
    search_low_precision: bool = dataclasses.field(
        default_factory=lambda: _env_bool("CUSP_TPU_TUNE_BF16"))

    def log_fn(self):
        if not self.log_tuning:
            return None
        return lambda msg: print(msg, file=sys.stderr, flush=True)


_config: Optional[Config] = None


def get_config() -> Config:
    global _config
    if _config is None:
        _config = Config()
    return _config


def plan_value_dtype(config: dict, dtype):
    """Storage dtype for PLANNED VALUE arrays (the DIA rails' diagonals):
    the explicit config key `value_dtype: 'bfloat16'` stores them in bf16,
    halving their device-memory stream on the bandwidth-bound SpMV path,
    while the products promote to f32 before the adds.  An extension with
    no reference analogue; rounding each value to 8 mantissa bits costs
    ~4e-3 relative error, so this is an EXPLICIT opt-in: set the
    config key directly, or set search_low_precision (CUSP_TPU_TUNE_BF16)
    to add it to the exhaustive tuning walk, where bf16 configurations are
    validated at their own precision-class tolerance (Tuner._tolerance).
    Full f32 accuracy is recovered by solvers.refine (defect correction)."""
    import numpy as np
    vd = (config or {}).get("value_dtype", 0)
    base = np.dtype(dtype)
    if not vd or vd in ("none", "0"):
        return base
    if str(vd) not in ("bfloat16", "bf16"):
        from cusp_autotuned_tpu.utils.exceptions import (
            NotImplementedException)
        raise NotImplementedException(
            f"value_dtype must be 'bfloat16' (got {vd!r})")
    if base.itemsize <= 2:
        return base                      # already 16-bit storage
    if not np.issubdtype(base, np.floating):
        from cusp_autotuned_tpu.utils.exceptions import (
            NotImplementedException)
        raise NotImplementedException(
            "value_dtype='bfloat16' applies to real floating matrices only")
    import jax.numpy as jnp
    return np.dtype(jnp.bfloat16)


def configure(**kwargs) -> Config:
    """Override configuration fields programmatically (tests, embedders)."""
    cfg = get_config()
    for k, v in kwargs.items():
        if not hasattr(cfg, k):
            raise AttributeError(f"unknown config field {k!r}")
        setattr(cfg, k, v)
    return cfg


def compile_cache_dir() -> str:
    """JAX_COMPILATION_CACHE_DIR when set, else the fixed in-checkout
    `.xla_cache/` (a fixed path: the path is part of the cache key)."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR", "").strip()
    if env:
        return env
    return os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".xla_cache")


def enable_compile_cache(min_compile_secs: float = 0.5) -> str:
    """Turn on JAX's persistent XLA-executable cache at compile_cache_dir().

    The tuner compiles one executable per configuration (the reference pays
    NVRTC milliseconds per config, cusp/system/cuda/ktt/multiply.h:56-77;
    XLA pays seconds — SURVEY.md §7 'hard parts'), so exhaustive walks are
    compile-dominated.  With this cache a re-walk of an already-seen tuning
    space costs only execution time: entries are keyed on the HLO hash, so
    they survive process restarts and are immune to staleness.  Called by
    the entry points (chip_smoke.py, bench.py, the offline tuning CLI)."""
    import jax
    path = compile_cache_dir()
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      float(min_compile_secs))
    return path
