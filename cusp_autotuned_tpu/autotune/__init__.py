"""Autotuning layer — the rebuild of the fork's KTT integration
(cusp/ktt/ktt.h:14-124 and cusp/system/cuda/ktt/).

Public API parity:
  enable() / disable()          — cusp::ktt::enable/disable
  is_enabled()                  — (hook guard, generic/multiply.inl:141-149)
  get_tuner()                   — cusp::ktt::get_tuner (lazy global tuner)
  multiply(A, x)                — one dynamic tuning step per call (ktt.h:35-43)
  multiply(A, x, configuration) — run a fixed configuration (ktt.h:62-72)
  tune(A, x, ...)               — offline search with per-config validation
                                  (ktt.h:90-101)
  reset_tuning(A)               — clear accumulated results (ktt.h:117-124)

Instead of NVRTC-compiled CUDA text, configurations are XLA kernel
strategies and their knobs (the SpMV rail, format selection, bf16 value
storage); validation compares against the SciPy reference oracle.
"""

from cusp_autotuned_tpu.autotune.tuner import (
    Tuner, get_tuner, enable, disable, is_enabled,
    multiply, tune, reset_tuning, choose_format, tuned_operator,
    TUNABLE_FORMATS,
)
from cusp_autotuned_tpu.autotune.space import (
    TuningSpace, Parameter, configurations_for,
)
from cusp_autotuned_tpu.autotune.result import (
    ResultStatus, TuningResult,
)
from cusp_autotuned_tpu.autotune.search import (
    DeterministicSearcher, RandomSearcher, ModelGuidedSearcher,
    StopCondition, TuningDuration, ConfigurationCount,
    ConfigurationFraction,
)
from cusp_autotuned_tpu.autotune.cost_model import (
    predict, recommend_config, pattern_stats,
)
