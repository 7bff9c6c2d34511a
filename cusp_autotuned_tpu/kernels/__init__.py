"""SpMV kernel variants: XLA-fused implementations and format-selection moves,
exposed through a registry the autotuner searches over (the rebuild of the
fork's runtime-compiled kernel zoo, cusp/system/cuda/ktt/kernels/)."""

from cusp_autotuned_tpu.kernels.variants import (
    build_spmv, default_config, tuning_space, VARIANTS,
)
