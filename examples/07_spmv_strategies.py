"""The unstructured SpMV strategy menu and the benchmark suite.

The tuner picks among kernel STRATEGIES per matrix (the fork's per-format
tuning spaces, cusp/system/cuda/ktt/*_multiply.h, rebuilt in JAX):
  - segsum      XLA gather + sorted segment-sum (the safe default)
  - bcoo        the vendor library (jax.experimental.sparse BCOO)
  - via_dia     re-layout as DIA and run the diagonal kernel (banded
                patterns: stencils, FEM)
  - rcm_dia     RCM-reorder to shrink the bandwidth, then via_dia
  - via_dense   densify and run a GEMV (dense-enough patterns)
Strategies whose guard rejects a pattern are skipped, as in the tuner.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp

from cusp_autotuned_tpu import gallery
from cusp_autotuned_tpu.backend.reference import from_scipy, reference_spmv
from cusp_autotuned_tpu.kernels.variants import build_spmv
from cusp_autotuned_tpu.gallery.suite import williams_suite
from cusp_autotuned_tpu.utils.exceptions import FormatConversionException

# a banded FEM-like matrix and a power-law graph from the suite stand-ins
suite = williams_suite(scale=0.05)
for name in ("FEM/Cantilever", "Webbase"):
    S = suite[name]
    A = from_scipy(S.tocoo().astype(np.float32), "csr")
    x = np.linspace(-1, 1, A.num_cols).astype(np.float32)
    ref = reference_spmv(A, x)
    for impl in ("segsum", "bcoo", "via_dia", "rcm_dia", "via_dense"):
        cfg = {"impl": impl}
        try:
            y = np.asarray(jax.jit(build_spmv(A, cfg))(jnp.asarray(x)))
            err = np.linalg.norm(y - ref) / (np.linalg.norm(ref) or 1.0)
            print(f"{name:16s} {impl:8s} rel err {err:.2e}")
        except FormatConversionException as e:  # a guard-raised skip
            print(f"{name:16s} {impl:8s} skipped ({type(e).__name__})")

print("\nfull sweep: python benchmarks/spmv_suite.py --scale 1.0")
