"""cusp_autotuned_tpu — sparse linear algebra in JAX, run on an NVIDIA GPU.

A JAX/XLA rebuild of the capability surface of CUSP v0.6.0-dev plus
its KTT autotuning fork (reference: bigno78/cusp-autotuned).  Containers are
JAX pytrees with padded static layouts, the algorithm verbs are jitted
functions dispatched on format type (replacing the reference's Thrust ADL
tag dispatch, cusp/system/detail/adl/*), the SpMV rails are XLA spellings
per format plus format-selection moves, and the KTT autotuning layer
(cusp/ktt/ktt.h) is reborn as `autotune`: a searcher over kernel strategies
and their meta-parameters, with per-matrix format selection and a
persistent on-disk cache.

Layer map (mirrors SURVEY.md §1):
  formats/   containers: COO, CSR, DIA, ELL, ELLR, HYB, permutation, dense
  ops/       verbs: multiply, convert, transpose, elementwise, sort,
             format_utils, verify, print, blas, lapack
  kernels/   SpMV kernel variants (XLA rails + format-selection moves)
  autotune/  the KTT-equivalent tuner: enable/disable, tune, searchers,
             stop conditions, persistent result cache
  solvers/   Krylov: cg, cg_m, bicg, bicgstab, bicgstab_m, cr, gmres + monitor
  precond/   diagonal, AINV, smoothed-aggregation AMG, relaxation
  eigen/     lanczos, lobpcg, arnoldi, spectral radius
  graph/     bfs, connected components, MIS, coloring, RCM, hilbert
  io/        MatrixMarket, binary, DIMACS
  gallery/   poisson / grid / diffusion / random / stencil generators
  parallel/  multi-device sharded SpMV + solvers over a jax.sharding.Mesh
  backend/   NumPy/SciPy reference oracle (the `sequential` backend analogue)
"""

__version__ = "0.1.0"

from cusp_autotuned_tpu.formats import (
    COO, CSR, DIA, ELL, ELLR, HYB, PermutationMatrix,
    is_sparse, is_coo, is_csr, is_dia, is_ell, is_ellr, is_hyb,
)
from cusp_autotuned_tpu.ops.convert import convert
from cusp_autotuned_tpu.ops.multiply import multiply, generalized_spmv, generalized_spgemm
from cusp_autotuned_tpu.ops.transpose import transpose
from cusp_autotuned_tpu.ops.elementwise import add, subtract, elementwise
from cusp_autotuned_tpu.ops import blas
from cusp_autotuned_tpu.ops.verify import is_valid_matrix, assert_is_valid_matrix
from cusp_autotuned_tpu.ops.printing import print_matrix
from cusp_autotuned_tpu.solvers.monitor import Monitor
from cusp_autotuned_tpu.utils.exceptions import (
    CuspException, FormatException, FormatConversionException,
    NotImplementedException, InvalidInputException, RuntimeException,
)

from cusp_autotuned_tpu import autotune
from cusp_autotuned_tpu import formats, ops, solvers, gallery, io, utils
from cusp_autotuned_tpu import eigen, graph, precond, relaxation
from cusp_autotuned_tpu.operators import (
    IdentityOperator, FunctionOperator, PlannedOperator,
    identity_operator, make_linear_operator, planned_operator,
)

# central runtime config (SURVEY §5 config/flag system): honor the
# CUSP_TPU_AUTOTUNE env flag at import
from cusp_autotuned_tpu.utils.config import get_config as _get_config

if _get_config().autotune_on_import:
    from cusp_autotuned_tpu import autotune as _autotune
    _autotune.enable()

