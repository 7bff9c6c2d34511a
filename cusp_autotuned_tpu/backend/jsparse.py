"""Optional vendor-library adapter: jax.experimental.sparse (BCOO).

Parity: the reference's cusparse/cublas adapter paths
(cusp/system/cuda/detail/cusparse/cusparse_spmv.h:72,
cusparse_csr_matrix.h; cublas binding cublas/execute_with_cublas.h:37-86)
— optional vendor-library baselines that sit NEXT TO the native kernels
and share the same verbs.  Here the "vendor sparse library" is
jax.experimental.sparse; these adapters convert containers to/from BCOO
and expose a BCOO-backed SpMV usable as an explicit `impl="bcoo"`
configuration (kept out of the default tuning walk: it exists as a
baseline, not a contender)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def to_bcoo(A):
    """Any container -> jax.experimental.sparse.BCOO (sorted indices)."""
    from jax.experimental import sparse as jsp
    from cusp_autotuned_tpu.ops.convert import _coo_arrays
    row, col, val, shape = _coo_arrays(A)
    idx = jnp.stack([jnp.asarray(np.asarray(row, np.int32)),
                     jnp.asarray(np.asarray(col, np.int32))], axis=1)
    return jsp.BCOO((jnp.asarray(val), idx), shape=tuple(shape),
                    indices_sorted=True, unique_indices=True)


def from_bcoo(M, format: str = "coo"):
    """jax.experimental.sparse.BCOO -> container in the given format."""
    from cusp_autotuned_tpu.formats.coo import coo_matrix
    from cusp_autotuned_tpu.ops.convert import convert
    idx = np.asarray(M.indices)
    val = np.asarray(M.data)
    C = coo_matrix(idx[:, 0], idx[:, 1], val, tuple(M.shape), sort=True)
    return C if format == "coo" else convert(C, format)


def bcoo_spmv(A):
    """Build fn(x) -> A @ x through the vendor library (BCOO matmul)."""
    M = to_bcoo(A)

    def fn(x):
        return M @ x
    return fn
