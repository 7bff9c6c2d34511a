"""Kernel-variant registry + per-format tuning spaces.

The fork's per-format tuning spaces (cusp/system/cuda/ktt/{dia,csr,ell,coo}
_multiply.h) are rebuilt here: `impl` is the kernel strategy — the XLA
spellings of each format's SpMV, the format-selection moves (via_dia,
rcm_dia, via_dense) and the vendor library (bcoo).
Configuration values are baked into Python closures that jit specializes —
the analogue of KTT's NVRTC '#define' injection.

Every variant is build(A, config) -> fn with fn(x) -> y traceable and the
planned-operator contract: `fn.planned_arrays` holds the matrix data and
`fn.apply(arrays, x)` computes y from it, so the data rides jit as an
argument instead of an embedded constant (operators.planned_operator).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import jax
import jax.numpy as jnp
import numpy as np

from cusp_autotuned_tpu.autotune.space import TuningSpace
from cusp_autotuned_tpu.utils.exceptions import NotImplementedException

def _planned(arrays, apply: Callable) -> Callable:
    def fn(x):
        return apply(arrays, x)
    fn.planned_arrays = arrays
    fn.apply = apply
    return fn


def _apply_container(arrays, x):
    """The format's XLA SpMV (ops.multiply) on a container carried as a
    planned array."""
    from cusp_autotuned_tpu.ops.multiply import _SPMV
    A = arrays["A"]
    return _SPMV[A.format](A, x)


# -- XLA variants --------------------------------------------------------------

def _build_container(A, config):
    return _planned({"A": A}, _apply_container)


def _build_dia_slices(A, config):
    from cusp_autotuned_tpu.utils.config import plan_value_dtype

    # honor value_dtype on the XLA path too (bf16 data x f32 x promotes to
    # f32 accumulation)
    store = plan_value_dtype(config, A.dtype)
    if store != np.dtype(A.dtype):
        A = dataclasses.replace(A, data=jnp.asarray(A.data).astype(store))
    return _planned({"A": A}, _apply_container)


def _apply_dia_gather(arrays, x):
    A = arrays["A"]
    m, n = A.shape
    idx = (jnp.arange(A.rows_padded, dtype=jnp.int32)[None, :]
           + jnp.asarray(A.offsets, jnp.int32)[:, None])
    xg = x[jnp.clip(idx, 0, n - 1)]
    valid = (idx >= 0) & (idx < n)
    data = A.data if xg.ndim == 2 else A.data[..., None]
    valid = valid if xg.ndim == 2 else valid[..., None]
    return jnp.sum(jnp.where(valid, data * xg, 0), axis=0)[:m]


def _build_dia_gather(A, config):
    return _planned({"A": A}, _apply_dia_gather)


def _apply_ellr_rowlen(arrays, x):
    A = arrays["A"]
    n = A.num_cols
    slot = jnp.arange(A.width, dtype=jnp.int32)[:, None]
    live = slot < A.row_lengths[None, :]
    xg = x[jnp.clip(A.col, 0, n - 1)]
    if xg.ndim == 3:
        prod, live = A.val[..., None] * xg, live[..., None]
    else:
        prod = A.val * xg
    return jnp.sum(jnp.where(live, prod, 0), axis=0)[: A.num_rows]


def _build_ellr_rowlen(A, config):
    """ELLR-semantics SpMV: mask slots by row_lengths instead of the -1
    sentinel (the fork's ELLR=1 kernel rail, kernels/ell_kernel.h:86-213)."""
    return _planned({"A": A}, _apply_ellr_rowlen)


def _apply_bcoo(arrays, x):
    return arrays["M"] @ x


def _build_bcoo(A, config):
    """Vendor-library baseline (jax.experimental.sparse BCOO — the
    reference's cusparse-adapter analogue).  Explicit-config only; not
    part of the tuning walk."""
    from cusp_autotuned_tpu.backend.jsparse import to_bcoo
    return _planned({"M": to_bcoo(A)}, _apply_bcoo)


# -- format-selection moves ----------------------------------------------------

def _build_via_dia(A, config):
    """Format-selection move: re-lay the matrix out as DIA (distinct
    col-row deltas become masked diagonals) and run a DIA kernel.  Viable
    when the diagonal fill is acceptable — the conversion's fill guard
    rejects pathological patterns, which the tuner records as a skippable
    failure (KTT DeviceLimitsExceeded semantics)."""
    from cusp_autotuned_tpu.ops.convert import convert
    D = convert(A, "dia")   # FormatConversionException -> skippable result
    fn = build_spmv(D, {**config, "impl": "slices"})
    fn.plan_stats = {"impl": "via_dia"}
    return fn


def _apply_dense(arrays, x):
    # full float32 precision: a TF32 product keeps ~3 digits
    return jnp.matmul(arrays["D"], x, precision=jax.lax.Precision.HIGHEST)


def _build_via_dense(A, config):
    """Format-selection move: densify and run the plain GEMV/GEMM (the
    reference serves dense patterns through array2d multiply,
    cusp/system/detail/generic/multiply.inl array2d path).  Viable when
    the dense data volume is comparable to the sparse entry stream —
    fill >= 1/4 makes m*n*4 B <= 2x the 8 B/entry sparse traffic — and
    the dense copy stays small; the guard raises the skippable conversion
    failure otherwise, exactly like via_dia's fill guard."""
    from cusp_autotuned_tpu.backend.reference import to_scipy
    from cusp_autotuned_tpu.utils.exceptions import FormatConversionException

    m, n = A.shape
    dense_bytes = m * n * np.dtype(A.dtype).itemsize
    fill = A.nnz / max(m * n, 1)
    if fill < 0.25 or dense_bytes > (32 << 20):
        raise FormatConversionException(
            f"via_dense needs fill >= 0.25 and <= 32 MB dense data "
            f"(fill {fill:.3f}, {dense_bytes >> 20} MB)")
    D = jnp.asarray(to_scipy(A).toarray().astype(A.dtype))
    return _planned({"D": D}, _apply_dense)


def _build_rcm_dia(A, config):
    """Format-selection move: symmetric RCM reorder to shrink bandwidth,
    then DIA.  y = P^T (D @ (P x)) with the permutation applied as cheap
    vector gathers around the hot kernel."""
    from cusp_autotuned_tpu.graph.ordering import symmetric_rcm
    from cusp_autotuned_tpu.ops.convert import convert, _coo_arrays
    from cusp_autotuned_tpu.formats.coo import coo_matrix
    from cusp_autotuned_tpu.utils.exceptions import FormatConversionException

    if A.shape[0] != A.shape[1]:
        raise FormatConversionException(
            "rcm_dia requires a square matrix (symmetric permutation)")
    perm = np.asarray(symmetric_rcm(A).perm)
    inv = np.argsort(perm)
    row, col, val, shape = _coo_arrays(A)
    reord = coo_matrix(inv[row], inv[col], val, shape, sort=True)
    D = convert(reord, "dia")
    inner = build_spmv(D, {**config, "impl": "slices"})

    def apply(arrays, x):
        return inner.apply(arrays["inner"], x[arrays["perm"]])[arrays["inv"]]
    return _planned({"inner": inner.planned_arrays,
                     "perm": jnp.asarray(perm), "inv": jnp.asarray(inv)},
                    apply)


VARIANTS: Dict[str, Dict[str, Callable]] = {
    "dia": {
        "slices": _build_dia_slices,
        "gather": _build_dia_gather,
    },
    "ell": {
        "gather": _build_container,
        "via_dia": _build_via_dia,
        "via_dense": _build_via_dense,
        "rcm_dia": _build_rcm_dia,
        "bcoo": _build_bcoo,
    },
    "ellr": {
        "gather": _build_container,
        "rowlen": _build_ellr_rowlen,
        "via_dia": _build_via_dia,
        "via_dense": _build_via_dense,
        "rcm_dia": _build_rcm_dia,
        "bcoo": _build_bcoo,
    },
    "csr": {
        "segsum": _build_container,
        "via_dia": _build_via_dia,
        "via_dense": _build_via_dense,
        "rcm_dia": _build_rcm_dia,
        "bcoo": _build_bcoo,
    },
    "coo": {
        "segsum": _build_container,
        "via_dia": _build_via_dia,
        "via_dense": _build_via_dense,
        "bcoo": _build_bcoo,
    },
    "hyb": {
        "default": _build_container,
        "via_dia": _build_via_dia,
        "via_dense": _build_via_dense,
        "bcoo": _build_bcoo,
    },
}

_DEFAULTS = {
    "dia": {"impl": "slices"},
    "ell": {"impl": "gather"},
    "ellr": {"impl": "rowlen"},
    "csr": {"impl": "segsum"},
    "coo": {"impl": "segsum"},
    "hyb": {"impl": "default"},
}

# rails whose planned arrays are the container itself ({"A": A}): the
# sharded solve path can place that container over a mesh unchanged
CONTAINER_RAILS = ("slices", "gather", "rowlen", "segsum", "default")


def default_config(A) -> Dict[str, Any]:
    return dict(_DEFAULTS[A.format])


def tuning_space(A) -> TuningSpace:
    """The constrained tuning space for a matrix's format.

    Parameters mirror the fork's spaces: `impl` is the kernel strategy
    (incl. the format-selection moves via_dia / rcm_dia / via_dense — the
    per-matrix format selection SURVEY.md calls for); the opt-in
    `value_dtype` axis adds bf16 diagonal storage on the DIA rails.
    Constraints pin parameters that don't apply — the same trick as the
    fork's PREFETCH_TYPE-only-when-prefetching constraint."""
    from cusp_autotuned_tpu.utils.config import get_config

    fmt = A.format
    space = TuningSpace(parameters=[])
    search_bf16 = get_config().search_low_precision and \
        np.dtype(A.dtype).itemsize == 4
    impls = {
        "dia": ("slices", "gather"),
        "ell": ("gather", "via_dia", "via_dense", "rcm_dia"),
        "ellr": ("gather", "rowlen", "via_dia", "via_dense", "rcm_dia"),
        "csr": ("segsum", "via_dia", "via_dense", "rcm_dia"),
        "coo": ("segsum", "via_dia", "via_dense"),
        "hyb": ("default", "via_dia"),
    }
    if fmt not in impls:
        raise NotImplementedException(f"no tuning space for format {fmt!r}")
    space.add_parameter("impl", impls[fmt])
    if search_bf16 and fmt != "hyb":
        # opt-in low-precision axis: bf16 value storage halves the
        # dominant device-memory stream (f32 accumulate); validated at its
        # own precision class (Tuner._tolerance)
        bf16_rails = ("slices",) if fmt == "dia" else ("via_dia", "rcm_dia")
        space.add_parameter("value_dtype", ("none", "bfloat16"))
        space.add_constraint(("impl", "value_dtype"),
                             lambda i, v: v == "none" or i in bf16_rails)
    return space


def build_spmv(A, config: Dict[str, Any]) -> Callable:
    impl = config.get("impl", _DEFAULTS[A.format]["impl"])
    try:
        builder = VARIANTS[A.format][impl]
    except KeyError:
        raise NotImplementedException(
            f"no variant {impl!r} for format {A.format!r}")
    return builder(A, config)
