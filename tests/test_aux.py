"""Auxiliary subsystems: call tracing (grapple analogue) and roofline
profiling (SURVEY.md §5)."""

import io

import numpy as np

from cusp_autotuned_tpu import gallery
from cusp_autotuned_tpu.utils.trace import trace
from cusp_autotuned_tpu.utils.profiling import profile_spmv, min_read_bytes


def test_trace_records_eager_verbs():
    import cusp_autotuned_tpu as ct
    A = gallery.poisson5pt(8, 8, format="csr", dtype=np.float64)
    b = np.ones(64)
    with trace() as t:
        y = ct.multiply(A, b)
        B = ct.convert(A, "ell")
        ct.transpose(B)
    counts = t.counts()
    assert counts.get("multiply", 0) >= 1
    assert counts.get("convert", 0) >= 1
    assert counts.get("transpose", 0) >= 1
    buf = io.StringIO()
    t.print(buf)
    out = buf.getvalue()
    assert "multiply(csr<64x64>" in out and "ms" in out
    # patching is undone outside the context
    import sys
    m = sys.modules["cusp_autotuned_tpu.ops.multiply"]
    assert m.multiply.__name__ == "multiply"
    assert ct.multiply.__name__ == "multiply"


def test_trace_nesting():
    import cusp_autotuned_tpu as ct
    A = gallery.poisson5pt(6, 6, format="coo")
    B = gallery.poisson5pt(6, 6, format="coo")
    with trace() as t:
        ct.multiply(A, B)       # spgemm nests under multiply
    names = [(r.name, r.depth) for r in t.records]
    assert ("multiply", 0) in names
    assert any(n == "spgemm" and d >= 1 for n, d in names)


def test_profile_spmv_report():
    A = gallery.poisson5pt(30, 30, format="dia")
    x = np.ones(A.num_cols, np.float32)
    rep = profile_spmv(A, x)
    assert rep.time_us > 0
    assert rep.model_bytes == min_read_bytes(A)
    assert np.isfinite(rep.roofline_fraction)
    assert "GB/s" in str(rep)


def test_config_module():
    """Central config (SURVEY §5 config/flag system): env-backed fields with
    programmatic overrides that the kernel code honors."""
    from cusp_autotuned_tpu.utils.config import get_config, configure
    from cusp_autotuned_tpu import gallery
    from cusp_autotuned_tpu.autotune.space import configurations_for
    cfg = get_config()
    old = cfg.search_low_precision
    A = gallery.poisson9pt(30, 30, format="csr", dtype=np.float32)
    try:
        configure(search_low_precision=True)   # the walk gains bf16 configs
        assert any(c.get("value_dtype") == "bfloat16"
                   for c in configurations_for(A))
        configure(search_low_precision=False)
        assert not any(c.get("value_dtype") == "bfloat16"
                       for c in configurations_for(A))
    finally:
        configure(search_low_precision=old)
    import pytest as _pytest
    with _pytest.raises(AttributeError):
        configure(not_a_field=1)
