"""Autotuner tests — the rebuild of testing/ktt.cu: enumerate the ENTIRE
tuning space per format on several matrices and validate every
configuration's output against the reference oracle, treating failed
configurations as skippable only for legitimate statuses."""

import os

import numpy as np
import pytest

import cusp_autotuned_tpu as ct
from cusp_autotuned_tpu import autotune, gallery
from cusp_autotuned_tpu.autotune import (
    ResultStatus, DeterministicSearcher, RandomSearcher,
    ConfigurationCount, TuningDuration,
)
from cusp_autotuned_tpu.autotune.tuner import Tuner, matrix_signature
from cusp_autotuned_tpu.autotune.space import configurations_for, config_key
from cusp_autotuned_tpu.backend.reference import reference_spmv, from_scipy
from tests.util import example_matrices, build


def _matrices():
    """Small matrices covering the tuned formats (parity: ktt.cu:214-256
    hand-written examples + generated diagonals)."""
    out = {}
    out["dia_sym"] = gallery.make_diagonal_symmetric_matrix(300, 300, 3, 5)
    out["dia_poisson"] = gallery.poisson5pt(17, 19, format="dia")
    S = example_matrices()["tri37"]
    for fmt in ("csr", "ell", "ellr", "coo"):
        out[f"{fmt}_tri"] = build(S, fmt)
    out["ell_rand"] = build(example_matrices()["rand50x40"], "ell")
    # wide scattered rectangular matrix: every rail's guards and
    # validation on a pattern unlike the small banded ones above
    import scipy.sparse as sp
    rng = np.random.RandomState(3)
    S = sp.random(2000, 40000, density=1.5e-4, random_state=rng,
                  format="csr", dtype=np.float32)
    out["csr_scatter_mw"] = from_scipy(S, "csr", dtype=np.float32)
    return out


ACCEPTABLE_FAILURES = {ResultStatus.DeviceLimitsExceeded,
                       ResultStatus.CompilationFailed}


@pytest.mark.parametrize("name", list(_matrices()))
def test_check_all_configurations(name):
    """Every configuration in the space must either validate against the
    oracle or fail with a skippable status (parity:
    CheckAllConfigurations + assert_tunning_results_valid, ktt.cu:84-206)."""
    A = _matrices()[name]
    rng = np.random.RandomState(1)
    x = rng.randn(A.num_cols).astype(np.float32)
    tuner = Tuner(measure=False)
    results = tuner.tune(A, x, reference_computation=reference_spmv)
    assert len(results) == len(configurations_for(A))
    assert any(r.status == ResultStatus.Ok for r in results)
    for r in results:
        assert r.status == ResultStatus.Ok or r.status in ACCEPTABLE_FAILURES, \
            f"config {r.configuration}: {r.status} {r.error}"
        if r.status == ResultStatus.Ok:
            assert np.isfinite(r.duration_ms)


def test_validation_rejects_wrong_kernel(monkeypatch):
    """A kernel producing wrong output must be recorded ValidationFailed."""
    A = gallery.poisson5pt(8, 8, format="dia")
    x = np.ones(64, np.float32)
    tuner = Tuner()
    from cusp_autotuned_tpu.kernels import variants

    def bad_builder(A, config):
        return lambda x: x[: A.num_rows] * 0 + 42.0

    monkeypatch.setitem(variants.VARIANTS["dia"], "gather", bad_builder)
    results = tuner.tune(A, x, reference_computation=reference_spmv)
    by_impl = {r.configuration["impl"]: r for r in results}
    assert by_impl["gather"].status == ResultStatus.ValidationFailed
    assert by_impl["slices"].status == ResultStatus.Ok
    # best_configuration must never pick the invalid one
    assert tuner.best_configuration(A)["impl"] != "gather"


def test_dynamic_tune_iteration_mode():
    """enable() + repeated multiply walks the space one configuration per
    call, then settles on the best (parity: ktt.h:35-43 one TuneIteration
    per multiply)."""
    A = gallery.make_diagonal_symmetric_matrix(256, 256, 2, 3)
    x = np.linspace(0, 1, 256).astype(np.float32)
    expect = reference_spmv(A, x)
    tuner = autotune.get_tuner()
    tuner.reset_tuning()
    autotune.enable()
    try:
        n_cfg = len(configurations_for(A))
        for _ in range(n_cfg + 3):
            y = ct.multiply(A, x)
            np.testing.assert_allclose(np.asarray(y), expect,
                                       rtol=1e-4, atol=1e-4)
    finally:
        autotune.disable()
    sig = matrix_signature(A)
    assert len(tuner.results[sig]) == n_cfg


def test_fixed_configuration_multiply():
    A = gallery.poisson5pt(10, 10, format="dia")
    x = np.ones(100, np.float32)
    y = autotune.multiply(A, x, configuration={"impl": "gather"})
    np.testing.assert_allclose(np.asarray(y), reference_spmv(A, x), rtol=1e-4)


def test_reset_tuning():
    A = gallery.poisson5pt(6, 6, format="dia")
    x = np.ones(36, np.float32)
    tuner = Tuner()
    tuner.tune(A, x)
    assert tuner.results
    tuner.reset_tuning(A)
    assert matrix_signature(A) not in tuner.results


def test_cache_persistence(tmp_path):
    """Tuning results survive a tuner restart via the on-disk cache
    (the rebuild's upgrade over KTT's in-process-only results)."""
    path = str(tmp_path / "tuning.json")
    A = gallery.make_diagonal_symmetric_matrix(200, 200, 1, 3)
    x = np.ones(200, np.float32)
    t1 = Tuner(cache_path=path)
    results = t1.tune(A, x, reference_computation=reference_spmv)
    assert os.path.exists(path)
    t2 = Tuner(cache_path=path)
    sig = matrix_signature(A)
    assert set(t2.results[sig]) == set(t1.results[sig])
    assert t2.best_configuration(A) == t1.best_configuration(A)


def test_searchers_and_stop_conditions():
    A = gallery.poisson5pt(8, 8, format="dia")
    x = np.ones(64, np.float32)
    cfgs = configurations_for(A)
    det = DeterministicSearcher().order(cfgs)
    assert det == cfgs
    rnd = RandomSearcher(seed=3).order(cfgs)
    assert sorted(map(config_key, rnd)) == sorted(map(config_key, cfgs))

    tuner = Tuner()
    results = tuner.tune(A, x, stop_condition=ConfigurationCount(2))
    assert len(results) == 2
    tuner.reset_tuning()
    results = tuner.tune(A, x, stop_condition=TuningDuration(0.0))
    assert len(results) == 0


def test_format_selection_moves():
    """via_dia / rcm_dia variants must validate on a banded CSR matrix —
    the per-matrix format selection the rebuild adds on top of KTT."""
    S = example_matrices()["tri37"]
    A = build(S, "csr")
    x = np.linspace(-1, 1, 37).astype(np.float32)
    tuner = Tuner(measure=False)
    results = tuner.tune(A, x, reference_computation=reference_spmv)
    ok_impls = {r.configuration["impl"] for r in results
                if r.status == ResultStatus.Ok}
    assert {"segsum", "via_dia", "rcm_dia"} <= ok_impls


def test_via_dense_validates_on_dense_pattern():
    """via_dense (plain GEMV) must validate on a dense-enough matrix
    and be the skippable conversion failure on a sparse one."""
    import scipy.sparse as sp
    from cusp_autotuned_tpu.kernels.variants import build_spmv
    from cusp_autotuned_tpu.utils.exceptions import FormatConversionException
    rng = np.random.RandomState(3)
    S = sp.csr_matrix(rng.randn(60, 60).astype(np.float32))
    A = build(S.tocoo(), "csr")
    x = np.linspace(-1, 1, 60).astype(np.float32)
    fn = build_spmv(A, {"impl": "via_dense"})
    np.testing.assert_allclose(np.asarray(fn(x)), reference_spmv(A, x),
                               rtol=1e-4, atol=1e-5)
    Sp = sp.random(2000, 2000, density=0.001, random_state=rng,
                   dtype=np.float32) + sp.eye(2000, dtype=np.float32)
    Asp = build(Sp.tocoo(), "csr")
    with pytest.raises(FormatConversionException):
        build_spmv(Asp, {"impl": "via_dense"})


def test_via_dia_fill_guard_is_skippable():
    """On a pattern with catastrophic diagonal fill, via_dia must be
    recorded DeviceLimitsExceeded (skippable), not crash the tune."""
    import scipy.sparse as sp
    rng = np.random.RandomState(0)
    S = sp.random(2000, 2000, density=0.0006, random_state=rng,
                  dtype=np.float32)
    S = S + sp.eye(2000, dtype=np.float32)
    A = build(S.tocoo(), "csr")
    x = np.ones(2000, np.float32)
    tuner = Tuner(measure=False)
    results = tuner.tune(A, x, reference_computation=reference_spmv)
    via = [r for r in results if r.configuration["impl"] == "via_dia"]
    assert via and all(r.status == ResultStatus.DeviceLimitsExceeded
                       for r in via)
    assert any(r.status == ResultStatus.Ok for r in results)


def test_choose_format():
    """Explicit per-matrix format selection across converted candidates."""
    from cusp_autotuned_tpu.autotune.tuner import choose_format
    A = gallery.make_diagonal_symmetric_matrix(256, 256, 2, 5).asformat("csr")
    x = np.ones(256, np.float32)
    B, config = choose_format(A, x, formats=("csr", "dia"),
                              reference_computation=reference_spmv,
                              tuner=Tuner(warmup=0, repeats=2, measure=False))
    assert B.format in ("csr", "dia")
    assert "impl" in config
    # the chosen (format, config) must reproduce the right answer
    from cusp_autotuned_tpu.kernels.variants import build_spmv
    y = np.asarray(build_spmv(B, config)(jnp_x := __import__("jax").numpy.asarray(x)))
    np.testing.assert_allclose(y, reference_spmv(A, x), rtol=1e-4)


def test_hyb_tuning_space():
    """HYB joined the tunable formats (default / via_dia)."""
    S = example_matrices()["widerow"]
    A = build(S, "hyb")
    x = np.random.RandomState(0).randn(A.num_cols).astype(np.float32)
    results = Tuner(measure=False).tune(A, x, reference_computation=reference_spmv)
    impls_ok = {r.configuration["impl"] for r in results
                if r.status == ResultStatus.Ok}
    assert "default" in impls_ok
    assert "via_dia" in impls_ok


def test_signature_distinguishes_same_shape_matrices():
    """Two matrices with identical structure but different entries must not
    share compiled kernels (the closures bake the data in)."""
    S1 = gallery.poisson5pt(9, 9, format="dia")
    import dataclasses
    import jax.numpy as jnp
    S2 = dataclasses.replace(S1, data=S1.data * 2.0)
    assert matrix_signature(S1) != matrix_signature(S2)
    x = np.ones(81, np.float32)
    tuner = Tuner()
    y1 = tuner.run(S1, x, {"impl": "slices"})
    y2 = tuner.run(S2, x, {"impl": "slices"})
    np.testing.assert_allclose(np.asarray(y2), 2 * np.asarray(y1), rtol=1e-6)


def test_permutation_spgemm_and_symmetric_permute():
    """P @ A @ P^T works through multiply (regression: spgemm used to try
    converting the product to format 'permutation')."""
    import cusp_autotuned_tpu.formats as F
    from cusp_autotuned_tpu.ops.transpose import transpose
    S = example_matrices()["small4x4"]
    A = build(S, "csr")
    P = F.permutation_matrix([2, 0, 3, 1])
    PA = ct.multiply(P, A)
    PAPt = ct.multiply(PA, transpose(P))
    perm = np.asarray(P.perm)
    expect = np.asarray(S.todense())[perm][:, perm]
    from tests.util import dense_of
    np.testing.assert_allclose(dense_of(PAPt), expect, rtol=1e-6)


def test_tuned_operator_packaging(monkeypatch):
    # the tuner's best config packaged as a solver operator whose planned
    # arrays are pytree leaves.  The global tuner is
    # swapped for a validation-only one (measure=False) — the walk's
    # timing loop is irrelevant to the packaging under test
    import jax
    from cusp_autotuned_tpu import autotune, solvers, gallery
    from cusp_autotuned_tpu.autotune import tuner as tuner_mod
    from cusp_autotuned_tpu.operators import PlannedOperator
    monkeypatch.setattr(tuner_mod, "_global_tuner", Tuner(measure=False))
    A = gallery.poisson9pt(20, 20, format="csr", dtype=np.float32)
    op = autotune.tuned_operator(A, tune_first=True)
    assert isinstance(op, PlannedOperator)
    b = np.ones(A.num_rows, np.float32)
    x, mon = solvers.cg(op, b)
    assert mon.converged()
    # a format-selection winner plans too: the DIA data are the leaves
    from cusp_autotuned_tpu.operators import planned_operator
    p = planned_operator(A, {"impl": "via_dia"})
    assert isinstance(p, PlannedOperator) and p.impl == "via_dia"
    assert len(jax.tree_util.tree_leaves(p)) >= 1


def test_dynamic_hook_spmm():
    # the TuneIteration-per-call hook serves 2-D right-hand sides with a
    # per-k signature (parity: the multiply hook, generic/multiply.inl)
    from cusp_autotuned_tpu import autotune
    from cusp_autotuned_tpu.ops.multiply import multiply
    A = gallery.poisson9pt(16, 16, format="csr", dtype=np.float32)
    X = np.random.RandomState(3).randn(A.num_cols, 4).astype(np.float32)
    autotune.enable()
    try:
        for _ in range(3):
            Y = np.asarray(multiply(A, X))
    finally:
        autotune.disable()
    ref = A.to_scipy() @ X
    np.testing.assert_allclose(Y, ref, rtol=1e-4, atol=1e-4)


# -- analytic cost model (autotune.cost_model) --------------------------------

def _scattered_pattern(m=6000, n=6000, nnz=60_000, seed=0):
    import scipy.sparse as sp
    rng = np.random.RandomState(seed)
    r = rng.randint(0, m, nnz)
    c = rng.randint(0, n, nnz)
    v = rng.randn(nnz).astype(np.float32)
    return sp.coo_matrix((v, (r, c)), shape=(m, n))


def test_cost_model_class_selection(model_device):
    """The model picks per-pattern classes without compiling anything:
    banded → via_dia, dense → via_dense, uniform scatter → the default
    segment-sum rail (its DIA and dense layouts fail their guards)."""
    from cusp_autotuned_tpu.autotune.cost_model import (
        predict, recommend_config)

    A = gallery.poisson5pt(60, 60, format="csr", dtype=np.float32)
    cfg, _ = recommend_config(A)
    assert cfg["impl"] == "via_dia"

    D = from_scipy(_scattered_pattern(400, 400, 120_000).tocoo(), "csr")
    cfg, _ = recommend_config(D)
    assert cfg["impl"] == "via_dense"

    S = from_scipy(_scattered_pattern().tocoo(), "csr")
    p = predict(S)
    cfg, _ = recommend_config(S)
    assert cfg["impl"] == "segsum"
    # the via_dia guard must fire exactly like ops.convert's (skippable)
    assert "skip" in p["via_dia"] and "skip" in p["via_dense"]


def test_untuned_best_configuration_uses_model(model_device):
    """With NOTHING measured, best_configuration answers with the cost
    model's zero-compile pick (the reference can only hand back the static
    default kernel here), and tuned_operator solves with it."""
    from cusp_autotuned_tpu import solvers
    from cusp_autotuned_tpu.autotune import tuner as tuner_mod

    A = gallery.poisson5pt(40, 40, format="csr", dtype=np.float32)
    t = Tuner()
    assert t.best_configuration(A)["impl"] == "via_dia"

    # the packaged operator path (global tuner, empty): model pick builds
    # and the monitored solve converges
    fresh = Tuner(measure=False)
    old = tuner_mod._global_tuner
    tuner_mod._global_tuner = fresh
    try:
        from cusp_autotuned_tpu.autotune.tuner import tuned_operator
        op = tuned_operator(A)
        b = np.ones(A.num_rows, np.float32)
        x, mon = solvers.cg(op, b, monitor=solvers.Monitor(b, 500, 1e-5))
        assert mon.converged()
    finally:
        tuner_mod._global_tuner = old


def test_cost_model_bf16_halves_dia_time(model_device):
    from cusp_autotuned_tpu.autotune.cost_model import predict
    A = gallery.poisson5pt(60, 60, format="csr", dtype=np.float32)
    p = predict(A, allow_low_precision=True)
    assert p["via_dia_bf16"]["us"] < p["via_dia"]["us"]
    assert p["via_dia_bf16"]["config"]["value_dtype"] == "bfloat16"
    # opt-in only: without the flag no low-precision strategy is offered
    assert "via_dia_bf16" not in predict(A)


def test_model_guided_searcher_orders_walk(model_device):
    """ModelGuidedSearcher puts the predicted-winner class first while
    keeping every configuration (a reordering, not a filter)."""
    from cusp_autotuned_tpu.autotune import ModelGuidedSearcher
    A = gallery.poisson5pt(40, 40, format="csr", dtype=np.float32)
    configs = configurations_for(A)
    ordered = ModelGuidedSearcher(A).order(configs)
    assert sorted(map(config_key, ordered)) == \
        sorted(map(config_key, configs))
    assert ordered[0]["impl"] in ("via_dia", "rcm_dia")
    # on a banded pattern every via_dia-class config precedes the
    # segment-sum default
    pos = {config_key(c): i for i, c in enumerate(ordered)}
    dia_last = max(pos[config_key(c)] for c in configs
                   if c["impl"] in ("via_dia", "rcm_dia"))
    seg = min(pos[config_key(c)] for c in configs if c["impl"] == "segsum")
    assert dia_last < seg


def test_cost_model_empty_and_dia_inputs(model_device):
    from cusp_autotuned_tpu.autotune.cost_model import predict
    import scipy.sparse as sp
    E = from_scipy(sp.coo_matrix((5, 7), dtype=np.float32), "csr")
    p = predict(E)
    assert "us" in p["default"]
    D = gallery.poisson5pt(30, 30, format="dia", dtype=np.float32)
    pd = predict(D)
    assert pd["via_dia"]["config"]["impl"] == "slices"


def test_bf16_axis_opt_in(monkeypatch):
    """With search_low_precision on (CUSP_TPU_TUNE_BF16), the walk gains a
    value_dtype axis whose bf16 configurations validate at their own
    precision class; off (default), no low-precision config is searched."""
    from cusp_autotuned_tpu.utils import config as C
    A = gallery.make_diagonal_symmetric_matrix(200, 200, 3, 5)
    base = configurations_for(A)
    assert not any(c.get("value_dtype") == "bfloat16" for c in base)

    monkeypatch.setattr(C.get_config(), "search_low_precision", True)
    try:
        configs = configurations_for(A)
        bf16 = [c for c in configs if c.get("value_dtype") == "bfloat16"]
        assert bf16, "flag must add bf16 configurations"
        x = np.linspace(-1, 1, A.num_cols).astype(np.float32)
        tuner = Tuner(warmup=0, repeats=1)
        results = tuner.tune(A, x, reference_computation=reference_spmv)
        by_cfg = {config_key(r.configuration): r for r in results}
        ok_bf16 = [r for r in results
                   if r.configuration.get("value_dtype") == "bfloat16"
                   and r.status == ResultStatus.Ok]
        assert ok_bf16, \
            f"bf16 configs must validate at their class tolerance: " \
            f"{[(r.status.value, r.error) for r in results]}"
        assert len(by_cfg) == len(configs)
    finally:
        monkeypatch.setattr(C.get_config(), "search_low_precision", False)


def test_dynamic_walk_is_model_ordered(model_device):
    """The dynamic TuneIteration walk tries the model's predicted winner
    class first (each iteration runs on the caller's critical path), while
    still covering the whole space and converging to the measured best."""
    A = gallery.poisson5pt(40, 40, format="csr", dtype=np.float32)
    x = np.linspace(-1, 1, A.num_cols).astype(np.float32)
    tuner = Tuner(warmup=0, repeats=1)
    sig = matrix_signature(A, x)
    order = tuner._dynamic_order(A, sig)
    assert sorted(map(config_key, order)) == \
        sorted(map(config_key, configurations_for(A)))
    assert order[0]["impl"] in ("via_dia", "rcm_dia")
    y = tuner.tune_iteration(A, x)
    ref = reference_spmv(A, x)
    np.testing.assert_allclose(np.asarray(y), ref, rtol=1e-4, atol=1e-4)
    first = next(iter(tuner.results[sig].values()))
    assert first.configuration["impl"] in ("via_dia", "rcm_dia")


def test_offline_walk_evicts_and_saves_incrementally(tmp_path):
    """An exhaustive walk must not retain each configuration's built
    kernel (planned arrays + executable — a measured multi-GB leak on
    large matrices) and must persist results as it goes, so an
    interrupted walk keeps its measurements."""
    A = gallery.poisson5pt(15, 15, format="csr", dtype=np.float32)
    x = np.linspace(-1, 1, A.num_cols).astype(np.float32)
    path = str(tmp_path / "walk.json")
    tuner = Tuner(cache_path=path, measure=False)
    saves = []
    orig_save = tuner.save
    tuner.save = lambda *a, **k: (saves.append(len(tuner.results)),
                                  orig_save(*a, **k))
    results = tuner.tune(A, x, reference_computation=reference_spmv)
    assert len(results) >= 4
    assert not tuner._compiled, "walk retained built kernels"
    # one save per 10 configs plus the final one
    assert len(saves) >= len(results) // 10
    # the winner still runs after eviction (recompiles once)
    best = tuner.best_configuration(A, x)
    y = tuner.run(A, x, best)
    np.testing.assert_allclose(np.asarray(y), reference_spmv(A, x),
                               rtol=1e-4, atol=1e-4)


def test_tuning_result_device_us_roundtrip():
    """device_us (the profiler channel) persists through the JSON cache
    and drives ranking_ms when present (VERDICT r4 item 4)."""
    from cusp_autotuned_tpu.autotune.result import ResultStatus, TuningResult
    r = TuningResult({"impl": "via_dia"}, ResultStatus.Ok,
                     duration_ms=2.0, device_us=150.0)
    r2 = TuningResult.from_json(r.to_json())
    assert r2.device_us == 150.0
    assert r2.ranking_ms() == pytest.approx(0.15)
    r3 = TuningResult.from_json(
        TuningResult({"impl": "x"}, ResultStatus.Ok, duration_ms=2.0)
        .to_json())
    assert r3.device_us is None and r3.ranking_ms() == 2.0


def test_tuner_ranks_on_device_channel(monkeypatch):
    """When the device channel is captured, best_configuration ranks on
    it — the wall channel no longer decides; wall stays the fallback for
    results without device_us."""
    import itertools

    A = gallery.make_diagonal_symmetric_matrix(256, 256, 2, 5)
    x = np.linspace(0, 1, 256).astype(np.float32)

    monkeypatch.setattr(Tuner, "_time", lambda self, fn, x, y: 1.0)
    seq = itertools.count()
    # device channel disagrees with the (flat) wall channel: the LAST
    # config measured gets the smallest device time
    monkeypatch.setattr(Tuner, "_time_device",
                        lambda self, fn, x: 1000.0 - next(seq))
    t = Tuner(timing_channel="device")
    res = t.tune(A, x, reference_computation=reference_spmv)
    ok = [r for r in res if r.is_valid()]
    assert len(ok) > 1 and all(r.device_us is not None for r in ok)
    best = t.best_configuration(A, x)
    expect = min(ok, key=lambda r: r.device_us).configuration
    assert best == expect


def test_tuner_wall_channel_records_no_device_us():
    A = gallery.make_diagonal_symmetric_matrix(256, 256, 2, 5)
    x = np.linspace(0, 1, 256).astype(np.float32)
    t = Tuner(timing_channel="wall")
    res = t.tune(A, x, reference_computation=reference_spmv)
    assert all(r.device_us is None for r in res)


def test_tuner_auto_channel_skips_device_on_cpu():
    """'auto' must not attempt profiler capture on the CPU oracle backend
    (no device spans there — it would waste a trace per config)."""
    t = Tuner(timing_channel="auto")
    assert t._time_device(lambda v: v, np.zeros(4, np.float32)) is None
    with pytest.raises(ValueError):
        Tuner(timing_channel="nonsense")
