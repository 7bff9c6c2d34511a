"""A CPU rehearsal of chip_smoke.py at a tiny size: its phases run end to
end on small matrices and stop short of the device assertion, which must
refuse the CPU.  The card-only checks (Pallas kernel compiled for the GPU,
device times, real sizes) are chip_smoke phases, not tests."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from cusp_autotuned_tpu import gallery  # noqa: E402
from cusp_autotuned_tpu.backend.reference import from_scipy, to_scipy  # noqa: E402,E501
from cusp_autotuned_tpu.gallery.suite import _scattered  # noqa: E402


def _system(n, dtype):
    A = gallery.poisson5pt(n, n, format="csr", dtype=dtype)
    S = to_scipy(A).astype(np.float64).tocsr()
    b = jnp.asarray(np.random.RandomState(3).randn(A.num_rows)
                    .astype(dtype))
    return A, S, b


def test_require_gpu_refuses_the_cpu():
    with pytest.raises(SystemExit):
        chip_smoke.require_gpu(1)


def test_main_exits_nonzero_without_a_gpu(capsys):
    with pytest.raises(SystemExit) as e:
        chip_smoke.main([])
    assert e.value.code != 0
    assert '"ok"' not in capsys.readouterr().out


def test_host_cg_iterations_matches_scipy_residual_rule():
    A, S, b = _system(20, np.float64)
    b = np.asarray(b)
    its = chip_smoke.host_cg_iterations(S, b, 1e-8, 1000)
    assert 0 < its < 1000
    from scipy.sparse.linalg import cg as scipy_cg
    seen = []
    x, info = scipy_cg(S, b, x0=np.zeros_like(b), atol=1e-8 * np.linalg.norm(b),
                       rtol=0.0, maxiter=1000,
                       callback=lambda xk: seen.append(1))
    assert info == 0 and abs(len(seen) - its) <= 1


@pytest.mark.parametrize("dtype,rtol", [(np.float32, 1e-5),
                                        (np.float64, 1e-10)])
def test_phase_cg_rehearsal(dtype, rtol):
    A, S, b = _system(24, dtype)
    op = chip_smoke.phase_cg(A, S, b, rtol, 2000, "rehearsal")
    assert op.impl   # the rail is named


def test_phase_refine_rehearsal():
    """Defect correction around the float32 solve reaches a float64 true
    residual below the float32 solve's own."""
    A, S, b = _system(30, np.float32)
    op = chip_smoke.phase_cg(A, S, b, 1e-5, 2000, "rehearsal",
                             residual_limit=chip_smoke.CG32_RESIDUAL_LIMIT)
    chip_smoke.phase_refine(op, S, b, 1e-7, 2000, "rehearsal")


def test_phase_cg_fails_above_its_residual_limit():
    """The float32 iterate's true residual (~1e-6 here) is held to the
    stated limit."""
    A, S, b = _system(30, np.float32)
    with pytest.raises(AssertionError, match="true residual"):
        chip_smoke.phase_cg(A, S, b, 1e-5, 2000, "rehearsal",
                            residual_limit=1e-12)


def test_phase_refine_fails_when_sweeps_run_out():
    A, S, b = _system(30, np.float32)
    op = chip_smoke.phase_cg(A, S, b, 1e-5, 2000, "rehearsal",
                             residual_limit=chip_smoke.CG32_RESIDUAL_LIMIT)
    with pytest.raises(AssertionError, match="refined residual"):
        chip_smoke.phase_refine(op, S, b, 1e-14, 2000, "rehearsal",
                                sweeps=1)


def test_phase_amg_rehearsal():
    A, S, b = _system(40, np.float32)
    chip_smoke.phase_amg(A, S, b)


def test_phase_walks_rehearsal():
    chip_smoke.phase_walks({
        "dia": gallery.poisson5pt(20, 20, format="dia", dtype=np.float32),
        "csr": gallery.poisson5pt(20, 20, format="csr", dtype=np.float32),
        "economics": from_scipy(_scattered(1500, 6, seed=8)
                                .astype(np.float32), "csr"),
    })


def test_phase_walks_fails_on_a_bad_configuration(monkeypatch):
    """A configuration that is neither Ok nor a guard-raised skip fails
    the phase."""
    from cusp_autotuned_tpu.autotune import tuner
    from cusp_autotuned_tpu.autotune.result import ResultStatus, TuningResult
    monkeypatch.setattr(
        tuner.Tuner, "_execute",
        lambda self, A, x, config, validate=None: TuningResult(
            dict(config), ResultStatus.CompilationFailed, error="boom"))
    with pytest.raises(AssertionError):
        chip_smoke.phase_walks({"dia": gallery.poisson5pt(
            8, 8, format="dia", dtype=np.float32)})
