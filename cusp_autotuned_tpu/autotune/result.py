"""Tuning results and status codes.

Parity: KTT's ResultStatus — the tuner treats CompilationFailed /
ComputationFailed / ValidationFailed / DeviceLimitsExceeded configurations as
skippable failures (testing/ktt.cu:101-116 relies on this)."""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, Any, Optional


class ResultStatus(enum.Enum):
    Ok = "Ok"
    CompilationFailed = "CompilationFailed"
    ComputationFailed = "ComputationFailed"
    ValidationFailed = "ValidationFailed"
    DeviceLimitsExceeded = "DeviceLimitsExceeded"


@dataclasses.dataclass
class TuningResult:
    """duration_ms is the host-side wall channel; device_us is the
    device time per call measured from a jax.profiler trace (None when
    the device channel wasn't captured).  The tuner ranks on device_us
    when present — it is free of host dispatch noise (reference analog:
    per-config counter profiling, dia_multiply.h:168-173) — and on the
    wall channel otherwise."""

    configuration: Dict[str, Any]
    status: ResultStatus
    duration_ms: float = float("inf")
    compilation_ms: float = 0.0
    error: Optional[str] = None
    device_us: Optional[float] = None

    def is_valid(self) -> bool:
        return self.status == ResultStatus.Ok

    def ranking_ms(self) -> float:
        """The time this result should be RANKED by, in ms: measured
        device time when captured, else the wall channel."""
        return (self.device_us / 1e3 if self.device_us is not None
                else self.duration_ms)

    def to_json(self):
        return {
            "configuration": self.configuration,
            "status": self.status.value,
            "duration_ms": self.duration_ms,
            "compilation_ms": self.compilation_ms,
            "error": self.error,
            "device_us": self.device_us,
        }

    @staticmethod
    def from_json(d):
        dev = d.get("device_us")
        return TuningResult(
            configuration=dict(d["configuration"]),
            status=ResultStatus(d["status"]),
            duration_ms=float(d["duration_ms"]),
            compilation_ms=float(d.get("compilation_ms", 0.0)),
            error=d.get("error"),
            device_us=float(dev) if dev is not None else None,
        )
