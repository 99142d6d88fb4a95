"""Task kinds and the typed errors of the port (the counterpart of
``repro.core.api``'s ``Task``, ``YdfError`` and ``EngineFailure``).

Error messages follow the paper's §2.1/§2.2 guidance: say what failed in
task terms, show the offending values, and propose concrete fixes.
"""
from __future__ import annotations

import enum


class Task(enum.Enum):
    CLASSIFICATION = "CLASSIFICATION"
    REGRESSION = "REGRESSION"
    RANKING = "RANKING"
    UPLIFT = "UPLIFT"
    ANOMALY = "ANOMALY"


class YdfError(ValueError):
    """An error with directions (paper Table 1b style)."""


class EngineFailure(YdfError):
    """A typed inference-engine failure raised at serving time.

    Raised when a compiled host or plain-PyTorch engine call fails on a
    batch, or by an injected fault from ``serving.faults``. Carries the
    engine name so ``serving.server`` can attribute the failure to a
    circuit breaker, and ``transient`` so it knows whether a retry on the
    same engine is worth attempting. The CUDA kernel's errors are not
    engine failures: a kernel that fails to build raises ``RuntimeError``
    when the predictor is compiled, and one that fails to launch raises
    its ``RuntimeError`` at dispatch; no degradation chain catches either.
    """

    def __init__(self, message: str, *, engine: str = "?",
                 transient: bool = False):
        super().__init__(message)
        self.engine = engine
        self.transient = transient
