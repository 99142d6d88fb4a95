"""The ``Model.training_logs`` schema (v1), the port's copy of
``repro.obs.logs``: every learner builds its logs through
:func:`build_training_logs`, so one shape holds everywhere:

    {
      "schema_version": 1,
      "learner": "gbt" | ...,
      "num_trees": int,
      "growth_engine": str | None,   # None: learner has no engine choice
      "engine_fallback": str | None, # engine asked for but replaced
      "resilience": list[dict],      # checkpoint/recovery events ([] = none)
      "interrupted": bool,           # cooperative SIGINT/SIGTERM truncation
      # learner-specific extras ride along: train_loss, valid_loss,
      # device_impl, ...
      # "profile": phase breakdown — present iff tracing was active.
    }

:func:`validate_training_logs` is the shared gate; :func:`attach_profile`
snapshots the active tracer's phase aggregates into ``logs["profile"]``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from . import export as _export
from . import trace as _trace

__all__ = ["TRAINING_LOGS_SCHEMA_VERSION", "REQUIRED_KEYS",
           "build_training_logs", "validate_training_logs",
           "attach_profile"]

TRAINING_LOGS_SCHEMA_VERSION = 1

REQUIRED_KEYS = ("schema_version", "learner", "num_trees", "growth_engine",
                 "engine_fallback", "resilience", "interrupted")


def build_training_logs(*, learner: str, num_trees: int,
                        growth_engine: Optional[str] = None,
                        engine_fallback: Optional[str] = None,
                        resilience: Optional[list] = None,
                        interrupted: bool = False,
                        extra: Optional[Dict[str, Any]] = None,
                        ) -> Dict[str, Any]:
    """Assemble, profile-stamp and validate one training_logs dict."""
    logs: Dict[str, Any] = {
        "schema_version": TRAINING_LOGS_SCHEMA_VERSION,
        "learner": learner,
        "num_trees": int(num_trees),
        "growth_engine": growth_engine,
        "engine_fallback": engine_fallback,
        "resilience": list(resilience) if resilience is not None else [],
        "interrupted": bool(interrupted),
    }
    if extra:
        for k, v in extra.items():
            if v is not None:
                logs[k] = v
    attach_profile(logs)
    return validate_training_logs(logs)


def validate_training_logs(logs: Dict[str, Any]) -> Dict[str, Any]:
    """Raise ``YdfError`` unless *logs* matches the §13.4 schema."""
    from repro_torch.core.api import YdfError  # late: obs must not import core
    if not isinstance(logs, dict):
        raise YdfError(f"training_logs must be a dict, got {type(logs)}")
    missing = [k for k in REQUIRED_KEYS if k not in logs]
    if missing:
        raise YdfError(f"training_logs missing keys: {missing}")
    if logs["schema_version"] != TRAINING_LOGS_SCHEMA_VERSION:
        raise YdfError("training_logs schema_version "
                       f"{logs['schema_version']!r} != "
                       f"{TRAINING_LOGS_SCHEMA_VERSION}")
    if not isinstance(logs["learner"], str) or not logs["learner"]:
        raise YdfError("training_logs.learner must be a non-empty str")
    if not isinstance(logs["num_trees"], int) or logs["num_trees"] < 0:
        raise YdfError("training_logs.num_trees must be an int >= 0, got "
                       f"{logs['num_trees']!r}")
    for key in ("growth_engine", "engine_fallback"):
        if logs[key] is not None and not isinstance(logs[key], str):
            raise YdfError(f"training_logs.{key} must be str or None")
    if not isinstance(logs["resilience"], list):
        raise YdfError("training_logs.resilience must be a list")
    if not isinstance(logs["interrupted"], bool):
        raise YdfError("training_logs.interrupted must be a bool")
    return logs


def attach_profile(logs: Dict[str, Any]) -> Dict[str, Any]:
    """If a tracer is active, snapshot its phase aggregates into
    ``logs["profile"]`` (no-op when tracing is off)."""
    tracer = _trace.active()
    if tracer is not None:
        logs["profile"] = _export.profile_dict(tracer)
    return logs
