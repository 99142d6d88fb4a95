"""Phase aggregates of a trace, the part of ``repro.obs.export`` that
``training_logs["profile"]`` needs: ``phase_summary`` folds a span tree into
per-phase aggregates (count / total / mean / max seconds, self-time
excluding children), and ``profile_dict`` is the versioned wrapper.
"""
from __future__ import annotations

import numbers
from typing import Any, Dict, Iterable, List, Optional, Union

from .trace import Span, Tracer

__all__ = ["phase_summary", "profile_dict"]

PROFILE_SCHEMA_VERSION = 1


def _roots(source: Union[Tracer, Iterable[Span]]) -> List[Span]:
    if isinstance(source, Tracer):
        return list(source.roots)
    return list(source)


def phase_summary(source: Union[Tracer, Iterable[Span]]) -> Dict[str, Any]:
    """Aggregate spans by name: count, total/mean/max wall seconds and
    self seconds (duration minus direct children)."""
    phases: Dict[str, Dict[str, float]] = {}
    for root in _roots(source):
        for sp in root.walk():
            d = phases.get(sp.name)
            if d is None:
                d = phases[sp.name] = {"count": 0, "total_s": 0.0,
                                       "self_s": 0.0, "max_s": 0.0}
            dur = sp.duration
            child = sum(c.duration for c in sp.children)
            d["count"] += 1
            d["total_s"] += dur
            d["self_s"] += max(0.0, dur - child)
            d["max_s"] = max(d["max_s"], dur)
    for d in phases.values():
        d["mean_s"] = d["total_s"] / d["count"] if d["count"] else 0.0
    return phases


def profile_dict(tracer: Tracer,
                 *, top_events: Optional[int] = 64) -> Dict[str, Any]:
    """Versioned profile payload for training_logs / BENCH files."""
    events = list(tracer.events)
    truncated = False
    if top_events is not None and len(events) > top_events:
        events = events[:top_events]
        truncated = True
    return {
        "schema_version": PROFILE_SCHEMA_VERSION,
        "span_count": tracer.span_count(),
        "phases": phase_summary(tracer),
        "events": [{k: ({a: _jsonable(b) for a, b in v.items()}
                        if k == "args" else _jsonable(v))
                    for k, v in ev.items()} for ev in events],
        "events_truncated": truncated,
    }


def _jsonable(v: Any) -> Any:
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, numbers.Integral):  # numpy int scalars
        return int(v)
    if isinstance(v, numbers.Real):      # numpy float scalars
        return float(v)
    return str(v)
