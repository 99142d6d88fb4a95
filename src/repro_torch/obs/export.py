"""Trace exporters, the port's copy of ``repro.obs.export``: Chrome
trace-event JSON and phase aggregates.

``chrome_trace`` emits the Trace Event Format that ``chrome://tracing`` and
Perfetto read: a dict with a ``traceEvents`` list of complete ("X") events
(microsecond ``ts``/``dur``, ``pid``/``tid`` lanes, span args), instant
("i") events such as checkpoint rollbacks, and thread-name ("M") rows.
``validate_chrome_trace`` checks that structure (the CLI's ``profile``
verb and the tests use it). A captured tracer's document also carries
``otherData``: ``origin_s``, the tracer-clock second at ``ts`` 0, and the
tracer's ``epoch_offset_s`` / ``epoch_drift_s``, so an event's epoch second
is ``origin_s + ts / 1e6 + epoch_offset_s``. ``device_ops`` reads the
device's operations from a ``torch.profiler`` run onto the tracer's clock;
given to ``chrome_trace``, they fill a lane of their own.

``phase_summary`` folds a span tree into per-phase aggregates (count /
total / mean / max seconds, self-time excluding children), and
``profile_dict`` is the versioned wrapper that lands in
``training_logs["profile"]`` (with the tracer's counters and samples under
``metrics`` when it holds any).
"""
from __future__ import annotations

import json
import numbers
from typing import Any, Dict, Iterable, List, Optional, Tuple, Union

from .trace import Span, Tracer

__all__ = ["chrome_trace", "write_chrome_trace", "phase_summary",
           "profile_dict", "validate_chrome_trace", "device_ops"]

PROFILE_SCHEMA_VERSION = 1

# the lane of the device's operations in a Chrome trace
DEVICE_LANE = "device"

# (name, t0, t1): one device operation, in tracer-clock seconds
DeviceOp = Tuple[str, float, float]


def _roots(source: Union[Tracer, Iterable[Span]]) -> List[Span]:
    if isinstance(source, Tracer):
        return list(source.roots)
    return list(source)


def chrome_trace(source: Union[Tracer, Iterable[Span]],
                 *, pid: int = 1,
                 device: Iterable[DeviceOp] = ()) -> Dict[str, Any]:
    """Render a tracer (or span list) as a Chrome trace-event dict, with
    the ``device`` operations (``device_ops``) on a lane of their own."""
    roots = _roots(source)
    device = list(device)
    tids: Dict[str, int] = {}

    def tid_of(name: str) -> int:
        if name not in tids:
            tids[name] = len(tids) + 1
        return tids[name]

    events: List[Dict[str, Any]] = []
    t_origin = min((r.t0 for r in roots), default=0.0)
    if isinstance(source, Tracer) and source.events:
        t_origin = min(t_origin,
                       min(ev["ts"] for ev in source.events))
    if device:
        t_origin = min(t_origin, min(op[1] for op in device))

    for root in roots:
        for sp in root.walk():
            ev: Dict[str, Any] = {
                "name": sp.name,
                "cat": sp.name.split("/", 1)[0],
                "ph": "X",
                "ts": round((sp.t0 - t_origin) * 1e6, 3),
                "dur": round(sp.duration * 1e6, 3),
                "pid": pid,
                "tid": tid_of(sp.tid),
            }
            if sp.args:
                ev["args"] = {k: _jsonable(v) for k, v in sp.args.items()}
            events.append(ev)

    if isinstance(source, Tracer):
        for iev in source.events:
            ev = {
                "name": iev["name"],
                "cat": iev["name"].split("/", 1)[0],
                "ph": "i",
                "s": "t",
                "ts": round((iev["ts"] - t_origin) * 1e6, 3),
                "pid": pid,
                "tid": tid_of(iev["tid"]),
            }
            if iev.get("args"):
                ev["args"] = {k: _jsonable(v)
                              for k, v in iev["args"].items()}
            events.append(ev)

    for name, t0, t1 in device:
        events.append({"name": name, "cat": DEVICE_LANE, "ph": "X",
                       "ts": round((t0 - t_origin) * 1e6, 3),
                       "dur": round((t1 - t0) * 1e6, 3),
                       "pid": pid, "tid": tid_of(DEVICE_LANE)})

    # Thread-name metadata rows make the Perfetto lanes readable.
    for tname, tid in tids.items():
        events.append({"name": "thread_name", "ph": "M", "pid": pid,
                       "tid": tid, "args": {"name": tname}})

    doc: Dict[str, Any] = {"traceEvents": events, "displayTimeUnit": "ms"}
    if isinstance(source, Tracer) and source.epoch_offset_s is not None:
        doc["otherData"] = {"origin_s": t_origin,
                            "epoch_offset_s": source.epoch_offset_s,
                            "epoch_drift_s": source.epoch_drift_s}
    return doc


def write_chrome_trace(path: str, source: Union[Tracer, Iterable[Span]],
                       device: Iterable[DeviceOp] = ()) -> None:
    with open(path, "w") as f:
        json.dump(chrome_trace(source, device=device), f)


def device_ops(prof, tracer: Tracer) -> List[DeviceOp]:
    """The device's operations (kernels, copies, sets) among a
    ``torch.profiler.profile`` run's raw records, on the tracer's clock:
    the profiler stamps them in epoch nanoseconds, and the tracer's
    ``epoch_offset_s`` carries them over."""
    off = tracer.epoch_offset_s or 0.0
    return sorted((e.name(), e.start_ns() / 1e9 - off, e.end_ns() / 1e9 - off)
                  for e in prof.profiler.kineto_results.events()
                  if "CUDA" in str(e.device_type()))


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
    out = {
        "schema_version": PROFILE_SCHEMA_VERSION,
        "span_count": tracer.span_count(),
        "phases": phase_summary(tracer),
        "events": [{k: ({a: _jsonable(b) for a, b in v.items()}
                        if k == "args" else _jsonable(v))
                    for k, v in ev.items()} for ev in events],
        "events_truncated": truncated,
    }
    if len(tracer.metrics):
        out["metrics"] = tracer.metrics.to_dict()
    return out


def validate_chrome_trace(doc: Any) -> None:
    """Raise ValueError unless *doc* is a structurally valid Chrome
    trace-event document (used by the tests and the CLI's ``profile`` verb)."""
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        raise ValueError("chrome trace: missing traceEvents")
    for ev in doc["traceEvents"]:
        if not isinstance(ev, dict) or "ph" not in ev or "name" not in ev:
            raise ValueError(f"chrome trace: malformed event {ev!r}")
        if ev["ph"] == "X":
            for k in ("ts", "dur", "pid", "tid"):
                if k not in ev:
                    raise ValueError(
                        f"chrome trace: X event missing {k}: {ev!r}")
            if ev["dur"] < 0 or ev["ts"] < 0:
                raise ValueError(f"chrome trace: negative time: {ev!r}")
        elif ev["ph"] == "i":
            if "ts" not in ev:
                raise ValueError(f"chrome trace: i event missing ts: {ev!r}")


def _jsonable(v: Any) -> Any:
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, numbers.Integral):  # numpy int scalars
        return int(v)
    if isinstance(v, numbers.Real):      # numpy float scalars
        return float(v)
    return str(v)
