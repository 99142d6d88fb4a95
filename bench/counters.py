"""What the metric readers take from the program's tracer beyond span
durations (``readers.spans``): its counters and samples
(``Tracer.metrics``) and the spans themselves. A program whose tracer has
none of them reads None, never an error."""
from __future__ import annotations


def found(rec: dict, name: str) -> list:
    """The program's spans ``name`` in the traced window."""
    tracer = rec.get("spans")
    return [] if tracer is None else tracer.find(name)


def _series(rec: dict, name: str) -> list:
    registry = getattr(rec.get("spans"), "metrics", None)
    return [] if registry is None else [obj for _, obj in
                                        registry.series(name)]


def counter(rec: dict, name: str):
    """The total of the program's counter ``name`` over its labels, or
    None where it never counted."""
    s = _series(rec, name)
    return sum(c.value for c in s) if s else None


def sample_mean(rec: dict, name: str):
    """The exact mean of the program's samples ``name`` (count and total,
    not the reservoir), or None where it took none."""
    s = _series(rec, name)
    n = sum(h.count for h in s)
    return sum(h.total for h in s) / n if n else None


def mean_ms(rec: dict, name: str):
    """Mean milliseconds of the program's spans ``name``."""
    s = found(rec, name)
    return 1e3 * sum(x.duration for x in s) / len(s) if s else None
