"""Metrics registry: counters, gauges, bounded-reservoir histograms.

The port's copy of ``repro.obs.metrics``: one schema for everything that
counts or samples. ``ServerMetrics`` (serving/server.py) is a facade over
it. Series are keyed by ``(name, sorted(labels))`` so
``counter("engine_dispatches", engine="cuda")`` and
``counter("engine_dispatches", engine="vectorized")`` are separate series
of one logical metric.

Histograms keep an exact count/total plus a bounded reservoir (cap
65536, drop-oldest-half on overflow) from which percentiles are computed.
A registry exports to a plain dict (``to_dict``).
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "DEFAULT_RESERVOIR_CAP"]

DEFAULT_RESERVOIR_CAP = 65536

_LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, Any]) -> _LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _series_name(name: str, key: _LabelKey) -> str:
    if not key:
        return name
    return name + "{" + ",".join(f"{k}={v}" for k, v in key) + "}"


class Counter:
    """Monotonic-by-convention integer counter (settable for facades)."""

    __slots__ = ("value",)

    def __init__(self, value: int = 0) -> None:
        self.value = value

    def inc(self, n: int = 1) -> None:
        self.value += n

    def to_value(self) -> int:
        return self.value


class Gauge:
    """Last-write-wins float sample (queue depth, EWMA rate, ...)."""

    __slots__ = ("value",)

    def __init__(self, value: float = 0.0) -> None:
        self.value = value

    def set(self, v: float) -> None:
        self.value = float(v)

    def to_value(self) -> float:
        return self.value


class Histogram:
    """Exact count/total + bounded reservoir for percentile estimates.

    The reservoir drops its oldest half when full (cap is mutable so
    facades like ServerMetrics can expose a tunable), matching the
    reference package's ServerMetrics latency buffer byte for byte.
    """

    __slots__ = ("cap", "count", "total", "values")

    def __init__(self, cap: int = DEFAULT_RESERVOIR_CAP) -> None:
        self.cap = cap
        self.count = 0
        self.total = 0.0
        self.values: List[float] = []

    def observe(self, v: float) -> None:
        self.count += 1
        self.total += v
        self.values.append(v)
        if len(self.values) > self.cap:
            del self.values[: len(self.values) // 2]

    def percentile(self, q: float) -> float:
        """q in [0, 100]; nearest-rank over the reservoir; 0.0 if empty."""
        if not self.values:
            return 0.0
        vs = sorted(self.values)
        idx = min(len(vs) - 1, max(0, int(round(q / 100.0 * (len(vs) - 1)))))
        return vs[idx]

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def to_dict(self) -> Dict[str, Any]:
        return {"count": self.count, "total": self.total,
                "cap": self.cap, "reservoir": list(self.values)}


class MetricsRegistry:
    """Labeled series of counters, gauges and histograms.

    ``counter/gauge/histogram`` are get-or-create: instrumented code
    never pre-registers. ``len`` is the number of series of all kinds.
    """

    SCHEMA_VERSION = 1

    def __init__(self) -> None:
        self._counters: Dict[Tuple[str, _LabelKey], Counter] = {}
        self._gauges: Dict[Tuple[str, _LabelKey], Gauge] = {}
        self._hists: Dict[Tuple[str, _LabelKey], Histogram] = {}

    # -- get-or-create accessors --------------------------------------
    def counter(self, name: str, **labels: Any) -> Counter:
        key = (name, _label_key(labels))
        c = self._counters.get(key)
        if c is None:
            c = self._counters[key] = Counter()
        return c

    def gauge(self, name: str, **labels: Any) -> Gauge:
        key = (name, _label_key(labels))
        g = self._gauges.get(key)
        if g is None:
            g = self._gauges[key] = Gauge()
        return g

    def histogram(self, name: str, cap: int = DEFAULT_RESERVOIR_CAP,
                  **labels: Any) -> Histogram:
        key = (name, _label_key(labels))
        h = self._hists.get(key)
        if h is None:
            h = self._hists[key] = Histogram(cap=cap)
        return h

    # -- queries -------------------------------------------------------
    def __len__(self) -> int:
        return len(self._counters) + len(self._gauges) + len(self._hists)

    def series(self, name: str) -> Iterator[Tuple[Dict[str, str], Any]]:
        """Yield ``(labels_dict, instrument)`` for every series of name
        across all three kinds."""
        for store in (self._counters, self._gauges, self._hists):
            for (n, key), obj in store.items():
                if n == name:
                    yield dict(key), obj

    def labeled_values(self, name: str, label: str) -> Dict[str, Any]:
        """Collapse one label dimension to ``{label_value: value}`` —
        e.g. ``labeled_values("engine_dispatches", "engine")``."""
        out: Dict[str, Any] = {}
        for labels, obj in self.series(name):
            if label in labels:
                out[labels[label]] = obj.to_value() \
                    if hasattr(obj, "to_value") else obj
        return out

    # -- serialization -------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return {
            "schema_version": self.SCHEMA_VERSION,
            "counters": {_series_name(n, k): c.value
                         for (n, k), c in sorted(self._counters.items())},
            "gauges": {_series_name(n, k): g.value
                       for (n, k), g in sorted(self._gauges.items())},
            "histograms": {_series_name(n, k): h.to_dict()
                           for (n, k), h in sorted(self._hists.items())},
        }
