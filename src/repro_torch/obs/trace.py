"""Structured tracing: nested spans with an injectable clock.

The port's copy of ``repro.obs.trace`` (DESIGN.md §13), so that engines and
the server emit the same span names under either package:

- One module-level active tracer (``_active``).  Instrumented code calls
  ``trace.span("subsystem/phase", **args)`` unconditionally; when no
  tracer is active the call returns a shared no-op context manager and
  does nothing else (one global load, one ``if`` and a pre-allocated
  singleton).
- Span stacks are thread-local; finished top-level spans from every
  thread land in ``Tracer.roots`` (lock-protected).
- The clock is injectable (``Tracer(clock=FakeClock().now)``), so span
  tests are deterministic and wall-clock-free.
- Spans survive exceptions: the ``with`` block closes the span on the
  error path too and tags it ``error=<ExcType>``.
- ``trace.annotate(**args)`` adds attributes to the innermost open span
  of the calling thread, for a callee that knows what its caller's span
  should say (the plan a kernel launch chose).
- Counters and samples go to the tracer's ``metrics`` registry through
  ``trace.count(name, n, **labels)`` and ``trace.observe(name, value,
  **labels)``, which cost what ``span`` costs when tracing is off.
- ``capture`` anchors the tracer's clock to the epoch clock that
  ``torch.profiler`` stamps device operations with: ``epoch_offset_s``
  (epoch seconds less tracer seconds, read at the start) and
  ``epoch_drift_s`` (how far that offset moved by the end), so a span and a
  device operation share one timeline without a second measurement.

Span names follow ``subsystem/phase`` (e.g. ``engines/dispatch``,
``engines/compile``); exporters group on the full name.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional

from . import clock as _clock
from .metrics import MetricsRegistry

__all__ = ["Span", "Tracer", "span", "annotate", "event", "count", "observe",
           "capture", "enabled", "active"]


class Span:
    """One timed phase: name, [t0, t1) in tracer-clock seconds, args,
    children. Plain attributes, no dataclass overhead on the hot path."""

    __slots__ = ("name", "t0", "t1", "args", "children", "tid")

    def __init__(self, name: str, t0: float, args: Dict[str, Any],
                 tid: str) -> None:
        self.name = name
        self.t0 = t0
        self.t1 = t0
        self.args = args
        self.children: List["Span"] = []
        self.tid = tid

    @property
    def duration(self) -> float:
        return self.t1 - self.t0

    def walk(self):
        """Yield this span and every descendant, depth-first."""
        yield self
        for c in self.children:
            yield from c.walk()

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"name": self.name, "t0": self.t0,
                             "t1": self.t1, "tid": self.tid}
        if self.args:
            d["args"] = dict(self.args)
        if self.children:
            d["children"] = [c.to_dict() for c in self.children]
        return d

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Span({self.name!r}, dur={self.duration:.6f}, "
                f"children={len(self.children)})")


class _SpanCtx:
    """Context manager that opens a Span on the calling thread's stack."""

    __slots__ = ("_tracer", "_span")

    def __init__(self, tracer: "Tracer", name: str,
                 args: Dict[str, Any]) -> None:
        self._tracer = tracer
        self._span = tracer._open(name, args)

    def __enter__(self) -> Span:
        return self._span

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is not None:
            self._span.args["error"] = exc_type.__name__
        self._tracer._close(self._span)
        return False


class _NoopCtx:
    """Shared do-nothing context manager for the disabled path."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


_NOOP_CTX = _NoopCtx()


class Tracer:
    """Collects well-nested spans per thread, instant events, and counters
    and samples in ``metrics``."""

    def __init__(self, clock: Optional[Callable[[], float]] = None) -> None:
        self.clock: Callable[[], float] = clock or _clock.perf
        self.roots: List[Span] = []
        self.events: List[Dict[str, Any]] = []
        self.metrics = MetricsRegistry()
        # epoch seconds less tracer seconds, and its change over the
        # capture; set by ``capture`` (None for a tracer used by hand)
        self.epoch_offset_s: Optional[float] = None
        self.epoch_drift_s: Optional[float] = None
        self._tls = threading.local()
        self._lock = threading.Lock()

    def epoch_offset(self) -> float:
        """Epoch seconds less tracer seconds now (the epoch clock read
        between two reads of the tracer's)."""
        a = self.clock()
        w = _clock.wall()
        b = self.clock()
        return w - (a + b) / 2

    # -- span lifecycle (called via _SpanCtx) --------------------------
    def _stack(self) -> List[Span]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _open(self, name: str, args: Dict[str, Any]) -> Span:
        sp = Span(name, self.clock(), args, threading.current_thread().name)
        stack = self._stack()
        if stack:
            stack[-1].children.append(sp)
        stack.append(sp)
        return sp

    def _close(self, sp: Span) -> None:
        sp.t1 = self.clock()
        stack = self._stack()
        # Unwind to sp: exceptions that skipped inner __exit__ calls (or
        # a mis-nested close) must not leave orphans on the stack.
        while stack:
            top = stack.pop()
            if top is sp:
                break
            top.t1 = sp.t1
        if not stack:
            with self._lock:
                self.roots.append(sp)

    def add_event(self, name: str, args: Dict[str, Any]) -> None:
        ev = {"name": name, "ts": self.clock(),
              "tid": threading.current_thread().name}
        if args:
            ev["args"] = args
        with self._lock:
            self.events.append(ev)

    # -- queries -------------------------------------------------------
    def span_count(self) -> int:
        return sum(1 for r in self.roots for _ in r.walk())

    def find(self, name: str) -> List[Span]:
        return [s for r in self.roots for s in r.walk() if s.name == name]


# ----------------------------------------------------------------------
# Module-level active tracer.  ``span``/``event``/``count``/``observe`` are
# the only functions instrumented code should call (``enabled`` guards a
# loop that runs only to feed them); the rest is test/tooling surface.
# ----------------------------------------------------------------------
_active: Optional[Tracer] = None
_active_lock = threading.Lock()


def span(name: str, **args: Any):
    """Open a span if tracing is on; otherwise return the no-op ctx."""
    t = _active
    if t is None:
        return _NOOP_CTX
    return _SpanCtx(t, name, args)


def annotate(**args: Any) -> None:
    """Add ``args`` to the calling thread's innermost open span; nothing
    when tracing is off or no span is open."""
    t = _active
    if t is not None:
        stack = t._stack()
        if stack:
            stack[-1].args.update(args)


def event(name: str, **args: Any) -> None:
    """Record an instant event (worker death, rollback, circuit open)."""
    t = _active
    if t is not None:
        t.add_event(name, args)


def count(name: str, n: int = 1, **labels: Any) -> None:
    """Add ``n`` to the active tracer's counter ``name`` (bytes moved,
    rows); nothing when tracing is off."""
    t = _active
    if t is not None:
        t.metrics.counter(name, **labels).inc(n)


def observe(name: str, value: float, **labels: Any) -> None:
    """Sample ``value`` into the active tracer's histogram ``name`` (its
    count and total are exact); nothing when tracing is off."""
    t = _active
    if t is not None:
        t.metrics.histogram(name, **labels).observe(value)


def enabled() -> bool:
    return _active is not None


def active() -> Optional[Tracer]:
    return _active


class capture:
    """``with trace.capture() as tracer:`` — scoped tracing.

    Restores the previously active tracer on exit so captures nest; the
    inner capture sees only its own spans.
    """

    def __init__(self, clock: Optional[Callable[[], float]] = None) -> None:
        self._clock = clock
        self._prev: Optional[Tracer] = None
        self.tracer: Optional[Tracer] = None

    def __enter__(self) -> Tracer:
        global _active
        tracer = Tracer(clock=self._clock)
        tracer.epoch_offset_s = tracer.epoch_offset()
        with _active_lock:
            self._prev = _active
            self.tracer = tracer
            _active = tracer
        return tracer

    def __exit__(self, exc_type, exc, tb) -> bool:
        global _active
        with _active_lock:
            _active = self._prev
        t = self.tracer
        t.epoch_drift_s = t.epoch_offset() - t.epoch_offset_s
        return False
