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

Span names follow ``subsystem/phase`` (e.g. ``engines/dispatch``,
``engines/compile``); exporters group on the full name.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional

from . import clock as _clock

__all__ = ["Span", "Tracer", "span", "event", "capture", "enabled",
           "active", "start", "stop"]


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
    """Collects well-nested spans per thread plus instant events."""

    def __init__(self, clock: Optional[Callable[[], float]] = None) -> None:
        self.clock: Callable[[], float] = clock or _clock.perf
        self.roots: List[Span] = []
        self.events: List[Dict[str, Any]] = []
        self._tls = threading.local()
        self._lock = threading.Lock()

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

    def phase_names(self) -> List[str]:
        seen: Dict[str, None] = {}
        for r in self.roots:
            for s in r.walk():
                seen.setdefault(s.name, None)
        return list(seen)


# ----------------------------------------------------------------------
# Module-level active tracer.  ``span``/``event`` are the only functions
# instrumented code should call; everything else is test/tooling surface.
# ----------------------------------------------------------------------
_active: Optional[Tracer] = None
_active_lock = threading.Lock()


def span(name: str, **args: Any):
    """Open a span if tracing is on; otherwise return the no-op ctx."""
    t = _active
    if t is None:
        return _NOOP_CTX
    return _SpanCtx(t, name, args)


def event(name: str, **args: Any) -> None:
    """Record an instant event (worker death, rollback, circuit open)."""
    t = _active
    if t is not None:
        t.add_event(name, args)


def enabled() -> bool:
    return _active is not None


def active() -> Optional[Tracer]:
    return _active


def start(clock: Optional[Callable[[], float]] = None) -> Tracer:
    """Install a fresh active tracer and return it (idempotent stop via
    ``stop()``). Prefer ``capture()`` unless you need manual control."""
    global _active
    tracer = Tracer(clock=clock)
    with _active_lock:
        _active = tracer
    return tracer


def stop() -> None:
    global _active
    with _active_lock:
        _active = None


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
        with _active_lock:
            self._prev = _active
            self.tracer = Tracer(clock=self._clock)
            _active = self.tracer
        return self.tracer

    def __exit__(self, exc_type, exc, tb) -> bool:
        global _active
        with _active_lock:
            _active = self._prev
        return False
