"""Deterministic fault injection for the serving stack (DESIGN.md §9.3),
the port's copy of ``repro.serving.faults``.

The paper's *safety of use* principle demands that every failure path of the
serving front-end — shed, timeout, retry-then-succeed, engine fallback,
circuit open/half-open/close — is *exercised*, not hoped-for. This module
makes failure a first-class, reproducible input:

* ``FakeClock`` — a virtual clock the server and the fault wrapper share, so
  latency spikes, deadlines, backoff sleeps and circuit-breaker cooldowns
  advance the SAME timeline deterministically (no wall-clock flakiness in
  tier-1 tests).
* ``FaultPlan`` — a declarative fault schedule keyed by predictor-call
  index: explicit call lists for tier-1 tests, seeded Bernoulli rates for
  soak tests and benchmarks. Same seed → same faults, always.
* ``FaultyPredictor`` — wraps any CompiledPredictor-shaped object and
  replays the plan: added latency, transient exceptions, sticky engine
  death (with optional revival, for half-open probe tests), and
  poisoned-output sentinels (NaN-filled results returned WITHOUT an
  exception — the adversarial case output validation must catch).

Faults model ENGINE failures: ``encode`` is never injected (schema errors
are caller errors and follow a different path).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Mapping

import numpy as np

from repro_torch.core.api import EngineFailure

#: the poisoned-output sentinel: a correct serving stack must never let a
#: non-finite prediction escape to a caller (DESIGN.md §9.3)
POISON = np.float32(np.nan)


class FakeClock:
    """A virtual monotonic clock: ``sleep`` advances time instead of
    waiting. Hand ``clock.now``/``clock.sleep`` to ForestServer and
    ``clock.advance`` to FaultyPredictor and the whole timing stack —
    deadlines, EWMA estimates, backoff, cooldowns — runs deterministically
    in zero wall time."""

    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def now(self) -> float:
        return self._t

    def advance(self, dt: float) -> None:
        if dt < 0:
            raise ValueError(f"cannot advance a monotonic clock by {dt}")
        self._t += float(dt)

    def sleep(self, dt: float) -> None:
        self.advance(max(0.0, dt))


def _hash_uniform(seed: int, call: int, salt: int) -> float:
    """Counter-based uniform[0,1) draw: independent of draw order, so the
    fault at call #k is the same whether or not earlier calls happened."""
    return float(np.random.default_rng((seed, call, salt)).random())


@dataclass(frozen=True)
class FaultPlan:
    """A deterministic fault schedule over predictor calls 0,1,2,…

    Explicit schedules (tier-1 tests):
      * ``transient_calls`` — call indices that raise a retryable
        ``EngineFailure(transient=True)``.
      * ``poison_calls``    — call indices whose output is returned
        NaN-poisoned (no exception raised: the silent-corruption case).
      * ``latency_calls``   — {call index: seconds} of added latency.
      * ``dead_from``/``dead_until`` — sticky engine death: every call ``i``
        with ``dead_from <= i`` and (``dead_until`` is None or
        ``i < dead_until``) raises a NON-transient ``EngineFailure``.
        ``dead_until`` models an engine coming back, so circuit-breaker
        half-open probes can be driven to both re-open and close.

    Seeded rates (soak tests, benchmarks) — drawn per call with
    counter-based hashing, so the schedule is reproducible from ``seed``
    alone:
      * ``transient_rate``, ``poison_rate`` — Bernoulli per call.
      * ``latency_rate`` + ``latency_s`` — Bernoulli latency spikes.
    """
    seed: int = 0
    transient_calls: tuple[int, ...] = ()
    poison_calls: tuple[int, ...] = ()
    latency_calls: Mapping[int, float] | tuple[tuple[int, float], ...] = ()
    dead_from: int | None = None
    dead_until: int | None = None
    transient_rate: float = 0.0
    poison_rate: float = 0.0
    latency_rate: float = 0.0
    latency_s: float = 0.0

    def _latency_map(self) -> dict[int, float]:
        return dict(self.latency_calls)

    def latency_for(self, call: int) -> float:
        dt = self._latency_map().get(call, 0.0)
        if self.latency_rate and \
                _hash_uniform(self.seed, call, 0) < self.latency_rate:
            dt += self.latency_s
        return dt

    def is_dead(self, call: int) -> bool:
        return (self.dead_from is not None and call >= self.dead_from
                and (self.dead_until is None or call < self.dead_until))

    def is_transient(self, call: int) -> bool:
        return (call in self.transient_calls
                or (self.transient_rate > 0.0 and
                    _hash_uniform(self.seed, call, 1) < self.transient_rate))

    def is_poisoned(self, call: int) -> bool:
        return (call in self.poison_calls
                or (self.poison_rate > 0.0 and
                    _hash_uniform(self.seed, call, 2) < self.poison_rate))


@dataclass
class FaultyPredictor:
    """A CompiledPredictor look-alike that replays a FaultPlan.

    Wrap the PRIMARY engine's predictor (``ForestServer.inject_faults``
    does this in place) and drive traffic: every ``predict_encoded`` call
    consumes one plan index. ``advance`` is how injected latency passes —
    ``time.sleep`` against the real clock, ``FakeClock.advance`` in tests.
    ``counts`` records what actually fired, so tests can assert the exact
    fault sequence they scheduled.
    """
    inner: object                       # CompiledPredictor (or another wrapper)
    plan: FaultPlan = field(default_factory=FaultPlan)
    advance: Callable[[float], None] = time.sleep
    calls: int = 0
    counts: dict = field(default_factory=lambda: {
        "latency": 0, "dead": 0, "transient": 0, "poison": 0, "clean": 0})

    # -- passthrough of the CompiledPredictor surface
    @property
    def name(self) -> str:
        return self.inner.name

    @property
    def out_shape(self) -> tuple:
        return tuple(getattr(self.inner, "out_shape", ()))

    @property
    def compile_s(self) -> float:
        return getattr(self.inner, "compile_s", 0.0)

    def encode(self, dataset) -> np.ndarray:
        return self.inner.encode(dataset)      # never fault-injected

    def per_tree(self, X: np.ndarray) -> np.ndarray:
        return self.inner.per_tree(X)

    # -- the injected surface
    def predict_encoded(self, X: np.ndarray) -> np.ndarray:
        i = self.calls
        self.calls += 1
        lat = self.plan.latency_for(i)
        if lat > 0.0:
            self.counts["latency"] += 1
            self.advance(lat)
        if self.plan.is_dead(i):
            self.counts["dead"] += 1
            raise EngineFailure(
                f"injected sticky engine death at call {i}",
                engine=self.name, transient=False)
        if self.plan.is_transient(i):
            self.counts["transient"] += 1
            raise EngineFailure(
                f"injected transient failure at call {i}",
                engine=self.name, transient=True)
        out = np.asarray(self.inner.predict_encoded(X))
        if self.plan.is_poisoned(i):
            self.counts["poison"] += 1
            return np.full_like(out, POISON)
        self.counts["clean"] += 1
        return out

    def predict(self, dataset) -> np.ndarray:
        return self.predict_encoded(self.encode(dataset))
