"""Fault-tolerant serving front-end (DESIGN.md §9), the port's copy.

``ForestServer`` is the layer that faces production traffic, built over the
§5.4 ``ForestServeBundle`` dispatch policy. It adds what a synchronous
single-model micro-batcher cannot offer:

* **Deadlines + admission control** (§9.2): every request carries a
  latency budget. At submit time the server estimates completion from
  queue depth × an EWMA per-row service-time estimate; requests whose
  deadline cannot be met are SHED immediately — a loud, cheap ``RequestShed``
  at enqueue beats a silent timeout after wasted compute. Requests whose
  deadline expires while queued or during dispatch resolve as
  ``RequestTimedOut``: an accepted request either returns a correct
  prediction or raises a typed error, never a stale/partial result.
* **Retry with seeded-jitter exponential backoff** (§9.2): transient
  engine failures (``EngineFailure(transient=True)``, or output-validation
  rejections — non-finite predictions never escape) retry on the same
  engine; the jitter stream is seeded, so retry timing is deterministic
  under the fault harness.
* **Graceful degradation + circuit breaker** (§9.2): each model compiles a
  CHAIN of engines (ref → vectorized → naive on the CPU — every engine
  produces bit-identical per-tree leaf outputs, so degradation is invisible
  in the predictions). On the card the default chain is the kernel engine
  alone: work never moves from the card to the host. Only a failure AT
  DISPATCH (an ``EngineFailure``) moves traffic down the chain. Every level
  compiles when the server is built, so a kernel that does not build
  raises ``RuntimeError`` from the constructor, and a kernel launch that
  fails raises its ``RuntimeError`` from ``pump`` (the dispatch's tickets
  resolve with it); neither is served by another engine, even in a chain
  the caller passes in. Repeated primary failures open the
  circuit and traffic flows through the next engine; after a cooldown a
  half-open probe tries the primary again and closes the circuit on
  success.
* **Multi-model routing**: bundles are per model name; device-forest
  uploads stay deduplicated by the id-keyed caches in
  ``kernels/forest_infer/ops.py``, so N routed models cost N uploads, not
  N × requests.
* **Devices**: ``device=None`` is cuda; without a card the constructor
  raises ``YdfError`` and asks for ``device="cpu"``.
* **Metrics** (§9.4): accepted/shed/timed-out/retried/fallback counters,
  circuit transitions, per-bucket padding waste, and p50/p99 latency over a
  bounded reservoir.

The core is deliberately synchronous and clock-injected: driven by
``submit``/``pump``/``result`` it is deterministic under
``serving.faults.FakeClock``, which is how every failure path gets tier-1
coverage. ``AsyncForestServer`` is the thin asyncio front end that drives
the same core from an event loop.
"""
from __future__ import annotations

import asyncio
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Mapping

import numpy as np

from repro_torch.core.api import EngineFailure, YdfError
from repro_torch.core.engines import compile_predictor, resolve_device
from repro_torch.obs import clock as obs_clock
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.serving.faults import FaultyPredictor
from repro_torch.serving.forest import DEFAULT_BUCKETS, ForestServeBundle


# ------------------------------------------------------------ typed outcomes

class RequestShed(YdfError):
    """Admission control refused the request: its deadline cannot be met
    given the current queue depth and observed service rate (or the queue
    is full). Retry later, widen the deadline, or add capacity."""


class RequestTimedOut(YdfError):
    """The request was accepted but its deadline expired before a result
    was produced. The computed result (if any) is discarded — a late
    answer is treated as no answer."""


class RequestFailed(YdfError):
    """Every engine in the degradation chain failed for this dispatch.
    The underlying EngineFailure is chained as ``__cause__``."""


# ------------------------------------------------------------- retry policy

@dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff with seeded jitter (§9.2). ``max_attempts`` is
    the total number of tries per engine per dispatch; the delay before
    retry ``k`` (0-based) is ``base * factor**k * (1 + jitter*u)`` with
    ``u`` a counter-hashed uniform[0,1) draw from ``seed`` — deterministic,
    but decorrelated across dispatches (no retry convoys)."""
    max_attempts: int = 3
    base_s: float = 0.001
    factor: float = 2.0
    jitter: float = 0.5
    seed: int = 0

    def delay(self, dispatch: int, attempt: int) -> float:
        u = float(np.random.default_rng(
            (self.seed, dispatch, attempt)).random())
        return self.base_s * self.factor ** attempt * (1.0 + self.jitter * u)


# ---------------------------------------------------------- circuit breaker

class CircuitBreaker:
    """CLOSED → (threshold consecutive failures) → OPEN → (cooldown) →
    HALF_OPEN probe → CLOSED on success / OPEN on failure (§9.2)."""

    def __init__(self, failure_threshold: int = 3, cooldown_s: float = 1.0):
        self.failure_threshold = failure_threshold
        self.cooldown_s = cooldown_s
        self.state = "closed"
        self.failures = 0          # consecutive
        self.opened_at = -np.inf

    def allow(self, now: float) -> bool:
        """May this engine be tried? Transitions OPEN→HALF_OPEN once the
        cooldown has elapsed (the next dispatch is the probe)."""
        if self.state == "open":
            if now - self.opened_at >= self.cooldown_s:
                self.state = "half_open"
                return True
            return False
        return True                 # closed or half_open (probe in flight)

    def record_success(self) -> bool:
        """Returns True when this success CLOSED a non-closed circuit."""
        self.failures = 0
        if self.state != "closed":
            self.state = "closed"
            return True
        return False

    def record_failure(self, now: float) -> bool:
        """Returns True when this failure OPENED the circuit."""
        self.failures += 1
        if self.state == "half_open" or (
                self.state == "closed"
                and self.failures >= self.failure_threshold):
            self.state = "open"
            self.opened_at = now
            self.failures = 0
            return True
        if self.state == "open":    # failure while open (shouldn't dispatch)
            self.opened_at = now
        return False


# ------------------------------------------------------------------ metrics

# scalar counters exposed as plain attributes (call sites use `+=`); each
# is one unlabeled Counter series in the backing registry
_COUNTER_FIELDS = ("submitted", "accepted", "shed", "timed_out", "completed",
                   "failed", "retries", "fallback_dispatches",
                   "poisoned_rejected", "circuit_opens", "circuit_closes",
                   "dispatches", "rows_dispatched", "rows_padded")

# latency series outcomes (§13.4 survivorship fix): pre-§13 only COMPLETED
# requests entered the reservoir, so p50/p99 under overload silently
# excluded every shed and timed-out request — exactly the requests that
# make overload painful. Each outcome is its own labeled series now.
LATENCY_OUTCOMES = ("completed", "timed_out", "shed")


class ServerMetrics:
    """Serving counters + latency reservoirs (§9.4), a facade over one
    ``obs.metrics.MetricsRegistry`` (§13.4 — same schema as every other
    metric in the system). ``to_dict`` is the machine surface (benchmarks,
    CLI --json) and keeps its pre-§13 keys; ``summary`` the human one.

    Latency is a labeled histogram series ``latency_s{outcome=...}``:
    ``completed`` feeds the headline p50/p99 (unchanged semantics),
    ``timed_out`` records the sojourn time of requests that missed their
    deadline, ``shed`` the estimated-completion time that triggered
    admission shedding — so overload is measured, not censored.
    """

    def __init__(self, registry: MetricsRegistry | None = None,
                 max_latency_samples: int = 65536) -> None:
        object.__setattr__(self, "registry", registry or MetricsRegistry())
        object.__setattr__(self, "max_latency_samples",
                           int(max_latency_samples))
        for name in _COUNTER_FIELDS:
            self.registry.counter(name)
        for oc in LATENCY_OUTCOMES:
            self.registry.histogram("latency_s", outcome=oc)

    # counter attributes proxy to registry series so `metrics.shed += 1`
    # call sites stay untouched while the data lives in one schema
    def __getattr__(self, name: str):
        if name in _COUNTER_FIELDS:
            return self.__dict__["registry"].counter(name).value
        raise AttributeError(name)

    def __setattr__(self, name: str, value) -> None:
        if name in _COUNTER_FIELDS:
            self.__dict__["registry"].counter(name).value = int(value)
        else:
            object.__setattr__(self, name, value)

    @property
    def engine_dispatches(self) -> dict:
        return {k: int(v) for k, v in self.registry.labeled_values(
            "engine_dispatches", "engine").items()}

    @property
    def padding_by_bucket(self) -> dict:
        out: dict = {}
        for b, v in self.registry.labeled_values(
                "bucket_dispatches", "bucket").items():
            out[int(b)] = {"dispatches": int(v), "pad_rows": 0}
        for b, v in self.registry.labeled_values(
                "bucket_pad_rows", "bucket").items():
            out.setdefault(int(b), {"dispatches": 0, "pad_rows": 0})[
                "pad_rows"] = int(v)
        return out

    @property
    def _latencies(self) -> list:
        # legacy view: the completed-outcome reservoir (soak tests, §9.4)
        return self.registry.histogram("latency_s",
                                       outcome="completed").values

    def observe_latency(self, seconds: float,
                        outcome: str = "completed") -> None:
        h = self.registry.histogram("latency_s", outcome=outcome)
        h.cap = self.max_latency_samples
        h.observe(float(seconds))

    def observe_dispatch(self, engine: str, rows: int, padded: int) -> None:
        self.dispatches += 1
        self.rows_dispatched += rows
        self.rows_padded += padded - rows
        self.registry.counter("engine_dispatches", engine=engine).inc()
        self.registry.counter("bucket_dispatches", bucket=int(padded)).inc()
        self.registry.counter("bucket_pad_rows",
                              bucket=int(padded)).inc(padded - rows)

    def latency_percentiles(self, outcome: str = "completed") -> dict:
        vals = self.registry.histogram("latency_s", outcome=outcome).values
        if not vals:
            return {"p50_ms": None, "p99_ms": None, "n": 0}
        lat = np.asarray(vals)
        return {"p50_ms": round(float(np.percentile(lat, 50)) * 1e3, 4),
                "p99_ms": round(float(np.percentile(lat, 99)) * 1e3, 4),
                "n": len(lat)}

    def to_dict(self) -> dict:
        out = {k: getattr(self, k) for k in _COUNTER_FIELDS}
        out["engine_dispatches"] = dict(self.engine_dispatches)
        out["padding_by_bucket"] = {str(k): dict(v) for k, v in
                                    sorted(self.padding_by_bucket.items())}
        out["latency"] = self.latency_percentiles()
        out["latency_by_outcome"] = {
            oc: self.latency_percentiles(outcome=oc)
            for oc in LATENCY_OUTCOMES}
        return out

    def summary(self) -> str:
        lat = self.latency_percentiles()
        lines = [
            "ForestServer metrics:",
            f"  requests : submitted={self.submitted} accepted={self.accepted}"
            f" shed={self.shed} timed_out={self.timed_out}"
            f" completed={self.completed} failed={self.failed}",
            f"  resilience: retries={self.retries}"
            f" fallback_dispatches={self.fallback_dispatches}"
            f" poisoned_rejected={self.poisoned_rejected}"
            f" circuit_opens={self.circuit_opens}"
            f" circuit_closes={self.circuit_closes}",
            f"  dispatch : {self.dispatches} dispatches,"
            f" {self.rows_dispatched} rows (+{self.rows_padded} pad)"
            + (", engines " + " ".join(
                f"{k}={v}" for k, v in self.engine_dispatches.items())
               if self.engine_dispatches else ""),
        ]
        if lat["n"]:
            lines.append(f"  latency  : p50={lat['p50_ms']:.3f} ms "
                         f"p99={lat['p99_ms']:.3f} ms over {lat['n']} "
                         "completed requests")
        for oc in ("timed_out", "shed"):
            ol = self.latency_percentiles(outcome=oc)
            if ol["n"]:
                lines.append(f"  latency  : [{oc}] p50={ol['p50_ms']:.3f} ms "
                             f"p99={ol['p99_ms']:.3f} ms over {ol['n']} "
                             "requests (excluded from headline percentiles)")
        for b, s in sorted(self.padding_by_bucket.items()):
            total = s["dispatches"] * b
            waste = s["pad_rows"] / total if total else 0.0
            lines.append(f"  bucket {b:>5d}: {s['dispatches']} dispatches, "
                         f"{s['pad_rows']} pad rows ({waste:.1%} waste)")
        return "\n".join(lines)


# ------------------------------------------------------------- model state

@dataclass
class _Request:
    ticket: int
    model: str
    X: np.ndarray
    deadline: float | None         # absolute, server-clock time
    t_submit: float


class _ModelState:
    """Per-routed-model serving state: the engine chain with its bundles
    (every level compiled up front), one circuit breaker per engine level,
    the EWMA service-rate estimate, and the pending request queue."""

    def __init__(self, name: str, model, chain: list[str],
                 buckets: tuple[int, ...], failure_threshold: int,
                 cooldown_s: float, device):
        self.name = name
        self.model = model
        self.chain = chain
        self.buckets = tuple(buckets)
        # compiled here, not lazily inside the degradation loop: a build
        # error is not an EngineFailure and must not be served around
        self.bundles = [ForestServeBundle(
            compile_predictor(model, engine, device), self.buckets)
            for engine in chain]
        self.breakers = [CircuitBreaker(failure_threshold, cooldown_s)
                         for _ in chain]
        self.ewma_row_s: float | None = None
        self.queue: list[_Request] = []

    def bundle(self, level: int) -> ForestServeBundle:
        return self.bundles[level]

    def pending_rows(self) -> int:
        return sum(len(r.X) for r in self.queue)


def _default_chain(device) -> list[str]:
    """The kernel engine alone on the card, for every forest (sparse-oblique
    ones too); on the CPU the degradation chain: "ref" (the plain PyTorch
    traversal), then the numpy engines."""
    return ["cuda"] if device.type == "cuda" else ["ref", "vectorized", "naive"]


# ------------------------------------------------------------------- server

class ForestServer:
    """The fault-tolerant request front-end (§9). See module docstring.

    ``models`` is one model or a ``{name: model}`` mapping (multi-model
    routing); requests address a model by name, defaulting to the single /
    first one. ``clock``/``sleep`` default to real time; hand in
    ``FakeClock.now``/``FakeClock.sleep`` for deterministic tests.
    ``device`` is where the engines run: None is cuda, and without a card
    the constructor raises YdfError unless ``device="cpu"`` is passed.
    """

    def __init__(self, models, *,
                 engines: Mapping[str, list[str]] | list[str] | None = None,
                 buckets: tuple[int, ...] = DEFAULT_BUCKETS,
                 default_deadline_s: float | None = None,
                 max_batch: int = 1024,
                 max_queue_rows: int = 8192,
                 max_results: int = 4096,
                 retry: RetryPolicy = RetryPolicy(),
                 failure_threshold: int = 3,
                 cooldown_s: float = 0.5,
                 ewma_alpha: float = 0.3,
                 admission_overhead_s: float = 0.0,
                 validate_output: Callable[[np.ndarray], bool] | None = None,
                 clock: Callable[[], float] | None = None,
                 sleep: Callable[[float], None] | None = None,
                 warmup: bool = False,
                 device=None):
        self.device = resolve_device(device)
        if not isinstance(models, Mapping):
            models = {"default": models}
        if not models:
            raise YdfError("ForestServer needs at least one model to route.")
        self.default_deadline_s = default_deadline_s
        self.max_batch = max_batch
        self.max_queue_rows = max_queue_rows
        self.max_results = max_results
        self.retry = retry
        self.ewma_alpha = ewma_alpha
        self.admission_overhead_s = admission_overhead_s
        # non-finite predictions are treated as an engine failure: never
        # silently corrupt a caller's result (§2.1 safety of use)
        self.validate_output = validate_output or \
            (lambda out: bool(np.isfinite(out).all()))
        self._clock = clock or obs_clock.monotonic
        self._sleep = sleep or time.sleep
        self.metrics = ServerMetrics()
        self._states: dict[str, _ModelState] = {}
        for name, model in models.items():
            chain = engines.get(name) if isinstance(engines, Mapping) \
                else engines
            chain = list(chain) if chain else _default_chain(self.device)
            self._states[name] = _ModelState(
                name, model, chain, buckets, failure_threshold, cooldown_s,
                self.device)
        self._default_model = next(iter(self._states))
        self._next_ticket = 0
        self._ticket_model: dict[int, str] = {}
        # ticket -> ("ok", array) | ("err", exception); insertion-ordered so
        # abandoned results evict oldest-first (bounded memory, §9.4)
        self._done: "OrderedDict[int, tuple]" = OrderedDict()
        self._dispatch_seq = 0      # retry-jitter counter
        if warmup:
            for st in self._states.values():
                st.bundle(0).predict_encoded(np.zeros(
                    (1, len(st.model.features)), np.float32))

    # ------------------------------------------------------------- routing

    def _state(self, model: str | None) -> _ModelState:
        name = model if model is not None else self._default_model
        st = self._states.get(name)
        if st is None:
            raise YdfError(
                f"Unknown model {name!r}. Routed models: "
                f"{sorted(self._states)}.")
        return st

    def models(self) -> list[str]:
        return list(self._states)

    def engine_status(self, model: str | None = None) -> list[dict]:
        """Chain snapshot for introspection / the CLI: one row per engine
        level with its circuit state."""
        st = self._state(model)
        return [{"engine": e, "circuit": br.state}
                for e, br in zip(st.chain, st.breakers)]

    def inject_faults(self, plan, model: str | None = None, level: int = 0,
                      advance: Callable[[float], None] | None = None):
        """Wrap the engine at ``level`` of ``model``'s chain in a
        ``FaultyPredictor`` replaying ``plan`` (serving/faults.py). Returns
        the wrapper so tests can assert on its call/fault counts. Injected
        latency advances the server's own timeline by default. Re-injecting
        REPLACES any previous plan (wrappers never stack)."""
        st = self._state(model)
        base = st.bundle(level)
        pred = base.predictor
        while isinstance(pred, FaultyPredictor):
            pred = pred.inner
        wrapped = FaultyPredictor(pred, plan, advance=advance or self._sleep)
        st.bundles[level] = ForestServeBundle(wrapped, base.buckets)
        return wrapped

    def clear_faults(self, model: str | None = None, level: int = 0) -> None:
        """Restore the pristine predictor at ``level`` (undo inject_faults)."""
        st = self._state(model)
        base = st.bundle(level)
        pred = base.predictor
        while isinstance(pred, FaultyPredictor):
            pred = pred.inner
        st.bundles[level] = ForestServeBundle(pred, base.buckets)

    # ----------------------------------------------------------- admission

    def _estimate_service_s(self, st: _ModelState, rows: int) -> float | None:
        """Expected seconds to serve a dispatch of ``rows`` queued rows:
        padded batch size × EWMA per-row service time (+ fixed overhead).
        None until the first dispatch has been observed (optimistic
        admission: with no evidence, accept)."""
        if st.ewma_row_s is None or rows == 0:
            return None
        padded = st.bundle(0).bucket_for(rows)
        return padded * st.ewma_row_s + self.admission_overhead_s

    def submit(self, batch, *, model: str | None = None,
               deadline_s: float | None = None, pump: bool = True) -> int:
        """Encode + admit one request. Returns a ticket, or raises
        ``RequestShed`` (loudly, at enqueue) when the deadline cannot be
        met or the queue is full. ``deadline_s`` is relative to now;
        ``None`` falls back to the server default (``None`` = no deadline).
        """
        st = self._state(model)
        X = st.bundle(0).predictor.encode(batch)   # schema errors = caller's
        now = self._clock()
        if deadline_s is None:
            deadline_s = self.default_deadline_s
        self.metrics.submitted += 1
        queued = st.pending_rows()
        if queued + len(X) > self.max_queue_rows:
            self.metrics.shed += 1
            est = self._estimate_service_s(st, queued + len(X))
            self.metrics.observe_latency(est or 0.0, outcome="shed")
            raise RequestShed(
                f"queue full for model {st.name!r}: {queued} rows pending, "
                f"request adds {len(X)} (max_queue_rows={self.max_queue_rows})."
                " Retry later or raise max_queue_rows.")
        if deadline_s is not None:
            est = self._estimate_service_s(st, queued + len(X))
            if est is not None and est > deadline_s:
                self.metrics.shed += 1
                self.metrics.observe_latency(est, outcome="shed")
                raise RequestShed(
                    f"deadline {deadline_s * 1e3:.2f} ms cannot be met for "
                    f"model {st.name!r}: {queued} rows queued ahead, "
                    f"estimated completion in {est * 1e3:.2f} ms "
                    f"(EWMA {st.ewma_row_s * 1e6:.1f} us/row). "
                    "Shed at admission — widen the deadline or add capacity.")
        ticket = self._next_ticket
        self._next_ticket += 1
        deadline = None if deadline_s is None else now + deadline_s
        st.queue.append(_Request(ticket, st.name, X, deadline, now))
        self._ticket_model[ticket] = st.name
        self.metrics.accepted += 1
        if pump and st.pending_rows() >= self.max_batch:
            self.pump(model=st.name)
        return ticket

    # ------------------------------------------------------------ dispatch

    def _attempt_engine(self, st: _ModelState, level: int,
                        X: np.ndarray) -> np.ndarray:
        """One engine's tries for this dispatch: up to ``retry.max_attempts``
        attempts with backoff on TRANSIENT failures (injected transients,
        output-validation rejections). Non-transient failures propagate
        immediately — retrying a dead engine only burns the deadline."""
        bundle = st.bundle(level)
        seq = self._dispatch_seq
        self._dispatch_seq += 1
        last: EngineFailure | None = None
        for attempt in range(max(1, self.retry.max_attempts)):
            if attempt:
                self.metrics.retries += 1
                self._sleep(self.retry.delay(seq, attempt - 1))
            t0 = self._clock()
            try:
                out = np.asarray(bundle.predict_encoded(X))
                if not self.validate_output(out):
                    self.metrics.poisoned_rejected += 1
                    raise EngineFailure(
                        f"engine {st.chain[level]!r} returned invalid "
                        f"(non-finite) predictions for {len(X)} rows",
                        engine=st.chain[level], transient=True)
            except EngineFailure as e:
                last = e
                if not e.transient:
                    raise
                continue
            dt = self._clock() - t0
            padded = bundle.padded_size(len(X))
            rate = dt / max(1, padded)
            st.ewma_row_s = rate if st.ewma_row_s is None else (
                self.ewma_alpha * rate
                + (1.0 - self.ewma_alpha) * st.ewma_row_s)
            self.metrics.observe_dispatch(st.chain[level], len(X), padded)
            if level > 0:
                self.metrics.fallback_dispatches += 1
            return out
        raise last  # transient retries exhausted

    def _predict_resilient(self, st: _ModelState, X: np.ndarray) -> np.ndarray:
        """Walk the degradation chain under the circuit breakers. Raises
        ``RequestFailed`` only when every engine is down."""
        last: Exception | None = None
        for level in range(len(st.chain)):
            br = st.breakers[level]
            if not br.allow(self._clock()):
                continue                      # circuit open: skip this engine
            try:
                out = self._attempt_engine(st, level, X)
            except EngineFailure as e:
                last = e
                if br.record_failure(self._clock()):
                    self.metrics.circuit_opens += 1
                continue
            if br.record_success():
                self.metrics.circuit_closes += 1
            return out
        raise RequestFailed(
            f"all engines failed for model {st.name!r} "
            f"(chain {st.chain}): {last}") from last

    def _resolve(self, req: _Request, value=None, error=None) -> None:
        self._ticket_model.pop(req.ticket, None)
        self._done[req.ticket] = ("err", error) if error is not None \
            else ("ok", value)
        # abandoned-results cap: oldest unclaimed entries go first (§9.4)
        while len(self._done) > self.max_results:
            self._done.popitem(last=False)

    def pump(self, model: str | None = None) -> list[int]:
        """Dispatch all pending requests (for one model, or every model) as
        padded batches; resolve their tickets. Returns the resolved
        tickets. Expired requests are dropped BEFORE dispatch (no compute
        for a caller that already gave up) and requests whose deadline
        passes DURING dispatch resolve as timed out — a late result is
        discarded, never delivered."""
        states = [self._state(model)] if model is not None \
            else list(self._states.values())
        resolved: list[int] = []
        for st in states:
            if not st.queue:
                continue
            reqs, st.queue = st.queue, []
            now = self._clock()
            live: list[_Request] = []
            for r in reqs:
                if r.deadline is not None and now > r.deadline:
                    self.metrics.timed_out += 1
                    self.metrics.observe_latency(now - r.t_submit,
                                                 outcome="timed_out")
                    self._resolve(r, error=RequestTimedOut(
                        f"deadline expired while queued "
                        f"({(now - r.t_submit) * 1e3:.2f} ms since submit)"))
                    resolved.append(r.ticket)
                else:
                    live.append(r)
            if not live:
                continue
            X = np.concatenate([r.X for r in live], axis=0)
            try:
                out = self._predict_resilient(st, X)
            except RequestFailed as e:
                for r in live:
                    self.metrics.failed += 1
                    self._resolve(r, error=RequestFailed(str(e)))
                    resolved.append(r.ticket)
                continue
            except Exception as e:      # a dead kernel: fail loudly
                for r in live:
                    self.metrics.failed += 1
                    self._resolve(r, error=e)
                raise
            t_done = self._clock()
            row = 0
            for r in live:
                end = row + len(r.X)
                if r.deadline is not None and t_done > r.deadline:
                    self.metrics.timed_out += 1
                    self.metrics.observe_latency(t_done - r.t_submit,
                                                 outcome="timed_out")
                    self._resolve(r, error=RequestTimedOut(
                        f"deadline expired during dispatch "
                        f"({(t_done - r.t_submit) * 1e3:.2f} ms since "
                        "submit); late result discarded"))
                else:
                    self.metrics.completed += 1
                    self.metrics.observe_latency(t_done - r.t_submit)
                    self._resolve(r, value=out[row:end])
                resolved.append(r.ticket)
                row = end
        return resolved

    # ------------------------------------------------------------- results

    def done(self, ticket: int) -> bool:
        return ticket in self._done

    def result(self, ticket: int) -> np.ndarray:
        """Claim a ticket: returns its predictions or raises its typed
        error (RequestTimedOut / RequestFailed). Pending tickets pump
        their model on demand; never-issued or already-claimed tickets
        raise KeyError without side effects."""
        if ticket not in self._done:
            name = self._ticket_model.get(ticket)
            if name is None:
                raise KeyError(
                    f"ticket {ticket!r} was never issued, already claimed, "
                    "or evicted")
            self.pump(model=name)
        status, payload = self._done.pop(ticket)
        if status == "err":
            raise payload
        return payload

    def predict(self, batch, *, model: str | None = None,
                deadline_s: float | None = None) -> np.ndarray:
        """Synchronous convenience: submit + pump + result."""
        ticket = self.submit(batch, model=model, deadline_s=deadline_s)
        return self.result(ticket)


# ------------------------------------------------------------ async wrapper

class AsyncForestServer:
    """The asyncio front end over the deterministic core (§9.5).

    ``await aserver.predict(batch)`` submits into the shared queue and
    awaits its ticket; a background flusher pumps the server every
    ``flush_interval_s``, so concurrent awaiters micro-batch into shared
    padded dispatches. Shed requests fail their future at submit. Dispatch
    runs inline on the loop (one engine call; for multi-core serving put
    the whole server behind a thread or process pool).

    A dead kernel fails loudly here too: when ``pump`` raises (a failed
    launch, which ``ForestServer`` never serves around), every pending
    future gets that error and the flusher ends with it, so ``__aexit__``
    re-raises it.

        async with AsyncForestServer(server) as a:
            preds = await asyncio.gather(*(a.predict(b) for b in batches))
    """

    def __init__(self, server: ForestServer, flush_interval_s: float = 0.002):
        self.server = server
        self.flush_interval_s = flush_interval_s
        self._futures: dict[int, asyncio.Future] = {}
        self._task: asyncio.Task | None = None

    async def __aenter__(self) -> "AsyncForestServer":
        self._task = asyncio.get_running_loop().create_task(self._run())
        return self

    async def __aexit__(self, *exc) -> None:
        task, self._task = self._task, None
        if task is not None:
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass
        self._drain()   # resolve anything the last pump completed

    async def _run(self) -> None:
        while True:
            await asyncio.sleep(self.flush_interval_s)
            if self._futures:
                try:
                    self.server.pump()
                except Exception as e:
                    self._drain()
                    for fut in self._futures.values():
                        if not fut.done():
                            fut.set_exception(e)
                    self._futures.clear()
                    raise
                self._drain()

    def _drain(self) -> None:
        for ticket in [t for t in self._futures if self.server.done(t)]:
            fut = self._futures.pop(ticket)
            if fut.done():
                continue
            try:
                fut.set_result(self.server.result(ticket))
            except Exception as e:      # the ticket's typed error, or the
                fut.set_exception(e)    # dead kernel's RuntimeError

    async def predict(self, batch, *, model: str | None = None,
                      deadline_s: float | None = None) -> np.ndarray:
        loop = asyncio.get_running_loop()
        # pump=False: resolution happens on the flusher tick so concurrent
        # submitters share one padded dispatch instead of racing max_batch
        ticket = self.server.submit(batch, model=model,
                                    deadline_s=deadline_s, pump=False)
        fut: asyncio.Future = loop.create_future()
        self._futures[ticket] = fut
        if self.server.done(ticket):
            self._drain()
        return await fut
