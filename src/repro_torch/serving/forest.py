"""Micro-batched decision-forest serving (DESIGN.md §5.4), the port's copy.

A factory wraps a model's CompiledPredictor (§5.1) into a frozen bundle
whose dispatches are padded to a fixed ladder of batch-size buckets, as in
the reference, so the device sees a small fixed set of batch shapes.
``MicroBatcher`` is the request loop on top: accumulate requests (encoding
each on arrival, off the dispatch path), pad the concatenated batch to its
bucket, dispatch once, and scatter per-request slices back to their
tickets.

Synchronous by design: the loop is driven by ``submit``/``flush`` calls so
it is deterministic and testable.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Mapping

import numpy as np

DEFAULT_BUCKETS = (32, 64, 128, 256, 512, 1024)


@dataclass(frozen=True)
class ForestServeBundle:
    """A compiled predictor plus the padded-dispatch policy (§5.4)."""
    predictor: Any                 # repro_torch.core.engines.CompiledPredictor
    buckets: tuple[int, ...] = DEFAULT_BUCKETS

    def __post_init__(self):
        # bucket_for scans for the first bucket >= n: the ladder must ascend
        object.__setattr__(self, "buckets", tuple(sorted(self.buckets)))

    def bucket_for(self, n: int) -> int:
        """Smallest bucket >= n; beyond the ladder, the next multiple of the
        largest bucket. The single source of truth for dispatch sizes —
        padding stats derive from it too."""
        for b in self.buckets:
            if n <= b:
                return b
        top = self.buckets[-1]
        return -(-n // top) * top

    def padded_size(self, n: int) -> int:
        """The batch size a dispatch of ``n`` rows actually runs at.
        Zero rows dispatch nothing — no phantom-row padding."""
        return self.bucket_for(n) if n else 0

    def predict_encoded(self, X: np.ndarray) -> np.ndarray:
        n = X.shape[0]
        if n == 0:
            # correctly-shaped empty output, no engine dispatch
            return np.zeros((0,) + tuple(self.predictor.out_shape),
                            np.float32)
        b = self.padded_size(n)
        if b > n:
            X = np.concatenate(
                [X, np.zeros((b - n, X.shape[1]), X.dtype)], axis=0)
        return np.asarray(self.predictor.predict_encoded(X))[:n]

    def predict(self, batch) -> np.ndarray:
        return self.predict_encoded(self.predictor.encode(batch))

    def warm_ladder(self, n_features: int,
                    up_to: int | None = None) -> list[int]:
        """Dispatch one zero batch at every ladder bucket up to
        ``up_to`` rows (all buckets when None), so no production dispatch
        pays a first call at its shape (engines.JIT_ENGINES: the kernel's
        plan and first launch, the bucketed tables' first use, the caching
        allocator's growth). Returns the bucket sizes touched. For the
        numpy engines this is a cheap pass that changes nothing."""
        touched = []
        for b in self.buckets:
            if up_to is not None and b > self.bucket_for(up_to):
                break
            self.predict_encoded(np.zeros((b, n_features), np.float32))
            touched.append(b)
        return touched

    def predict_encoded_bulk(self, X: np.ndarray,
                             chunk_rows: int | None = None) -> np.ndarray:
        """Dispatch one LARGE encoded batch (an analysis sweep: permuted
        copies, partial-dependence grids) through the bucket ladder:
        ``chunk_rows`` is rounded DOWN to a multiple of the top bucket (and
        is at least one top bucket), so every full chunk dispatches at one
        exact shape with no padding and only the last partial chunk pads
        to its bucket."""
        n = X.shape[0]
        top = self.buckets[-1]
        step = (top if chunk_rows is None
                else max(top, chunk_rows - chunk_rows % top))
        if n <= step:
            return self.predict_encoded(X)
        return np.concatenate([self.predict_encoded(X[i:i + step])
                               for i in range(0, n, step)], axis=0)


def make_forest_server(model, engine: str | None = None,
                       buckets: tuple[int, ...] = DEFAULT_BUCKETS,
                       warmup: bool = True, device=None) -> ForestServeBundle:
    """Compile ``model`` for serving on ``device`` (None -> cuda; raises
    YdfError without a card) and wrap it in a bundle. ``warmup`` runs one
    padded dispatch at the SMALLEST bucket only, so the first request does
    not pay the first launch; a dispatch that pads to a larger bucket still
    pays its first call at that shape once. To pay them all up front, call
    ``bundle.warm_ladder(len(model.features))``."""
    predictor = model.predictor(engine, device)
    bundle = ForestServeBundle(predictor, tuple(buckets))
    if warmup and len(model.features):
        bundle.predict_encoded(
            np.zeros((1, len(model.features)), np.float32))
    return bundle


@dataclass
class MicroBatcher:
    """Accumulate→pad→dispatch request loop (§5.4).

    ``submit`` encodes a request's feature columns immediately (cheap, and
    it surfaces schema errors at enqueue time) and returns a ticket; once
    pending rows reach ``max_batch`` — or on explicit ``flush`` — all
    pending requests dispatch as ONE padded engine call and every ticket
    resolves. ``result`` flushes on demand, so callers can never deadlock
    on an unfilled batch. Resolved results are held until claimed, capped
    at ``max_results``: beyond it the OLDEST unclaimed results are evicted
    (abandoned tickets must not leak memory in a long-running server; late
    claimers get a KeyError).
    """
    bundle: ForestServeBundle
    max_batch: int = 1024
    max_results: int = 4096
    dispatches: int = 0
    rows_dispatched: int = 0
    rows_padded: int = 0
    _pending: list = field(default_factory=list)      # (ticket, X rows)
    _results: dict = field(default_factory=dict)      # ticket -> np.ndarray
    _next_ticket: int = 0

    def pending_rows(self) -> int:
        return sum(len(x) for _, x in self._pending)

    def submit(self, batch: Mapping) -> int:
        X = self.bundle.predictor.encode(batch)
        ticket = self._next_ticket
        self._next_ticket += 1
        self._pending.append((ticket, X))
        if self.pending_rows() >= self.max_batch:
            self.flush()
        return ticket

    def flush(self) -> None:
        if not self._pending:
            return
        X = np.concatenate([x for _, x in self._pending], axis=0)
        n = X.shape[0]
        out = self.bundle.predict_encoded(X)
        row = 0
        for ticket, x in self._pending:
            self._results[ticket] = out[row:row + len(x)]
            row += len(x)
        # evict oldest unclaimed results — but never the ones this flush just
        # resolved, whose callers are live and about to claim them
        floor = max(self.max_results, len(self._pending))
        while len(self._results) > floor:
            self._results.pop(next(iter(self._results)))
        self.dispatches += 1
        self.rows_dispatched += n
        self.rows_padded += self.bundle.padded_size(n) - n
        self._pending = []

    def result(self, ticket: int) -> np.ndarray:
        if ticket in self._results:
            return self._results.pop(ticket)
        # validate BEFORE the side-effecting flush: a never-issued or
        # already-consumed ticket must raise immediately without dispatching
        # other callers' pending work
        if not (isinstance(ticket, int) and 0 <= ticket < self._next_ticket):
            raise KeyError(f"ticket {ticket!r} was never issued")
        if not any(t == ticket for t, _ in self._pending):
            raise KeyError(f"ticket {ticket} already consumed or evicted")
        self.flush()
        return self._results.pop(ticket)
