"""Online serving: ``ForestServer`` (its default engine chain, no deadline)
driven by ``clients`` callers in a closed loop: each has one request of
raw columns outstanding and sends its next when its answer arrives. The
server is pumped whenever requests wait.

Traffic parameters: ``clients``; ``requests`` in the pool made in set-up
(callers take them in turn); request sizes log-uniform from
``min_rows`` to ``max_rows``; ``check_requests`` answers the reference
checks, drawn from the seed among the window's, with the longest request
among them. Set-up warms every dispatch shape the window can meet: the
bucket ladder and each multiple of its top bucket up to ``clients`` times
``max_rows`` rows.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from bench import frozen, reference
from bench.generators import score
from bench.harness import Run


@dataclass
class State:
    model: object
    server: object
    arrays: dict
    spec: dict
    requests: list
    answers: list = field(default_factory=list)   # (request index, answer)


def setup(run: Run) -> State:
    from repro_torch.serving.server import ForestServer
    p, data = run.params, run.config["data"]
    sizes = frozen.request_sizes(p["requests"], p["min_rows"], p["max_rows"],
                                 run.seed)
    rows = frozen.synth_rows(data, int(sizes.sum()), run.seed, 200,
                             labels=False)
    ends = np.cumsum(sizes)
    requests = [{k: v[e - n:e] for k, v in rows.items()}
                for n, e in zip(sizes, ends)]
    model, arrays, spec = score.make_model(run, rows)
    server = ForestServer(model, device=run.device)
    bundle = server._state(None).bundle(0)
    F = len(model.features)
    bundle.warm_ladder(F)
    top = bundle.buckets[-1]
    for b in range(2 * top, p["clients"] * p["max_rows"] + top, top):
        bundle.predict_encoded(np.zeros((b, F), np.float32))
    return State(model, server, arrays, spec, requests)


def window(run: Run, state: State) -> dict:
    from repro_torch.obs import trace
    server, reqs = state.server, state.requests
    n_clients = run.params["clients"]
    latencies, rows, failed = [], 0, 0
    nxt = 0
    outstanding = {}                    # client -> (ticket, request, t)
    t0 = time.perf_counter()

    def send(client: int) -> None:
        nonlocal nxt
        k = nxt % len(reqs)
        nxt += 1
        ts = time.perf_counter()
        with trace.span("bench/submit"):
            outstanding[client] = (server.submit(reqs[k], pump=False), k, ts)

    for c in range(n_clients):
        send(c)
    while outstanding:
        with trace.span("bench/pump"):
            server.pump()
        for c in list(outstanding):
            ticket, k, ts = outstanding[c]
            if not server.done(ticket):
                continue
            del outstanding[c]
            try:
                ans = server.result(ticket)
            except Exception:           # a typed failure: counted, not kept
                failed += 1
            else:
                latencies.append(time.perf_counter() - ts)
                rows += len(ans)
                state.answers.append((k, ans))
            if time.perf_counter() - t0 < run.seconds:
                send(c)
    t1 = time.perf_counter()
    m = server.metrics
    return {"window_t0": t0, "window_t1": t1, "window_s": t1 - t0,
            "rows": rows, "attempted": len(latencies) + failed,
            "failed": failed, "latencies": latencies,
            "server": {"rows_dispatched": m.rows_dispatched,
                       "rows_padded": m.rows_padded,
                       "dispatches": m.dispatches},
            "notes": {"requests": len(latencies),
                      "dispatches": m.dispatches}}


def facts(run: Run, state: State, rec: dict) -> None:
    """The work of the requests served: rows and node visits by the
    reference's traversal of each pool request."""
    means = np.array([c["mean"] for k, c in state.spec["columns"].items()
                      if k != "label"])
    feats = frozen.features(run.config["data"])
    X = reference.encode({f: np.concatenate([r[f] for r in state.requests])
                          for f in feats}, feats, means, run.device)
    per_row = reference.traverse(state.arrays, X)[1].cpu().numpy()
    ends = np.cumsum([len(r[feats[0]]) for r in state.requests])
    visits = np.diff(np.concatenate([[0], np.cumsum(per_row)[ends - 1]]))
    used = [k for k, _ in state.answers]
    rec["work"] = {"rows": [len(state.requests[k][feats[0]]) for k in used],
                   "visits": [int(visits[k]) for k in used],
                   "features": len(feats),
                   "nodes": int(state.arrays["n_nodes"].sum()),
                   "trees": int(state.arrays["feature"].shape[0]),
                   "out_dim": int(state.arrays["leaf_value"].shape[-1]),
                   "dispatches": rec["server"]["dispatches"]}


def check(run: Run, state: State) -> dict:
    """``check_requests`` answers drawn from the seed, and the longest
    request's, against the reference's predictions."""
    n = len(state.answers)
    r = frozen.rng(run.seed, 5)
    picks = set(r.choice(n, size=min(run.params["check_requests"], n),
                         replace=False).tolist()) if n else set()
    if n:
        feat0 = frozen.features(run.config["data"])[0]
        picks.add(max(range(n), key=lambda i: len(
            state.requests[state.answers[i][0]][feat0])))
    kept = [state.answers[i] for i in sorted(picks)]
    state.answers.clear()
    state.server = state.model = None
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    return {"pred_gap": request_gap(run, state, kept)}


def request_gap(run: Run, state: State, kept: list,
                precision: str = "float64") -> float:
    feats = frozen.features(run.config["data"])
    rows = {f: np.concatenate([r[f] for r in state.requests]) for f in feats}
    means = reference.column_means(rows, feats)
    head = run.config["forest"]["head"]
    gap = 0.0
    for k, got in kept:
        X = reference.encode(state.requests[k], feats, means, run.device)
        want = reference.predict(state.arrays, head, X)
        if precision != "float64":
            got = reference.predict(state.arrays, head, X, precision) \
                .cpu().numpy()
        gap = max(gap, reference.widest_gap(got, want))
    return gap
