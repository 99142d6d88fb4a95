"""Bulk scoring: ``Model.predict`` on batches of raw columns, back to back,
one caller.

Traffic parameters: ``rows`` a call, ``pool`` distinct batches made in
set-up (the window takes them in turn), ``check_calls`` calls whose every
answer the reference checks, drawn from the seed among the window's. The
forest is made from the seed by the configuration's ``forest.maker``.

Untraced, a call is ``model.predict``. Traced, the window runs the three
stages ``predict`` composes (the encoder, the engine's per-tree call and
the head) with a clock and a sync around each, inside ``bench/encode``,
``bench/dispatch`` and ``bench/finalize`` spans.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from bench import frozen, reference
from bench.harness import Run, sync


@dataclass
class State:
    model: object
    arrays: dict
    spec: dict
    pool: list
    outputs: list = field(default_factory=list)    # (pool index, answers)


def make_model(run: Run, rows: dict) -> tuple:
    """The configuration's forest, made from the seed on the device, as the
    program's model (plain data through ``convert.model_from_arrays``)."""
    from repro_torch import convert
    cfg = run.config
    fcfg, data = cfg["forest"], cfg["data"]
    arrays = frozen.MAKERS[fcfg["maker"]](fcfg, data, rows, run.seed,
                                         run.device)
    spec = frozen.spec_dict(rows, data)
    model = convert.model_from_arrays(
        fcfg["kind"], arrays, spec, frozen.features(data),
        task="CLASSIFICATION", classes=data["classes"],
        loss=fcfg.get("loss"),
        winner_take_all=fcfg.get("winner_take_all", True))
    return model, arrays, spec


def setup(run: Run) -> State:
    p, data = run.params, run.config["data"]
    pool = [frozen.synth_rows(data, p["rows"], run.seed, 100 + i,
                              labels=False) for i in range(p["pool"])]
    model, arrays, spec = make_model(run, pool[0])
    model.predict(pool[0], device=run.device)      # compile + the call's shape
    return State(model, arrays, spec, pool)


def window(run: Run, state: State) -> dict:
    from repro_torch.obs import trace
    pred = state.model.predictor(None, run.device)
    stages = {"encode": [], "dispatch": [], "finalize": []}
    rows = calls = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < run.seconds:
        k = calls % len(state.pool)
        batch = state.pool[k]
        if run.trace:
            ta = time.perf_counter()
            with trace.span("bench/encode"):
                X = pred.encode(batch)
            tb = time.perf_counter()
            with trace.span("bench/dispatch"):
                per_tree = pred.per_tree(X)
                sync(run.device)
            tc = time.perf_counter()
            with trace.span("bench/finalize"):
                out = pred.finalize(per_tree)
            td = time.perf_counter()
            for name, dt in zip(stages, (tb - ta, tc - tb, td - tc)):
                stages[name].append(dt)
        else:
            out = state.model.predict(batch, device=run.device)
        state.outputs.append((k, out))
        rows += len(out)
        calls += 1
    t1 = time.perf_counter()
    return {"window_t0": t0, "window_t1": t1, "window_s": t1 - t0,
            "rows": rows, "attempted": calls, "failed": 0, "stages": stages,
            "notes": {"calls": calls}}


def facts(run: Run, state: State, rec: dict) -> None:
    """The work of the window's calls: rows and node visits of each pool
    batch by the reference's traversal, and the forest's held nodes."""
    means = np.array([c["mean"] for k, c in state.spec["columns"].items()
                      if k != "label"])
    feats = frozen.features(run.config["data"])
    visits = []
    for batch in state.pool:
        X = reference.encode(batch, feats, means, run.device)
        visits.append(int(reference.traverse(state.arrays, X)[1].sum()))
    used = [k for k, _ in state.outputs]
    rec["work"] = {"rows": [len(state.pool[k][feats[0]]) for k in used],
                   "visits": [visits[k] for k in used],
                   "features": len(feats),
                   "nodes": int(state.arrays["n_nodes"].sum()),
                   "trees": int(state.arrays["feature"].shape[0]),
                   "out_dim": int(state.arrays["leaf_value"].shape[-1])}


def check(run: Run, state: State) -> dict:
    """Every answer of ``check_calls`` calls drawn from the seed against
    the reference's prediction for the same rows."""
    picks = sample_calls(run, len(state.outputs))
    kept = [state.outputs[i] for i in picks]
    state.outputs.clear()
    state.model = None
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    return {"pred_gap": score_gap(run, state, kept)}


def sample_calls(run: Run, n_calls: int) -> list[int]:
    r = frozen.rng(run.seed, 4)
    k = min(run.params["check_calls"], n_calls)
    return sorted(r.choice(n_calls, size=k, replace=False).tolist())


def score_gap(run: Run, state: State, kept: list,
              precision: str = "float64") -> float:
    """The widest gap between the answers kept and the reference's; with
    ``precision`` below float64, the control's answers in their place."""
    feats = frozen.features(run.config["data"])
    means = reference.column_means(state.pool[0], feats)
    head = run.config["forest"]["head"]
    gap = 0.0
    for k, got in kept:
        X = reference.encode(state.pool[k], feats, means, run.device)
        want = reference.predict(state.arrays, head, X)
        if precision != "float64":
            got = reference.predict(state.arrays, head, X, precision) \
                .cpu().numpy()
        gap = max(gap, reference.widest_gap(got, want))
    return gap
