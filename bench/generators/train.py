"""Whole trainings, back to back, one caller.

The configuration's ``rows`` make a training's dataset. Traffic
parameters: ``pool`` datasets made in set-up
(each training takes the next, so no two of a window share rows),
``warm_trees`` for the set-up's warm-up training, ``check_trees`` the first
trees the reference judges and ``sample_trees`` the trees it judges besides,
drawn from the seed among the later ones (the last always among them),
``held_out_rows`` the rows the trained model scores for the check. The
window starts a training only while fewer than ``seconds`` have passed, and
finishes the one it started.
"""
from __future__ import annotations

import resource
import time
from dataclasses import dataclass, field

import numpy as np

from bench import frozen, reference
from bench.harness import Run, sync


@dataclass
class State:
    pool: list
    held: dict
    first: object = None        # the first model the window trained
    first_data: int = 0
    forests: list = field(default_factory=list)    # the window's forests


def learner(run: Run, **over):
    import repro_torch.core.gbt  # noqa: F401  (registers the learners)
    import repro_torch.core.rf   # noqa: F401
    from repro_torch.core.api import get_learner
    cfg = run.config
    return get_learner(cfg["learner"])(
        label="label", seed=cfg["learner_seed"], device=run.device,
        **{**cfg["hparams"], **over})


def setup(run: Run) -> State:
    p, data = run.params, run.config["data"]
    pool = [frozen.synth_rows(data, run.config["rows"], run.seed, i)
            for i in range(p["pool"])]
    held = frozen.synth_rows(data, p["held_out_rows"], run.seed, 10_000)
    learner(run, num_trees=p["warm_trees"]).train(pool[0])
    return State(pool, held)


def window(run: Run, state: State) -> dict:
    from repro_torch.obs import trace
    trainings = []
    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < run.seconds:
        data = state.pool[i % len(state.pool)]
        ts, cs, ws = time.perf_counter(), time.process_time(), _preempted()
        with trace.span("bench/training", index=i):
            model = learner(run).train(data)
            sync(run.device)
        te = time.perf_counter()
        trainings.append({"seconds": te - ts,
                          "cpu_seconds": time.process_time() - cs,
                          "preempted": _preempted() - ws,
                          "rows_trained": run.config["rows"],
                          "trees": int(model.forest.n_trees)})
        state.forests.append(model.forest)
        if state.first is None:
            state.first, state.first_data = model, i % len(state.pool)
        i += 1
    t1 = time.perf_counter()
    return {"window_t0": t0, "window_t1": t1, "window_s": t1 - t0,
            "trainings": trainings, "attempted": len(trainings), "failed": 0,
            "notes": {k: [t[k] for t in trainings] for k in
                      ("seconds", "cpu_seconds", "preempted", "trees")}}


def _preempted() -> int:
    """Times the host took this process off a core before it was done."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_nivcsw


def _depths(forest) -> list[int]:
    """Depth of each tree (0 for a lone root)."""
    out = []
    for t in range(forest.n_trees):
        depth = np.zeros(forest.max_nodes, np.int64)
        left = forest.left_child[t]
        for n in range(int(forest.n_nodes[t])):
            if forest.feature[t, n] >= 0:
                depth[left[n]] = depth[left[n] + 1] = depth[n] + 1
        out.append(int(depth[:int(forest.n_nodes[t])].max()))
    return out


def facts(run: Run, state: State, rec: dict) -> None:
    """The depth of every tree each training kept, and the columns."""
    rec["features"] = run.config["data"]["n_num"]
    for t, forest in zip(rec["trainings"], state.forests):
        t["depths"] = _depths(forest)


def check(run: Run, state: State) -> dict:
    """The window's first model against the reference: its trees (their
    number, and a sample of them judged node by node) and its predictions
    on held-out rows against the reference's traversal of its forest."""
    model, data = state.first, state.pool[state.first_data]
    f = model.forest
    feats = frozen.features(run.config["data"])
    got = model.predict({k: state.held[k] for k in feats}, device=run.device)
    prog = {"feature": f.feature.copy(), "split_bin": f.split_bin.astype(np.int64),
            "left_child": f.left_child.copy(),
            "leaf_value": f.leaf_value[..., 0].astype(np.float64)}
    arrays = {k: getattr(f, k).copy() for k in
              ("feature", "threshold", "left_child", "leaf_value")}
    arrays["init_pred"] = f.init_pred.copy()
    state.first = None
    del model, f
    return follow_checks(run, data, state.held, prog, arrays, got)


def judged_trees(run: Run, n_trees: int) -> list[int]:
    """The trees the reference judges: the first ``check_trees``, the last,
    and ``sample_trees`` more drawn from the seed among those between."""
    first = min(run.params["check_trees"], n_trees)
    between = np.arange(first, n_trees - 1)
    k = min(run.params["sample_trees"], len(between))
    drawn = frozen.rng(run.seed, 7).choice(between, size=k, replace=False)
    return sorted({*range(first), *drawn.tolist(), *([n_trees - 1]
                                                      if n_trees else [])})


def follow_checks(run: Run, data: dict, held: dict, prog: dict,
                  arrays: dict, got: np.ndarray,
                  precision: str = "float64", fault: str | None = None
                  ) -> dict:
    """The numbers compared: ``trees_gap``, the trees the model holds less
    the ``num_trees`` the configuration states (it stops no training
    early); ``split_gap`` and ``leaf_gap`` of the judged trees
    (``judged_trees``, ``reference.judge_gbt``); and ``pred_gap``, the
    widest gap of the held-out predictions. ``precision`` / ``fault``
    make the reference, put in the program's place, the control or a
    fault (a fault's readings leave out ``pred_gap``)."""
    cfg = run.config
    hp = cfg["hparams"]
    feats = frozen.features(cfg["data"])
    dev = run.device
    X = np.stack([data[k] for k in feats], axis=1).astype(np.float32)
    codes, _ = reference.bin_columns(X, hp["max_bins"])
    y = reference.label_index(data["label"])
    if precision != "float64" or fault is not None:
        prog = reference.grow_gbt(codes, y, hp, hp["num_trees"], dev,
                                  precision=precision, fault=fault)
    n_trees = len(prog["feature"])
    out = {"trees_gap": float(abs(n_trees - hp["num_trees"]))}
    out.update(reference.judge_gbt(codes, y, hp, prog,
                                   judged_trees(run, n_trees), dev))
    if got is None and precision == "float64":
        return out                      # a fault: the trees are its target
    means = reference.column_means(data, feats)
    Xh = reference.encode(held, feats, means, dev)
    want = reference.predict(arrays, "gbt", Xh)
    if precision != "float64":
        got = reference.predict(arrays, "gbt", Xh, precision).cpu().numpy()
    out["pred_gap"] = reference.widest_gap(got, want)
    return out
