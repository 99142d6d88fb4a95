"""Bulk scoring of mixed columns: ``Model.predict`` on batches of raw
Adult-width columns (int64 numerical arrays, object arrays of ``str`` with
None for missing), back to back, one caller.

Traffic parameters as ``score``'s: ``rows`` a call, ``pool`` distinct
batches made in set-up and taken in turn, ``check_calls`` calls whose
every answer the reference checks, drawn from the seed. The model's
dataspec is that of a model trained on Adult's 32,561 rows made from the
seed (``frozen_mixed.spec_dict``); its forest is made from the seed by the
configuration's ``forest.maker`` (``frozen_mixed.MAKERS``). The window is
``score.window``'s.
"""
from __future__ import annotations

import numpy as np
import torch

from bench import frozen_mixed, reference_mixed
from bench.generators import score
from bench.harness import Run

window = score.window
sample_calls = score.sample_calls


def make_model(run: Run) -> tuple:
    """The configuration's forest and the dataspec of its training rows,
    made from the seed, as the program's model (plain data through
    ``convert.model_from_arrays``)."""
    from repro_torch import convert
    cfg = run.config
    fcfg, data = cfg["forest"], cfg["data"]
    trained = frozen_mixed.adult_rows(data, data["rows_published"],
                                      run.seed, 0)
    spec = frozen_mixed.spec_dict(trained, data)
    arrays = frozen_mixed.MAKERS[fcfg["maker"]](fcfg, data, trained, spec,
                                                run.seed, run.device)
    model = convert.model_from_arrays(
        fcfg["kind"], arrays, spec, frozen_mixed.features(data),
        task="CLASSIFICATION", classes=data["classes"], loss=fcfg["loss"])
    return model, arrays, spec


def setup(run: Run) -> score.State:
    p, data = run.params, run.config["data"]
    pool = [frozen_mixed.adult_rows(data, p["rows"], run.seed, 100 + i,
                                    labels=False) for i in range(p["pool"])]
    model, arrays, spec = make_model(run)
    model.predict(pool[0], device=run.device)      # compile + the call's shape
    return score.State(model, arrays, spec, pool)


def facts(run: Run, state: score.State, rec: dict) -> None:
    """The work of the window's calls: each pool batch's visits of each
    kind of condition (and the non-zero pairs of the oblique nodes
    visited) by the reference's traversal, and the forest's held nodes of
    each kind and its oblique nodes' non-zero pairs."""
    feats = frozen_mixed.features(run.config["data"])
    visits = []
    for batch in state.pool:
        X, miss = reference_mixed.encode(batch, state.spec, feats,
                                         run.device)
        visits.append(reference_mixed.traverse(state.arrays, X, miss)[1]
                      .tolist())
    a = state.arrays
    held = np.arange(a["feature"].shape[1])[None, :] < a["n_nodes"][:, None]
    inner = held & (a["left_child"] >= 0)
    obl = inner & (a["feature"] == -2)
    cat = inner & ~obl & a["cat_mask"].any(-1)
    used = [k for k, _ in state.outputs]
    rec["work"] = {"rows": [len(state.pool[k][feats[0]]) for k in used],
                   "visits": [visits[k] for k in used],
                   "features": len(feats),
                   "nodes": int(held.sum()), "oblique_nodes": int(obl.sum()),
                   "oblique_pairs": int((a["obl_weights"][obl] != 0).sum()),
                   "categorical_nodes": int(cat.sum()),
                   "obl_width": int(a["obl_weights"].shape[-1]),
                   "trees": int(a["feature"].shape[0]),
                   "out_dim": int(a["leaf_value"].shape[-1])}


def check(run: Run, state: score.State) -> dict:
    """Every answer of ``check_calls`` calls drawn from the seed against
    the reference's prediction for the same rows."""
    picks = sample_calls(run, len(state.outputs))
    kept = [state.outputs[i] for i in picks]
    state.outputs.clear()
    state.model = None
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    return {"pred_gap": score_gap(run, state, kept)}


def score_gap(run: Run, state: score.State, kept: list,
              precision: str = "float64", fault: str | None = None
              ) -> float:
    """The widest gap between the answers kept and the reference's; with
    ``precision`` below float64 or a ``fault``, the answers of the
    reference so changed in their place."""
    feats = frozen_mixed.features(run.config["data"])
    gap = 0.0
    for k, got in kept:
        X, miss = reference_mixed.encode(state.pool[k], state.spec, feats,
                                         run.device)
        want = reference_mixed.predict(state.arrays, X, miss)
        if precision != "float64" or fault is not None:
            got = reference_mixed.predict(state.arrays, X, miss, precision,
                                          fault).cpu().numpy()
        gap = max(gap, reference_mixed.widest_gap(got, want))
    return gap
