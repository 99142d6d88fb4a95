"""Variable-importance engines (DESIGN.md §8), the port's copy of
``repro.analysis.importance``.

Three engines, one contract (an ``ImportanceTable`` per kind):

  * ``structural_importances`` — read straight off the Forest SoA in one
    vectorized pass (tree.Forest.variable_importances): NUM_NODES,
    NUM_AS_ROOT, SUM_SCORE (training-time split gains), INV_MEAN_MIN_DEPTH.
  * ``permutation_importances`` — mean decrease of the primary metric when
    one feature column is shuffled (Breiman 2001). Analysis is an
    inference-heavy sweep: ALL (feature, repetition) replicas are stacked
    into one large encoded batch and dispatched through the cached
    CompiledPredictor (or a ForestServeBundle's bucket ladder) — never a
    per-feature python predict loop. On the card that predictor is the
    cuda engine, so every sweep is launches of the tiled traversal kernel
    (kernels/forest_infer), and the scores are aggregated on the host. Bootstrap CI95s come from
    evaluation._bootstrap_ci over per-example score contributions.
  * ``oob_permutation_importances`` — the Random-Forest out-of-bag variant:
    per-tree bootstrap bags are REGENERATED from ``model.bag_info`` (the
    multinomial draw is the first consumption of each per-tree rng stream,
    rf.py), per-tree outputs come from the compiled engine's ``per_tree``,
    and each example is scored only by trees that did not train on it —
    the same accumulation ``compute_oob`` performs during training, so the
    unpermuted baseline reproduces ``model.self_evaluation``.

Permutations are keyed by (seed, feature, repetition), never by dispatch
order, so the batched-replica path is bit-equal to a naive per-feature loop
at equal seeds (tested).

Every sweep takes ``device`` (None is the card; without one it raises
``YdfError`` unless ``device="cpu"`` is passed) and ``engine`` (None: the
device's default), and dispatches through ``model.predictor(engine,
device)``. A failed launch propagates as it does from the predictor;
nothing moves the sweep to another engine or device.
"""
from __future__ import annotations

import numpy as np

from repro_torch.analysis.report import ImportanceEntry, ImportanceTable
from repro_torch.core.api import Task, YdfError
from repro_torch.core.dataspec import label_values
from repro_torch.core.evaluation import Evaluation, _bootstrap_ci, \
    evaluate_predictions

# row budget per stacked dispatch: large enough to amortize per-call
# overheads, small enough that the traversal's per-round (rows, trees)
# index/state arrays stay cache-resident on CPU hosts (the reference's
# measured sweet spot, kept so both packages chunk the same way)
DEFAULT_ROW_BUDGET = 8192


def structural_importances(model) -> list[ImportanceTable]:
    """Every structural kind the model exposes, as sorted tables."""
    out = []
    for kind, table in model.variable_importances().items():
        out.append(ImportanceTable(
            kind=kind, source="structure",
            entries=[ImportanceEntry(f, v) for f, v in table.items()]))
    return out


# ------------------------------------------------------------------ shared

def _require_predictor(model, device=None, engine: str | None = None):
    if not hasattr(model, "predictor"):
        raise YdfError(
            f"{type(model).__name__} has no compiled predictor; dataset-"
            "based analysis (permutation importances, PDP) supports "
            "decision-forest models. Solution: run structural analysis only "
            "(model.analyze() without a dataset).")
    return model.predictor(engine, device)


def _permutation(seed: int, feature: int, rep: int, n: int) -> np.ndarray:
    """The shuffle used for replica (feature, rep) — a pure function of
    (seed, feature, rep) so batching layout can never change scores."""
    return np.random.default_rng((seed, 1021, feature, rep)).permutation(n)


def _chunked(fn, X: np.ndarray, row_budget: int) -> np.ndarray:
    if X.shape[0] <= row_budget:
        return np.asarray(fn(X))
    return np.concatenate([np.asarray(fn(X[i:i + row_budget]))
                           for i in range(0, X.shape[0], row_budget)], axis=0)


def _example_scores(task: Task, out: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Per-example contributions the primary metric is a function of:
    correctness for classification, squared error for every scalar-output
    task (regression, and — as a proxy — ranking scores vs graded
    relevance, uplift effects vs outcome, anomaly scores vs indicator;
    the task-true metric still appears in the baseline Evaluation)."""
    if task == Task.CLASSIFICATION:
        return (np.asarray(out).argmax(1) == y).astype(np.float64)
    return np.square(np.asarray(out).reshape(-1).astype(np.float64) - y)


def _primary(task: Task, scores: np.ndarray) -> float:
    """Higher-is-better metric from per-example scores (Evaluation.primary
    convention): accuracy, or -rmse."""
    if task == Task.CLASSIFICATION:
        return float(scores.mean())
    return -float(np.sqrt(scores.mean()))


def _metric_name(task: Task) -> str:
    return "accuracy" if task == Task.CLASSIFICATION else "rmse"


def _kind_name(task: Task, oob: bool = False) -> str:
    base = ("MEAN_DECREASE_ACCURACY" if task == Task.CLASSIFICATION
            else "MEAN_INCREASE_RMSE")
    return ("OOB_" + base) if oob else base


def _entry_with_ci(task: Task, feature: str, s_base: np.ndarray,
                   s_perm: np.ndarray) -> ImportanceEntry:
    """Importance = primary(base) - mean_r primary(perm_r), CI95 by
    bootstrapping examples jointly across the base and permuted scores."""
    R = s_perm.shape[0]
    imp = _primary(task, s_base) - float(
        np.mean([_primary(task, s_perm[r]) for r in range(R)]))
    values = np.concatenate([s_base[:, None], s_perm.T], axis=1)  # (N, 1+R)

    def stat(v):
        return _primary(task, v[:, 0]) - float(
            np.mean([_primary(task, v[:, 1 + r]) for r in range(R)]))

    lo, hi = _bootstrap_ci(values, stat)
    return ImportanceEntry(feature=feature, importance=imp, ci95=(lo, hi))


# ------------------------------------------------------- permutation engine

def permutation_importances(model, dataset, *, repetitions: int = 3,
                            seed: int = 42, bundle=None,
                            row_budget: int = DEFAULT_ROW_BUDGET,
                            device=None, engine: str | None = None,
                            ) -> tuple[ImportanceTable, Evaluation]:
    """Mean decrease of the primary metric per feature, plus the unpermuted
    baseline Evaluation. All F x repetitions permuted replicas are stacked
    into encoded batches of <= ``row_budget`` rows and dispatched through
    the compiled serving path (``bundle`` routes dispatches through a
    ForestServeBundle's padding buckets instead)."""
    if repetitions < 1:
        raise YdfError(f"repetitions must be >= 1, got {repetitions}.")
    pred = _require_predictor(model, device, engine)
    X = pred.encode(dataset)
    y = label_values(model, dataset)
    N, F = X.shape
    if N == 0:
        raise YdfError("Cannot analyze an empty dataset.")
    dispatch = ((lambda Z: bundle.predict_encoded_bulk(Z, row_budget))
                if bundle is not None
                else lambda Z: _chunked(pred.predict_encoded, Z, row_budget))
    base_out = dispatch(X)
    from repro_torch.core.api import _evaluation_extras
    baseline = evaluate_predictions(
        model.task, base_out, y, classes=getattr(model, "classes", None),
        source="analysis", **_evaluation_extras(model, dataset))
    s_base = _example_scores(model.task, base_out, y)

    pairs = [(j, r) for j in range(F) for r in range(repetitions)]
    group = max(1, row_budget // N)
    s_perm = np.empty((F, repetitions, N), np.float64)
    for g0 in range(0, len(pairs), group):
        chunk = pairs[g0:g0 + group]
        X_rep = np.tile(X, (len(chunk), 1))
        for i, (j, r) in enumerate(chunk):
            X_rep[i * N:(i + 1) * N, j] = X[_permutation(seed, j, r, N), j]
        out = dispatch(X_rep)
        for i, (j, r) in enumerate(chunk):
            s_perm[j, r] = _example_scores(model.task, out[i * N:(i + 1) * N], y)

    entries = [_entry_with_ci(model.task, model.features[j], s_base, s_perm[j])
               for j in range(F)]
    table = ImportanceTable(
        kind=_kind_name(model.task), source="permutation", entries=entries,
        metric=_metric_name(model.task),
        baseline=abs(_primary(model.task, s_base)), repetitions=repetitions)
    return table, baseline


# --------------------------------------------------------- OOB permutation

def regenerate_oob_masks(bag_info: dict, n_trees: int) -> np.ndarray:
    """(T, N) bool: example i is OUT of tree t's bootstrap bag. Reproduces
    rf.py's per-tree streams: rng((seed, 104729, t)).multinomial is the
    first draw of each stream, so bags regenerate exactly."""
    N = bag_info["n_rows"]
    p = np.full(N, 1.0 / N)
    oob = np.empty((n_trees, N), bool)
    for t in range(n_trees):
        rng = np.random.default_rng((bag_info["seed"], 104729, t))
        oob[t] = rng.multinomial(N, p) == 0
    return oob


def _oob_aggregate(model, per_tree: np.ndarray, oob: np.ndarray,
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Training-time compute_oob accumulation, vectorized: per_tree
    (N, T, C) leaf outputs, oob (T, N). Returns (predictions over seen
    examples, seen mask)."""
    pt = np.asarray(per_tree, np.float64)
    C = pt.shape[-1]
    cls = model.task == Task.CLASSIFICATION
    if cls and getattr(model, "winner_take_all", False) and C > 1:
        votes = np.zeros_like(pt)
        np.put_along_axis(votes, pt.argmax(-1)[..., None], 1.0, axis=-1)
        pt = votes
    mask = oob.T[:, :, None]                      # (N, T, 1)
    sums = (pt * mask).sum(axis=1)                # (N, C)
    cnt = oob.sum(axis=0)                         # (N,)
    seen = cnt > 0
    preds = sums[seen] / cnt[seen, None]
    if cls:
        preds = preds / np.maximum(preds.sum(1, keepdims=True), 1e-12)
    return preds, seen


def oob_permutation_importances(model, dataset, *, repetitions: int = 1,
                                seed: int = 42,
                                row_budget: int = DEFAULT_ROW_BUDGET,
                                device=None, engine: str | None = None,
                                ) -> tuple[ImportanceTable, Evaluation]:
    """Breiman's out-of-bag permutation importance. ``dataset`` must be the
    exact training dataset: bags are regenerated from ``model.bag_info``
    and each example is scored only by trees it is out-of-bag for, so the
    unpermuted baseline reproduces the training-time OOB self-evaluation."""
    bag_info = getattr(model, "bag_info", None)
    if bag_info is None:
        raise YdfError(
            "OOB permutation importance needs a Random Forest trained with "
            "bootstrap=True and compute_oob=True (the learner then records "
            "model.bag_info for bag regeneration). Solutions: (1) retrain "
            "with those defaults, or (2) use permutation_importances on a "
            "held-out dataset.")
    pred = _require_predictor(model, device, engine)
    X = pred.encode(dataset)
    y = label_values(model, dataset)
    N, F = X.shape
    if N != bag_info["n_rows"]:
        raise YdfError(
            f"OOB permutation importance must run on the exact training "
            f"dataset: the model trained on {bag_info['n_rows']} rows, got "
            f"{N}. Solution: pass the training dataset (or use "
            "permutation_importances on held-out data).")
    expect = bag_info.get("fingerprint")
    if expect is not None:
        from repro_torch.core.rf import training_data_fingerprint
        if training_data_fingerprint(X, y) != expect:
            raise YdfError(
                "OOB permutation importance must run on the exact training "
                "dataset: this dataset has the right size but different "
                "content (the regenerated bootstrap bags would be "
                "meaningless). Solution: pass the training dataset, or use "
                "permutation_importances on held-out data.")
    T = model.forest.n_trees
    oob = regenerate_oob_masks(bag_info, T)
    if not oob.any():
        raise YdfError("No example is out-of-bag (forest too small); cannot "
                       "compute OOB importances.")
    out_dim = model.forest.leaf_value.shape[-1]
    # per-tree sweeps hold (rows, T, out) floats; budget rows accordingly
    rows_cap = max(256, int(row_budget * 4 // max(1, T * out_dim)))
    per_tree = lambda Z: _chunked(pred.per_tree, Z, rows_cap)

    def oob_scores(Z: np.ndarray) -> np.ndarray:
        preds, seen = _oob_aggregate(model, per_tree(Z), oob)
        return _example_scores(model.task, preds, y[seen])

    preds, seen = _oob_aggregate(model, per_tree(X), oob)
    s_base = _example_scores(model.task, preds, y[seen])
    baseline = evaluate_predictions(
        model.task, preds, y[seen], classes=getattr(model, "classes", None),
        source="out-of-bag")
    s_perm = np.empty((F, repetitions, len(s_base)), np.float64)
    for j in range(F):
        for r in range(repetitions):
            Xp = X.copy()
            Xp[:, j] = X[_permutation(seed, j, r, N), j]
            s_perm[j, r] = oob_scores(Xp)
    entries = [_entry_with_ci(model.task, model.features[j], s_base, s_perm[j])
               for j in range(F)]
    table = ImportanceTable(
        kind=_kind_name(model.task, oob=True), source="oob-permutation",
        entries=entries, metric=_metric_name(model.task),
        baseline=abs(_primary(model.task, s_base)), repetitions=repetitions)
    return table, baseline
