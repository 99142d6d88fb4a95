"""Decision-forest models and the shared training preparation (mirrors
``repro.core.models``).

A ``DecisionForestModel`` holds a Forest SoA, the training DataSpec and
feature list, and routes ``predict`` through a compiled predictor
(core/engines.py). Models come from the port's learners (core/gbt.py,
core/rf.py, core/cart.py, tasks/), from a saved model directory (``Model.load``)
or from the JAX package through ``repro_torch.convert``.
``prepare_train_data`` turns a raw dataset into the binned codes, raw
matrix and labels a learner trains on (host numpy, as in the reference).

A saved decision forest is plain data: ``forest.npz`` holds every Forest
array that is not None, and ``model.json`` the rest (task, label,
features, classes, the GBT loss name, ``winner_take_all``, ``bag_info``,
the task fields ``ranking_group``, ``treatment_col`` and ``c_psi``,
``training_logs``, the self-evaluation and the Forest's scalars). Loading
builds the model through ``convert.model_from_arrays``, the constructors
that carry a JAX-trained model across.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np

from repro_torch.core.api import Model, Task, YdfError
from repro_torch.core.binning import BinnedFeatures, bin_features
from repro_torch.core.dataspec import (
    DataSpec,
    Semantic,
    VerticalDataset,
    check_classification_label,
    dataset_from_raw,
    encode_dataset,
)
from repro_torch.core.evaluation import Evaluation
from repro_torch.core.losses import Loss
from repro_torch.core.tree import Forest, aggregate_gbt, aggregate_rf
from repro_torch.obs import trace


# ---------------------------------------------------------------- prep

@dataclass
class TrainData:
    ds: VerticalDataset
    features: list[str]
    binned: BinnedFeatures
    X_raw: np.ndarray          # (N, F) float32: raw numerical values / cat codes
    y: np.ndarray              # class idx (0-based) or float target
    w: np.ndarray              # example weights
    n_classes: int
    classes: list[str] | None
    num_lo: np.ndarray         # per numerical feature: min (oblique min-max)
    num_hi: np.ndarray
    # task side-channels (DESIGN.md §12): never input features
    groups: np.ndarray | None = None     # (N,) int64 ranking group ids
    treatment: np.ndarray | None = None  # (N,) int64 uplift arm (0=control)


def _as_vertical(dataset, spec: DataSpec | None = None) -> VerticalDataset:
    if isinstance(dataset, VerticalDataset):
        return dataset
    if spec is not None:
        return encode_dataset(dataset, spec)
    return dataset_from_raw(dataset)


def raw_matrix(ds: VerticalDataset, features: list[str]) -> np.ndarray:
    """Raw-value matrix with GLOBAL imputation from the dataspec (mean /
    most-frequent == code 1, since dictionaries are frequency-ordered)."""
    N = ds.n_rows
    X = np.zeros((N, len(features)), np.float32)
    for j, name in enumerate(features):
        col = ds.spec[name]
        if col.semantic == Semantic.NUMERICAL:
            v = ds.numerical[name].astype(np.float32).copy()
            v[np.isnan(v)] = np.float32(col.mean)
            X[:, j] = v
        else:
            v = ds.categorical[name].astype(np.float32).copy()
            fill = 1.0 if col.vocab_size > 1 else 0.0
            v[v < 0] = fill
            X[:, j] = v
    return X


def prepare_train_data(learner, dataset, *, features: list[str] | None = None,
                       max_bins: int = 255) -> TrainData:
    ds = _as_vertical(dataset)
    label = learner.label
    if label not in ds.spec.columns:
        raise YdfError(
            f'Label column "{label}" not found in the training dataset. '
            f"Available columns: {sorted(ds.spec.columns)}.")
    # task side-channel columns (ranking group / uplift treatment) are
    # extracted here and NEVER become input features — a model that splits
    # on its own query id or treatment assignment is leakage, not learning
    exclude: list[str] = []
    groups = treatment = None
    if learner.task == Task.RANKING:
        gcol = getattr(learner.hparams, "ranking_group", "group")
        if gcol not in ds.spec.columns:
            raise YdfError(
                f'Ranking training requires the group/query column "{gcol}" '
                f"in the dataset. Available columns: {sorted(ds.spec.columns)}. "
                "Solution: add the column, or point ranking_group= at it.")
        exclude.append(gcol)
        groups = np.unique(np.asarray(ds.column(gcol)).astype(str),
                           return_inverse=True)[1].astype(np.int64)
    elif learner.task == Task.UPLIFT:
        tcol = getattr(learner.hparams, "treatment", "treatment")
        if tcol not in ds.spec.columns:
            raise YdfError(
                f'Uplift training requires the treatment column "{tcol}" in '
                f"the dataset. Available columns: {sorted(ds.spec.columns)}. "
                "Solution: add the column, or point treatment= at it.")
        exclude.append(tcol)
        vals, t = np.unique(np.asarray(ds.column(tcol)).astype(str),
                            return_inverse=True)
        if len(vals) != 2:
            raise YdfError(
                f'Uplift treatment column "{tcol}" must have exactly two '
                f"distinct values (control, treated); found {len(vals)}: "
                f"{list(vals[:5])}.")
        treatment = t.astype(np.int64)
    feats = ds.spec.feature_names(label, features, exclude=exclude)
    col = ds.spec[label]
    if learner.task == Task.CLASSIFICATION:
        check_classification_label(col, learner.task)
        classes = col.vocab[1:]
        n_classes = len(classes)
        if n_classes < 2:
            raise YdfError(
                f"{learner.task.value} training (task=CLASSIFICATION) requires "
                f'a label with >= 2 classes, however {n_classes} classe(s) were '
                f'found in the label column "{label}": {classes}. Possible '
                "solutions: (1) use a training dataset with more label "
                "diversity, or (2) use task=REGRESSION for numerical targets.")
        y_enc = ds.categorical[label]
        if (y_enc <= 0).any():
            raise YdfError(
                f'Label column "{label}" has missing/out-of-dictionary values '
                "in the training set; every training example must be labeled.")
        y = (y_enc - 1).astype(np.int32)
    else:
        task_name = learner.task.value.capitalize()
        if col.semantic == Semantic.BOOLEAN and learner.task == Task.UPLIFT:
            # binary outcomes are the normal uplift case; codes are 0/1
            y = ds.column(label).astype(np.float64)
            if (y < 0).any():
                raise YdfError(
                    f'{task_name} label "{label}" contains missing values.')
        elif col.semantic != Semantic.NUMERICAL:
            raise YdfError(
                f'{task_name} training requires a NUMERICAL label, but "{label}" '
                f"is {col.semantic.value}. Solution: use task=CLASSIFICATION.")
        else:
            y = ds.numerical[label].astype(np.float64)
            if np.isnan(y).any():
                raise YdfError(
                    f'{task_name} label "{label}" contains missing values.')
        classes, n_classes = None, 0
    with trace.span("grower/binning", rows=ds.n_rows, features=len(feats)):
        binned = bin_features(ds, feats, max_bins=max_bins)
    X_raw = raw_matrix(ds, feats)
    num_cols = np.where(~binned.is_cat)[0]
    if len(num_cols) and ds.n_rows:
        num_lo = X_raw[:, num_cols].min(0).astype(np.float32)
        num_hi = X_raw[:, num_cols].max(0).astype(np.float32)
    else:
        num_lo = np.zeros(len(num_cols), np.float32)
        num_hi = np.ones(len(num_cols), np.float32)
    w = np.ones(ds.n_rows, np.float64)
    return TrainData(ds=ds, features=feats, binned=binned, X_raw=X_raw, y=y,
                     w=w, n_classes=n_classes, classes=classes,
                     num_lo=num_lo, num_hi=num_hi,
                     groups=groups, treatment=treatment)


def extract_validation(n: int, ratio: float, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """Deterministic train/valid index split (paper §3.3: learners extract
    their own validation set when none is provided)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    n_valid = int(round(n * ratio))
    return np.sort(perm[n_valid:]), np.sort(perm[:n_valid])


# ---------------------------------------------------------------- model


class DecisionForestModel(Model):
    def __init__(self, *, forest: Forest, spec: DataSpec, features: list[str],
                 task: Task, classes: list[str] | None,
                 label: str | None = None,
                 self_evaluation: Evaluation | None = None):
        self.forest = forest
        self.spec = spec
        self.features = list(features)
        self.task = task
        self.classes = classes
        self.label = label
        self.self_evaluation = self_evaluation
        self.training_logs: dict | None = None
        self._predictors: dict = {}

    # -------- engines + compiled predictor (§3.7; DESIGN.md §5.1)
    def compile(self, engine: str | None = None, device=None):
        """(Re)compile the serving stack for (engine, device): encode tables
        + engine closure + output head. Returns the selected Engine; the
        whole CompiledPredictor is ``predictor(engine, device)``.
        ``device=None`` is cuda."""
        from repro_torch.core.engines import compile_predictor, resolve_device
        key = (engine, str(resolve_device(device)))
        self._predictors[key] = compile_predictor(self, engine, key[1])
        return self._predictors[key].engine

    def predictor(self, engine: str | None = None, device=None):
        """The CompiledPredictor for (engine, device), compiled on first use
        and reused by every later ``predict``. ``device=None`` is cuda."""
        from repro_torch.core.engines import resolve_device
        key = (engine, str(resolve_device(device)))
        if key not in self._predictors:
            self.compile(engine, device)
        return self._predictors[key]

    def predict(self, dataset, *, engine: str | None = None,
                device=None) -> np.ndarray:
        """Raw request columns -> predictions. Classification: (N, n_classes)
        probabilities; regression, ranking, uplift and anomaly: (N,).
        ``engine`` names one of ``engines.ENGINES`` that the device and the
        forest allow (None: "cuda" on the card, "ref" on the CPU)."""
        return self.predictor(engine, device).predict(dataset)

    def _scores(self, dataset, engine=None, device=None) -> np.ndarray:
        """(N, T, leaf_dim) per-tree outputs via the compiled predictor."""
        p = self.predictor(engine, device)
        return np.asarray(p.per_tree(p.encode(dataset)))

    def _compile_finalize(self):
        """Self-contained output head: it captures the fields it needs, not
        the model, so the predictor does not hold the model alive."""
        raise NotImplementedError

    # -------- typed tree API (ROADMAP A6)
    def inspect(self):
        raise YdfError(
            "The typed tree API (py_tree.ModelInspector) is not ported yet "
            "(ROADMAP A6). The Forest SoA is model.forest.")

    def summary(self, verbose: int | bool = False) -> str:
        if verbose:
            raise YdfError(
                "summary(verbose=...) renders trees through "
                "py_tree.ModelInspector, which is not ported yet (ROADMAP "
                "A6). Solution: call summary() without verbose.")
        c = self.forest.node_counts()
        lines = [f"Type: {type(self).__name__}",
                 f"Task: {self.task.value}", f'Label: "{self.label}"',
                 f"Input Features ({len(self.features)}): {self.features}",
                 f"Number of trees: {c['n_trees']}",
                 f"Total number of nodes: {c['total_nodes']}",
                 f"Max depth: {self.forest.depth}"]
        vi = self.variable_importances()
        for kind, table in vi.items():
            top = sorted(table.items(), key=lambda kv: -kv[1])[:5]
            lines.append(f"Variable Importance {kind}: "
                         + ", ".join(f'"{k}" {v:g}' for k, v in top))
        if self.self_evaluation is not None:
            lines.append("Self-evaluation: "
                         + f"{self.self_evaluation.source}: "
                         + ", ".join(f"{k}={v:.4g}" for k, v in
                                     self.self_evaluation.metrics.items()
                                     if isinstance(v, float)))
        logs = getattr(self, "training_logs", None)
        if isinstance(logs, dict):
            from repro_torch.obs.logs import summarize_training_logs
            lines.extend(summarize_training_logs(logs))
            oob = logs.get("oob")
            if oob:
                lines.append(
                    f"Out-of-bag coverage: {oob['coverage']:.1%} of training "
                    f"examples "
                    f"({oob['mean_trees_per_example']:.1f} trees/example)")
        return "\n".join(lines)

    def variable_importances(self) -> dict[str, dict[str, float]]:
        return self.forest.variable_importances()

    # -------- plain-data save (Model.save writes the rest)
    def _write_state(self, path: str) -> None:
        f = self.forest
        arrays = {k: getattr(f, k) for k in _FOREST_ARRAYS
                  if getattr(f, k) is not None}
        np.savez(os.path.join(path, "forest.npz"), **arrays)
        ev = self.self_evaluation
        fields = {
            "task": self.task.value, "label": self.label,
            "features": self.features, "classes": self.classes,
            "forest": {"depth": int(f.depth), "out_dim": int(f.out_dim)},
            "loss": getattr(getattr(self, "loss", None), "name", None),
            "winner_take_all": getattr(self, "winner_take_all", None),
            "bag_info": getattr(self, "bag_info", None),
            "ranking_group": getattr(self, "ranking_group", None),
            "treatment_col": getattr(self, "treatment_col", None),
            "c_psi": getattr(self, "c_psi", None),
            "training_logs": self.training_logs,
            "self_evaluation": None if ev is None else ev.to_dict(),
        }
        with open(os.path.join(path, "model.json"), "w") as fh:
            json.dump(fields, fh, indent=1)


# the Forest arrays a saved model carries (those that are not None)
_FOREST_ARRAYS = ("feature", "threshold", "cat_mask", "left_child",
                  "leaf_value", "n_nodes", "tree_class", "init_pred",
                  "split_bin", "split_gain", "obl_weights", "obl_features")
_KIND_OF = {"GradientBoostedTreesModel": "gbt", "RandomForestModel": "rf",
            "CartModel": "cart", "UpliftModel": "uplift",
            "IsolationForestModel": "isolation"}


def load_forest_model(path: str, meta: dict) -> DecisionForestModel:
    """The decision forest saved at ``path`` (``Model.load`` has read and
    checked ``meta``, its header), built through
    ``convert.model_from_arrays``. Reads no pickle."""
    from repro_torch.convert import model_from_arrays
    if not os.path.exists(os.path.join(path, "forest.npz")):
        if os.path.exists(os.path.join(path, "model.pkl")):
            raise YdfError(
                f"Model directory {path!r} was saved by the JAX package "
                "(it holds 'model.pkl', a pickle); this package reads no "
                "pickle. Solution: load it with the JAX package and carry "
                "its Forest fields and dataspec across with "
                "repro_torch.convert.model_from_arrays.")
        raise YdfError(
            f"Model directory {path!r} has a header but no 'forest.npz'. "
            "The save was interrupted or the file was removed. Solution: "
            "re-save the model with model.save(path).")
    kind = _KIND_OF.get(meta.get("class"))
    if kind is None:
        raise YdfError(
            f"Model directory {path!r} holds a {meta.get('class')!r}; this "
            f"package loads {sorted(_KIND_OF)}.")
    try:
        with open(os.path.join(path, "model.json")) as fh:
            fields = json.load(fh)
        with open(os.path.join(path, "dataspec.json")) as fh:
            spec = json.load(fh)
    except (OSError, json.JSONDecodeError) as e:
        raise YdfError(
            f"Model directory {path!r} is incomplete or corrupt ({e}). "
            "Solution: re-save the model with model.save(path).") from None
    with np.load(os.path.join(path, "forest.npz"), allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    arrays.update(depth=fields["forest"]["depth"],
                  out_dim=fields["forest"]["out_dim"])
    model = model_from_arrays(
        kind, arrays, spec, fields["features"], task=fields["task"],
        classes=fields["classes"], loss=fields["loss"],
        winner_take_all=bool(fields["winner_take_all"]),
        treatment_col=fields.get("treatment_col") or "treatment",
        c_psi=fields.get("c_psi"))
    model.label = fields["label"]
    if fields.get("ranking_group") is not None:
        model.ranking_group = fields["ranking_group"]
    model.training_logs = fields["training_logs"]
    if fields["self_evaluation"] is not None:
        model.self_evaluation = Evaluation.from_dict(fields["self_evaluation"])
    if kind in ("rf", "cart"):
        model.bag_info = fields["bag_info"]
    return model


class GradientBoostedTreesModel(DecisionForestModel):
    def __init__(self, *, loss: Loss, **kw):
        super().__init__(**kw)
        self.loss = loss

    def _compile_finalize(self):
        return _GbtFinalize(self.loss, self.forest)

    def predict_scores(self, dataset, *, engine: str | None = None,
                       device=None) -> np.ndarray:
        """(N, out_dim) raw boosting scores (before the activation)."""
        return aggregate_gbt(self._scores(dataset, engine, device), self.forest)


class RandomForestModel(DecisionForestModel):
    def __init__(self, *, winner_take_all: bool = True, **kw):
        super().__init__(**kw)
        self.winner_take_all = winner_take_all
        # what regenerates the bootstrap bags of a trained Random Forest:
        # seed, n_rows, num_trees and a fingerprint of the training data
        # (core/rf.py); None for a model without out-of-bag evaluation
        self.bag_info: dict | None = None

    def _compile_finalize(self):
        return _RfFinalize(self.winner_take_all and
                           self.task == Task.CLASSIFICATION,
                           self.task == Task.REGRESSION)


class CartModel(RandomForestModel):
    pass


class UpliftModel(DecisionForestModel):
    """Honest uplift forest (DESIGN.md §12.2): every leaf stores the local
    treatment effect p_t - p_c; predict() averages leaves over trees, so the
    output is the per-example estimated uplift (positive = treat)."""

    def __init__(self, *, treatment_col: str = "treatment", **kw):
        super().__init__(**kw)
        self.treatment_col = treatment_col

    def _compile_finalize(self):
        return _RfFinalize(False, True)   # mean over trees, scalar output


class IsolationForestModel(DecisionForestModel):
    """Isolation forest (DESIGN.md §12.3): leaves store the path length
    depth + c(n); predict() maps the mean path length h through the anomaly
    score 2^(-h / c(psi)) — near 1 for anomalies, well below 1 for inliers."""

    def __init__(self, *, c_psi: float, **kw):
        super().__init__(**kw)
        self.c_psi = c_psi

    def _compile_finalize(self):
        return _IsolationFinalize(self.c_psi)


@dataclass
class _GbtFinalize:
    loss: Loss
    forest: Forest

    def __call__(self, per_tree: np.ndarray) -> np.ndarray:
        return self.loss.activation(aggregate_gbt(per_tree, self.forest))


@dataclass
class _RfFinalize:
    wta: bool
    regression: bool

    def __call__(self, per_tree: np.ndarray) -> np.ndarray:
        out = aggregate_rf(per_tree, self.wta)
        return out[:, 0] if self.regression else out


@dataclass
class _IsolationFinalize:
    c_psi: float

    def __call__(self, per_tree: np.ndarray) -> np.ndarray:
        # per_tree: (N, T, 1) path lengths; Liu et al. 2008 eq. 2
        h = np.asarray(per_tree)[..., 0].mean(axis=1)
        return np.power(2.0, -h / max(self.c_psi, 1e-12))
