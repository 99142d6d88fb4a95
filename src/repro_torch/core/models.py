"""Decision-forest models and the shared training preparation (mirrors
``repro.core.models``).

A ``DecisionForestModel`` holds a Forest SoA, the training DataSpec and
feature list, and routes ``predict`` through a compiled predictor
(core/engines.py). Models come from the port's learners (core/gbt.py,
core/rf.py, core/cart.py) or from the JAX package through
``repro_torch.convert``.
``prepare_train_data`` turns a raw dataset into the binned codes, raw
matrix and labels a learner trains on (host numpy, as in the reference).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.api import Task, YdfError
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
    """Classification and regression training data (the ranking and uplift
    side channels come with those tasks' learners)."""
    ds = _as_vertical(dataset)
    label = learner.label
    if label not in ds.spec.columns:
        raise YdfError(
            f'Label column "{label}" not found in the training dataset. '
            f"Available columns: {sorted(ds.spec.columns)}.")
    if learner.task not in (Task.CLASSIFICATION, Task.REGRESSION):
        raise YdfError(
            f"Training for task={learner.task.value} is not ported yet; the "
            "port trains CLASSIFICATION and REGRESSION models.")
    feats = ds.spec.feature_names(label, features)
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
        if col.semantic != Semantic.NUMERICAL:
            raise YdfError(
                f'Regression training requires a NUMERICAL label, but "{label}" '
                f"is {col.semantic.value}. Solution: use task=CLASSIFICATION.")
        y = ds.numerical[label].astype(np.float64)
        if np.isnan(y).any():
            raise YdfError(f'Regression label "{label}" contains missing values.')
        classes, n_classes = None, 0
    with trace.span("grower/binning", rows=ds.n_rows, features=len(feats)):
        binned = bin_features(ds, feats, max_bins=max_bins)
    X_raw = raw_matrix(ds, feats)
    w = np.ones(ds.n_rows, np.float64)
    return TrainData(ds=ds, features=feats, binned=binned, X_raw=X_raw, y=y,
                     w=w, n_classes=n_classes, classes=classes)


def extract_validation(n: int, ratio: float, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """Deterministic train/valid index split (paper §3.3: learners extract
    their own validation set when none is provided)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    n_valid = int(round(n * ratio))
    return np.sort(perm[n_valid:]), np.sort(perm[:n_valid])


# ---------------------------------------------------------------- model


class DecisionForestModel:
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

    def predictor(self, engine: str | None = None, device=None):
        """The CompiledPredictor for (engine, device), compiled on first use
        and reused by every later ``predict``. ``device=None`` is cuda."""
        from repro_torch.core.engines import compile_predictor, resolve_device
        key = (engine, str(resolve_device(device)))
        if key not in self._predictors:
            self._predictors[key] = compile_predictor(self, engine, key[1])
        return self._predictors[key]

    def predict(self, dataset, *, engine: str | None = None,
                device=None) -> np.ndarray:
        """Raw request columns -> predictions. Classification: (N, n_classes)
        probabilities; regression: (N,)."""
        return self.predictor(engine, device).predict(dataset)

    def _compile_finalize(self):
        """Self-contained output head: it captures the fields it needs, not
        the model, so the predictor does not hold the model alive."""
        raise NotImplementedError


class GradientBoostedTreesModel(DecisionForestModel):
    def __init__(self, *, loss: Loss, **kw):
        super().__init__(**kw)
        self.loss = loss

    def _compile_finalize(self):
        return _GbtFinalize(self.loss, self.forest)


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
