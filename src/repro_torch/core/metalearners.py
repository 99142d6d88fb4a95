"""Meta-Learners (paper §3.2), the port's copy of ``repro.core.metalearners``:
Learners that wrap other Learners.

All four of the paper's examples, each itself a Learner (so they compose —
Fig. 3's calibrator(ensembler(tuner(RF), GBT)) works):

  * HyperParameterTuner — random search over a space (App. C.2), scored by
    cross-validation or train-valid, optimizing loss or accuracy.
  * Ensembler           — averages the predictions of several Learners.
  * Calibrator          — Platt-scales a base Learner's scores on a held-out
    validation split.
  * FeatureSelector     — greedy backward feature elimination using the
    model's Self-Evaluation (§3.6: OOB for RF, validation for GBT).

Devices: a meta-learner takes ``device`` (None is the card; without one
``train`` raises ``YdfError`` unless ``device="cpu"`` is passed) and hands
it to every learner it builds or wraps: factories are called with
``device=``, and a wrapped Learner trains as a copy of itself on the
meta-learner's device. Scoring (the tuner's validation folds, the
calibrator's validation predictions) predicts on that device too. Nothing
trains or predicts on the CPU on the caller's behalf.

The meta-models (``EnsembleModel``, ``CalibratedModel``) predict through
their sub-models (``predict(dataset, engine=, device=)``; None is the card)
and have no plain-data form: ``save`` raises with directions, and nothing
pickles them.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Sequence

import numpy as np

from repro_torch.core.api import Learner, Model, Task, YdfError, register_learner
from repro_torch.core.dataspec import VerticalDataset, label_values
from repro_torch.core.models import _as_vertical


def _subset(ds: VerticalDataset, idx: np.ndarray) -> VerticalDataset:
    return ds.subset(idx)


def _resolve(device):
    from repro_torch.core.engines import resolve_device
    return resolve_device(device)


def _on_device(learner: Learner, device) -> Learner:
    """A copy of ``learner`` that trains on ``device`` (the caller's
    learner is left as it was). A wrapped meta-learner hands the device on
    to its own learners when it trains."""
    out = copy.copy(learner)
    out.device = device
    return out


def kfold_indices(n: int, k: int, seed: int) -> list[tuple[np.ndarray, np.ndarray]]:
    """Fold splits consistent across learners for fair comparison (§5.2)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    folds = np.array_split(perm, k)
    out = []
    for i in range(k):
        va = np.sort(folds[i])
        tr = np.sort(np.concatenate([folds[j] for j in range(k) if j != i]))
        out.append((tr, va))
    return out


def _score_model(model: Model, ds: VerticalDataset, metric: str,
                 device) -> float:
    """Higher is better."""
    ev = model.evaluate(ds, device=device)
    if metric == "accuracy":
        return ev.metrics["accuracy"]
    if metric == "loss":
        key = "logloss" if model.task == Task.CLASSIFICATION else "rmse"
        return -ev.metrics[key]
    raise YdfError(f"Unknown tuner metric {metric!r}; use 'loss' or 'accuracy'.")


class MetaLearner(Learner):
    """Base: meta-learners have no own hparams dataclass."""

    def default_hparams(self):
        return dataclasses.make_dataclass("Empty", [])()


@register_learner("HYPERPARAMETER_TUNER")
class HyperParameterTuner(MetaLearner):
    """Random-search tuner. The evaluation protocol is itself a
    hyper-parameter of the tuner (paper §3.2): 'train-valid' or 'cv'.
    ``base_factory`` is called as ``base_factory(label=, task=, seed=,
    device=, **trial_hparams)``."""

    def __init__(self, base_factory: Callable[..., Learner], space: dict[str, list],
                 *, label: str, task: Task = Task.CLASSIFICATION,
                 n_trials: int = 30, metric: str = "loss",
                 protocol: str = "train-valid", cv_folds: int = 5,
                 valid_ratio: float = 0.2, seed: int = 1234, device=None):
        super().__init__(label, task, seed=seed, device=device)
        self.base_factory = base_factory
        self.space = space
        self.n_trials = n_trials
        self.metric = metric
        self.protocol = protocol
        self.cv_folds = cv_folds
        self.valid_ratio = valid_ratio

    def _sample(self, rng) -> dict:
        return {k: v[rng.integers(0, len(v))] for k, v in self.space.items()}

    def _learner(self, hp: dict) -> Learner:
        return self.base_factory(label=self.label, task=self.task,
                                 seed=self.seed, device=self.device, **hp)

    def train(self, dataset, valid=None) -> Model:
        _resolve(self.device)            # no card: raise before any work
        ds = _as_vertical(dataset)
        rng = np.random.default_rng(self.seed)
        n = ds.n_rows
        trials: list[dict] = []
        seen = set()
        for _ in range(self.n_trials * 5):
            if len(trials) >= self.n_trials:
                break
            hp = self._sample(rng)
            key = tuple(sorted(hp.items()))
            if key not in seen:
                seen.add(key)
                trials.append(hp)

        if self.protocol == "cv":
            folds = kfold_indices(n, self.cv_folds, self.seed)
        else:
            tr, va = kfold_indices(n, max(2, int(round(1 / self.valid_ratio))),
                                   self.seed)[0]
            folds = [(tr, va)]

        best_score, best_hp = -np.inf, None
        log = []
        for hp in trials:
            scores = []
            for tr, va in folds:
                model = self._learner(hp).train(_subset(ds, tr))
                scores.append(_score_model(model, _subset(ds, va),
                                           self.metric, self.device))
            s = float(np.mean(scores))
            log.append({"hparams": hp, "score": s})
            if s > best_score:
                best_score, best_hp = s, hp
        if best_hp is None:
            raise YdfError("Hyper-parameter tuning produced no trials; "
                           "check the search space.")
        model = self._learner(best_hp).train(ds, valid)
        model.tuning_logs = {"best": best_hp, "score": best_score, "trials": log}
        return model


@register_learner("ENSEMBLER")
class Ensembler(MetaLearner):
    def __init__(self, learners: Sequence[Learner], *, label: str,
                 task: Task = Task.CLASSIFICATION, seed: int = 1234,
                 device=None):
        super().__init__(label, task, seed=seed, device=device)
        self.learners = list(learners)
        if not self.learners:
            raise YdfError("Ensembler requires at least one sub-learner.")

    def train(self, dataset, valid=None) -> "EnsembleModel":
        _resolve(self.device)
        ds = _as_vertical(dataset)
        models = [_on_device(l, self.device).train(ds, valid)
                  for l in self.learners]
        m0 = models[0]
        return EnsembleModel(models=models, label=self.label, task=self.task,
                             classes=getattr(m0, "classes", None))


def _no_plain_data(model: Model, how: str) -> None:
    raise YdfError(
        f"{type(model).__name__} has no plain-data form, and this package "
        f"writes no pickle, so it cannot be saved. Solution: {how}")


class EnsembleModel(Model):
    def __init__(self, *, models, label, task, classes):
        self.models, self.label, self.task, self.classes = models, label, task, classes

    def predict(self, dataset, **kw) -> np.ndarray:
        """The mean of the sub-models' predictions; ``kw`` (``engine``,
        ``device``) goes to each sub-model."""
        preds = [m.predict(dataset, **kw) for m in self.models]
        return np.mean(preds, axis=0)

    def save(self, path: str) -> None:
        _no_plain_data(self, "save each sub-model (model.models[i].save(dir)) "
                       "and rebuild the EnsembleModel from the loaded models.")


@register_learner("CALIBRATOR")
class Calibrator(MetaLearner):
    """Platt scaling of a binary classifier's score on a held-out split."""

    def __init__(self, base: Learner, *, label: str,
                 task: Task = Task.CLASSIFICATION, valid_ratio: float = 0.2,
                 seed: int = 1234, device=None):
        super().__init__(label, task, seed=seed, device=device)
        self.base = base
        self.valid_ratio = valid_ratio

    def train(self, dataset, valid=None) -> "CalibratedModel":
        _resolve(self.device)
        ds = _as_vertical(dataset)
        if valid is None:
            from repro_torch.core.models import extract_validation
            tr, va = extract_validation(ds.n_rows, self.valid_ratio, self.seed)
            train_ds, valid_ds = _subset(ds, tr), _subset(ds, va)
        else:
            train_ds, valid_ds = ds, _as_vertical(valid, ds.spec)
        base_model = _on_device(self.base, self.device).train(train_ds)
        p = base_model.predict(valid_ds, device=self.device)
        if p.ndim != 2 or p.shape[1] != 2:
            raise YdfError("Calibrator supports binary classification models "
                           f"(got predictions of shape {np.shape(p)}).")
        y = label_values(base_model, valid_ds)
        score = np.log(np.clip(p[:, 1], 1e-9, 1) / np.clip(1 - p[:, 1], 1e-9, 1))
        a, b = _platt_fit(score, y)
        return CalibratedModel(base=base_model, a=a, b=b, label=self.label,
                               task=self.task, classes=base_model.classes)


def _platt_fit(score: np.ndarray, y: np.ndarray, iters: int = 50):
    """1-D logistic regression p = sigmoid(a*score + b) by Newton iterations.
    Uses Platt's smoothed targets t+=(n+ +1)/(n+ +2), t-=1/(n- +2) so the fit
    cannot diverge on a separable validation set."""
    n_pos, n_neg = float((y == 1).sum()), float((y != 1).sum())
    t_pos, t_neg = (n_pos + 1) / (n_pos + 2), 1.0 / (n_neg + 2)
    y = np.where(y == 1, t_pos, t_neg)
    lam = 1e-3  # ridge: keeps the optimum finite and Newton stable
    a, b = 1.0, 0.0
    for _ in range(iters):
        z = np.clip(a * score + b, -35, 35)
        p = 1 / (1 + np.exp(-z))
        g = p - y
        ga, gb = (g * score).sum() + lam * a, g.sum() + lam * b
        h = np.maximum(p * (1 - p), 1e-9)
        haa = (h * score * score).sum() + lam
        hab = (h * score).sum()
        hbb = h.sum() + lam
        det = haa * hbb - hab * hab
        if abs(det) < 1e-12:
            break
        da = (hbb * ga - hab * gb) / det
        db = (haa * gb - hab * ga) / det
        # damp oversized Newton steps (separable-ish validation sets)
        norm = abs(da) + abs(db)
        if norm > 10.0:
            da, db = da * 10.0 / norm, db * 10.0 / norm
        a, b = a - da, b - db
        if norm < 1e-10:
            break
    return float(a), float(b)


class CalibratedModel(Model):
    def __init__(self, *, base, a, b, label, task, classes):
        self.base, self.a, self.b = base, a, b
        self.label, self.task, self.classes = label, task, classes

    def predict(self, dataset, **kw) -> np.ndarray:
        """The base model's probabilities, Platt-scaled; ``kw`` (``engine``,
        ``device``) goes to the base model."""
        p = self.base.predict(dataset, **kw)
        score = np.log(np.clip(p[:, 1], 1e-9, 1) / np.clip(1 - p[:, 1], 1e-9, 1))
        p1 = 1 / (1 + np.exp(-np.clip(self.a * score + self.b, -35, 35)))
        return np.stack([1 - p1, p1], 1)

    def save(self, path: str) -> None:
        _no_plain_data(self, "save the base model (model.base.save(dir)) and "
                       "keep its Platt parameters (model.a, model.b) beside "
                       "it.")


@register_learner("FEATURE_SELECTOR")
class FeatureSelector(MetaLearner):
    """Greedy backward elimination scored by the model's Self-Evaluation
    (OOB for RF — the paper's §3.6 example).

    ``tolerance``: a removal is accepted when the self-eval score drops by at
    most this much (default 0.0 — only score-preserving removals). Self-eval
    scores carry sampling noise (OOB on a few hundred rows moves +-1-2%
    between refits), so a small tolerance is what actually lets elimination
    shed near-zero-value features instead of stalling on noise.
    ``base_factory`` is called as ``base_factory(label=, task=, seed=,
    device=)``."""

    def __init__(self, base_factory: Callable[..., Learner], *, label: str,
                 task: Task = Task.CLASSIFICATION, max_removals: int | None = None,
                 tolerance: float = 0.0, seed: int = 1234, device=None):
        super().__init__(label, task, seed=seed, device=device)
        self.base_factory = base_factory
        self.max_removals = max_removals
        self.tolerance = tolerance

    def train(self, dataset, valid=None) -> Model:
        _resolve(self.device)
        ds = _as_vertical(dataset)
        features = ds.spec.feature_names(self.label)

        def fit(feats: list[str]) -> Model:
            learner = self.base_factory(label=self.label, task=self.task,
                                        seed=self.seed, device=self.device)
            return learner.train_with_features(ds, feats) \
                if hasattr(learner, "train_with_features") else \
                _train_on_features(learner, ds, feats)

        best_model = fit(features)
        best_score = _self_eval_score(best_model)
        removed = []
        max_rm = self.max_removals or max(0, len(features) - 1)
        improved = True
        while improved and len(features) > 1 and len(removed) < max_rm:
            improved = False
            # fast path: try dropping the 3 least-important features first
            # (NUM_NODES), then — only if none of those helps — the rest.
            # NUM_NODES over-counts deep overfit splits on continuous noise
            # columns, so the guided candidates alone can miss exactly the
            # features most worth dropping.
            vi = best_model.variable_importances().get("NUM_NODES", {})
            order = sorted(features, key=lambda f: vi.get(f, 0.0))
            for cands in (order[:3], order[3:]):
                if not cands:
                    continue
                trials = []
                for cand in cands:
                    trial_feats = [f for f in features if f != cand]
                    m = fit(trial_feats)
                    trials.append((_self_eval_score(m), cand, m, trial_feats))
                s, cand, m, trial_feats = max(trials, key=lambda t: t[0])
                # each single removal may cost at most `tolerance` relative
                # to the CURRENT model (plain thresholded elimination)
                if s >= best_score - self.tolerance:
                    best_model, best_score = m, s
                    features = trial_feats
                    removed.append(cand)
                    improved = True
                    break
        best_model.selected_features = features
        best_model.removed_features = removed
        return best_model


def _train_on_features(learner: Learner, ds: VerticalDataset,
                       feats: list[str]) -> Model:
    keep = set(feats) | {learner.label}
    sub = VerticalDataset(
        spec=dataclasses.replace(
            ds.spec, columns={k: v for k, v in ds.spec.columns.items() if k in keep}),
        numerical={k: v for k, v in ds.numerical.items() if k in keep},
        categorical={k: v for k, v in ds.categorical.items() if k in keep},
        n_rows=ds.n_rows)
    return learner.train(sub)


def _self_eval_score(model: Model) -> float:
    ev = getattr(model, "self_evaluation", None)
    if ev is None:
        raise YdfError(
            "FeatureSelector requires a base learner with Self-Evaluation "
            "(RF out-of-bag or GBT validation). Enable compute_oob / "
            "early_stopping on the base learner.")
    return ev.primary


# --------------------------------------------------------------- CV utility

def cross_validate(make_learner: Callable[[], Learner], dataset, k: int = 10,
                   seed: int = 1234, device=None) -> list:
    """Technology-agnostic k-fold CV evaluator (a §3.1 'tool over Learners').
    Every fold's learner trains and evaluates on ``device`` (None: the
    card)."""
    _resolve(device)
    ds = _as_vertical(dataset)
    evals = []
    for tr, va in kfold_indices(ds.n_rows, k, seed):
        model = _on_device(make_learner(), device).train(_subset(ds, tr))
        evals.append(model.evaluate(_subset(ds, va), device=device))
    return evals
