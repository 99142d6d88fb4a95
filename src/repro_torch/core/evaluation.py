"""Model evaluation with confidence intervals (paper §2.2; App. B.3 report
format), the port's copy of the classification and regression part of
``repro.core.evaluation``: host numpy over predictions and labels.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.api import Task, YdfError


@dataclass
class Evaluation:
    task: Task
    n_examples: int
    metrics: dict = field(default_factory=dict)
    confusion: np.ndarray | None = None
    classes: list[str] | None = None
    source: str = "test"  # test | validation | out-of-bag | cross-validation

    def __getitem__(self, k):
        return self.metrics[k]

    @property
    def primary(self) -> float:
        """Higher-is-better scalar for model selection."""
        if self.task == Task.CLASSIFICATION:
            return self.metrics["accuracy"]
        return -self.metrics["rmse"]

    def to_dict(self) -> dict:
        """JSON-serializable form (analysis reports, CLI --json, artefacts)."""
        metrics = {k: (list(v) if isinstance(v, tuple) else float(v))
                   for k, v in self.metrics.items()}
        return {"task": self.task.value, "n_examples": int(self.n_examples),
                "source": self.source, "metrics": metrics,
                "classes": self.classes,
                "confusion": (None if self.confusion is None
                              else self.confusion.tolist())}

    def report(self) -> str:
        L = [f"Evaluation ({self.source}):",
             f"Number of predictions: {self.n_examples}",
             f"Task: {self.task.value}"]
        for k, v in self.metrics.items():
            if isinstance(v, tuple):
                L.append(f"{k}: CI95[B][{v[0]:.6g} {v[1]:.6g}]")
            else:
                L.append(f"{k}: {v:.6g}")
        if self.confusion is not None:
            L.append("Confusion (truth x prediction):")
            L.append(str(self.confusion))
        return "\n".join(L)


def _bootstrap_ci(values: np.ndarray, stat, n_boot: int = 200, seed: int = 7):
    """95% bootstrap CI of `stat` over example-level values (paper's [B]/[W])."""
    rng = np.random.default_rng(seed)
    n = len(values)
    if n == 0:
        return 0.0, 0.0
    stats = [stat(values[rng.integers(0, n, n)]) for _ in range(n_boot)]
    return float(np.quantile(stats, 0.025)), float(np.quantile(stats, 0.975))


def auc_binary(y: np.ndarray, score: np.ndarray) -> float:
    """Rank-based AUC (Mann-Whitney)."""
    order = np.argsort(score, kind="stable")
    ranks = np.empty(len(score), np.float64)
    ranks[order] = np.arange(1, len(score) + 1)
    # midranks for ties
    s_sorted = score[order]
    i = 0
    while i < len(s_sorted):
        j = i
        while j + 1 < len(s_sorted) and s_sorted[j + 1] == s_sorted[i]:
            j += 1
        if j > i:
            ranks[order[i:j + 1]] = (i + j) / 2 + 1
        i = j + 1
    pos = y == 1
    n1, n0 = int(pos.sum()), int((~pos).sum())
    if n1 == 0 or n0 == 0:
        return 0.5
    return float((ranks[pos].sum() - n1 * (n1 + 1) / 2) / (n1 * n0))


def evaluate_predictions(task: Task, pred: np.ndarray, y: np.ndarray, *,
                         classes: list[str] | None = None,
                         source: str = "test") -> Evaluation:
    n = len(y)
    if n == 0:
        raise YdfError("Cannot evaluate on an empty dataset.")
    m: dict = {}
    confusion = None
    if task == Task.CLASSIFICATION:
        pred = np.asarray(pred)
        if pred.ndim != 2:
            raise YdfError(f"Classification predictions must be (N, n_classes), "
                           f"got shape {pred.shape}.")
        yhat = pred.argmax(1)
        correct = (yhat == y).astype(np.float64)
        lo, hi = _bootstrap_ci(correct, np.mean)
        m["accuracy"] = float(correct.mean())
        m["accuracy_ci95"] = (lo, hi)
        p = np.clip(pred[np.arange(n), y], 1e-12, None)
        m["logloss"] = float(-np.log(p).mean())
        m["error_rate"] = 1.0 - float(correct.mean())
        C = pred.shape[1]
        default = np.bincount(y, minlength=C).max() / n
        m["default_accuracy"] = float(default)
        if C == 2:
            m["auc"] = auc_binary(y, pred[:, 1])
        confusion = np.zeros((C, C), np.int64)
        np.add.at(confusion, (y, yhat), 1)
    elif task == Task.REGRESSION:
        pred = np.asarray(pred).reshape(-1)
        err = pred - y
        m["rmse"] = float(np.sqrt(np.mean(np.square(err))))
        m["mae"] = float(np.mean(np.abs(err)))
        denom = max(np.var(y), 1e-12)
        m["r2"] = float(1.0 - np.mean(np.square(err)) / denom)
    else:
        raise YdfError(f"Evaluation for task={task} is not ported yet; the "
                       "port evaluates CLASSIFICATION and REGRESSION.")
    return Evaluation(task=task, n_examples=n, metrics=m, confusion=confusion,
                      classes=classes, source=source)
