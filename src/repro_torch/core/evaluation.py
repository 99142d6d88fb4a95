"""Model evaluation with confidence intervals (paper §2.2; App. B.3 report
format), the port's copy of ``repro.core.evaluation``: host numpy over
predictions and labels, for classification, regression, ranking (NDCG@k
over groups), uplift (Qini and AUUC over treatment arms) and anomaly
detection (AUC of the anomaly score).
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
        if self.task == Task.RANKING:
            return self.metrics["ndcg@5"]
        if self.task == Task.UPLIFT:
            return self.metrics["qini"]
        if self.task == Task.ANOMALY:
            return self.metrics["auc"]
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

    @staticmethod
    def from_dict(d: dict) -> "Evaluation":
        """The inverse of ``to_dict`` (a saved model's self-evaluation):
        intervals come back as tuples, the confusion matrix as int64."""
        return Evaluation(
            task=Task(d["task"]), n_examples=int(d["n_examples"]),
            metrics={k: (tuple(v) if isinstance(v, list) else v)
                     for k, v in d["metrics"].items()},
            confusion=(None if d["confusion"] is None
                       else np.asarray(d["confusion"], np.int64)),
            classes=d["classes"], source=d["source"])

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


def _ndcg_group(rel: np.ndarray, score: np.ndarray, k: int) -> float:
    """NDCG@k for one group: DCG = sum (2^rel_i - 1)/log2(i+2) over the top-k
    by score (descending, stable index tie-break); IDCG sorts by relevance.
    A group with no relevant item (IDCG == 0) scores 0."""
    order = np.argsort(-np.asarray(score, np.float64), kind="stable")
    gains = np.power(2.0, np.asarray(rel, np.float64)) - 1.0
    disc = 1.0 / np.log2(np.arange(2, min(k, len(rel)) + 2))
    dcg = float((gains[order[:k]] * disc).sum())
    ideal = np.sort(gains)[::-1]
    idcg = float((ideal[:k] * disc).sum())
    return dcg / idcg if idcg > 0 else 0.0


def ndcg_at_k(y: np.ndarray, score: np.ndarray, groups: np.ndarray,
              k: int = 5) -> float:
    """Mean NDCG@k over groups (the ranking quality metric, paper §3.1)."""
    vals = [_ndcg_group(y[idx], score[idx], k)
            for g in np.unique(groups)
            for idx in (np.flatnonzero(groups == g),)]
    return float(np.mean(vals))


def qini_curve(y: np.ndarray, score: np.ndarray,
               treatment: np.ndarray) -> np.ndarray:
    """Incremental-uplift curve: rows sorted by predicted uplift descending
    (stable index tie-break); at cut k the value is the treated outcome sum
    minus the control outcome sum scaled to the treated count,
    ``yt_k - yc_k * nt_k / max(nc_k, 1)``."""
    order = np.argsort(-np.asarray(score, np.float64).reshape(-1),
                       kind="stable")
    t = np.asarray(treatment, np.float64)[order]
    yy = np.asarray(y, np.float64)[order]
    nt, nc = np.cumsum(t), np.cumsum(1.0 - t)
    yt, yc = np.cumsum(yy * t), np.cumsum(yy * (1.0 - t))
    return yt - yc * nt / np.maximum(nc, 1.0)


def evaluate_predictions(task: Task, pred: np.ndarray, y: np.ndarray, *,
                         classes: list[str] | None = None,
                         source: str = "test",
                         groups: np.ndarray | None = None,
                         treatment: np.ndarray | None = None) -> Evaluation:
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
    elif task == Task.RANKING:
        if groups is None:
            raise YdfError(
                "Ranking evaluation requires per-example group ids. Solution: "
                "pass groups= (Model.evaluate extracts them from the group "
                "column automatically).")
        pred = np.asarray(pred).reshape(-1)
        for k in (1, 5, 10):
            m[f"ndcg@{k}"] = ndcg_at_k(y, pred, groups, k)
        m["n_groups"] = float(len(np.unique(groups)))
    elif task == Task.UPLIFT:
        if treatment is None:
            raise YdfError(
                "Uplift evaluation requires per-example treatment assignment. "
                "Solution: pass treatment= (Model.evaluate extracts it from "
                "the treatment column automatically).")
        pred = np.asarray(pred).reshape(-1)
        g = qini_curve(y, pred, np.asarray(treatment))
        # areas normalized per example: auuc is the mean curve height / n,
        # qini subtracts the random-targeting straight line to g[-1]
        m["auuc"] = float(g.mean()) / n
        m["qini"] = float(g.mean() - g[-1] * (n + 1) / (2 * n)) / n
    elif task == Task.ANOMALY:
        pred = np.asarray(pred).reshape(-1)
        # label = 1 for planted/true anomalies; higher score = more anomalous
        m["auc"] = auc_binary((np.asarray(y, np.float64) == 1).astype(np.int64),
                              pred)
        m["mean_score"] = float(pred.mean())
    else:
        raise YdfError(f"Evaluation for task={task} not implemented.")
    return Evaluation(task=task, n_examples=n, metrics=m, confusion=confusion,
                      classes=classes, source=source)


def compare_correctness(correct_a: np.ndarray, correct_b: np.ndarray,
                        n_boot: int = 500, seed: int = 11) -> dict:
    """Paired bootstrap comparison (§2.2): per-example correctness/score
    vectors of two models on the SAME examples. Returns the mean difference,
    its CI95, and P(a beats b) under resampling."""
    if len(correct_a) != len(correct_b):
        raise YdfError("compare_correctness requires predictions on the same "
                       f"examples ({len(correct_a)} vs {len(correct_b)}).")
    d = np.asarray(correct_a, np.float64) - np.asarray(correct_b, np.float64)
    rng = np.random.default_rng(seed)
    n = len(d)
    means = np.array([d[rng.integers(0, n, n)].mean() for _ in range(n_boot)])
    return {"mean_diff": float(d.mean()),
            "ci95": (float(np.quantile(means, 0.025)),
                     float(np.quantile(means, 0.975))),
            "p_a_better": float((means > 0).mean())}
