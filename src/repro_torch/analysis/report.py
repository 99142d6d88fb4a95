"""Structured model-analysis reports (DESIGN.md §8), the port's copy of
``repro.analysis.report``; host code, and the text and JSON forms are the
reference's, character for character.

Every analysis engine (structural / permutation / OOB importances, partial
dependence) returns one of the dataclasses below; ``AnalysisReport`` bundles
them with the optional evaluation. Each object renders BOTH ways the paper's
§4.1 artefact style demands: ``report()`` (human text, with ASCII sparklines
for curves) and ``to_dict()`` (pure-JSON payload for the CLI ``--json`` path
and for downstream tooling).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.evaluation import Evaluation

_SPARK = "▁▂▃▄▅▆▇█"


def sparkline(values) -> str:
    """Min-max-scaled block-character rendering of a 1-D series."""
    v = np.asarray(values, np.float64).ravel()
    if v.size == 0:
        return ""
    lo, hi = float(np.nanmin(v)), float(np.nanmax(v))
    if not np.isfinite(lo) or not np.isfinite(hi) or hi - lo < 1e-12:
        return _SPARK[0] * v.size
    idx = np.clip(((v - lo) / (hi - lo) * (len(_SPARK) - 1) + 0.5).astype(int),
                  0, len(_SPARK) - 1)
    return "".join(_SPARK[i] for i in idx)


@dataclass
class ImportanceEntry:
    feature: str
    importance: float
    ci95: tuple[float, float] | None = None  # bootstrap CI (permutation kinds)

    def to_dict(self) -> dict:
        d = {"feature": self.feature, "importance": float(self.importance)}
        if self.ci95 is not None:
            d["ci95"] = [float(self.ci95[0]), float(self.ci95[1])]
        return d


@dataclass
class ImportanceTable:
    """One importance kind, entries sorted most-important-first. All kinds
    are higher-is-more-important (structural kinds by construction;
    permutation kinds measure the drop of the higher-is-better primary
    metric), so every table shares one sort order."""
    kind: str                  # e.g. "SUM_SCORE", "MEAN_DECREASE_ACCURACY"
    source: str                # structure | permutation | oob-permutation
    entries: list[ImportanceEntry]
    metric: str | None = None     # underlying metric for permutation kinds
    baseline: float | None = None  # unpermuted metric value
    repetitions: int | None = None

    def __post_init__(self):
        self.entries = sorted(self.entries, key=lambda e: -e.importance)

    def ranking(self) -> list[str]:
        return [e.feature for e in self.entries]

    def top(self, n: int = 5) -> list[ImportanceEntry]:
        return self.entries[:n]

    def __getitem__(self, feature: str) -> float:
        for e in self.entries:
            if e.feature == feature:
                return e.importance
        raise KeyError(feature)

    def to_dict(self) -> dict:
        d = {"kind": self.kind, "source": self.source,
             "entries": [e.to_dict() for e in self.entries]}
        if self.metric is not None:
            d["metric"] = self.metric
            d["baseline"] = float(self.baseline)
            d["repetitions"] = self.repetitions
        return d

    def report(self) -> str:
        head = f"Variable importance {self.kind} ({self.source}"
        if self.metric is not None:
            head += (f"; baseline {self.metric}={self.baseline:.6g}, "
                     f"{self.repetitions} repetition(s)")
        lines = [head + "):"]
        width = max((len(e.feature) for e in self.entries), default=0)
        for i, e in enumerate(self.entries):
            ci = (f"  CI95[{e.ci95[0]:.6g}, {e.ci95[1]:.6g}]"
                  if e.ci95 is not None else "")
            lines.append(f"  {i + 1:>3}. {e.feature:<{width}} "
                         f"{e.importance:>12.6g}{ci}")
        return "\n".join(lines)


@dataclass
class PDPCurve:
    """Partial dependence of the model output on one feature, plus the
    per-grid-point dispersion of the underlying conditional-expectation
    (ICE) curves. ``mean``/``stdev`` are (grid, out) where out is
    n_classes for classification and 1 for regression; ``ice`` (optional)
    keeps the full (grid, sample, out) curves."""
    feature: str
    semantic: str                    # NUMERICAL | CATEGORICAL | BOOLEAN
    grid: np.ndarray                 # (g,) raw values / category codes
    mean: np.ndarray                 # (g, out)
    stdev: np.ndarray                # (g, out)
    labels: list[str] | None = None  # categorical grid value names
    classes: list[str] | None = None
    n_sample: int = 0
    ice: np.ndarray | None = None    # (g, n_sample, out)

    def curve(self, class_idx: int = -1) -> np.ndarray:
        """The (g,) mean curve for one output column (default: last class —
        the positive class for binary models — or the regression output)."""
        return self.mean[:, class_idx]

    def to_dict(self) -> dict:
        d = {"feature": self.feature, "semantic": self.semantic,
             "grid": [float(v) for v in self.grid],
             "mean": self.mean.tolist(), "stdev": self.stdev.tolist(),
             "n_sample": int(self.n_sample)}
        if self.labels is not None:
            d["labels"] = list(self.labels)
        if self.classes is not None:
            d["classes"] = list(self.classes)
        if self.ice is not None:
            d["ice"] = self.ice.tolist()
        return d

    def report(self) -> str:
        out = self.mean.shape[1]
        heads = (self.classes if self.classes and len(self.classes) == out
                 else ([""] if out == 1 else [str(k) for k in range(out)]))
        lines = []
        for k, cname in enumerate(heads):
            tag = f" p({cname})" if cname else ""
            lo, hi = float(self.mean[:, k].min()), float(self.mean[:, k].max())
            lines.append(
                f'  "{self.feature}"{tag} [{lo:.4g}, {hi:.4g}] '
                f"{sparkline(self.mean[:, k])}")
            if out == 1:
                break
        if self.labels is not None:
            shown = ", ".join(self.labels[:6])
            lines.append(f"    grid: {shown}"
                         + (", ..." if len(self.labels) > 6 else ""))
        else:
            lines.append(f"    grid: {self.grid[0]:.4g} .. "
                         f"{self.grid[-1]:.4g} ({len(self.grid)} points)")
        return "\n".join(lines)


@dataclass
class AnalysisReport:
    """The ``model.analyze(ds)`` result: text via ``report()``/``str()``,
    JSON payload via ``to_dict()``."""
    model_type: str
    task: str
    label: str
    n_examples: int                       # 0 for structure-only analyses
    importances: list[ImportanceTable] = field(default_factory=list)
    pdp: list[PDPCurve] = field(default_factory=list)
    evaluation: Evaluation | None = None
    notes: list[str] = field(default_factory=list)

    def importance(self, kind: str) -> ImportanceTable:
        for t in self.importances:
            if t.kind == kind:
                return t
        raise KeyError(
            f"No importance table {kind!r}. Available: "
            f"{[t.kind for t in self.importances]}")

    def pdp_curve(self, feature: str) -> PDPCurve:
        for c in self.pdp:
            if c.feature == feature:
                return c
        raise KeyError(
            f"No PDP curve for {feature!r}. Available: "
            f"{[c.feature for c in self.pdp]}")

    def to_dict(self) -> dict:
        return {
            "model_type": self.model_type, "task": self.task,
            "label": self.label, "n_examples": int(self.n_examples),
            "variable_importances": [t.to_dict() for t in self.importances],
            "partial_dependence": [c.to_dict() for c in self.pdp],
            "evaluation": (None if self.evaluation is None
                           else self.evaluation.to_dict()),
            "notes": list(self.notes),
        }

    def report(self) -> str:
        lines = [f"Analysis of {self.model_type} "
                 f'(task={self.task}, label="{self.label}")']
        if self.n_examples:
            lines.append(f"Examples analyzed: {self.n_examples}")
        for t in self.importances:
            lines += ["", t.report()]
        if self.pdp:
            lines += ["", "Partial dependence:"]
            for c in self.pdp:
                lines.append(c.report())
        if self.evaluation is not None:
            lines += ["", self.evaluation.report()]
        for n in self.notes:
            lines += ["", f"note: {n}"]
        return "\n".join(lines)

    __str__ = report
