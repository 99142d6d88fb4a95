"""Decision-forest models, serving side (mirrors ``repro.core.models``).

A ``DecisionForestModel`` holds a Forest SoA, the training DataSpec and
feature list, and routes ``predict`` through a compiled predictor
(core/engines.py). Models arrive from the JAX package through
``repro_torch.convert``; training is not part of the port yet.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.api import Task
from repro_torch.core.dataspec import DataSpec
from repro_torch.core.losses import Loss
from repro_torch.core.tree import Forest, aggregate_gbt, aggregate_rf


class DecisionForestModel:
    def __init__(self, *, forest: Forest, spec: DataSpec, features: list[str],
                 task: Task, classes: list[str] | None):
        self.forest = forest
        self.spec = spec
        self.features = list(features)
        self.task = task
        self.classes = classes
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

    def _compile_finalize(self):
        return _RfFinalize(self.winner_take_all and
                           self.task == Task.CLASSIFICATION,
                           self.task == Task.REGRESSION)


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
