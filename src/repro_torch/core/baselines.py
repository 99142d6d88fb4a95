"""The linear baseline the paper benchmarks against (§5), the port of
``repro.core.baselines``: multinomial logistic or linear regression on
standardized numericals and one-hot categoricals, trained with torch
autograd and Adam on the learner's device.

A saved ``LinearModel`` is plain data: ``linear.npz`` (W, b) and
``model.json`` (task, label, features, classes), beside the
``header.json`` and ``dataspec.json`` that ``Model.save`` writes;
``Model.load`` reads it back through ``convert.model_from_arrays`` (kind
"linear").
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from repro_torch.core.api import Learner, Model, Task, YdfError, register_learner
from repro_torch.core.dataspec import DataSpec, Semantic, VerticalDataset
from repro_torch.core.models import _as_vertical, prepare_train_data


def _design_matrix(ds: VerticalDataset, features: list[str], spec) -> np.ndarray:
    """Standardized numericals + one-hot categoricals (the paper's encoding
    for libraries without native categorical support)."""
    cols = []
    for name in features:
        col = spec[name]
        if col.semantic == Semantic.NUMERICAL:
            v = ds.numerical[name].astype(np.float64).copy()
            v[np.isnan(v)] = col.mean
            sd = col.std if col.std > 1e-12 else 1.0
            cols.append(((v - col.mean) / sd)[:, None])
        else:
            v = ds.categorical[name].copy()
            v[v < 0] = 0
            V = max(col.vocab_size, int(v.max()) + 1, 2)
            oh = np.zeros((len(v), V), np.float64)
            oh[np.arange(len(v)), v] = 1.0
            cols.append(oh)
    return np.concatenate(cols, axis=1)


class LinearModel(Model):
    """z = X @ W + b over ``_design_matrix``: softmax probabilities for
    classification, z[:, 0] for regression."""

    def __init__(self, *, W, b, spec: DataSpec, features, label, task,
                 classes):
        self.W, self.b = W, b
        self.spec, self.features = spec, list(features)
        self.label, self.task, self.classes = label, task, classes

    def predict(self, dataset, *, device=None) -> np.ndarray:
        """Raw columns -> (N, n_classes) probabilities or (N,) values, in
        float64 on ``device`` (None is cuda)."""
        from repro_torch.core.engines import resolve_device
        dev = resolve_device(device)
        ds = _as_vertical(dataset, self.spec)
        X = torch.from_numpy(_design_matrix(ds, self.features,
                                            self.spec)).to(dev)
        W = torch.tensor(self.W, dtype=torch.float64, device=dev)
        b = torch.tensor(self.b, dtype=torch.float64, device=dev)
        z = X @ W + b
        if self.task == Task.REGRESSION:
            return z[:, 0].cpu().numpy()
        p = torch.exp(z - z.max(1, keepdim=True).values)
        return (p / p.sum(1, keepdim=True)).cpu().numpy()

    def summary(self, verbose: int | bool = False) -> str:
        return "\n".join([f"Type: {type(self).__name__}",
                          f"Task: {self.task.value}", f'Label: "{self.label}"',
                          f"Input Features ({len(self.features)}): "
                          f"{self.features}",
                          f"Weights: {self.W.shape[0]} x {self.W.shape[1]}"])

    def _write_state(self, path: str) -> None:
        np.savez(os.path.join(path, "linear.npz"), W=self.W, b=self.b)
        with open(os.path.join(path, "model.json"), "w") as fh:
            json.dump({"task": self.task.value, "label": self.label,
                       "features": self.features, "classes": self.classes},
                      fh, indent=1)


def load_linear_model(path: str) -> LinearModel:
    """The linear model saved at ``path``, built through
    ``convert.model_from_arrays``."""
    from repro_torch.convert import model_from_arrays
    try:
        with open(os.path.join(path, "model.json")) as fh:
            fields = json.load(fh)
        with open(os.path.join(path, "dataspec.json")) as fh:
            spec = json.load(fh)
        with np.load(os.path.join(path, "linear.npz"),
                     allow_pickle=False) as z:
            arrays = {k: z[k] for k in z.files}
    except (OSError, json.JSONDecodeError) as e:
        raise YdfError(
            f"Model directory {path!r} is incomplete or corrupt ({e}). "
            "Solution: re-save the model with model.save(path).") from None
    model = model_from_arrays("linear", arrays, spec, fields["features"],
                              task=fields["task"], classes=fields["classes"])
    model.label = fields["label"]
    return model


@register_learner("LINEAR")
class LinearLearner(Learner):
    """Multinomial logistic / linear regression, trained on ``device``
    (None is cuda) with torch autograd and the reference's Adam, written
    out step for step: moments 0.9/0.1 and 0.999/0.001, bias correction
    with t + 1, eps 1e-8 outside the square root. ``X @ W`` is a float32
    matmul; TF32 is not asked for."""

    def default_hparams(self):
        from dataclasses import make_dataclass
        HP = make_dataclass("LinearHparams", [("steps", int, 300),
                                              ("lr", float, 0.05),
                                              ("l2", float, 1e-4)])
        return HP()

    def train(self, dataset, valid=None, checkpoint=None) -> LinearModel:
        from repro_torch.core.engines import resolve_device
        if checkpoint is not None:
            raise YdfError("LinearLearner trains in one pass of "
                           f"{self.hparams.steps} steps and takes no "
                           "checkpoint; call train(dataset).")
        dev = resolve_device(self.device)
        td = prepare_train_data(self, dataset)
        X = _design_matrix(td.ds, td.features, td.ds.spec)
        N, D = X.shape
        K = td.n_classes if self.task == Task.CLASSIFICATION else 1
        hp = self.hparams
        Xt = torch.from_numpy(X.astype(np.float32)).to(dev)
        yt = torch.from_numpy(np.asarray(td.y)).to(
            dev, torch.float32 if self.task == Task.REGRESSION else torch.long)
        rows = torch.arange(N, device=dev)

        def loss_fn(W, b):
            z = Xt @ W + b
            if self.task == Task.REGRESSION:
                loss = torch.mean(torch.square(z[:, 0] - yt))
            else:
                loss = torch.mean(torch.logsumexp(z, 1) - z[rows, yt])
            return loss + hp.l2 * torch.sum(torch.square(W))

        params = [torch.zeros((D, K), dtype=torch.float32, device=dev),
                  torch.zeros((K,), dtype=torch.float32, device=dev)]
        m = [torch.zeros_like(p) for p in params]
        v = [torch.zeros_like(p) for p in params]
        for t in range(hp.steps):
            leaves = [p.requires_grad_() for p in params]
            grads = torch.autograd.grad(loss_fn(*leaves), leaves)
            # the bias corrections as float32 device scalars, divided by
            # (a python-float divisor would become a multiply by its
            # reciprocal on the card)
            c1 = torch.tensor(1 - 0.9 ** (t + 1), dtype=torch.float32,
                              device=dev)
            c2 = torch.tensor(1 - 0.999 ** (t + 1), dtype=torch.float32,
                              device=dev)
            with torch.no_grad():
                m = [0.9 * a + 0.1 * g for a, g in zip(m, grads)]
                v = [0.999 * a + 0.001 * torch.square(g)
                     for a, g in zip(v, grads)]
                params = [p - hp.lr * (a / c1) / (torch.sqrt(b / c2) + 1e-8)
                          for p, a, b in zip(params, m, v)]

        return LinearModel(W=params[0].cpu().numpy(),
                           b=params[1].cpu().numpy(), spec=td.ds.spec,
                           features=td.features, label=self.label,
                           task=self.task, classes=td.classes)
