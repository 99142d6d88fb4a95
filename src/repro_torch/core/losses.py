"""GBT losses, the port's copy of ``repro.core.losses`` (host numpy, as in
the reference): initial prediction, per-example gradients and hessians,
the loss value (read by early stopping) and the output head
(``activation``). Scores are raw (logits) per output dimension, shaped
(N, out_dim). The ranking loss lives in ``repro_torch.tasks.ranking``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.api import Task, YdfError


class Loss:
    name = "?"
    out_dim = 1

    def init_pred(self, y, w) -> np.ndarray: ...
    def grad_hess(self, pred, y, w) -> tuple[np.ndarray, np.ndarray]:
        """-> grad (N, K), hess (N, K); boosting fits trees to -grad."""
    def value(self, pred, y, w) -> float: ...
    def activation(self, scores) -> np.ndarray: ...


class Binomial(Loss):
    """BINOMIAL_LOG_LIKELIHOOD: y in {0,1}, single logit."""
    name = "BINOMIAL_LOG_LIKELIHOOD"
    out_dim = 1

    def init_pred(self, y, w):
        p = np.clip(np.average(y, weights=w), 1e-6, 1 - 1e-6)
        return np.array([np.log(p / (1 - p))], np.float32)

    def grad_hess(self, pred, y, w):
        p = 1.0 / (1.0 + np.exp(-pred[:, 0]))
        g = (p - y) * w
        h = np.maximum(p * (1 - p), 1e-12) * w
        return g[:, None], h[:, None]

    def value(self, pred, y, w):
        z = pred[:, 0]
        ll = np.logaddexp(0, z) - y * z
        return float(np.average(ll, weights=w))

    def activation(self, scores):
        p1 = 1.0 / (1.0 + np.exp(-scores[:, 0]))
        return np.stack([1 - p1, p1], axis=1)


class Multinomial(Loss):
    name = "MULTINOMIAL_LOG_LIKELIHOOD"

    def __init__(self, n_classes: int):
        self.out_dim = n_classes

    def init_pred(self, y, w):
        pri = np.array([np.average(y == c, weights=w) for c in range(self.out_dim)])
        return np.log(np.clip(pri, 1e-6, None)).astype(np.float32)

    def grad_hess(self, pred, y, w):
        z = pred - pred.max(1, keepdims=True)
        p = np.exp(z)
        p /= p.sum(1, keepdims=True)
        onehot = np.eye(self.out_dim, dtype=np.float64)[y]
        g = (p - onehot) * w[:, None]
        h = np.maximum(p * (1 - p), 1e-12) * w[:, None]
        return g, h

    def value(self, pred, y, w):
        z = pred - pred.max(1, keepdims=True)
        lse = np.log(np.exp(z).sum(1))
        ll = lse - z[np.arange(len(y)), y]
        return float(np.average(ll, weights=w))

    def activation(self, scores):
        z = scores - scores.max(1, keepdims=True)
        p = np.exp(z)
        return p / p.sum(1, keepdims=True)


class SquaredError(Loss):
    name = "SQUARED_ERROR"
    out_dim = 1

    def init_pred(self, y, w):
        return np.array([np.average(y, weights=w)], np.float32)

    def grad_hess(self, pred, y, w):
        return ((pred[:, 0] - y) * w)[:, None], w[:, None].astype(np.float64)

    def value(self, pred, y, w):
        return float(np.average(np.square(pred[:, 0] - y), weights=w))

    def activation(self, scores):
        return scores[:, 0]


def make_loss(task: Task, loss_name: str, n_classes: int) -> Loss:
    if loss_name != "DEFAULT":
        table = {"BINOMIAL": Binomial(), "SQUARED_ERROR": SquaredError(),
                 "MULTINOMIAL": Multinomial(n_classes)}
        if loss_name not in table:
            raise YdfError(f"Unknown loss {loss_name!r}. Available: "
                           f"{sorted(table) + ['DEFAULT']}.")
        return table[loss_name]
    if task == Task.REGRESSION:
        return SquaredError()
    if task == Task.CLASSIFICATION:
        if n_classes < 2:
            raise YdfError(
                f"Classification requires a label with >= 2 classes, found "
                f"{n_classes}. Solutions: (1) check the label column, or (2) "
                "use task=REGRESSION for numerical targets.")
        return Binomial() if n_classes == 2 else Multinomial(n_classes)
    # RANKING is handled by gbt.py directly (repro_torch.tasks.ranking.
    # LambdaMARTLoss needs the group layout, which make_loss does not see)
    raise YdfError(
        f"GBT does not support task={task}. Supported: CLASSIFICATION, "
        "REGRESSION, RANKING. For UPLIFT use UPLIFT_TREES, for ANOMALY use "
        "ISOLATION_FOREST.")


def loss_by_name(name: str, out_dim: int) -> Loss:
    """The head for a loss name as the reference's ``Loss.name`` spells it.
    A ranking model gets LambdaMART's serving head (the training loss holds
    the group layouts, which a trained model does not keep)."""
    from repro_torch.tasks.ranking import RankingActivation
    if name == Binomial.name:
        return Binomial()
    if name == Multinomial.name:
        return Multinomial(out_dim)
    if name == SquaredError.name:
        return SquaredError()
    if name == RankingActivation.name:
        return RankingActivation()
    served = [Binomial.name, Multinomial.name, SquaredError.name,
              RankingActivation.name]
    raise YdfError(
        f"Unknown or unsupported GBT loss {name!r}. The port serves {served}.")
