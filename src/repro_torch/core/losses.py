"""GBT output heads: the ``activation`` of each loss (the port serves
models; the gradient side of ``repro.core.losses`` stays with training).
Scores are raw (logits) per output dimension, shaped (N, out_dim)."""
from __future__ import annotations

import numpy as np

from repro_torch.core.api import YdfError


class Loss:
    name = "?"
    out_dim = 1

    def activation(self, scores: np.ndarray) -> np.ndarray:
        raise NotImplementedError


class Binomial(Loss):
    """BINOMIAL_LOG_LIKELIHOOD: a single logit -> (N, 2) probabilities."""
    name = "BINOMIAL_LOG_LIKELIHOOD"
    out_dim = 1

    def activation(self, scores):
        p1 = 1.0 / (1.0 + np.exp(-scores[:, 0]))
        return np.stack([1 - p1, p1], axis=1)


class Multinomial(Loss):
    """MULTINOMIAL_LOG_LIKELIHOOD: K logits -> (N, K) softmax."""
    name = "MULTINOMIAL_LOG_LIKELIHOOD"

    def __init__(self, n_classes: int):
        self.out_dim = n_classes

    def activation(self, scores):
        z = scores - scores.max(1, keepdims=True)
        p = np.exp(z)
        return p / p.sum(1, keepdims=True)


class SquaredError(Loss):
    """SQUARED_ERROR: the score itself, (N,)."""
    name = "SQUARED_ERROR"
    out_dim = 1

    def activation(self, scores):
        return scores[:, 0]


def loss_by_name(name: str, out_dim: int) -> Loss:
    """The head for a loss name as the reference's ``Loss.name`` spells it."""
    if name == Binomial.name:
        return Binomial()
    if name == Multinomial.name:
        return Multinomial(out_dim)
    if name == SquaredError.name:
        return SquaredError()
    raise YdfError(
        f"Unknown or unsupported GBT loss {name!r}. The port serves "
        f"{[Binomial.name, Multinomial.name, SquaredError.name]}.")
