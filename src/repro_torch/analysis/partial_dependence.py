"""Partial dependence + individual conditional expectation (DESIGN.md §8),
the port's copy of ``repro.analysis.partial_dependence``.

PD(f, v) = E_x[ model(x with x_f := v) ] (Friedman 2001): for every grid
value of the analyzed feature, every sampled background example is re-scored
with that feature overridden. That grid x sample cross product is a pure
inference sweep, so it is materialized as ONE stacked encoded batch and
dispatched through the compiled serving path (row-budget-chunked), exactly
like the permutation-importance replicas — never one predict call per grid
point.

Numerical grids reuse the binning machinery (binning._quantile_boundaries)
on the analysis dataset, i.e. the same quantile bin edges training splits
are drawn from; categorical/boolean grids come from the DataSpec dictionary
(frequency-ordered, OOD code 0 excluded).

``device`` and ``engine`` select the predictor as in analysis/importance.py
(None: the card, which raises ``YdfError`` without one).
"""
from __future__ import annotations

import numpy as np

from repro_torch.analysis.importance import DEFAULT_ROW_BUDGET, _chunked, \
    _require_predictor
from repro_torch.analysis.report import PDPCurve
from repro_torch.core.api import Task, YdfError
from repro_torch.core.binning import _quantile_boundaries
from repro_torch.core.dataspec import Semantic


def _numerical_grid(x: np.ndarray, grid_size: int) -> np.ndarray:
    bounds = _quantile_boundaries(x.astype(np.float64), grid_size)
    return np.unique(np.concatenate(
        [[float(x.min())], bounds, [float(x.max())]])).astype(np.float32)


def _categorical_grid(col, x: np.ndarray, grid_size: int
                      ) -> tuple[np.ndarray, list[str]]:
    """Dictionary codes in frequency order (code 1 = most frequent), capped
    at ``grid_size``; boolean columns grid over {0, 1}."""
    if col.semantic == Semantic.BOOLEAN or col.vocab_size <= 1:
        codes = np.unique(x.astype(np.int64))
        return codes.astype(np.float32), [str(int(c)) for c in codes]
    n = min(col.vocab_size - 1, grid_size)
    codes = np.arange(1, n + 1)
    return codes.astype(np.float32), [col.vocab[c] for c in codes]


def partial_dependence(model, dataset, *, features: list[str] | None = None,
                       grid_size: int = 16, sample_rows: int = 256,
                       ice: bool = False, seed: int = 7, bundle=None,
                       row_budget: int = DEFAULT_ROW_BUDGET,
                       device=None, engine: str | None = None,
                       ) -> list[PDPCurve]:
    """One PDPCurve per analyzed feature (default: every input feature)."""
    pred = _require_predictor(model, device, engine)
    X = pred.encode(dataset)
    N = X.shape[0]
    if N == 0:
        raise YdfError("Cannot analyze an empty dataset.")
    names = list(features) if features is not None else list(model.features)
    unknown = [f for f in names if f not in model.features]
    if unknown:
        raise YdfError(
            f"Feature(s) {unknown} are not inputs of the model. Model "
            f"features: {model.features}.")
    rng = np.random.default_rng(seed)
    sel = (np.sort(rng.choice(N, sample_rows, replace=False))
           if N > sample_rows else np.arange(N))
    Xs = X[sel]
    n = len(Xs)
    dispatch = ((lambda Z: bundle.predict_encoded_bulk(Z, row_budget))
                if bundle is not None
                else lambda Z: _chunked(pred.predict_encoded, Z, row_budget))
    classes = getattr(model, "classes", None)
    curves: list[PDPCurve] = []
    for name in names:
        j = model.features.index(name)
        col = model.spec[name]
        if col.semantic == Semantic.NUMERICAL:
            grid, labels = _numerical_grid(X[:, j], grid_size), None
        else:
            grid, labels = _categorical_grid(col, X[:, j], grid_size)
        g = len(grid)
        X_rep = np.tile(Xs, (g, 1))
        X_rep[:, j] = np.repeat(grid, n)
        out = np.asarray(dispatch(X_rep), np.float64)
        out = out.reshape(g, n, -1)            # (g, n, out)
        curves.append(PDPCurve(
            feature=name, semantic=col.semantic.value, grid=grid,
            mean=out.mean(axis=1), stdev=out.std(axis=1), labels=labels,
            classes=(classes if model.task == Task.CLASSIFICATION else None),
            n_sample=n, ice=(out if ice else None)))
    return curves
