"""Feature binning for the histogram splitter (paper §3.8 "approximate
splitting by discretization"), the port's copy of ``repro.core.binning``:
host numpy, unchanged, so both packages bin a dataset into the same codes.

Numerical features are quantile-binned to <=255 uint8 codes; categorical
features map their dictionary ids to codes directly (capped). Missing values
use GLOBAL imputation (mean / most-frequent, §3.4) at binning time.

With fewer unique values than bins, boundaries are the midpoints between
consecutive unique values, so the histogram splitter is exact.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.api import YdfError
from repro_torch.core.dataspec import Semantic, VerticalDataset

MAX_BINS = 256  # uint8 codes


@dataclass
class BinnedFeatures:
    codes: np.ndarray                 # (N, F) uint8
    n_bins: np.ndarray                # (F,) int32, actual bins used per feature
    is_cat: np.ndarray                # (F,) bool
    boundaries: list[np.ndarray | None]  # per numerical feature: ascending thresholds
    names: list[str]
    # categorical: code c corresponds to dictionary id c (identity, capped)

    @property
    def n_features(self) -> int:
        return self.codes.shape[1]

    def threshold_value(self, f: int, split_bin: int) -> float:
        """Raw-value threshold for 'code >= split_bin' on numerical feature f:
        x > boundaries[split_bin-1]."""
        b = self.boundaries[f]
        assert b is not None and 1 <= split_bin <= len(b)
        return float(b[split_bin - 1])


def bin_features(ds: VerticalDataset, features: list[str], *,
                 max_bins: int = 255, seed: int = 0) -> BinnedFeatures:
    if not features:
        raise YdfError(
            "No input features. Solutions: (1) pass features explicitly, or "
            "(2) check that the dataset has columns other than the label.")
    N = ds.n_rows
    F = len(features)
    codes = np.zeros((N, F), np.uint8)
    n_bins = np.zeros(F, np.int32)
    is_cat = np.zeros(F, bool)
    boundaries: list[np.ndarray | None] = []
    for j, name in enumerate(features):
        col = ds.spec[name]
        if col.semantic == Semantic.NUMERICAL:
            x = ds.numerical[name].astype(np.float64).copy()
            miss = np.isnan(x)
            if miss.all():
                x[:] = 0.0
            elif miss.any():
                x[miss] = x[~miss].mean()  # GLOBAL imputation
            bounds = _quantile_boundaries(x, max_bins)
            codes[:, j] = np.searchsorted(bounds, x, side="left").astype(np.uint8)
            n_bins[j] = len(bounds) + 1
            boundaries.append(bounds.astype(np.float32))
        else:  # categorical / boolean: ids are already dense
            v = ds.categorical[name].copy()
            if (v < 0).any():
                present = v[v >= 0]
                fill = np.bincount(present).argmax() if present.size else 0
                v[v < 0] = fill  # GLOBAL imputation: most frequent
            v = np.minimum(v, max_bins - 1)
            codes[:, j] = v.astype(np.uint8)
            n_bins[j] = int(v.max()) + 1 if v.size else 1
            is_cat[j] = True
            boundaries.append(None)
    return BinnedFeatures(codes=codes, n_bins=n_bins, is_cat=is_cat,
                          boundaries=boundaries, names=list(features))


def _quantile_boundaries(x: np.ndarray, max_bins: int) -> np.ndarray:
    """Ascending thresholds t_1..t_k (k <= max_bins-1); bin(x) = #(t <= x).
    If the feature has fewer unique values than bins, boundaries are the exact
    midpoints between consecutive unique values -> the histogram splitter is
    then EXACT (matches the in-sorting oracle)."""
    uniq = np.unique(x)
    if len(uniq) <= 1:
        return np.empty(0, np.float64)
    if len(uniq) <= max_bins:
        return (uniq[1:] + uniq[:-1]) / 2.0
    qs = np.quantile(x, np.linspace(0, 1, max_bins + 1)[1:-1], method="nearest")
    return np.unique(qs)
