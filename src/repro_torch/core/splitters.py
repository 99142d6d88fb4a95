"""Splitter parameters and the gain-validity floor, the port's copy of the
part of ``repro.core.splitters`` the device growth engine reads. The host
histogram scans (``best_splits`` and friends) come with the batched engine
(ROADMAP A9).

Stat layouts ("label type" modules, paper §2.3):

  * "gh"     — [grad, hess, ..., count]       (GBT, any smooth loss)
  * "class"  — [count_class_0..C-1, count]    (RF/CART classification)
  * "moment" — [sum_y, sum_y^2, count]        (RF/CART regression)
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

NEG_INF = -1e30

# Scale-aware validity floor for split gains. Gains are evaluated in float32
# (score(L) + score(R) - score(P) — a catastrophic cancellation when the
# split is worthless), so a node whose true gain is 0 reads as noise of order
# eps_f32 * |score(P)| accumulated over the cumulative scan. Any fixed
# min_gain below that floor turns pure-noise argmax flips into spurious
# splits that differ between backends. All engines gate on
# max(min_gain, REL_GAIN_EPS * |score(parent)|) so they agree that such
# splits are invalid.
REL_GAIN_EPS = 4e-6


def gain_floor(min_gain: float, parent_score) -> np.ndarray:
    return np.maximum(min_gain, REL_GAIN_EPS * np.abs(parent_score))


@dataclass
class SplitterParams:
    stat_kind: str = "gh"            # gh | class | moment
    min_examples: int = 5
    l2: float = 0.0                  # lambda (gh gain)
    min_gain: float = 1e-12
    categorical_algorithm: str = "CART"   # CART | RANDOM | ONE_HOT
    random_cat_trials: int = 32
    num_candidate_ratio: float = 1.0  # per-node feature sampling (RF: sqrt rule)
    # sparse oblique (benchmark_rank1 template)
    oblique: bool = False
    oblique_num_projections_exponent: float = 1.0
    oblique_density: float = 0.5     # P(feature in projection)
    oblique_bins: int = 128
