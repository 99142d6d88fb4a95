"""Hyper-parameters with paper-exact defaults (App. C.1) and versioned
templates (§3.11), the port's copy of the GBT part of
``repro.core.hparams``: defaults never change; newer methods are opt-in;
templates like ``benchmark_rank1@v1`` bundle the best-known settings per
version.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

from repro_torch.core.api import YdfError

@dataclass(frozen=True)
class GBTHparams:
    num_trees: int = 300
    # -- App C.1 "Gradient Boosted Trees hyper-parameters"
    early_stopping: str = "LOSS_INCREASE"   # LOSS_INCREASE | NONE
    l1_regularization: float = 0.0
    l2_regularization: float = 0.0
    max_depth: int = 6
    num_candidate_attributes_ratio: float = 1.0   # -1 i.e. all
    shrinkage: float = 0.1
    subsample: float = 1.0                  # sampling_method: NONE
    use_hessian_gain: bool = False
    growing_strategy: str = "LOCAL"         # LOCAL | BEST_FIRST_GLOBAL
    categorical_algorithm: str = "CART"     # CART | RANDOM | ONE_HOT
    split_axis: str = "AXIS_ALIGNED"        # AXIS_ALIGNED | SPARSE_OBLIQUE
    sparse_oblique_normalization: str = "MIN_MAX"
    sparse_oblique_num_projections_exponent: float = 1.0
    # non-C.1 plumbing
    min_examples: int = 5
    max_num_nodes: int = 256                # BEST_FIRST_GLOBAL budget
    validation_ratio: float = 0.1
    early_stopping_patience: int = 30       # trees without improvement
    max_bins: int = 255
    loss: str = "DEFAULT"                   # DEFAULT | BINOMIAL | MULTINOMIAL | SQUARED_ERROR
    growth_engine: str = "batched"          # batched | oracle | device (§6)
    histogram_backend: str = "auto"         # auto | numpy | simple | cuda | torch
    # -- ranking (task=RANKING, DESIGN.md §12.1): LambdaMART pairwise loss
    ranking_group: str = "group"            # group/query column name
    ndcg_truncation: int = 5                # the k in the |ΔNDCG@k| weights


# ---------------------------------------------------------------- templates

_TEMPLATES: dict[tuple[str, str], dict] = {
    # paper App C.1 "rank1@v1": same as defaults with these changes
    ("GRADIENT_BOOSTED_TREES", "benchmark_rank1@v1"): dict(
        growing_strategy="BEST_FIRST_GLOBAL",
        categorical_algorithm="RANDOM",
        split_axis="SPARSE_OBLIQUE",
        sparse_oblique_normalization="MIN_MAX",
        sparse_oblique_num_projections_exponent=1.0,
    ),
    ("RANDOM_FOREST", "benchmark_rank1@v1"): dict(
        categorical_algorithm="RANDOM",
        split_axis="SPARSE_OBLIQUE",
        sparse_oblique_normalization="MIN_MAX",
        sparse_oblique_num_projections_exponent=1.0,
    ),
}
# unversioned alias -> latest version (version pinning keeps old behaviour)
_LATEST = {"benchmark_rank1": "benchmark_rank1@v1"}


def apply_template(learner_name: str, hp, template: str | None):
    if not template:
        return hp
    template = _LATEST.get(template, template)
    key = (learner_name, template)
    if key not in _TEMPLATES:
        avail = sorted(t for (l, t) in _TEMPLATES if l == learner_name)
        raise YdfError(
            f"Unknown hyper-parameter template {template!r} for {learner_name}. "
            f"Available templates: {avail}.")
    return dataclasses.replace(hp, **_TEMPLATES[key])
