"""Hyper-parameters with paper-exact defaults (App. C.1) and versioned
templates (§3.11), the port's copy of the GBT, Random Forest, CART, uplift
and isolation-forest parts of ``repro.core.hparams``: defaults never change; newer methods are opt-in;
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


@dataclass(frozen=True)
class RFHparams:
    num_trees: int = 300
    # -- App C.1 "Random Forest default hyper-parameters"
    categorical_algorithm: str = "CART"
    growing_strategy: str = "LOCAL"
    max_depth: int = 16
    min_examples: int = 5
    num_candidate_attributes: str = "SQRT"  # Breiman rule of thumb | "ALL" | float ratio
    split_axis: str = "AXIS_ALIGNED"
    sparse_oblique_normalization: str = "MIN_MAX"
    sparse_oblique_num_projections_exponent: float = 1.0
    # non-C.1 plumbing
    bootstrap: bool = True
    winner_take_all: bool = True
    compute_oob: bool = True
    max_num_nodes: int = 4096
    max_bins: int = 255
    growth_engine: str = "batched"          # batched | oracle | device (§6)
    histogram_backend: str = "auto"         # auto | numpy | simple | cuda | torch
    # trees grown per lockstep block (grower.grow_trees). Execution-only:
    # forests are bit-identical for any value (keyed feature sampling).
    tree_parallelism: int = 8


@dataclass(frozen=True)
class CartHparams:
    max_depth: int = 16
    min_examples: int = 5
    categorical_algorithm: str = "CART"
    validation_ratio: float = 0.1           # for pruning
    max_num_nodes: int = 4096
    max_bins: int = 255
    growth_engine: str = "batched"          # batched | oracle | device (§6)
    histogram_backend: str = "auto"         # auto | numpy | simple | cuda | torch


@dataclass(frozen=True)
class UpliftHparams:
    """Honest uplift trees (task=UPLIFT, DESIGN.md §12.2): RF-style growth
    over the "uplift" splitter statistics — per-node treated/control outcome
    sums scored by the Euclidean-distance gain n*(p_t - p_c)^2."""
    num_trees: int = 100
    max_depth: int = 8
    min_examples: int = 20                  # per node, BOTH arms pooled
    num_candidate_attributes: str = "SQRT"
    bootstrap: bool = True
    max_num_nodes: int = 4096
    max_bins: int = 255
    treatment: str = "treatment"            # 0/1 treatment column name
    growth_engine: str = "batched"          # batched | oracle (device: no uplift scores)
    histogram_backend: str = "auto"         # auto | numpy | simple | cuda | torch
    tree_parallelism: int = 8


@dataclass(frozen=True)
class IsolationForestHparams:
    """Isolation forest (task=ANOMALY, DESIGN.md §12.3; Liu et al. 2008).
    Random splits, no histograms: the splitter never scans gains, so the
    grower seam is bypassed and trees are written straight into the Forest
    SoA, then served through the ordinary compiled engines."""
    num_trees: int = 100
    subsample_count: int = 256              # psi: rows sampled per tree
    max_depth: int = 0                      # 0 = ceil(log2(subsample_count))


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
