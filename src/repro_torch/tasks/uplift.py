"""Honest uplift trees (DESIGN.md §12.2; Rzepakowski & Jaroszewicz 2012),
the port's copy of ``repro.tasks.uplift``.

task=UPLIFT rides the ordinary RF-style growth path: the ONLY new pieces are
the "uplift" splitter statistics layout ``[sum_y_treated, n_treated,
sum_y_control, n]`` and its Euclidean-distance gain ``n * (p_t - p_c)^2``
(splitters._score), plus leaves that store the local treatment effect
``p_t - p_c``. Everything else — binning, keyed feature sampling, lockstep
tree blocks, the compiled serving engines — is reused unchanged.

Trees grow on the learner's ``device`` (None is cuda) through the batched
engine: on the CPU in lockstep blocks of ``tree_parallelism`` (numpy), on
the card tree by tree, every level histogram of the four uplift stats built
by the CUDA histogram kernel. The stats are integer multiples of the
bootstrap counts, so the kernel's sums are exact and the card's forest
equals the CPU's. The device engine scores only gh, class and moment
stats, so ``growth_engine="device"`` raises ``YdfError`` before any tree
grows (the reference starts that engine and fails inside it).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.api import Learner, Task, YdfError, register_learner
from repro_torch.core.gbt import _engine_logs
from repro_torch.core.grower import GrowthParams, grow_trees, resolve_engine
from repro_torch.core.hparams import UpliftHparams
from repro_torch.core.models import UpliftModel, prepare_train_data
from repro_torch.core.splitters import SplitterParams
from repro_torch.core.tree import empty_forest
from repro_torch.obs import trace
from repro_torch.obs.logs import build_training_logs


def uplift_leaf(s: np.ndarray) -> np.ndarray:
    """Leaf value = local treatment effect p_t - p_c; a leaf whose bag
    misses one arm has no estimate and predicts 0 (neutral)."""
    nt = s[1]
    nc = s[3] - s[1]
    if nt <= 0 or nc <= 0:
        return np.zeros(1, np.float32)
    return np.array([s[0] / nt - s[2] / nc], np.float32)


@register_learner("UPLIFT_TREES")
class UpliftTreesLearner(Learner):
    """Forest of honest uplift trees; predict() = estimated uplift."""

    def __init__(self, label: str, task: Task = Task.UPLIFT, **kw):
        if task != Task.UPLIFT:
            raise YdfError(
                f"UPLIFT_TREES only supports task=UPLIFT, got {task}. "
                "Solution: use RANDOM_FOREST/GRADIENT_BOOSTED_TREES for "
                "classification or regression.")
        super().__init__(label, task, **kw)

    def default_hparams(self) -> UpliftHparams:
        return UpliftHparams()

    def train(self, dataset, valid=None, checkpoint=None) -> UpliftModel:
        from repro_torch.core.engines import resolve_device
        device = resolve_device(self.device)
        hp: UpliftHparams = self.hparams
        td = prepare_train_data(self, dataset, max_bins=hp.max_bins)
        N, F = td.binned.codes.shape
        t01 = td.treatment.astype(np.float64)
        base_stats = np.stack([td.y * t01, t01,
                               td.y * (1.0 - t01), np.ones(N)], 1)

        if hp.num_candidate_attributes == "SQRT":
            ratio = min(1.0, np.sqrt(F) / F)
        elif hp.num_candidate_attributes == "ALL":
            ratio = 1.0
        else:
            ratio = float(hp.num_candidate_attributes)
        sp = SplitterParams(stat_kind="uplift", min_examples=hp.min_examples,
                            num_candidate_ratio=ratio)
        gp = GrowthParams(max_depth=hp.max_depth, max_nodes=hp.max_num_nodes,
                          splitter=sp, engine=hp.growth_engine,
                          histogram_backend=hp.histogram_backend,
                          feature_sampling="keyed",
                          sampling_key=self.seed & 0xFFFFFFFF,
                          device=str(device))
        engine_used, fallback = resolve_engine(gp, td.binned, False)
        if engine_used == "device":
            raise YdfError(
                "UPLIFT_TREES cannot grow on growth_engine='device': the "
                "device engine scores gh, class and moment stats, and uplift "
                "trees score the four uplift stats. Solution: use "
                "growth_engine='batched' (the default), which builds the "
                "uplift histograms with the CUDA histogram kernel on the "
                "card.")
        block = max(1, int(hp.tree_parallelism))
        forest = empty_forest(hp.num_trees, hp.max_num_nodes, 1,
                              feature_names=td.features)
        forest.tree_class = None
        tree_rng = [np.random.default_rng((self.seed & 0xFFFFFFFF, 104729, t))
                    for t in range(hp.num_trees)]
        for b0 in range(0, hp.num_trees, block):
            ts = list(range(b0, min(b0 + block, hp.num_trees)))
            counts_b = []
            for t in ts:
                if hp.bootstrap:
                    counts_b.append(tree_rng[t].multinomial(
                        N, np.full(N, 1.0 / N)).astype(np.float64))
                else:
                    counts_b.append(np.ones(N))
            with trace.span("uplift/block", first_tree=ts[0], trees=len(ts)):
                grow_trees(forest, ts, td.binned, td.X_raw,
                           [base_stats * c[:, None] for c in counts_b],
                           [c > 0 for c in counts_b], uplift_leaf, gp,
                           [tree_rng[t] for t in ts], td.num_lo, td.num_hi,
                           block=block)

        model = UpliftModel(
            treatment_col=getattr(hp, "treatment", "treatment"),
            forest=forest, spec=td.ds.spec, features=td.features,
            label=self.label, task=self.task, classes=None)
        model.training_logs = build_training_logs(
            learner="uplift", num_trees=forest.n_trees,
            growth_engine=engine_used, engine_fallback=fallback,
            extra={"tree_parallelism": block, "device": str(device),
                   **_engine_logs(gp, engine_used, td.binned, device)})
        return model
