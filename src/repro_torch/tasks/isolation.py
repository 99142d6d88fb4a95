"""Isolation forests (DESIGN.md §12.3; Liu, Ting & Zhou 2008), the port's
copy of ``repro.tasks.isolation`` (host numpy: the same rng streams, the
same trees).

task=ANOMALY is the deliberate stress test of the engine seams: growth uses
NO histograms, NO gain scan and NO labels — each tree picks a random feature
and a uniform random threshold over the node's value range, on a small
per-tree row subsample (psi), until rows isolate or the depth cap
``ceil(log2 psi)`` hits. The splitter machinery is bypassed entirely; trees
are written straight into the ordinary Forest SoA, where every leaf stores
its PATH LENGTH ``depth + c(n)`` — so the compiled traversal engines (the
CUDA traversal kernels on the card, the numpy engines on the CPU) serve
anomaly scores with zero changes.

All features are treated as ordinals (categorical codes included): every
node is a plain ``x >= threshold`` condition, the one kind every engine
implements identically.
"""
from __future__ import annotations

import math

import numpy as np

from repro_torch.core.api import Learner, Task, YdfError, register_learner
from repro_torch.core.hparams import IsolationForestHparams
from repro_torch.core.models import IsolationForestModel, _as_vertical, raw_matrix
from repro_torch.core.tree import empty_forest
from repro_torch.obs import trace
from repro_torch.obs.logs import build_training_logs


def average_path_length(n: int) -> float:
    """c(n): expected BST search depth over n rows (Liu et al. eq. 1) —
    the unbuilt-subtree correction added to leaf path lengths."""
    if n <= 1:
        return 0.0
    if n == 2:
        return 1.0
    h = math.log(n - 1.0) + 0.5772156649015329  # harmonic via ln + gamma
    return 2.0 * h - 2.0 * (n - 1.0) / n


def _grow_iso_tree(forest, t: int, X: np.ndarray, rows: np.ndarray,
                   depth_cap: int, rng: np.random.Generator) -> int:
    """Random-split frontier growth of tree ``t`` in place; returns depth."""
    n_nodes = 1
    max_d = 0
    frontier = [(0, rows, 0)]           # LIFO: deterministic rng consumption
    while frontier:
        node, r, d = frontier.pop()
        max_d = max(max_d, d)
        xs = X[r]
        lo, hi = xs.min(axis=0), xs.max(axis=0)
        cands = np.flatnonzero(lo < hi)
        if d >= depth_cap or len(r) <= 1 or len(cands) == 0 \
                or n_nodes + 2 > forest.max_nodes:
            forest.leaf_value[t, node, 0] = d + average_path_length(len(r))
            continue
        f = int(cands[rng.integers(len(cands))])
        thr = float(rng.uniform(lo[f], hi[f]))
        go = xs[:, f] >= thr
        if not go.any() or go.all():
            forest.leaf_value[t, node, 0] = d + average_path_length(len(r))
            continue
        forest.feature[t, node] = f
        forest.threshold[t, node] = np.float32(thr)
        forest.left_child[t, node] = n_nodes
        # push right first so the LEFT child pops (and draws rng) first
        frontier.append((n_nodes + 1, r[go], d + 1))
        frontier.append((n_nodes, r[~go], d + 1))
        n_nodes += 2
    forest.n_nodes[t] = n_nodes
    return max_d


@register_learner("ISOLATION_FOREST")
class IsolationForestLearner(Learner):
    """Unsupervised: ``label`` is only used at evaluate() time (a 0/1
    anomaly indicator); when present in the training set it is excluded
    from the features, never required. Training is host numpy on every
    device; ``device`` (None is cuda) is checked as for every learner, and
    the model serves wherever ``predict`` is asked to."""

    def __init__(self, label: str = "", task: Task = Task.ANOMALY, **kw):
        if task != Task.ANOMALY:
            raise YdfError(
                f"ISOLATION_FOREST only supports task=ANOMALY, got {task}.")
        super().__init__(label, task, **kw)

    def default_hparams(self) -> IsolationForestHparams:
        return IsolationForestHparams()

    def train(self, dataset, valid=None, checkpoint=None) -> IsolationForestModel:
        from repro_torch.core.engines import resolve_device
        device = resolve_device(self.device)
        hp: IsolationForestHparams = self.hparams
        ds = _as_vertical(dataset)
        label = self.label if self.label in ds.spec.columns else None
        feats = ds.spec.feature_names(label)
        if not feats:
            raise YdfError("Isolation forest needs at least one feature.")
        X = raw_matrix(ds, feats)
        N = X.shape[0]
        psi = max(2, min(int(hp.subsample_count), N))
        depth_cap = int(hp.max_depth) or max(1, math.ceil(math.log2(psi)))
        forest = empty_forest(hp.num_trees, 2 * psi + 1, 1,
                              feature_names=feats)
        forest.tree_class = None
        depth = 0
        with trace.span("isolation/grow", trees=hp.num_trees, psi=psi):
            for t in range(hp.num_trees):
                rng = np.random.default_rng((self.seed & 0xFFFFFFFF, 104729, t))
                rows = rng.choice(N, size=psi, replace=False)
                depth = max(depth, _grow_iso_tree(forest, t, X, rows,
                                                  depth_cap, rng))
        forest.depth = depth
        model = IsolationForestModel(
            c_psi=average_path_length(psi), forest=forest, spec=ds.spec,
            features=feats, label=self.label, task=self.task, classes=None)
        model.training_logs = build_training_logs(
            learner="isolation", num_trees=forest.n_trees,
            extra={"psi": psi, "depth_cap": depth_cap,
                   "device": str(device)})
        return model
