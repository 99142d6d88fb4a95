"""Faults planted under the timed path, for the tests that see ``correct``
come out false: each patches the program (with pytest's ``monkeypatch``)
where its answer is made.

Training (``repro_torch.core.gbt.grow_tree``): ``unchanged``, a tree that
leaves the boosting state as it was (its leaves zero); ``half``, trees
grown on the first half of the rows; ``altered``, the first tree's
largest leaf moved by 1%; ``stale``, the boosting state left unmoved by tree
``STALE_FROM`` and every later one (the trees themselves kept); ``early``,
the boosting stopped after ``EARLY_TREES`` trees (``Forest.truncated``).
Scoring and serving
(``CompiledPredictor.per_tree``): ``half``, the second half of a batch
left out (its per-tree outputs zero); ``altered``, row 0's first tree
answered with its outputs reversed and moved by 1.
"""
import numpy as np

from bench.reference import EARLY_TREES, STALE_FROM

TRAIN = ("unchanged", "half", "altered", "stale", "early")
SCORE = ("half", "altered")


def plant(monkeypatch, kind: str, fault: str) -> None:
    if kind == "train" and fault == "early":
        from repro_torch.core.tree import Forest
        truncated = Forest.truncated
        monkeypatch.setattr(Forest, "truncated", lambda self, n: truncated(
            self, min(n, EARLY_TREES)))
        return
    if kind == "train":
        from repro_torch.core import gbt
        grow = gbt.grow_tree

        def broken(forest, t, binned, X, stats, active, *rest):
            if fault == "half":
                active = active.copy()
                active[len(active) // 2:] = False
            node_of = grow(forest, t, binned, X, stats, active, *rest)
            if fault == "unchanged":
                forest.leaf_value[t] = 0.0
            elif fault == "altered" and t == 0:
                values = np.where(forest.feature[0] < 0,
                                  np.abs(forest.leaf_value[0, :, 0]), -1.0)
                forest.leaf_value[0, int(np.argmax(values))] *= 1.01
            elif fault == "stale" and t >= STALE_FROM:
                return np.full_like(node_of, -1)    # no row moves
            return node_of
        monkeypatch.setattr(gbt, "grow_tree", broken)
        return
    from repro_torch.core.engines import CompiledPredictor
    per_tree = CompiledPredictor.per_tree

    def broken_per_tree(self, X):
        out = np.array(per_tree(self, X))
        if fault == "half":
            out[len(out) // 2:] = 0.0
        else:
            out[0, 0] = out[0, 0, ::-1] + 1.0
        return out
    monkeypatch.setattr(CompiledPredictor, "per_tree", broken_per_tree)
