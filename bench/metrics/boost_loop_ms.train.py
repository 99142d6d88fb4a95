"""Milliseconds a tree of the learner's host loop, outside the trees'
growth: a training's wall time less its ``gbt/tree`` and
``grower/binning`` spans, over its trees (gradients, stats, the
prediction updates and the training loss)."""
from bench.readers import spans


def read(rec):
    trees = sum(t["trees"] for t in rec.get("trainings", []))
    if not trees or not spans(rec, "gbt/tree"):
        return None
    wall = sum(t["seconds"] for t in rec["trainings"])
    rest = wall - sum(spans(rec, "gbt/tree")) - sum(spans(rec, "grower/binning"))
    return 1e3 * rest / trees
