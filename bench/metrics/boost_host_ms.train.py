"""Milliseconds a tree of the learner's host loop, from its own spans:
gradients (``gbt/grad_hess``), the stats stack (``gbt/stats``), the leaf
gather and prediction updates (``gbt/update``) and the training loss
(``gbt/loss``), over the trees grown (``gbt/tree``)."""
from bench.counters import found

PARTS = ("gbt/grad_hess", "gbt/stats", "gbt/update", "gbt/loss")


def read(rec):
    parts = [found(rec, name) for name in PARTS]
    trees = len(found(rec, "gbt/tree"))
    if not trees or not all(parts):
        return None
    return 1e3 * sum(s.duration for p in parts for s in p) / trees
