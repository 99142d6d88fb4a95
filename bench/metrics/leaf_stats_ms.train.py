"""Milliseconds a tree the batched grower spends summing its children's
statistics (``grower/leaf_stats``, one span a level or a node), over the
trees grown (``gbt/tree``)."""
from bench.counters import found


def read(rec):
    spans, trees = found(rec, "grower/leaf_stats"), len(found(rec, "gbt/tree"))
    if not spans or not trees:
        return None
    return 1e3 * sum(s.duration for s in spans) / trees
