"""Mean seconds of a training's data preparation (``models/prepare``: the
dataspec, binning, the raw matrix)."""
from bench.counters import found


def read(rec):
    s = found(rec, "models/prepare")
    return sum(x.duration for x in s) / len(s) if s else None
