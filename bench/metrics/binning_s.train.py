"""Seconds a training spends binning its columns (``grower/binning``)."""
from bench.readers import spans


def read(rec):
    s = spans(rec, "grower/binning")
    return sum(s) / len(s) if s else None
