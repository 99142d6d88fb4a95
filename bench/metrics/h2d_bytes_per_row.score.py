"""Bytes the engine uploaded to the device a row scored: the program's
``engines/h2d_bytes`` counter over the rows of its ``engines/traverse``
spans (n_features x 4 B for the float32 encoded batch)."""
from bench.counters import counter, found


def read(rec):
    nbytes = counter(rec, "engines/h2d_bytes")
    rows = sum(s.args.get("rows", 0) for s in found(rec, "engines/traverse"))
    return nbytes / rows if nbytes is not None and rows else None
