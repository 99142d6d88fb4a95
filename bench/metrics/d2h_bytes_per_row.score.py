"""Bytes the engine copied back to the host a row scored: the program's
``engines/d2h_bytes`` counter over the rows of its ``engines/copy_back``
spans (T x O x 4 B for per-tree float32 scores)."""
from bench.counters import counter, found


def read(rec):
    nbytes = counter(rec, "engines/d2h_bytes")
    rows = sum(s.args.get("rows", 0) for s in found(rec, "engines/copy_back"))
    return nbytes / rows if nbytes is not None and rows else None
