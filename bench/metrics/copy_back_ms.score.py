"""Mean milliseconds a call of the (N, T, O) per-tree scores' copy back
to the host (``engines/copy_back``; it waits for the traversal too)."""
from bench.counters import mean_ms


def read(rec):
    return mean_ms(rec, "engines/copy_back")
