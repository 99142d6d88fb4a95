"""Mean milliseconds of the program's encoder a call (``engines/encode``,
raw columns to the encoded matrix, no sync)."""
from bench.counters import mean_ms


def read(rec):
    return mean_ms(rec, "engines/encode")
