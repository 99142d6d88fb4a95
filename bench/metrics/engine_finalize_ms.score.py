"""Mean milliseconds a call of the model's aggregation and head
(``engines/finalize``)."""
from bench.counters import mean_ms


def read(rec):
    return mean_ms(rec, "engines/finalize")
