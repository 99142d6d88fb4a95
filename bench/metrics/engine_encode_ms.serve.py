"""Mean milliseconds of the program's encoder a request (``engines/encode``
inside ``server/submit``)."""
from bench.counters import mean_ms


def read(rec):
    return mean_ms(rec, "engines/encode")
