"""Mean milliseconds a call of the encoder's object path: the columns
parsed from Python objects (``engines/encode_objects``, inside
``engines/encode``)."""
from bench.counters import mean_ms


def read(rec):
    return mean_ms(rec, "engines/encode_objects")
