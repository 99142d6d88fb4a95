"""Share of the traced window in which no operation ran on the device."""
from bench.readers import idle


def read(rec):
    return idle(rec)
