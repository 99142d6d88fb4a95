"""Mean milliseconds of the device engine's level step
(``grower_device/level_step``, which closes after a device sync while
tracing)."""
from bench.readers import spans


def read(rec):
    s = spans(rec, "grower_device/level_step")
    return 1e3 * sum(s) / len(s) if s else None
