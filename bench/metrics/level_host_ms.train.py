"""Mean milliseconds a level step spends in its six phase spans
(``grower_device/candidates`` ... ``/child_stats``, which never sync): the
host's part of ``level_step_ms.train``, whose span closes after a sync."""
from bench.counters import found

PHASES = tuple(f"grower_device/{p}" for p in (
    "candidates", "split_search", "allocate", "write", "route",
    "child_stats"))


def read(rec):
    per_step = [sum(c.duration for c in s.children if c.name in PHASES)
                for s in found(rec, "grower_device/level_step")
                if any(c.name in PHASES for c in s.children)]
    return 1e3 * sum(per_step) / len(per_step) if per_step else None
