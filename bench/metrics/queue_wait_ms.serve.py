"""Mean milliseconds a request waited in the server's queue, from submit to
the pump that dispatched it, by the server's own clock
(``server/queue_wait_s``: its exact count and total)."""
from bench.counters import sample_mean


def read(rec):
    s = sample_mean(rec, "server/queue_wait_s")
    return None if s is None else 1e3 * s
