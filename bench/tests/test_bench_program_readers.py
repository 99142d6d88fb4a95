"""The readers of the program's own spans and counters, on a hand-built
record with a fake-clock tracer: each returns its value, and None where
the program recorded nothing for it (a program without these spans and
counters, or without a tracer's ``metrics``)."""
import pytest
from repro_torch.obs import trace

from bench import harness


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def timed(clock, name, seconds, **args):
    with trace.span(name, **args):
        clock.t += seconds


def traced_record():
    clock = Clock()
    with trace.capture(clock=clock) as tr:
        for ms in (2.0, 4.0):                       # two score calls
            timed(clock, "engines/encode", ms / 1e3, rows=10)
            with trace.span("engines/dispatch", rows=10):
                timed(clock, "engines/traverse", 0.5e-3, rows=10)
                timed(clock, "engines/copy_back", (ms - 1) / 1e3, rows=10)
                trace.count("engines/h2d_bytes", 10 * 28 * 4)
                trace.count("engines/d2h_bytes", 10 * 300 * 4)
            timed(clock, "engines/finalize", 5e-3, rows=10)
        trace.observe("server/queue_wait_s", 0.010)
        trace.observe("server/queue_wait_s", 0.020)
        with trace.span("models/prepare"):
            timed(clock, "grower/binning", 0.5)
            clock.t += 1.0
        for tree in range(2):
            timed(clock, "gbt/grad_hess", 1e-3)
            timed(clock, "gbt/stats", 1e-3)
            with trace.span("gbt/tree"):
                for level in range(3):
                    with trace.span("grower_device/level_step", level=level):
                        for p in ("candidates", "split_search", "allocate",
                                  "write", "route", "child_stats"):
                            timed(clock, f"grower_device/{p}", 0.5e-3)
                        clock.t += 7e-3               # the sync's wait
                    timed(clock, "grower_device/host_sync", 1e-3)
            timed(clock, "gbt/update", 1e-3)
            timed(clock, "gbt/loss", 1e-3)
    return {"spans": tr}


EXPECTED = {
    "engine_encode_ms.score": 3.0,
    "engine_encode_ms.serve": 3.0,
    "copy_back_ms.score": 2.0,
    "d2h_bytes_per_row.score": 1200.0,
    "h2d_bytes_per_row.score": 112.0,
    "engine_finalize_ms.score": 5.0,
    "queue_wait_ms.serve": 15.0,
    "level_host_ms.train": 3.0,
    "boost_host_ms.train": 4.0,
    "data_prep_s.train": 1.5,
}


class Bare:
    """A tracer of a program that has none of these spans nor a registry."""

    def find(self, name):
        return []


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_reads_the_program(name):
    read = harness.reader(name).read
    assert read(traced_record()) == pytest.approx(EXPECTED[name], rel=1e-9)
    with trace.capture() as empty:
        pass
    for rec in ({}, {"spans": empty}, {"spans": Bare()}):
        assert read(rec) is None


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_is_declared_for_its_cells(name):
    (m,) = [m for m in harness.benchmark()["per_layer"] if m["name"] == name]
    assert m["source"] in ("program_span", "program_counter")
    cells = {w["name"]: w for w in harness.benchmark()["workloads"]}
    assert m["workloads"] and set(m["workloads"]) <= set(cells)
