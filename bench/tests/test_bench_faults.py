"""A run whose timed path is broken underneath comes out not correct: the
harness runs each cell on the CPU at a small size (its search for a card
skipped), with each fault the cell can have planted in the program."""
import time

import pytest

from bench import harness
from bench.tests import faults

SMALL = {
    # trees past the "stale" fault's first, so the last judged tree sees it
    "gbt_higgs.train": {"rows": 10_000, "hparams": {"num_trees": 12},
                        "params": {"pool": 1, "held_out_rows": 2_000}},
    "gbt_higgs.score_bulk": {"params": {"rows": 2_048, "pool": 2},
                             "forest": {"trees": 30}},
    "rf_higgs.score_bulk": {"params": {"rows": 2_048, "pool": 2},
                            "forest": {"trees": 10, "splits": 200}},
    "gbt_higgs.serve": {"params": {"clients": 8, "requests": 64},
                        "forest": {"trees": 30}},
}
CASES = [(cell, fault) for cell in SMALL
         for fault in (faults.TRAIN if cell.endswith(".train")
                       else faults.SCORE)]


def run_small(cell: str, seed: int = 2 ** 31 + 7) -> dict:
    b = harness.benchmark()
    run = harness.make_run(b, cell, seed, 0.5, False, "cpu", SMALL[cell])
    return harness.run_cell(run, time.perf_counter(), b)


@pytest.mark.parametrize("cell", list(SMALL))
def test_sound_run_is_correct(cell):
    out = run_small(cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0


@pytest.mark.parametrize("cell,fault", CASES)
def test_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    kind = "train" if cell.endswith(".train") else "score"
    faults.plant(monkeypatch, kind, fault)
    out = run_small(cell)
    assert not out["correct"], out["checks"]
