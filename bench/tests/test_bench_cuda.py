"""On the card: every cell, at its own sizes and a short window, comes out
correct, and with each fault planted under its timed path, not correct.

    python -m pytest -q -m cuda bench/tests/test_bench_cuda.py
"""
import time

import pytest
import torch

from bench import harness
from bench.tests import faults

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]
FAULTS = [(c, f) for c in CELLS
          for f in (faults.TRAIN if c.endswith(".train") else faults.SCORE)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


def run_on(card: str, cell: str, seed: int) -> dict:
    b = harness.benchmark()
    run = harness.make_run(b, cell, seed, 1.0, False, card)
    return harness.run_cell(run, time.perf_counter(), b)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct_on_the_card(card, cell):
    out = run_on(card, cell, 2 ** 31 + 11)
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"


@pytest.mark.cuda
@pytest.mark.parametrize("cell,fault", FAULTS)
def test_fault_is_not_correct_on_the_card(card, cell, fault, monkeypatch):
    faults.plant(monkeypatch, "train" if cell.endswith(".train")
                 else "score", fault)
    out = run_on(card, cell, 2 ** 31 + 13)
    assert not out["correct"], out["checks"]
