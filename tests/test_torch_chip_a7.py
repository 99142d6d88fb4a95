"""CPU rehearsals of chip_smoke's ROADMAP A7 and A8 phases (32-34:
train_distributed, simulated_cluster, train_linear) at a small size.

On the CPU the phases run every check but the launch counts, which are 0
here (the wrappers count kernel launches only): the world of 1 against a
second CPU world of 1, one spawned world of four gloo ranks over (2, 2),
(1, 4), (4, 1), the stop and the resume, the forest through the plain
traversal against ``predict_naive``; the simulation backend's faulted run
against its clean run; LINEAR twice, saved and loaded. Each phase must
return without raising.
"""
from __future__ import annotations

import numpy as np
import pytest

import chip_smoke as cs

CPU = "cpu"
ROWS = 4096                  # a multiple of 128, as A7_ROWS is


@pytest.fixture(scope="module")
def small():
    data = cs.higgs_like(ROWS)
    codes, y = cs.a7_data(data, ROWS)
    return data, codes, y


def test_a7_data_is_binned_to_64_bins(small):
    _, codes, y = small
    assert codes.shape == (ROWS, 28) and codes.dtype == np.uint8
    assert codes.max() < cs.A7_BINS and set(np.unique(y)) == {0.0, 1.0}
    assert cs.A7_ROWS % 128 == 0 and 100_000 - cs.A7_ROWS < 256


def test_train_distributed_phase_on_the_cpu(small, tmp_path):
    _, codes, y = small
    out = cs.train_distributed(CPU, codes, y, str(tmp_path), num_trees=3,
                               stop_at=2)
    assert out["b3_launches"] == 0 and out["b2_launches"] == 0
    assert out["card_vs_cpu"]["feat_bin_equal_gain_within_rtol"]
    assert out["card_vs_cpu"]["score_max_abs_diff"] == 0.0
    assert sorted(out["meshes"]) == ["1x4", "2x2", "2x2 stopped",
                                     "4x1", "4x1 resumed"]
    assert out["meshes"]["4x1 resumed"]["trees_grown"] == 1
    assert all(m["score_max_abs_diff"] <= 1e-4
               for k, m in out["meshes"].items() if "stopped" not in k)
    assert out["collective_bytes_per_level"]["1x4"][0] == {
        "hist_all_reduce": 1 * 7 * 64 * 3 * 4,
        "candidates_all_gather": 12, "partition_all_reduce": ROWS // 32 * 4}


def test_simulated_cluster_phase_on_the_cpu(small):
    _, codes, y = small
    out = cs.simulated_cluster(CPU, codes, y, num_trees=5)
    assert out["faulted_equals_clean"] and len(out["deaths"]) >= 2
    assert out["clean"]["b3_launches"] == 0
    assert out["clean"]["traffic_bytes"] == out["cpu"]["traffic_bytes"]
    assert out["card_vs_cpu"]["split_gain_differ"] == 0


def test_train_linear_phase_on_the_cpu(small, tmp_path):
    data, _, _ = small
    out = cs.train_linear(CPU, data, str(tmp_path), 0.5, n=ROWS)
    assert out["card_vs_cpu_max_abs"] == {"W": 0.0, "b": 0.0,
                                          "probabilities": 0.0}
    assert out["train_rows"] + out["valid_rows"] == ROWS
    assert 0.5 < out["accuracy"] <= 1.0


def test_collective_bytes_from_the_shapes():
    from repro_torch.core.distributed import DistGBTConfig
    cfg = DistGBTConfig()
    assert cs.collective_bytes(cfg, 99_840, 28, 2, 2, 3) == {
        "hist_all_reduce": 8 * 14 * 64 * 3 * 4,
        "candidates_all_gather": 8 * 12,
        "partition_all_reduce": 99_840 // 2 // 32 * 4}
    assert cs.collective_bytes(cfg, 99_840, 28, 2, 2, 5) == \
        {"hist_all_reduce": 32 * 3 * 4}
