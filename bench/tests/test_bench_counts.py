"""The work counts of B1 and B2 against counts by hand, and the level
steps the work model counts against those the program took."""
import numpy as np

from bench import reference, workcount
from bench.tests.test_bench_reference import VISITS, encoded, hand_forest


def test_b1_level_by_hand():
    # 10 rows, 3 columns, 4 stats, 2 slots: codes 30 B, stats 160 B, node
    # ids 40 B, 2 x 12 B out; 120 adds and 2 x 3 x 256 x 10 scan ops
    assert workcount.b1_level(10, 3, 4, 2) == (254, 120 + 15_360)


def test_levels_of_a_tree():
    assert workcount.tree_levels(6, 6) == [1, 2, 4, 8, 16, 32]
    assert workcount.tree_levels(2, 6) == [1, 2, 4]     # the last finds none
    assert workcount.tree_levels(0, 6) == [1]


def test_b2_call_on_the_hand_forest():
    f = hand_forest()
    _, visits = reference.traverse(f, encoded())
    nodes = int(f["n_nodes"].sum())                  # 9 held nodes
    got = workcount.b2_call(3, int(visits.sum()), 2, nodes, 3, 1)
    # rows 3 x 2 x 4 B, nodes 9 x 16 B, out 3 x 4 B; 8 visits + 9 adds
    assert got == (24 + 144 + 12, sum(VISITS) + 9)
    assert workcount.scoring_call(3, int(visits.sum()), 2, nodes, 3, 1) == \
        (24 + 144 + 12 + 24, sum(VISITS) + 9 + 6)


def test_least_time_takes_the_larger_bound():
    assert workcount.least_s(3.35e12, 0) == 1.0
    assert workcount.least_s(0, 67e12) == 1.0


def test_level_steps_match_a_tiny_training():
    from repro_torch.core import grower_device
    from repro_torch.core.gbt import GradientBoostedTreesLearner
    from bench import frozen
    from bench.generators.train import _depths
    data = {"n_num": 4, "missing_rate": 0.02, "noise": 0.1}
    rows = frozen.synth_rows(data, 400, 3, 0)
    before = grower_device.LEVEL_STEPS
    m = GradientBoostedTreesLearner(
        label="label", device="cpu", num_trees=3, max_depth=3,
        growth_engine="device", early_stopping="NONE").train(rows)
    steps = grower_device.LEVEL_STEPS - before
    depths = _depths(m.forest)
    assert steps == sum(len(workcount.tree_levels(d, 3)) for d in depths)
    w = workcount.training(400, 4, 4, depths, 3)
    assert w["b1"][0] == sum(workcount.b1_level(400, 4, 4, s)[0]
                             for d in depths
                             for s in workcount.tree_levels(d, 3))
    assert np.all(np.array(depths) <= 3)
