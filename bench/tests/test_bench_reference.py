"""The plain reference agrees with forests and data traced by hand."""
import numpy as np
import pytest
import torch

from bench import reference

NAN = float("nan")


def hand_forest(out_dim=1):
    """Three trees over two columns (see each row's trace below)."""
    T, M = 3, 5
    f = {"feature": np.full((T, M), -1, np.int32),
         "threshold": np.zeros((T, M), np.float32),
         "left_child": np.full((T, M), -1, np.int32),
         "leaf_value": np.zeros((T, M, out_dim), np.float32),
         "n_nodes": np.array([3, 5, 1], np.int32),
         "init_pred": np.array([0.0], np.float32)}
    f["feature"][0, 0], f["threshold"][0, 0], f["left_child"][0, 0] = 0, 0.5, 1
    f["feature"][1, 0], f["threshold"][1, 0], f["left_child"][1, 0] = 1, 0.0, 1
    f["feature"][1, 2], f["threshold"][1, 2], f["left_child"][1, 2] = 0, 2.0, 3
    values = {(0, 1): -1.0, (0, 2): 1.0, (1, 1): 0.25, (1, 3): 0.5,
              (1, 4): 0.75, (2, 0): 0.1}
    for (t, n), v in values.items():
        f["leaf_value"][t, n] = [v] if out_dim == 1 else [1 - v, v]
    return f


# rows, each traced by hand:
#   r0 = (0, -1):  t0 left (-1.0); t1 left (0.25); t2 0.1   -> leaves 1 1 0
#   r1 = (3, 1):   t0 right (1.0); t1 right, 3 >= 2 (0.75)  -> leaves 2 4 0
#   r2 = (NaN, 0): NaN -> mean 1.0; t0 right; t1 0 >= 0 right, 1 < 2 (0.5)
ROWS = {"a": np.array([0.0, 3.0, NAN]), "b": np.array([-1.0, 1.0, 0.0])}
LEAVES = [[1, 1, 0], [2, 4, 0], [2, 3, 0]]
VISITS = [2, 3, 3]
SUMS = [-0.65, 1.85, 1.6]


def encoded():
    means = reference.column_means({"a": np.array([1.0, NAN, 1.0]),
                                    "b": ROWS["b"]}, ["a", "b"])
    return reference.encode(ROWS, ["a", "b"], means, "cpu")


def test_encode_replaces_missing_with_the_mean():
    X = encoded()
    assert X.dtype == torch.float32
    assert X[:, 0].tolist() == [0.0, 3.0, 1.0]


def test_traversal_matches_the_hand_trace():
    leaves, visits = reference.traverse(hand_forest(), encoded())
    assert leaves.tolist() == LEAVES
    assert visits.tolist() == VISITS


def test_gbt_head_matches_the_hand_sum():
    p = reference.predict(hand_forest(), "gbt", encoded())
    want = 1 / (1 + np.exp(-np.array(SUMS)))
    np.testing.assert_allclose(p[:, 1].numpy(), want, rtol=1e-7)
    np.testing.assert_allclose(p.sum(1).numpy(), 1.0)


def test_rf_winner_take_all_matches_the_hand_votes():
    # leaf (1 - v, v): class 1 wins where v > 0.5, class 0 where v < 0.5
    p = reference.predict(hand_forest(out_dim=2), "rf_wta", encoded())
    votes = [[0, 0, 0], [1, 1, 0], [1, 0, 0]]      # r2: t1 leaf 0.5 -> 0
    np.testing.assert_allclose(p[:, 1].numpy(),
                               [sum(v) / 3 for v in votes])


def test_bfloat16_control_moves_the_answer():
    # rounding keeps order, so only a row just below a threshold can move:
    # 2.986 and 2.99 both round to 2.984375 in bfloat16
    f = hand_forest()
    f["threshold"][0, 0] = 2.99
    X = torch.tensor([[2.986, 1.0]])
    want = reference.predict(f, "gbt", X)
    low = reference.predict(f, "gbt", X, "bfloat16")
    assert reference.widest_gap(low.numpy(), want) > 0.1


def test_binning_by_hand():
    X = np.array([[1], [1], [2], [3], [NAN]], np.float32)
    codes, bounds = reference.bin_columns(X, 255)
    np.testing.assert_allclose(bounds[0], [1.375, 1.875, 2.5])
    assert codes[:, 0].tolist() == [0, 0, 2, 3, 1]   # NaN -> mean 1.75


def separable(n=40):
    codes = np.zeros((n, 2), np.uint8)
    codes[:, 0] = np.arange(n) % 4
    y = (codes[:, 0] >= 2).astype(np.int64)
    return codes, y


HP = {"max_depth": 1, "min_examples": 5, "shrinkage": 0.1}


def test_first_tree_by_hand():
    codes, y = separable()
    t = reference.grow_gbt(codes, y, HP, 1, "cpu")
    assert t["feature"][0, 0] == 0 and t["split_bin"][0, 0] == 2
    # p = 0.5: g = 0.5 - y, h = 0.25 -> leaves -0.1 * (+-0.5) / 0.25
    np.testing.assert_allclose(t["leaf_value"][0, 1:3], [-0.2, 0.2])


def test_judge_the_reference_own_trees_and_planted_faults():
    codes, y = separable()
    prog = reference.grow_gbt(codes, y, HP, 2, "cpu")
    out = reference.judge_gbt(codes, y, HP, prog, [0, 1], "cpu")
    assert out["split_gap"] == 0.0 and out["leaf_gap"] < 1e-12
    prog["leaf_value"][0, 1] *= 1.01
    assert reference.judge_gbt(codes, y, HP, prog, [0, 1], "cpu")["leaf_gap"] \
        == pytest.approx(0.01)
    # a tree left out of the judgement still moves the state
    assert reference.judge_gbt(codes, y, HP, prog, [1], "cpu")["leaf_gap"] \
        > 1e-4
    prog["feature"][1, 0] = 1          # a column whose codes are all 0
    assert reference.judge_gbt(codes, y, HP, prog, [0, 1], "cpu")["split_gap"] \
        == 1.0


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered", "stale",
                                   "early"])
def test_faults_in_the_reference_are_seen(fault):
    r = np.random.default_rng(0)
    codes = r.integers(0, 8, (400, 2)).astype(np.uint8)
    y = (codes.sum(1) + r.integers(0, 4, 400) > 8).astype(np.int64)
    hp = {**HP, "max_depth": 2}
    n = reference.STALE_FROM + 2
    faulty = reference.grow_gbt(codes, y, hp, n, "cpu", fault=fault)
    kept = len(faulty["feature"])
    out = reference.judge_gbt(codes, y, hp, faulty, [0, 1, 2, kept - 1],
                              "cpu")
    assert out["leaf_gap"] >= 0.009 or out["split_gap"] > 0.01 or kept < n
