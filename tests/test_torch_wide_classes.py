"""Classification with more than 16 classes: the port against the JAX
package's learners.

With C classes the Random Forest and CART learners build histograms of
S = C + 1 stats (the class counts and the example count). The card's
kernels once refused S > 16; these forests pin what they must reproduce.
The data is ``synth_letter_like``: a SyntheticSpec of 26 classes over 16
numerical columns (the widths of UCI Letter), 3,000 rows.

The port runs on ``device="cpu"``. Tolerances:
  * the batched engine's Random Forest and CART: bit-identical to the
    reference's on every forest field (``split_gain`` included), the
    contract of tests/test_torch_rf.py::test_multiclass_equals_reference;
  * the device engine's Random Forest (the fused split search's plain
    version at S = 27, numerical data): argmax agreement above 0.97 with
    the reference's device engine, the tolerance of
    tests/test_torch_rf_device.py::test_multiclass_close_to_reference_device_engine,
    since that engine's float32 sums run in another order than the
    reference's.
"""
from __future__ import annotations

import numpy as np
import pytest

from repro.core import CartLearner as RefCart
from repro.core import RandomForestLearner as RefRF
from repro.data.tabular import SyntheticSpec, make_dataset, train_test_split
from repro_torch.core.cart import CartLearner
from repro_torch.core.rf import RandomForestLearner

FOREST_KEYS = ("feature", "threshold", "split_bin", "cat_mask", "left_child",
               "leaf_value", "n_nodes", "split_gain")
LETTER = SyntheticSpec("synth_letter_like", 3000, 16, 0, 26, seed=11)


def assert_identical(a, b, msg=""):
    for k in FOREST_KEYS:
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k),
                                      err_msg=f"{msg}: forest.{k}")
    assert a.depth == b.depth, msg


@pytest.fixture(scope="module")
def letter():
    return train_test_split(make_dataset(LETTER), 0.3, LETTER.seed)


def test_26_class_random_forest_equals_reference(letter):
    train, _ = letter
    kw = dict(label="label", num_trees=3, max_depth=6)
    ref = RefRF(**kw).train(train)
    got = RandomForestLearner(device="cpu", **kw).train(train)
    assert got.forest.leaf_value.shape[-1] == 26
    assert_identical(got.forest, ref.forest, "letter RF")
    assert got.self_evaluation.metrics == ref.self_evaluation.metrics


def test_26_class_cart_equals_reference(letter):
    train, test = letter
    ref = RefCart(label="label", max_depth=8).train(train)
    got = CartLearner(label="label", device="cpu", max_depth=8).train(train)
    assert got.forest.leaf_value.shape[-1] == 26
    assert_identical(got.forest, ref.forest, "letter CART")
    np.testing.assert_array_equal(
        got.predict(test, engine="ref", device="cpu"), ref.predict(test))


def test_26_class_device_engine_close_to_reference(letter, monkeypatch):
    from repro_torch.core import grower_device
    train, test = letter
    kw = dict(label="label", num_trees=3, max_depth=6, compute_oob=False,
              growth_engine="device")
    ref = RefRF(**kw).train(train)
    widths = set()
    search = grower_device.fused_best_split

    def spy(codes, stats, *a, **k):
        widths.add((stats.shape[1], k["kind"], k["impl"]))
        return search(codes, stats, *a, **k)

    monkeypatch.setattr(grower_device, "fused_best_split", spy)
    got = RandomForestLearner(device="cpu", **kw).train(train)
    assert widths == {(27, "class", "ref")}
    logs = got.training_logs
    assert (logs["growth_engine"], logs["device_impl"]) == ("device", "torch")
    pr, pg = ref.predict(test), got.predict(test, engine="ref", device="cpu")
    assert pg.shape == pr.shape == (len(test["label"]), 26)
    assert (pr.argmax(1) == pg.argmax(1)).mean() > 0.97
