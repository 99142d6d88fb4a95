"""The port's CART learner against the JAX package's.

Both learners train on the same raw columns with the same seed; the port
runs on ``device="cpu"`` (the batched engine on the numpy backend, as the
reference on a host without a TPU). Tolerance: none. The grown tree, the
pruned tree (reduced-error pruning on the self-extracted validation split)
and the served probabilities are bit-identical to the reference's, the
contract of tests/test_grower_batched.py:63-75 and
tests/test_core_learners.py:108.
"""
from __future__ import annotations

import copy

import numpy as np
import pytest

from repro.core.api import Task as RefTask
from repro.core.cart import CartLearner as RefCart
from repro.core.cart import _prune as ref_prune
from repro.core.dataspec import spec_to_dict
from repro.core.tree import empty_forest as ref_empty_forest
from repro.data.tabular import SUITE, adult_like, make_dataset, train_test_split
from repro_torch import convert
from repro_torch.core import Task, YdfError
from repro_torch.core.cart import CartLearner, _prune
from repro_torch.core.models import CartModel

FOREST_KEYS = ("feature", "threshold", "split_bin", "cat_mask", "left_child",
               "leaf_value", "n_nodes", "split_gain")


def assert_identical(a, b, msg=""):
    for k in FOREST_KEYS:
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k),
                                      err_msg=f"{msg}: forest.{k}")
    assert a.depth == b.depth, msg


@pytest.fixture(scope="module")
def adult():
    return train_test_split(adult_like(900), 0.3, 1)


@pytest.mark.parametrize("hp", [
    dict(),                                     # grown, then pruned
    dict(validation_ratio=0.0),                 # grown only
    dict(growth_engine="oracle"),
    dict(categorical_algorithm="ONE_HOT", max_depth=8),
    dict(growth_engine="device", max_depth=6),
], ids=["pruned", "grown", "oracle", "one_hot", "device"])
def test_classification_equals_reference(adult, hp):
    train, test = adult
    ref = RefCart(label="income", **hp).train(train)
    got = CartLearner(label="income", device="cpu", **hp).train(train)
    assert isinstance(got, CartModel) and got.forest.n_trees == 1
    if hp.get("growth_engine") == "device":
        # the device engine's leaf values are float32 sums in another order
        for k in ("feature", "split_bin", "cat_mask", "left_child", "n_nodes"):
            np.testing.assert_array_equal(getattr(got.forest, k),
                                          getattr(ref.forest, k), err_msg=k)
        np.testing.assert_allclose(got.forest.leaf_value,
                                   ref.forest.leaf_value, atol=1e-5)
        return
    assert_identical(got.forest, ref.forest, str(hp))
    np.testing.assert_array_equal(got.predict(test, engine="ref", device="cpu"),
                                  ref.predict(test))


def test_regression_equals_reference():
    train, test = train_test_split(make_dataset(SUITE[7]), 0.3, SUITE[7].seed)
    ref = RefCart(label="label", task=RefTask.REGRESSION).train(train)
    got = CartLearner(label="label", task=Task.REGRESSION,
                      device="cpu").train(train)
    assert_identical(got.forest, ref.forest, "regression")
    np.testing.assert_array_equal(got.predict(test, engine="ref", device="cpu"),
                                  ref.predict(test))


@pytest.mark.parametrize("task", ["CLASSIFICATION", "REGRESSION"])
def test_pruning_equals_the_reference_pruning(adult, task):
    """The port's pruning carries the current tree's score from node to
    node instead of scoring it again; on the same grown tree it makes the
    reference's decisions."""
    train, _ = adult
    if task == "REGRESSION":
        train = train_test_split(make_dataset(SUITE[7]), 0.3, SUITE[7].seed)[0]
        label = "label"
    else:
        label = "income"
    grown = CartLearner(label=label, task=Task(task), validation_ratio=0.0,
                        device="cpu").train(train)
    rng = np.random.default_rng(4)
    n = len(next(iter(train.values())))
    rows = {k: np.asarray(v)[rng.choice(n, 200)] for k, v in train.items()}
    from repro_torch.core.dataspec import BatchEncoder
    Xv = BatchEncoder(grown.spec, grown.features).encode(
        {k: rows[k] for k in grown.features})
    yv = grown.predict(rows, engine="ref", device="cpu")
    yv = yv.argmax(1) if task == "CLASSIFICATION" else yv + rng.normal(
        0, 0.5, len(yv))
    yv = np.where(rng.random(len(yv)) < 0.3, np.roll(yv, 1), yv)  # noise
    port_f = copy.deepcopy(grown.forest)
    ref_f = ref_empty_forest(1, port_f.max_nodes, port_f.leaf_value.shape[-1])
    for k in ("feature", "threshold", "cat_mask", "left_child", "leaf_value",
              "n_nodes"):
        setattr(ref_f, k, getattr(port_f, k).copy())
    ref_f.depth = port_f.depth
    _prune(port_f, Xv, yv, Task(task))
    ref_prune(ref_f, Xv, yv, RefTask(task))
    np.testing.assert_array_equal(port_f.left_child, ref_f.left_child)
    assert (port_f.left_child[0] >= 0).sum() < (
        grown.forest.left_child[0] >= 0).sum(), "nothing was pruned"


def test_model_from_arrays_serves_a_reference_cart(adult):
    train, test = adult
    ref = RefCart(label="income").train(train)
    arrays = {k: getattr(ref.forest, k) for k in (
        "feature", "threshold", "cat_mask", "left_child", "leaf_value",
        "n_nodes", "depth")}
    port = convert.model_from_arrays("cart", arrays, spec_to_dict(ref.spec),
                                     ref.features, task="CLASSIFICATION",
                                     classes=ref.classes)
    assert isinstance(port, CartModel) and not port.winner_take_all
    for engine in ("ref", "vectorized", "naive"):
        np.testing.assert_array_equal(
            port.predict(test, engine=engine, device="cpu"), ref.predict(test))


def test_training_logs_and_checkpoint(adult, tmp_path):
    train, _ = adult
    got = CartLearner(label="income", device="cpu").train(train)
    logs = got.training_logs
    assert (logs["learner"], logs["num_trees"], logs["growth_engine"],
            logs["histogram_backend"], logs["device"]) == \
        ("cart", 1, "batched", "numpy", "cpu")
    # checkpoint= is ported (tests/test_torch_checkpoint.py): the
    # checkpointed run grows and prunes the same tree and logs its save
    ck = CartLearner(label="income", device="cpu").train(
        train, checkpoint=str(tmp_path))
    for k in ("feature", "threshold", "left_child", "leaf_value", "n_nodes"):
        np.testing.assert_array_equal(getattr(ck.forest, k),
                                      getattr(got.forest, k), err_msg=k)
    assert [e["event"] for e in ck.training_logs["resilience"]] == \
        ["checkpoint"]
    assert not ck.training_logs["interrupted"]
    with pytest.raises(YdfError, match="checkpoint must be"):
        CartLearner(label="income", device="cpu").train(train, checkpoint=1)
