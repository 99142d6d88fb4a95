"""The port's GBT learner against the JAX package's device-engine GBT.

Both learners train on the same raw columns with the same seed; the port
runs on ``device="cpu"``, where its level steps take the torch path
(categorical data) or the fused split search's plain version (numerical
data). Tolerances, those of the reference's own device-engine tests
(tests/test_grower_device.py): structure identical on the strict configs,
leaf values within 2e-5, predictions within 1e-4; losses rtol 1e-6.
"""
from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from repro.core import GradientBoostedTreesLearner as RefGBT
from repro.core.api import Task as RefTask
from repro.data.tabular import SUITE, adult_like, make_dataset, train_test_split
from repro_torch.core import YdfError
from repro_torch.core.api import Task
from repro_torch.core.dataspec import BatchEncoder
from repro_torch.core.gbt import GradientBoostedTreesLearner
from repro_torch.core.tree import predict_naive
from repro_torch.data import tabular

STRUCT = ("feature", "split_bin", "cat_mask", "left_child", "n_nodes")


@pytest.fixture(scope="module")
def adult():
    return train_test_split(adult_like(900), 0.3, 1)


@pytest.mark.parametrize("hp,strict", [
    (dict(), True),                                         # LOCAL, CART cats
    (dict(categorical_algorithm="ONE_HOT", max_depth=4), True),
    (dict(subsample=0.7, use_hessian_gain=True), False),    # bagging + dups
    (dict(l2_regularization=0.3, max_depth=3), True),
])
def test_gbt_equals_reference_device_engine(adult, hp, strict):
    train, test = adult
    kw = dict(label="income", num_trees=4, validation_ratio=0.0,
              early_stopping="NONE", growth_engine="device", **hp)
    ref = RefGBT(**kw).train(train)
    got = GradientBoostedTreesLearner(**kw, device="cpu").train(train)
    logs = got.training_logs
    assert logs["growth_engine"] == "device" and logs["device_impl"] == "torch"
    assert logs["schema_version"] == 1 and logs["num_trees"] == 4
    if strict:
        for k in STRUCT:
            np.testing.assert_array_equal(getattr(got.forest, k),
                                          getattr(ref.forest, k),
                                          err_msg=f"forest.{k}")
        np.testing.assert_allclose(got.forest.leaf_value,
                                   ref.forest.leaf_value, atol=2e-5)
        np.testing.assert_allclose(got.predict(test, device="cpu"),
                                   ref.predict(test), atol=1e-4)
    else:
        np.testing.assert_array_equal(got.forest.n_nodes, ref.forest.n_nodes)
        pb, pd = ref.predict(test), got.predict(test, device="cpu")
        assert np.abs(pb - pd).mean() < 2e-3
        assert ((pb > 0.5) == (pd > 0.5)).mean() > 0.99


@pytest.fixture(scope="module")
def blood():
    spec = SUITE[1]                      # numerical only: the fused route
    data = train_test_split(make_dataset(spec), 0.3, spec.seed)
    kw = dict(label="label", num_trees=25, growth_engine="device")
    return data, RefGBT(**kw).train(data[0]), \
        GradientBoostedTreesLearner(**kw, device="cpu").train(data[0])


def test_numerical_gbt_takes_the_fused_route_and_equals_reference(blood):
    (train, test), ref, got = blood
    assert got.training_logs["device_impl"] == "torch"
    assert got.forest.n_trees == ref.forest.n_trees
    for k in STRUCT:
        np.testing.assert_array_equal(getattr(got.forest, k),
                                      getattr(ref.forest, k))
    np.testing.assert_allclose(got.forest.leaf_value, ref.forest.leaf_value,
                               atol=2e-5)
    for key in ("train_loss", "valid_loss"):
        np.testing.assert_allclose(got.training_logs[key],
                                   ref.training_logs[key], rtol=1e-6)
    np.testing.assert_allclose(got.predict(test, device="cpu"),
                               ref.predict(test), atol=1e-4)
    assert got.self_evaluation["accuracy"] == pytest.approx(
        ref.self_evaluation["accuracy"])


def test_trained_model_serves_as_predict_naive(blood):
    (_, test), _, got = blood
    feats = {k: test[k] for k in got.features}
    X = BatchEncoder(got.spec, got.features).encode(feats)
    want = got._compile_finalize()(predict_naive(got.forest, X))
    for engine in ("ref", "vectorized", "naive"):
        np.testing.assert_array_equal(
            got.predict(feats, engine=engine, device="cpu"), want)


def test_regression_equals_reference():
    spec = SUITE[7]
    train, test = train_test_split(make_dataset(spec), 0.3, spec.seed)
    kw = dict(label="label", num_trees=5, max_depth=4, growth_engine="device")
    ref = RefGBT(**kw, task=RefTask.REGRESSION).train(train)
    got = GradientBoostedTreesLearner(**kw, task=Task.REGRESSION,
                                      device="cpu").train(train)
    for k in STRUCT:
        np.testing.assert_array_equal(getattr(got.forest, k),
                                      getattr(ref.forest, k))
    np.testing.assert_allclose(got.predict(test, device="cpu"),
                               ref.predict(test), atol=1e-4)


def test_port_dataset_copy_equals_reference():
    for spec in (SUITE[1], SUITE[2]):
        port_spec = tabular.SyntheticSpec(**{
            f: getattr(spec, f) for f in spec.__dataclass_fields__})
        want, got = make_dataset(spec), tabular.make_dataset(port_spec)
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    want, got = adult_like(300, seed=3), tabular.adult_like(300, seed=3)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


# The ids are those of the cases when the port had no host engines and the
# first three raised; they now train as the reference does.
@pytest.mark.parametrize("kw,want", [
    pytest.param(dict(), ("batched", None), id="kw0-not have yet"),  # default
    pytest.param(dict(growth_engine="oracle"), ("oracle", None),
                 id="kw1-not have yet"),
    pytest.param(dict(growth_engine="device",
                      growing_strategy="BEST_FIRST_GLOBAL"),
                 ("batched", "BEST_FIRST"), id="kw2-BEST_FIRST"),
    pytest.param(dict(growth_engine="device", num_trees=0, warp=1),
                 "Unknown hyper", id="kw3-Unknown hyper"),
])
def test_unported_options_raise(adult, kw, want):
    """The engine that trains and the fallback reason the learner records
    are the reference's; an unknown hyper-parameter raises."""
    train, _ = adult
    if isinstance(want, str):
        with pytest.raises(YdfError, match=want):
            GradientBoostedTreesLearner(label="income", device="cpu",
                                        **kw).train(train)
        return
    kw = dict(label="income", num_trees=2, **kw)
    got = GradientBoostedTreesLearner(**kw, device="cpu").train(train)
    ref = RefGBT(**kw).train(train)
    for key in ("growth_engine", "engine_fallback"):
        assert got.training_logs[key] == ref.training_logs[key]
    engine, reason = want
    assert got.training_logs["growth_engine"] == engine
    fallback = got.training_logs["engine_fallback"]
    assert fallback is None if reason is None else reason in fallback


def test_checkpoint_and_ranking_raise(adult, tmp_path):
    # checkpoint= is ported (tests/test_torch_checkpoint.py): a directory
    # trains and checkpoints; an argument that is neither a directory nor a
    # CheckpointPolicy raises
    train, _ = adult
    learner = GradientBoostedTreesLearner(label="income", device="cpu",
                                          growth_engine="device", num_trees=1)
    with pytest.raises(YdfError, match="checkpoint must be"):
        learner.train(train, checkpoint=42)
    model = learner.train(train, checkpoint=str(tmp_path / "ckpt"))
    assert [e["event"] for e in model.training_logs["resilience"]] == \
        ["checkpoint"]
    assert os.listdir(tmp_path / "ckpt") == ["ckpt-00000001"]
    # ranking is ported (tests/test_torch_ranking.py): without its group
    # column it raises with directions
    with pytest.raises(YdfError, match="group/query column"):
        GradientBoostedTreesLearner(label="income", task=Task.RANKING,
                                    device="cpu",
                                    growth_engine="device").train(train)


def test_default_device_is_the_card(adult):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None trains on it")
    with pytest.raises(YdfError, match="device='cpu'"):
        GradientBoostedTreesLearner(label="income",
                                    growth_engine="device").train(adult[0])
