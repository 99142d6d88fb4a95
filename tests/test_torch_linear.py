"""The linear baseline in the port (``repro_torch.core.baselines``) against
the JAX package's ``repro.core.baselines``, on the CPU.

``_design_matrix`` is the same numpy code: bit-identical. Training is the
same loss and the same Adam arithmetic in another library (torch autograd
and matmuls against XLA's), so the float32 results differ in their last
bits and 300 Adam steps carry that on. Tolerances, stated per case:
  * binary, multiclass and regression data whose gradients are nonzero at
    the start: W, b and the predictions within atol 1e-4, equal accuracy;
  * balanced classes (synth_vowel: 63 rows of each of 11 classes): at
    W = 0 the bias gradient 1/K - freq_k is zero in exact arithmetic, and
    Adam's first step, lr * g / (|g| + 1e-8), turns float32 rounding noise
    of ~1e-8 into steps of up to ~lr/2 that differ between the libraries.
    There W and b within atol 2e-2, the predictions within 1e-3, and the
    same predicted class on every row.
Saving and loading is plain data (``linear.npz`` and ``model.json``);
``convert.model_from_arrays("linear", ...)`` carries a reference model
across and predicts as it does.
"""
from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from repro.core.api import Task as RTask
from repro.core.baselines import LinearLearner as RefLinear
from repro.core.baselines import _design_matrix as ref_design
from repro.core.dataspec import spec_to_dict
from repro.core.models import prepare_train_data as ref_prepare
from repro.data.tabular import SUITE, make_dataset, train_test_split

from repro_torch import convert
from repro_torch.core import (
    GradientBoostedTreesLearner,
    LinearLearner,
    Model,
    Task,
    YdfError,
    get_learner,
    make_learner,
)
from repro_torch.core.baselines import LinearModel, _design_matrix
from repro_torch.core.models import prepare_train_data

CPU = "cpu"
BY_NAME = {s.name: s for s in SUITE}


def _split(name):
    spec = BY_NAME[name]
    return train_test_split(make_dataset(spec), 0.3, spec.seed)


def _task(name):
    return "CLASSIFICATION" if BY_NAME[name].n_classes else "REGRESSION"


@pytest.fixture(scope="module")
def fitted():
    """(port model, reference model, test rows) per dataset, trained once."""
    out = {}
    for name in ("synth_adult", "synth_iris", "synth_segment",
                 "synth_wine_reg", "synth_vowel"):
        train, test = _split(name)
        task = _task(name)
        ref = RefLinear(label="label", task=RTask(task)).train(train)
        mine = LinearLearner(label="label", task=Task(task),
                             device=CPU).train(train)
        out[name] = (mine, ref, test)
    return out


@pytest.mark.parametrize("name", ["synth_adult", "synth_credit",
                                  "synth_cmc", "synth_wine_reg"])
def test_design_matrix_is_bit_identical(name):
    train, test = _split(name)
    task = _task(name)
    ref_td = ref_prepare(RefLinear(label="label", task=RTask(task)), train)
    td = prepare_train_data(LinearLearner(label="label", task=Task(task),
                                          device=CPU), train)
    assert td.features == ref_td.features
    want = ref_design(ref_td.ds, ref_td.features, ref_td.ds.spec)
    got = _design_matrix(td.ds, td.features, td.ds.spec)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("name,w_atol,p_atol", [
    ("synth_adult", 1e-4, 1e-4),       # binary, 14 columns, one-hot cats
    ("synth_iris", 1e-4, 1e-4),        # 3 classes
    ("synth_segment", 1e-4, 1e-4),     # 7 classes
    ("synth_wine_reg", 1e-4, 1e-4),    # regression
    ("synth_vowel", 2e-2, 1e-3),       # 11 balanced classes (see above)
])
def test_linear_learner_equals_the_reference(fitted, name, w_atol, p_atol):
    mine, ref, test = fitted[name]
    assert mine.W.dtype == ref.W.dtype == np.float32
    assert mine.W.shape == ref.W.shape and mine.b.shape == ref.b.shape
    np.testing.assert_allclose(mine.W, ref.W, atol=w_atol, rtol=0)
    np.testing.assert_allclose(mine.b, ref.b, atol=w_atol, rtol=0)
    got, want = mine.predict(test, device=CPU), ref.predict(test)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, atol=p_atol, rtol=0)
    if mine.task == Task.CLASSIFICATION:
        np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
        assert mine.evaluate(test, device=CPU)["accuracy"] == \
            ref.evaluate(test)["accuracy"]
        assert mine.classes == ref.classes
    else:
        assert mine.evaluate(test, device=CPU)["rmse"] == pytest.approx(
            ref.evaluate(test)["rmse"], abs=1e-4)


def test_save_and_load_round_trip(fitted, tmp_path):
    mine, _, test = fitted["synth_adult"]
    before = mine.predict(test, device=CPU)
    mine.evaluate(test, device=CPU)
    path = str(tmp_path / "linear")
    mine.save(path)
    assert sorted(os.listdir(path)) == [
        "dataspec.json", "evaluation.json", "evaluation.txt", "header.json",
        "linear.npz", "model.json", "summary.txt"]
    loaded = Model.load(path)
    assert isinstance(loaded, LinearModel)
    assert (loaded.label, loaded.task, loaded.features, loaded.classes) == \
        (mine.label, mine.task, mine.features, mine.classes)
    np.testing.assert_array_equal(loaded.W, mine.W)
    np.testing.assert_array_equal(loaded.b, mine.b)
    np.testing.assert_array_equal(loaded.predict(test, device=CPU), before)
    assert loaded.summary() == mine.summary()


def test_convert_carries_a_reference_linear_model_across(fitted):
    _, ref, test = fitted["synth_iris"]
    model = convert.model_from_arrays(
        "linear", {"W": ref.W, "b": ref.b}, spec_to_dict(ref.spec),
        ref.features, task=ref.task, classes=ref.classes)
    assert isinstance(model, LinearModel) and model.task == Task.CLASSIFICATION
    np.testing.assert_allclose(model.predict(test, device=CPU),
                               ref.predict(test), rtol=0, atol=1e-12)
    with pytest.raises(YdfError, match=r"missing \['b'\]"):
        convert.model_from_arrays("linear", {"W": ref.W},
                                  spec_to_dict(ref.spec), ref.features,
                                  task=ref.task)


def test_registry_and_train_config():
    assert get_learner("LINEAR") is LinearLearner
    ref = RefLinear(label="label", task=RTask.REGRESSION, steps=20, lr=0.1)
    mine = make_learner(ref.train_config(), device=CPU)
    assert isinstance(mine, LinearLearner)
    assert mine.train_config() == ref.train_config()
    with pytest.raises(YdfError, match="Unknown hyper-parameter"):
        LinearLearner(label="label", steps=3, momentum=0.5)


def test_c1_gbt_beats_linear_on_rule_data():
    """The port's counterpart of test_paper_claims.py's C1: on the
    classification sets of SUITE[:4], the GBT beats the linear model on all
    but at most one."""
    suite = [spec for spec in SUITE[:4] if spec.n_classes]
    wins = 0
    for spec in suite:
        train, test = train_test_split(make_dataset(spec), 0.3, spec.seed)
        gbt = GradientBoostedTreesLearner(label="label", num_trees=30,
                                          device=CPU).train(train)
        lin = LinearLearner(label="label", device=CPU).train(train)
        wins += (gbt.evaluate(test, device=CPU)["accuracy"]
                 > lin.evaluate(test, device=CPU)["accuracy"])
    assert wins >= len(suite) - 1


def test_device_default_is_the_card_and_checkpoints_are_refused(fitted):
    mine, _, test = fitted["synth_iris"]
    train, _ = _split("synth_iris")
    with pytest.raises(YdfError, match="takes no checkpoint"):
        LinearLearner(label="label", device=CPU).train(train,
                                                      checkpoint="/tmp/x")
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs on it")
    with pytest.raises(YdfError, match="no CUDA device"):
        LinearLearner(label="label").train(train)
    with pytest.raises(YdfError, match="no CUDA device"):
        mine.predict(test)
