"""The port's meta-learners (``repro_torch.core.metalearners``) against the
JAX package's (``repro.core.metalearners``), on the scenarios of
``tests/test_metalearners.py``.

Both packages run the same meta-learner over the same sub-learners on the
same numpy-seeded data, the port on ``device="cpu"``; their CPU forests are
bit-identical, and the meta-learners' own arithmetic (trial sampling,
folds, Platt's Newton steps, the greedy elimination) is the same numpy
code. Tolerance: none. The tuner's trial log and chosen hyper-parameters,
the selector's kept and removed features, the Platt (a, b), the folds of
``kfold_indices`` and the meta-models' predictions equal the reference's.
Also: the registry resolves all four names and LINEAR (A8, ported);
the meta-models' ``save`` refuses with directions and writes nothing; a
meta-learner hands its device to every learner it builds or wraps, and
without a card raises unless given ``device="cpu"``.
"""
from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from repro.core import Calibrator as RefCalibrator
from repro.core import Ensembler as RefEnsembler
from repro.core import FeatureSelector as RefFeatureSelector
from repro.core import GradientBoostedTreesLearner as RefGBT
from repro.core import HyperParameterTuner as RefTuner
from repro.core import RandomForestLearner as RefRF
from repro.core import cross_validate as ref_cross_validate
from repro.core.metalearners import _platt_fit as ref_platt_fit
from repro.core.metalearners import kfold_indices as ref_kfold_indices
from repro.data.tabular import adult_like, train_test_split
from repro_torch.core import (
    Calibrator,
    Ensembler,
    FeatureSelector,
    GradientBoostedTreesLearner,
    HyperParameterTuner,
    RandomForestLearner,
    YdfError,
    cross_validate,
    get_learner,
)
from repro_torch.core import api
from repro_torch.core.metalearners import (
    CalibratedModel,
    EnsembleModel,
    _platt_fit,
    kfold_indices,
)

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The CPU engines' small torch ops run on one thread: test workers
    share the host, and a thread pool per worker oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def adult():
    return train_test_split(adult_like(1200), 0.3, 1)


def _gbt(**kw):
    kw.setdefault("num_trees", 12)
    return GradientBoostedTreesLearner(**kw)


def _ref_gbt(**kw):
    kw.setdefault("num_trees", 12)
    return RefGBT(**kw)


def _evals_equal(a, b) -> None:
    assert a.n_examples == b.n_examples
    assert a.metrics == b.metrics


def test_tuner_trials_and_choice_equal_reference():
    """On XOR, depth-1 boosting cannot learn; both tuners score the same
    trials the same way and pick the same depth."""
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=700), rng.normal(size=700)
    y = np.where((a > 0) ^ (b > 0), "pos", "neg")
    data = {"a": a.astype(object), "b": b.astype(object), "y": y.astype(object)}
    train, test = train_test_split(data, 0.3, 0)
    space = {"max_depth": [1, 4], "shrinkage": [0.1, 0.3]}
    tuned = HyperParameterTuner(_gbt, space, label="y", n_trials=4,
                                metric="accuracy", seed=3,
                                device=CPU).train(train)
    want = RefTuner(_ref_gbt, space, label="y", n_trials=4, metric="accuracy",
                    seed=3).train(train)
    assert tuned.tuning_logs == want.tuning_logs
    assert tuned.tuning_logs["best"]["max_depth"] > 1
    np.testing.assert_array_equal(tuned.predict(test, device=CPU),
                                  want.predict(test))
    bad = GradientBoostedTreesLearner(label="y", num_trees=12, max_depth=1,
                                      device=CPU).train(train)
    assert tuned.evaluate(test, device=CPU)["accuracy"] > \
        bad.evaluate(test, device=CPU)["accuracy"] + 0.2


def test_tuner_cv_protocol_and_loss_metric_equal_reference(adult):
    train, _ = adult
    space = {"max_depth": [2, 3, 5], "num_trees": [4, 6]}
    kw = dict(label="income", n_trials=3, protocol="cv", cv_folds=3, seed=5)
    tuned = HyperParameterTuner(_gbt, space, device=CPU, **kw).train(train)
    want = RefTuner(_ref_gbt, space, **kw).train(train)
    assert tuned.tuning_logs == want.tuning_logs


def test_ensembler_averages_as_the_reference(adult):
    train, test = adult
    ens = Ensembler([
        GradientBoostedTreesLearner(label="income", num_trees=8, seed=1),
        RandomForestLearner(label="income", num_trees=6, seed=2),
    ], label="income", device=CPU)
    model = ens.train(train)
    want = RefEnsembler([RefGBT(label="income", num_trees=8, seed=1),
                         RefRF(label="income", num_trees=6, seed=2)],
                        label="income").train(train)
    p = model.predict(test, device=CPU)
    np.testing.assert_array_equal(p, want.predict(test))
    a = model.models[0].predict(test, device=CPU)
    b = model.models[1].predict(test, device=CPU)
    np.testing.assert_allclose(p, (a + b) / 2, atol=1e-6)
    _evals_equal(model.evaluate(test, device=CPU), want.evaluate(test))


def test_calibrator_platt_fit_equals_reference(adult):
    train, test = adult
    base = lambda **kw: RandomForestLearner(num_trees=5, winner_take_all=True,
                                            **kw)
    ref_base = lambda **kw: RefRF(num_trees=5, winner_take_all=True, **kw)
    raw = base(label="income", device=CPU).train(train)
    cal = Calibrator(base(label="income"), label="income", seed=5,
                     device=CPU).train(train)
    want = RefCalibrator(ref_base(label="income"), label="income",
                         seed=5).train(train)
    assert (cal.a, cal.b) == (want.a, want.b)
    np.testing.assert_array_equal(cal.predict(test, device=CPU),
                                  want.predict(test))
    assert cal.evaluate(test, device=CPU)["logloss"] < \
        raw.evaluate(test, device=CPU)["logloss"]
    rng = np.random.default_rng(4)
    score = rng.normal(size=300)
    y = (score + rng.normal(size=300) > 0).astype(int)
    assert _platt_fit(score, y) == ref_platt_fit(score, y)


def test_feature_selector_keeps_the_reference_features(adult):
    rng = np.random.default_rng(0)
    train, _ = adult
    train = dict(train, pure_noise=rng.choice(
        np.array(["a", "b", "c", "d"], object), size=len(train["income"])))
    kw = dict(label="income", tolerance=0.01, max_removals=2)
    model = FeatureSelector(
        lambda **k: RandomForestLearner(num_trees=8, **k), device=CPU,
        **kw).train(train)
    want = RefFeatureSelector(lambda **k: RefRF(num_trees=8, **k),
                              **kw).train(train)
    assert model.selected_features == want.selected_features
    assert model.removed_features == want.removed_features
    assert len(model.removed_features) <= 2


def test_metalearner_composition_equals_reference(adult):
    """Fig. 3: calibrator(ensembler(tuner(GBT), RF))."""
    train, test = adult
    tuner = HyperParameterTuner(_gbt, {"max_depth": [3, 6]}, label="income",
                                n_trials=2, seed=1)
    ens = Ensembler([tuner, RandomForestLearner(label="income", num_trees=6)],
                    label="income")
    model = Calibrator(ens, label="income", device=CPU).train(train)
    ref_tuner = RefTuner(_ref_gbt, {"max_depth": [3, 6]}, label="income",
                         n_trials=2, seed=1)
    want = RefCalibrator(RefEnsembler(
        [ref_tuner, RefRF(label="income", num_trees=6)], label="income"),
        label="income").train(train)
    assert (model.a, model.b) == (want.a, want.b)
    assert model.base.models[0].tuning_logs == want.base.models[0].tuning_logs
    np.testing.assert_array_equal(model.predict(test, device=CPU),
                                  want.predict(test))
    assert model.evaluate(test, device=CPU)["accuracy"] > 0.7
    # the wrapped learners were copies: the caller's keep their device
    assert tuner.device is None and ens.device is None


@pytest.mark.parametrize("n,k,seed", [(100, 5, 7), (37, 3, 0), (10, 10, 1)])
def test_kfold_indices_equal_reference(n, k, seed):
    folds = kfold_indices(n, k, seed)
    for (a, b), (c, d) in zip(folds, ref_kfold_indices(n, k, seed)):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
    all_va = np.sort(np.concatenate([va for _, va in folds]))
    np.testing.assert_array_equal(all_va, np.arange(n))


def test_cross_validate_equals_reference(adult):
    train, _ = adult
    evals = cross_validate(
        lambda: GradientBoostedTreesLearner(label="income", num_trees=5),
        train, k=3, device=CPU)
    want = ref_cross_validate(lambda: RefGBT(label="income", num_trees=5),
                              train, k=3)
    assert len(evals) == 3
    for a, b in zip(evals, want):
        _evals_equal(a, b)
    assert all(0.5 < e["accuracy"] <= 1.0 for e in evals)


# ------------------------------------------------------- registry, saving

def test_registry_resolves_the_meta_learners():
    for name, cls in (("HYPERPARAMETER_TUNER", HyperParameterTuner),
                      ("ENSEMBLER", Ensembler), ("CALIBRATOR", Calibrator),
                      ("FEATURE_SELECTOR", FeatureSelector)):
        assert get_learner(name) is cls
    # A8 is ported: no reference learner is left unported
    assert api._NOT_PORTED == {}
    assert get_learner("LINEAR").__module__ == "repro_torch.core.baselines"


def test_meta_models_refuse_to_save_with_directions(adult, tmp_path):
    train, _ = adult
    ens = Ensembler([GradientBoostedTreesLearner(label="income", num_trees=3)],
                    label="income", device=CPU).train(train)
    cal = CalibratedModel(base=ens.models[0], a=1.0, b=0.0, label="income",
                          task=ens.task, classes=ens.classes)
    assert isinstance(ens, EnsembleModel)
    for model, how in ((ens, r"model\.models\[i\]\.save"),
                       (cal, r"model\.base\.save")):
        path = tmp_path / type(model).__name__
        with pytest.raises(YdfError, match="no plain-data form") as err:
            model.save(str(path))
        assert how.replace("\\", "") in str(err.value)
        assert not path.exists() and not os.listdir(tmp_path)


# ------------------------------------------------------------- the device

def test_factories_and_wrapped_learners_get_the_meta_learners_device(adult):
    train, _ = adult
    seen = []

    def factory(**kw):
        seen.append(kw["device"])
        return GradientBoostedTreesLearner(num_trees=2, **kw)

    HyperParameterTuner(factory, {"max_depth": [2, 3]}, label="income",
                        n_trials=2, device=CPU).train(train)
    def rf_factory(**kw):
        seen.append(kw["device"])
        return RandomForestLearner(num_trees=2, **kw)

    FeatureSelector(rf_factory, label="income", max_removals=1,
                    device=CPU).train(train)
    assert seen and set(seen) == {CPU}
    inner = GradientBoostedTreesLearner(label="income", num_trees=2)
    model = Ensembler([inner], label="income", device=CPU).train(train)
    assert inner.device is None          # the caller's learner is untouched
    assert model.models[0].training_logs["device"] == CPU


def test_meta_learners_need_a_card_unless_given_the_cpu(adult):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without a card")
    train, _ = adult
    gbt = GradientBoostedTreesLearner(label="income", num_trees=2)
    for learner in (
            HyperParameterTuner(_gbt, {"max_depth": [2]}, label="income",
                                n_trials=1),
            Ensembler([gbt], label="income"),
            Calibrator(gbt, label="income"),
            FeatureSelector(_gbt, label="income")):
        with pytest.raises(YdfError, match="device='cpu'"):
            learner.train(train)
    with pytest.raises(YdfError, match="device='cpu'"):
        cross_validate(lambda: gbt, train, k=2)
    model = Ensembler([gbt], label="income", device=CPU).train(train)
    with pytest.raises(YdfError, match="device='cpu'"):
        model.predict(train)
