"""The port's uplift trees (``repro_torch.tasks.uplift``) against the JAX
package's.

Both learners train on the same raw columns with the same seed; the port
runs on ``device="cpu"``, where the batched engine grows lockstep blocks of
``tree_parallelism`` trees with numpy histograms of the four uplift stats.
Tolerance: exact — every Forest field, the predictions and the metrics
(``qini_curve``, ``evaluate_predictions``) ``np.array_equal`` / ``==``.

The device growth engine scores gh, class and moment stats only. The
reference starts it on an uplift configuration and fails inside its split
scan with ``ValueError: uplift`` (``grower_device.device_unsupported_reason``
does not screen the stat kind, and ``fused.score_stats`` has no uplift
branch); the port refuses the configuration with a directed ``YdfError``
before any tree grows. Both are pinned here.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.core.api import Task as RefTask
from repro.core.evaluation import evaluate_predictions as ref_evaluate
from repro.core.evaluation import qini_curve as ref_qini_curve
from repro.core.splitters import _order_key as ref_order_key
from repro.core.splitters import _score as ref_score
from repro.tasks import UpliftTreesLearner as RefUplift
from repro.tasks.uplift import uplift_leaf as ref_uplift_leaf
from repro_torch import convert
from repro_torch.core import Model, Task, YdfError, get_learner, make_learner
from repro_torch.core.evaluation import evaluate_predictions, qini_curve
from repro_torch.core.splitters import _order_key, _score
from repro_torch.core.tree import predict_naive
from repro_torch.data import tabular
from repro_torch.serving.forest import make_forest_server
from repro_torch.tasks import UpliftTreesLearner
from repro_torch.tasks.uplift import uplift_leaf

pytestmark = pytest.mark.tasks

FOREST_FIELDS = ("feature", "threshold", "cat_mask", "left_child",
                 "leaf_value", "n_nodes", "split_bin", "split_gain",
                 "tree_class", "init_pred")


def assert_same_forest(got, want, msg=""):
    for k in FOREST_FIELDS:
        a, b = getattr(got, k), getattr(want, k)
        assert (a is None) == (b is None), f"{msg}: forest.{k}"
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=f"{msg}: forest.{k}")
    assert (got.depth, got.out_dim) == (want.depth, want.out_dim), msg


# ---------------------------------------------------- scores and leaves

def _uplift_stats(seed, shape=(6, 9)):
    """Histogram-like uplift stats [sum_y_t, n_t, sum_y_c, n], with empty
    arms and empty cells among them."""
    rng = np.random.default_rng(seed)
    n = rng.integers(0, 12, shape).astype(np.float64)
    nt = np.floor(n * rng.random(shape))
    nt[0] = 0                              # no treated row
    nt[1] = n[1]                           # no control row
    st = np.floor(nt * rng.random(shape))
    sc = np.floor((n - nt) * rng.random(shape))
    return np.stack([st, nt, sc, n], -1)


@pytest.mark.parametrize("seed", range(3))
def test_uplift_score_order_key_and_leaf_equal_reference(seed):
    s = _uplift_stats(seed)
    assert np.array_equal(_score(s, "uplift", 0.0), ref_score(s, "uplift", 0.0))
    assert np.array_equal(_order_key(s, "uplift"), ref_order_key(s, "uplift"))
    for cell in s.reshape(-1, 4):
        assert np.array_equal(uplift_leaf(cell), ref_uplift_leaf(cell))
    # a child with an empty arm contributes no gain
    assert np.all(_score(s, "uplift", 0.0)[:2] == 0.0)


def test_qini_golden():
    """tests/test_tasks.py:67-80, through the port."""
    score = np.array([4.0, 3.0, 2.0, 1.0])
    treatment = np.array([1, 0, 1, 0], np.int64)
    y = np.array([1.0, 1.0, 0.0, 1.0])
    np.testing.assert_allclose(qini_curve(y, score, treatment),
                               [1.0, 0.0, -1.0, -1.0], atol=1e-15)
    ev = evaluate_predictions(Task.UPLIFT, score, y, treatment=treatment)
    assert ev.metrics["auuc"] == pytest.approx(-0.0625, abs=1e-12)
    assert ev.metrics["qini"] == pytest.approx(0.09375, abs=1e-12)
    assert ev.primary == ev.metrics["qini"]


@pytest.mark.parametrize("seed", range(4))
def test_uplift_metrics_equal_reference(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(5, 400))
    y = (rng.random(n) < 0.4).astype(np.float64)
    t = (rng.random(n) < 0.5).astype(np.int64)
    score = np.round(rng.normal(size=n), 1)        # ties included
    assert np.array_equal(qini_curve(y, score, t), ref_qini_curve(y, score, t))
    got = evaluate_predictions(Task.UPLIFT, score, y, treatment=t)
    want = ref_evaluate(RefTask.UPLIFT, score, y, treatment=t)
    assert got.metrics == want.metrics
    with pytest.raises(YdfError, match="treatment="):
        evaluate_predictions(Task.UPLIFT, score, y)


# --------------------------------------------------------- the learner

@pytest.fixture(scope="module")
def uplift_data():
    return tabular.randomized_treatment(n=1500, seed=11)


@pytest.mark.parametrize("hp", [
    dict(num_trees=10),                                 # defaults, 2 blocks
    dict(num_trees=3, tree_parallelism=1),              # tree by tree
    dict(num_trees=4, num_candidate_attributes="ALL", bootstrap=False,
         max_depth=5, min_examples=5),
    dict(num_trees=3, growth_engine="oracle"),
], ids=["default", "sequential", "all_no_bootstrap", "oracle"])
def test_uplift_forest_equals_reference(uplift_data, hp):
    kw = dict(label="outcome", seed=2, **hp)
    want = RefUplift(**kw).train(uplift_data)
    got = UpliftTreesLearner(device="cpu", **kw).train(uplift_data)
    assert_same_forest(got.forest, want.forest, str(hp))
    assert got.forest.tree_class is None
    assert got.treatment_col == want.treatment_col == "treatment"
    assert got.features == want.features == ["num_0", "num_1", "num_2",
                                             "num_3"]
    logs = got.training_logs
    assert logs["growth_engine"] == want.training_logs["growth_engine"]
    assert logs["tree_parallelism"] == want.training_logs["tree_parallelism"]
    pred = got.predict(uplift_data, device="cpu")
    np.testing.assert_array_equal(pred, np.asarray(want.predict(uplift_data)))
    assert pred.shape == (1500,) and (np.abs(pred) <= 1.0).all()
    ev, rev = got.evaluate(uplift_data, device="cpu"), want.evaluate(uplift_data)
    assert ev.metrics == rev.metrics and ev.task == Task.UPLIFT


def test_uplift_trees_positive_qini_on_randomized_treatment():
    """The port's copy of tests/test_tasks.py:169."""
    du = tabular.randomized_treatment()
    m = UpliftTreesLearner(label="outcome", num_trees=20, seed=2,
                           device="cpu").train(du)
    ev = m.evaluate(du, device="cpu")
    assert ev.task == Task.UPLIFT
    assert ev.metrics["qini"] > 0.0, ev.metrics
    assert (np.abs(np.asarray(m.predict(du, device="cpu"))) <= 1.0).all()


def test_device_engine_is_refused_with_directions():
    """The port refuses growth_engine="device" before training, naming the
    reason and the batched engine; it does not train on another engine."""
    du = tabular.randomized_treatment(n=300, seed=11)
    with pytest.raises(YdfError) as e:
        UpliftTreesLearner(label="outcome", growth_engine="device",
                           num_trees=2, device="cpu").train(du)
    msg = str(e.value)
    assert "gh, class and moment" in msg and "growth_engine='batched'" in msg


def test_reference_device_engine_fails_inside_its_split_scan():
    """The reference's fault the port's refusal answers: its device engine
    starts on the uplift stats and raises a bare ValueError."""
    du = tabular.randomized_treatment(n=300, seed=11)
    with pytest.raises(ValueError, match="uplift"):
        RefUplift(label="outcome", growth_engine="device",
                  num_trees=2).train(du)


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="a CUDA device is present: device=None trains on it")
def test_default_device_is_the_card():
    with pytest.raises(YdfError, match="device='cpu'"):
        UpliftTreesLearner(label="outcome", num_trees=1).train(
            tabular.randomized_treatment(n=100, seed=1))


def test_treatment_column_guards():
    du = tabular.randomized_treatment(n=300, seed=11)
    with pytest.raises(YdfError, match='treatment column "treatment"'):
        UpliftTreesLearner(label="outcome", num_trees=1, device="cpu").train(
            {k: v for k, v in du.items() if k != "treatment"})
    three = dict(du, treatment=(np.arange(300) % 3).astype(object))
    with pytest.raises(YdfError, match="exactly two"):
        UpliftTreesLearner(label="outcome", num_trees=1, device="cpu").train(
            three)
    with pytest.raises(YdfError, match="UPLIFT"):
        UpliftTreesLearner(label="outcome", task=Task.CLASSIFICATION)


def test_registry_and_train_config_equal_reference():
    assert get_learner("UPLIFT_TREES") is UpliftTreesLearner
    ref = RefUplift(label="outcome", num_trees=7, seed=5)
    got = UpliftTreesLearner(label="outcome", num_trees=7, seed=5)
    assert got.train_config() == ref.train_config()
    again = make_learner(ref.train_config(), device="cpu")
    assert type(again) is UpliftTreesLearner and again.hparams == got.hparams


# ------------------------------------------------ guards, serving, I/O

@pytest.fixture(scope="module")
def tiny():
    du = tabular.randomized_treatment(n=300, seed=11)
    kw = dict(label="outcome", num_trees=3, seed=2)
    return (UpliftTreesLearner(device="cpu", **kw).train(du),
            RefUplift(**kw).train(du), du)


def test_guards_fail_fast_with_directions(tiny):
    model, _, data = tiny
    with pytest.raises(YdfError, match="classification model"):
        model.predict_class(object())
    assert "Task: UPLIFT" in model.summary()
    with pytest.raises(YdfError, match="treatment"):
        model.evaluate({k: v for k, v in data.items() if k != "treatment"},
                       device="cpu")


def test_serves_through_the_bundle_as_predict(tiny):
    model, want, data = tiny
    bundle = make_forest_server(model, warmup=False, device="cpu")
    feats = {k: v for k, v in data.items() if k != model.label}
    got = np.asarray(bundle.predict(feats))
    np.testing.assert_array_equal(got, model.predict(data, device="cpu"))
    np.testing.assert_array_equal(got, np.asarray(want.predict(data)))
    p = model.predictor(device="cpu")
    np.testing.assert_array_equal(
        got, p.finalize(predict_naive(model.forest, p.encode(feats))))


def test_reference_model_crosses_through_model_from_arrays(tiny):
    _, want, data = tiny
    from repro.core.dataspec import spec_to_dict
    f = want.forest
    arrays = {k: getattr(f, k) for k in FOREST_FIELDS}
    arrays.update(depth=f.depth, out_dim=f.out_dim)
    got = convert.model_from_arrays(
        "uplift", arrays, spec_to_dict(want.spec), want.features,
        task=want.task, treatment_col=want.treatment_col)
    assert type(got).__name__ == "UpliftModel"
    assert got.forest.tree_class is None
    got.label = want.label                 # a label is not model data
    np.testing.assert_array_equal(got.predict(data, device="cpu"),
                                  np.asarray(want.predict(data)))
    assert got.evaluate(data, device="cpu").metrics == \
        want.evaluate(data).metrics


def test_save_load_round_trip(tiny, tmp_path):
    model, _, data = tiny
    model.save(str(tmp_path / "m"))
    back = Model.load(str(tmp_path / "m"))
    assert type(back).__name__ == "UpliftModel"
    assert back.task == Task.UPLIFT and back.treatment_col == "treatment"
    assert_same_forest(back.forest, model.forest)
    np.testing.assert_array_equal(back.predict(data, device="cpu"),
                                  model.predict(data, device="cpu"))
    assert back.summary() == model.summary()
    assert back.training_logs == model.training_logs


def test_chip_smoke_uplift_phase_on_the_cpu(monkeypatch):
    """``chip_smoke.run_uplift`` rehearsed on the CPU at 3,000 rows and 4
    trees (profiling stubbed): the forest equals the CPU's, Qini > 0 and
    the device engine is refused."""
    import chip_smoke
    from repro_torch.core.hist_backend import resolve_backend
    monkeypatch.setattr(chip_smoke, "profile_training", lambda *a, **k: {})
    cpu = torch.device("cpu")
    model, run = chip_smoke.run_uplift(cpu, resolve_backend("auto", cpu),
                                       n=3_000, n_trees=4)
    assert run["card_equals_cpu"] and run["qini"] > 0
    assert "growth_engine='batched'" in run["device_engine_refused"]
    assert model.forest.n_trees == 4
