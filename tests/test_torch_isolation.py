"""The port's isolation forest (``repro_torch.tasks.isolation``) against the
JAX package's.

Training is host numpy in both packages: the same rng stream per tree,
``(seed, 104729, t)``, and the same LIFO frontier, so the forests are
identical. Tolerance: exact — every Forest field, the anomaly scores
through every engine the port has on the CPU (the kernels' plain versions
among them), ``predict_naive`` and the metrics ``np.array_equal`` / ``==``;
the planted-anomaly AUC is >= 0.9, the reference's pin
(tests/test_tasks.py:158).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.core.api import Task as RefTask
from repro.core.evaluation import evaluate_predictions as ref_evaluate
from repro.tasks import IsolationForestLearner as RefIsolation
from repro.tasks.isolation import average_path_length as ref_apl
from repro_torch import convert
from repro_torch.core import Model, Task, YdfError, get_learner, make_learner
from repro_torch.core.evaluation import evaluate_predictions
from repro_torch.core.tree import predict_naive
from repro_torch.data import tabular
from repro_torch.kernels.forest_infer import ops
from repro_torch.serving.forest import make_forest_server
from repro_torch.tasks import IsolationForestLearner
from repro_torch.tasks.isolation import average_path_length

pytestmark = pytest.mark.tasks

FOREST_FIELDS = ("feature", "threshold", "cat_mask", "left_child",
                 "leaf_value", "n_nodes", "split_bin", "split_gain",
                 "tree_class", "init_pred")
CPU = torch.device("cpu")


def assert_same_forest(got, want, msg=""):
    for k in FOREST_FIELDS:
        a, b = getattr(got, k), getattr(want, k)
        assert (a is None) == (b is None), f"{msg}: forest.{k}"
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=f"{msg}: forest.{k}")
    assert (got.depth, got.out_dim) == (want.depth, want.out_dim), msg


@pytest.mark.parametrize("n", [0, 1, 2, 3, 10, 256, 100_000])
def test_average_path_length_equals_reference(n):
    assert average_path_length(n) == ref_apl(n)


@pytest.mark.parametrize("seed", range(3))
def test_anomaly_metrics_equal_reference(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(5, 300))
    y = (rng.random(n) < 0.1).astype(np.float64)
    score = np.round(rng.random(n), 2)             # ties included
    got = evaluate_predictions(Task.ANOMALY, score, y)
    want = ref_evaluate(RefTask.ANOMALY, score, y)
    assert got.metrics == want.metrics
    assert got.primary == got.metrics["auc"]


@pytest.fixture(scope="module")
def anomaly_data():
    return tabular.planted_anomaly(n_inlier=1000, n_anomaly=40, seed=13)


@pytest.mark.parametrize("hp", [
    dict(num_trees=30),                                   # psi 256, depth 8
    dict(num_trees=5, subsample_count=64, max_depth=3),
    dict(num_trees=4, subsample_count=5000),              # psi capped at N
], ids=["default", "small_psi_depth3", "psi_above_n"])
def test_isolation_forest_equals_reference(anomaly_data, hp):
    kw = dict(label="anomaly", seed=3, **hp)
    want = RefIsolation(**kw).train(anomaly_data)
    got = IsolationForestLearner(device="cpu", **kw).train(anomaly_data)
    assert_same_forest(got.forest, want.forest, str(hp))
    assert got.c_psi == want.c_psi
    assert got.features == want.features
    logs, rlogs = got.training_logs, want.training_logs
    assert (logs["psi"], logs["depth_cap"]) == (rlogs["psi"], rlogs["depth_cap"])
    want_scores = np.asarray(want.predict(anomaly_data))
    for engine in ("vectorized", "naive", "ref"):
        np.testing.assert_array_equal(
            got.predict(anomaly_data, engine=engine, device="cpu"),
            want_scores, err_msg=engine)
    # the traversal kernels' plain versions on CPU tensors: B2 ("cuda", the
    # packed layout) and B4 ("single", the SoA) against predict_naive
    p = got.predictor(device="cpu")
    X = p.encode(anomaly_data)
    naive = predict_naive(got.forest, X)
    for impl in ("cuda", "single", "ref"):
        per_tree = ops.forest_predict(got.forest, X, impl, CPU).numpy()
        np.testing.assert_array_equal(per_tree, naive, err_msg=impl)
        np.testing.assert_array_equal(p.finalize(per_tree), want_scores)
    ev, rev = got.evaluate(anomaly_data, device="cpu"), want.evaluate(anomaly_data)
    assert ev.metrics == rev.metrics


def test_isolation_forest_planted_anomaly_auc():
    """The port's copy of tests/test_tasks.py:158."""
    da = tabular.planted_anomaly()
    m = IsolationForestLearner(label="anomaly", num_trees=100, seed=3,
                               device="cpu").train(da)
    ev = m.evaluate(da, device="cpu")
    assert ev.task == Task.ANOMALY
    assert ev.metrics["auc"] >= 0.9, ev.metrics
    p = np.asarray(m.predict(da, device="cpu"))
    assert (p > 0).all() and (p <= 1).all()


def test_forest_shape_of_the_defaults(anomaly_data):
    """100 trees, node capacity 2 psi + 1 = 513, depth <= 8, path-length
    leaves: the shape the traversal kernels serve."""
    m = IsolationForestLearner(label="anomaly", device="cpu").train(
        anomaly_data)
    f = m.forest
    assert (f.n_trees, f.max_nodes, f.out_dim) == (100, 513, 1)
    assert 1 <= f.depth <= 8 and f.tree_class is None
    assert not f.cat_mask.any() and (f.n_nodes <= 511).all()
    leaves = f.left_child < 0
    live = np.arange(f.max_nodes)[None, :] < f.n_nodes[:, None]
    assert (f.leaf_value[leaves & live, 0] >= 0).all()


def test_label_is_optional_and_never_a_feature(anomaly_data):
    unlabeled = {k: v for k, v in anomaly_data.items() if k != "anomaly"}
    m = IsolationForestLearner(num_trees=3, device="cpu").train(unlabeled)
    want = RefIsolation(num_trees=3).train(unlabeled)
    assert_same_forest(m.forest, want.forest)
    lab = IsolationForestLearner(label="anomaly", num_trees=3,
                                 device="cpu").train(anomaly_data)
    assert "anomaly" not in lab.features
    with pytest.raises(YdfError, match="ANOMALY"):
        IsolationForestLearner(task=Task.REGRESSION)
    with pytest.raises(YdfError, match="at least one feature"):
        IsolationForestLearner(label="anomaly", device="cpu").train(
            {"anomaly": anomaly_data["anomaly"]})


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="a CUDA device is present: device=None trains on it")
def test_default_device_is_the_card(anomaly_data):
    with pytest.raises(YdfError, match="device='cpu'"):
        IsolationForestLearner(label="anomaly", num_trees=1).train(
            anomaly_data)


def test_registry_and_train_config_equal_reference():
    assert get_learner("ISOLATION_FOREST") is IsolationForestLearner
    ref = RefIsolation(label="anomaly", num_trees=9, seed=4)
    got = IsolationForestLearner(label="anomaly", num_trees=9, seed=4)
    assert got.train_config() == ref.train_config()
    again = make_learner(ref.train_config(), device="cpu")
    assert type(again) is IsolationForestLearner
    assert again.hparams == got.hparams


# ------------------------------------------------ guards, serving, I/O

@pytest.fixture(scope="module")
def tiny():
    da = tabular.planted_anomaly(n_inlier=120, n_anomaly=8, seed=13)
    kw = dict(label="anomaly", num_trees=4, seed=3)
    return (IsolationForestLearner(device="cpu", **kw).train(da),
            RefIsolation(**kw).train(da), da)


def test_guards_fail_fast_with_directions(tiny):
    model, _, _ = tiny
    with pytest.raises(YdfError, match="classification model"):
        model.predict_class(object())
    assert "Task: ANOMALY" in model.summary()


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
        "isolation", arrays, spec_to_dict(want.spec), want.features,
        task=want.task, c_psi=want.c_psi)
    assert type(got).__name__ == "IsolationForestModel"
    assert got.forest.tree_class is None and got.c_psi == want.c_psi
    np.testing.assert_array_equal(got.predict(data, device="cpu"),
                                  np.asarray(want.predict(data)))
    with pytest.raises(YdfError, match="c_psi"):
        convert.model_from_arrays("isolation", arrays, spec_to_dict(want.spec),
                                  want.features, task=want.task)


def test_save_load_round_trip(tiny, tmp_path):
    model, _, data = tiny
    ev = model.evaluate(data, device="cpu")
    model.save(str(tmp_path / "m"))
    back = Model.load(str(tmp_path / "m"))
    assert type(back).__name__ == "IsolationForestModel"
    assert back.task == Task.ANOMALY and back.c_psi == model.c_psi
    assert_same_forest(back.forest, model.forest)
    np.testing.assert_array_equal(back.predict(data, device="cpu"),
                                  model.predict(data, device="cpu"))
    assert back.evaluate(data, device="cpu").metrics == ev.metrics
    assert back.summary() == model.summary()
    assert (tmp_path / "m" / "evaluation.json").exists()


def test_chip_smoke_isolation_phase_on_the_cpu(monkeypatch):
    """``chip_smoke.run_isolation`` and ``check_variants`` rehearsed on the
    CPU at 3,120 rows: the requests equal ``predict_naive``, all rows the
    vectorized engine, the plain versions of B2 and B4 each other and
    ``predict_naive`` in both plan variants."""
    import chip_smoke
    monkeypatch.setattr(chip_smoke, "ANOMALY",
                        dict(n_inlier=3_000, n_anomaly=120, seed=13))
    model, X, run = chip_smoke.run_isolation(CPU, n_requests=5)
    assert run["auc"] >= 0.9 and run["card_equals_cpu"]
    assert (run["trees"], run["max_nodes"]) == (100, 513)
    v = chip_smoke.check_variants(model.forest, X, CPU)
    assert v["max_abs_err"] == 0.0
    assert set(v["variants"]["tiled"]) == {"staged", "global"}
