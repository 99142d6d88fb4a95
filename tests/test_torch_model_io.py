"""The port's model surface and model directory against the JAX package's.

Port-only scenarios (after ``tests/test_model_io.py`` and
``tests/test_train_checkpoint.py:350-412``), every learner on
``device="cpu"``:
  * save -> load -> predict over the same six learners: the loaded model
    holds no predictor until its first predict, and predicts
    ``array_equal`` with the model before the save;
  * the exact artefact file list (no pickle), with and without an
    evaluation;
  * every load error: missing, corrupt or keyless header, a future format,
    a header without ``forest.npz``, and a directory the JAX package saved;
  * ``predict_class`` checks the task before any inference;
  * templates through ``train_config``/``make_learner``;
  * the atomic save: a crash mid-write, a refused foreign directory, the
    overwrite of a model in place.

Parity: the same learner trained by both packages on the same data (the
port's CPU forests are bit-identical to the reference's):
  * ``variable_importances()`` and ``node_counts()`` equal exactly;
  * ``DataSpec.report()`` equal as a string, ``label_values`` equal;
  * ``evaluate()`` metrics within rtol 1e-9;
  * ``train_config()`` equal after a JSON round trip, and
    ``make_learner(reference_learner.train_config())`` gives equal hparams;
  * ``summary()`` equal line for line. No line is excepted:
    ``summarize_training_logs`` prints the learner, tree count, engine,
    fallback, resilience and profile, which the port's logs carry as the
    reference's do; the port's extras (``device``, ``device_impl``,
    ``histogram_backend``) are not printed;
  * a reference GBT and RF carried across by ``convert`` give the
    reference's importances in all four kinds, SUM_SCORE included.
"""
from __future__ import annotations

import json
import os

import numpy as np
import pytest

from repro.core import CartLearner as RefCart
from repro.core import GradientBoostedTreesLearner as RefGBT
from repro.core import RandomForestLearner as RefRF
from repro.core.api import Task as RefTask
from repro.core.dataspec import VerticalDataset as RefVerticalDataset
from repro.core.dataspec import label_values as ref_label_values
from repro.core.dataspec import spec_to_dict as ref_spec_to_dict
from repro.data.tabular import adult_like
from repro.obs.logs import summarize_training_logs as ref_summarize
from repro_torch import convert
from repro_torch.core import (
    CartLearner,
    GradientBoostedTreesLearner,
    Model,
    RandomForestLearner,
    Task,
    YdfError,
    get_learner,
    list_learners,
    make_learner,
)
from repro_torch.core.dataspec import (
    dataset_from_raw,
    label_values,
    spec_to_dict,
)
from repro_torch.core.evaluation import Evaluation
from repro_torch.core.tree import empty_forest
from repro_torch.obs.logs import summarize_training_logs

FOREST_KEYS = ("feature", "threshold", "split_bin", "cat_mask", "left_child",
               "leaf_value", "n_nodes", "split_gain")

LEARNERS = [
    ("rf_cls", "rf", Task.CLASSIFICATION,
     dict(num_trees=4, max_depth=4, compute_oob=False)),
    ("rf_reg", "rf", Task.REGRESSION,
     dict(num_trees=4, max_depth=4, compute_oob=False)),
    ("gbt_cls", "gbt", Task.CLASSIFICATION, dict(num_trees=4, max_depth=3)),
    ("gbt_reg", "gbt", Task.REGRESSION, dict(num_trees=4, max_depth=3)),
    ("cart_cls", "cart", Task.CLASSIFICATION, dict(max_depth=4)),
    ("cart_reg", "cart", Task.REGRESSION, dict(max_depth=4)),
]
IDS = [name for name, *_ in LEARNERS]
PORT = {"gbt": GradientBoostedTreesLearner, "rf": RandomForestLearner,
        "cart": CartLearner}
REF = {"gbt": RefGBT, "rf": RefRF, "cart": RefCart}


@pytest.fixture(scope="module")
def cls_data():
    return adult_like(400, seed=3)


@pytest.fixture(scope="module")
def reg_data(cls_data):
    data = dict(cls_data)
    rng = np.random.default_rng(5)
    data["target"] = rng.normal(size=len(data["age"])).astype(object)
    return data


def _data(task, cls_data, reg_data):
    if task == Task.CLASSIFICATION:
        return cls_data, "income"
    return reg_data, "target"


def _port(kind, task, label, **hp):
    return PORT[kind](label=label, task=task, device="cpu", **hp)


@pytest.fixture(scope="module")
def trained(cls_data, reg_data):
    """Each learner of LEARNERS trained once by both packages:
    name -> (port model, reference model, data)."""
    out = {}
    for name, kind, task, hp in LEARNERS:
        data, label = _data(task, cls_data, reg_data)
        got = _port(kind, task, label, **hp).train(data)
        ref = REF[kind](label=label, task=RefTask(task.value), **hp).train(data)
        out[name] = (got, ref, data)
    return out


# ------------------------------------------------------------- round trip

@pytest.mark.parametrize("name", IDS)
def test_save_load_predict_roundtrip_matrix(tmp_path, trained, name):
    model, _, data = trained[name]
    before = model.predict(data, device="cpu")
    path = str(tmp_path / name)
    model.save(path)
    loaded = Model.load(path)
    assert type(loaded) is type(model)
    # predictors are runtime artifacts: the load starts cold and recompiles
    assert loaded._predictors == {}
    after = loaded.predict(data, device="cpu")
    assert loaded._predictors
    np.testing.assert_array_equal(before, after)
    for k in FOREST_KEYS + ("tree_class", "init_pred"):
        np.testing.assert_array_equal(getattr(loaded.forest, k),
                                      getattr(model.forest, k), err_msg=k)
    assert loaded.forest.depth == model.forest.depth
    assert loaded.forest.feature_names == model.forest.feature_names
    assert (loaded.label, loaded.features, loaded.classes) == \
        (model.label, model.features, model.classes)
    assert loaded.training_logs == json.loads(json.dumps(model.training_logs))
    assert loaded.summary() == model.summary()
    assert loaded.variable_importances() == model.variable_importances()


def test_save_writes_inspectable_artifacts(tmp_path, cls_data):
    from repro_torch.core.dataspec import spec_from_dict
    model = CartLearner(label="income", max_depth=3,
                        device="cpu").train(cls_data)
    path = str(tmp_path / "m")
    model.save(path)
    assert sorted(os.listdir(path)) == ["dataspec.json", "forest.npz",
                                        "header.json", "model.json",
                                        "summary.txt"]
    assert json.load(open(os.path.join(path, "header.json"))) == \
        {"format_version": 1, "class": "CartModel"}
    text = open(os.path.join(path, "summary.txt")).read()
    assert "CartModel" in text and '"income"' in text
    with open(os.path.join(path, "dataspec.json")) as f:
        spec = spec_from_dict(json.load(f))
    assert set(spec.columns) == set(model.spec.columns)
    assert spec["income"].vocab == model.spec["income"].vocab
    with np.load(os.path.join(path, "forest.npz"), allow_pickle=False) as z:
        assert sorted(z.files) == sorted(
            FOREST_KEYS + ("tree_class", "init_pred"))
    ev = model.evaluate(cls_data, device="cpu")
    model.save(path)
    assert sorted(os.listdir(path)) == ["dataspec.json", "evaluation.json",
                                        "evaluation.txt", "forest.npz",
                                        "header.json", "model.json",
                                        "summary.txt"]
    assert json.load(open(os.path.join(path, "evaluation.json"))) == \
        json.loads(json.dumps(ev.to_dict()))


def test_self_evaluation_and_bag_info_survive_the_round_trip(tmp_path,
                                                            cls_data):
    model = RandomForestLearner(label="income", num_trees=3, max_depth=4,
                                device="cpu").train(cls_data)
    model.save(str(tmp_path / "rf"))
    loaded = Model.load(str(tmp_path / "rf"))
    assert loaded.bag_info == model.bag_info
    assert loaded.winner_take_all == model.winner_take_all
    a, b = loaded.self_evaluation, model.self_evaluation
    assert (a.task, a.n_examples, a.source, a.classes) == \
        (b.task, b.n_examples, b.source, b.classes)
    assert a.metrics == b.metrics
    np.testing.assert_array_equal(a.confusion, b.confusion)


# ------------------------------------------------------------- load errors

def test_load_errors(tmp_path, cls_data):
    with pytest.raises(YdfError, match="missing 'header.json'"):
        Model.load(str(tmp_path / "nowhere"))
    cases = {"bad": ("{not json", "corrupt"),
             "keyless": ('{"class": "X"}', "format_version"),
             "future": ('{"format_version": 2, "class": "CartModel"}',
                        "format v2"),
             "noforest": ('{"format_version": 1}', "forest.npz")}
    for name, (header, match) in cases.items():
        d = tmp_path / name
        d.mkdir()
        (d / "header.json").write_text(header)
        with pytest.raises(YdfError, match=match):
            Model.load(str(d))


def test_jax_saved_directory_is_refused_without_unpickling(tmp_path,
                                                           cls_data,
                                                           monkeypatch):
    ref = RefCart(label="income", max_depth=3).train(cls_data)
    path = str(tmp_path / "jax_model")
    ref.save(path)
    assert "model.pkl" in os.listdir(path)
    import pickle

    def refuse(*a, **k):
        raise AssertionError("the port unpickled a file")
    monkeypatch.setattr(pickle, "load", refuse)
    monkeypatch.setattr(pickle, "loads", refuse)
    with pytest.raises(YdfError, match="model_from_arrays"):
        Model.load(path)


def test_predict_class_checks_task_before_predicting(trained):
    model, _, data = trained["cart_reg"]
    calls = []
    original = type(model).predict

    def spy(self, dataset, **kw):
        calls.append(1)
        return original(self, dataset, **kw)

    type(model).predict = spy
    try:
        with pytest.raises(YdfError, match="classification"):
            model.predict_class(data, device="cpu")
    finally:
        type(model).predict = original
    assert not calls  # the task check must fire BEFORE any inference


def test_predict_class_equals_reference(trained):
    got, ref, data = trained["gbt_cls"]
    np.testing.assert_array_equal(got.predict_class(data, device="cpu"),
                                  ref.predict_class(data))


# ------------------------------------------------------------- templates

def test_template_applies_before_explicit_overrides():
    l = GradientBoostedTreesLearner(label="y", template="benchmark_rank1",
                                    split_axis="AXIS_ALIGNED", num_trees=7)
    assert l.hparams.growing_strategy == "BEST_FIRST_GLOBAL"
    assert l.hparams.split_axis == "AXIS_ALIGNED"
    assert l.hparams.num_trees == 7
    assert l.template == "benchmark_rank1"


def test_template_round_trips_through_train_config():
    l = RandomForestLearner(label="y", template="benchmark_rank1",
                            num_trees=9)
    cfg = l.train_config()
    assert cfg["template"] == "benchmark_rank1"
    l2 = make_learner(cfg)
    assert l2.hparams == l.hparams
    assert l2.template == l.template
    l3 = RandomForestLearner(label="y", num_trees=9)
    cfg3 = l3.train_config()
    assert "template" not in cfg3
    assert make_learner(cfg3).hparams == l3.hparams


def test_unknown_template_raises():
    with pytest.raises(YdfError, match="Unknown hyper-parameter template"):
        CartLearner(label="y", template="benchmark_rank1")


# ------------------------------------------------------------- registry

def test_registry_lists_the_ported_learners():
    assert list_learners() == ["CALIBRATOR", "CART", "ENSEMBLER",
                               "FEATURE_SELECTOR", "GRADIENT_BOOSTED_TREES",
                               "HYPERPARAMETER_TUNER", "ISOLATION_FOREST",
                               "LINEAR", "RANDOM_FOREST", "UPLIFT_TREES"]
    assert get_learner("CART") is CartLearner
    with pytest.raises(YdfError, match="Unknown learner"):
        get_learner("NO_SUCH_LEARNER")


# The A4, A6 and A8 ids are those of the cases when those learners were not
# ported and raised; they now resolve to the port's learners.
@pytest.mark.parametrize("name,item", [
    pytest.param("UPLIFT_TREES", None, id="UPLIFT_TREES-A4"),
    pytest.param("ISOLATION_FOREST", None, id="ISOLATION_FOREST-A4"),
    pytest.param("LINEAR", None, id="LINEAR-A8"),
    pytest.param("HYPERPARAMETER_TUNER", None, id="HYPERPARAMETER_TUNER-A6"),
    pytest.param("ENSEMBLER", None, id="ENSEMBLER-A6"),
    pytest.param("CALIBRATOR", None, id="CALIBRATOR-A6"),
    pytest.param("FEATURE_SELECTOR", None, id="FEATURE_SELECTOR-A6")])
def test_reference_learners_not_ported_name_their_roadmap_item(name, item):
    from repro.core.api import get_learner as ref_get
    from repro.core.api import list_learners as ref_list
    assert name in ref_list()
    if item is None:
        cls = get_learner(name)
        assert cls._registry_name == name
        assert cls.__name__ == ref_get(name).__name__
        return
    with pytest.raises(YdfError, match=f"ROADMAP {item}"):
        get_learner(name)


@pytest.mark.parametrize("name", IDS)
def test_train_config_equals_reference(trained, name):
    kind, task, hp = dict((n, (k, t, h)) for n, k, t, h in LEARNERS)[name]
    label = "income" if task == Task.CLASSIFICATION else "target"
    port = _port(kind, task, label, **hp)
    ref = REF[kind](label=label, task=RefTask(task.value), **hp)
    got = json.loads(json.dumps(port.train_config()))
    assert got == json.loads(json.dumps(ref.train_config()))
    assert "device" not in got
    again = make_learner(ref.train_config(), device="cpu")
    assert type(again) is type(port)
    assert again.hparams == port.hparams and again.device == "cpu"
    assert (again.label, again.task, again.seed) == \
        (port.label, port.task, port.seed)


# ------------------------------------------------------------- parity

@pytest.mark.parametrize("name", IDS)
def test_importances_and_node_counts_equal_reference(trained, name):
    got, ref, _ = trained[name]
    for k in FOREST_KEYS:
        np.testing.assert_array_equal(getattr(got.forest, k),
                                      getattr(ref.forest, k), err_msg=k)
    assert got.forest.node_counts() == ref.forest.node_counts()
    assert got.variable_importances() == ref.variable_importances()


@pytest.mark.parametrize("name", IDS)
def test_summary_equals_reference_line_for_line(trained, name):
    got, ref, _ = trained[name]
    assert got.summary().splitlines() == ref.summary().splitlines()


@pytest.mark.parametrize("name", IDS)
def test_evaluate_equals_reference(trained, name):
    got, ref, data = trained[name]
    a, b = got.evaluate(data, device="cpu"), ref.evaluate(data)
    assert (a.task.value, a.n_examples, a.source) == \
        (b.task.value, b.n_examples, b.source)
    assert set(a.metrics) == set(b.metrics)
    for k, v in b.metrics.items():
        np.testing.assert_allclose(a.metrics[k], v, rtol=1e-9, err_msg=k)
    if b.confusion is not None:
        np.testing.assert_array_equal(a.confusion, b.confusion)
    assert a.report() == b.report()


def test_predict_scores_equals_reference(trained):
    got, ref, data = trained["gbt_cls"]
    np.testing.assert_allclose(got.predict_scores(data, device="cpu"),
                               ref.predict_scores(data), rtol=1e-6)
    assert got.predict_scores(data, device="cpu").shape == (len(data["age"]), 1)


def test_dataspec_report_subset_and_label_values_equal_reference(trained):
    got, ref, data = trained["gbt_cls"]
    assert got.spec.report() == ref.spec.report()
    assert json.loads(json.dumps(spec_to_dict(got.spec))) == \
        json.loads(json.dumps(ref_spec_to_dict(ref.spec)))
    np.testing.assert_array_equal(label_values(got, data),
                                  ref_label_values(ref, data))
    vds = dataset_from_raw(data)
    from repro.core.dataspec import dataset_from_raw as ref_from_raw
    rvds = ref_from_raw(data)
    assert isinstance(rvds, RefVerticalDataset)
    np.testing.assert_array_equal(label_values(got, vds),
                                  ref_label_values(ref, rvds))
    idx = np.array([5, 1, 77, 3])
    sub, rsub = vds.subset(idx), rvds.subset(idx)
    assert sub.n_rows == rsub.n_rows == 4
    for k in rsub.numerical:
        np.testing.assert_array_equal(sub.numerical[k], rsub.numerical[k])
    for k in rsub.categorical:
        np.testing.assert_array_equal(sub.categorical[k], rsub.categorical[k])
    greg, rreg, rdata = trained["gbt_reg"]
    np.testing.assert_array_equal(label_values(greg, rdata),
                                  ref_label_values(rreg, rdata))


@pytest.mark.parametrize("logs", [
    None, {}, {"old": 1},
    {"schema_version": 1, "learner": "gbt", "num_trees": 3,
     "growth_engine": "batched", "engine_fallback": "device",
     "resilience": [{"event": "resume"}], "interrupted": True,
     "profile": {"phases": {"a": {"total_s": 0.5, "count": 2},
                            "b": {"total_s": 1.5, "count": 1}}}},
], ids=["none", "empty", "legacy", "full"])
def test_summarize_training_logs_equals_reference(logs):
    assert summarize_training_logs(logs) == ref_summarize(logs)


def test_convert_carries_split_gain_and_importances(trained):
    """The reference's GBT and RF carried across keep split_bin and
    split_gain, so all four importance kinds equal the reference's."""
    for name in ("gbt_cls", "rf_reg"):
        _, ref, data = trained[name]
        f = ref.forest
        arrays = {k: getattr(f, k) for k in (
            "feature", "threshold", "cat_mask", "left_child", "leaf_value",
            "n_nodes", "depth", "tree_class", "init_pred", "out_dim",
            "split_bin", "split_gain")}
        model = convert.model_from_arrays(
            "gbt" if name.startswith("gbt") else "rf", arrays,
            ref_spec_to_dict(ref.spec), ref.features,
            task=ref.task, classes=ref.classes)
        vi = model.variable_importances()
        assert set(vi) == {"NUM_NODES", "NUM_AS_ROOT", "SUM_SCORE",
                           "INV_MEAN_MIN_DEPTH"}
        assert vi == ref.variable_importances()
        np.testing.assert_array_equal(model.forest.split_gain, f.split_gain)
        np.testing.assert_array_equal(model.forest.split_bin, f.split_bin)


# ------------------------------------------------------------- not ported

def test_surfaces_of_later_items_raise_naming_them(trained):
    model, ref, data = trained["gbt_cls"]
    # A6 is ported: the surfaces that raised naming it give the reference's
    # answers (held in full in tests/test_torch_py_tree.py and
    # tests/test_torch_analysis.py)
    assert model.summary(verbose=True) == ref.summary(verbose=True)
    assert model.inspect().tree_stats() == ref.inspect().tree_stats()
    assert model.analyze(data, permutation_repetitions=1, sample_rows=16,
                         grid_size=3, device="cpu").to_dict() == \
        ref.analyze(data, permutation_repetitions=1, sample_rows=16,
                    grid_size=3).to_dict()
    # A3 is ported: an oblique node without oblique tables counts toward
    # nothing, as in the reference
    f = empty_forest(1, 3, 1, feature_names=["a"])
    f.feature[0, 0], f.left_child[0, 0] = -2, 1
    assert f.variable_importances()["NUM_NODES"] == {"a": 0.0}
    # A4 is ported: ranking and uplift evaluation are held to the
    # reference in tests/test_torch_ranking.py and tests/test_torch_uplift.py


def test_compile_returns_the_engine_and_recompiles(trained):
    model, _, data = trained["rf_cls"]
    eng = model.compile("vectorized", device="cpu")
    assert eng.name == "vectorized"
    p = model.predictor("vectorized", device="cpu")
    assert p.engine is eng
    assert model.compile("vectorized", device="cpu") is not eng
    np.testing.assert_array_equal(model.predict(data, engine="vectorized",
                                                device="cpu"),
                                  model.predict(data, device="cpu"))


def test_evaluation_from_dict_inverts_to_dict(trained):
    got, _, data = trained["gbt_cls"]
    ev = got.evaluate(data, device="cpu")
    back = Evaluation.from_dict(json.loads(json.dumps(ev.to_dict())))
    assert back.metrics == ev.metrics and back.report() == ev.report()


# ------------------------------------------------------------- atomic save

def _gbt(data, **over):
    kw = dict(label="income", seed=11, max_depth=3, num_trees=6)
    kw.update(over)
    return GradientBoostedTreesLearner(device="cpu", **kw).train(data)


def test_model_save_is_atomic_under_mid_write_crash(tmp_path, monkeypatch,
                                                    cls_data):
    m1 = _gbt(cls_data)
    m2 = _gbt(cls_data, num_trees=3)
    target = str(tmp_path / "model")
    m1.save(target)
    orig = Model._write_model_dir

    def crash_mid_write(self, path):
        orig(self, path)
        os.remove(os.path.join(path, "forest.npz"))  # torn state in the tmp
        raise RuntimeError("simulated crash mid-save")

    monkeypatch.setattr(Model, "_write_model_dir", crash_mid_write)
    with pytest.raises(RuntimeError):
        m2.save(target)
    monkeypatch.undo()
    # the target still holds the COMPLETE previous model, and no tmp junk
    loaded = Model.load(target)
    assert loaded.forest.n_trees == m1.forest.n_trees
    assert not [n for n in os.listdir(tmp_path) if ".tmp-" in n]


def test_model_save_refuses_to_clobber_foreign_directory(tmp_path, cls_data):
    m = _gbt(cls_data, num_trees=2)
    victim = tmp_path / "precious"
    victim.mkdir()
    (victim / "thesis.txt").write_text("years of work")
    with pytest.raises(YdfError, match="Refusing to overwrite"):
        m.save(str(victim))
    assert (victim / "thesis.txt").read_text() == "years of work"


def test_model_save_overwrites_previous_model_in_place(tmp_path, cls_data):
    m1 = _gbt(cls_data, num_trees=2)
    m2 = _gbt(cls_data)
    target = str(tmp_path / "model")
    m1.save(target)
    m2.save(target)                        # replacing a model dir is allowed
    assert Model.load(target).forest.n_trees == m2.forest.n_trees
    assert not [n for n in os.listdir(tmp_path) if ".old-" in n]
