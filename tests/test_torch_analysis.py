"""The port's model analysis (``repro_torch.analysis``) against the JAX
package's (``repro.analysis``), on the scenarios of ``tests/test_analysis.py``.

Both packages train the same learner on the same numpy-seeded data (their
CPU forests are bit-identical) and run the same analysis; the port on
``device="cpu"``, where its predictor is the plain PyTorch traversal whose
per-tree leaves equal the reference's numpy engines bit for bit, and the
aggregation, scoring and bootstrap are the same numpy code. So the
tolerance is none: ``AnalysisReport.to_dict()`` and ``report()`` are equal
as values and as text, for RF, GBT and CART on classification and
regression, and so are the permutation, out-of-bag and partial-dependence
results one by one (ICE and categorical grids included), with the
reference's refusals. The batched replicas equal a per-feature loop, and
the serving bundle's path equals the predictor's. Every entry point raises
``YdfError`` without a card unless given ``device="cpu"``.
"""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from repro import analysis as ref_analysis
from repro.core import CartLearner as RefCart
from repro.core import GradientBoostedTreesLearner as RefGBT
from repro.core import RandomForestLearner as RefRF
from repro.core.api import Task as RefTask
from repro.core.api import YdfError as RefYdfError
from repro_torch.analysis import (
    analyze_model,
    oob_permutation_importances,
    partial_dependence,
    permutation_importances,
    structural_importances,
)
from repro_torch.analysis.importance import DEFAULT_ROW_BUDGET, _permutation
from repro_torch.analysis.report import sparkline
from repro_torch.core import (
    CartLearner,
    GradientBoostedTreesLearner,
    RandomForestLearner,
    Task,
    YdfError,
)
from repro_torch.core.dataspec import label_values

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The CPU engines' small torch ops run on one thread: test workers
    share the host, and a thread pool per worker oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


LEARNERS = {
    "rf": (RandomForestLearner, RefRF,
           dict(num_trees=10, max_depth=8, num_candidate_attributes="ALL")),
    "gbt": (GradientBoostedTreesLearner, RefGBT,
            dict(num_trees=20, max_depth=4)),
    "cart": (CartLearner, RefCart, {}),
}


def planted_dataset(n=700, noise_feats=4, task="CLASSIFICATION", seed=0):
    """One informative feature (x0) and pure-noise features (the
    reference test's generator)."""
    rng = np.random.default_rng(seed)
    x0 = rng.normal(size=n)
    data = {"x0": x0.astype(object)}
    for j in range(noise_feats):
        data[f"noise{j}"] = rng.normal(size=n).astype(object)
    if task == "CLASSIFICATION":
        y = np.where(x0 + 0.2 * rng.normal(size=n) > 0, "pos", "neg")
        data["label"] = y.astype(object)
    else:
        data["label"] = (3.0 * x0 + 0.1 * rng.normal(size=n)).astype(object)
    return data


def train_both(kind: str, task: str, data: dict, **extra):
    port_cls, ref_cls, kw = LEARNERS[kind]
    kw = {**kw, **extra}
    return (port_cls(label="label", task=Task(task), device=CPU, **kw)
            .train(data),
            ref_cls(label="label", task=RefTask(task), **kw).train(data))


def jsonable(d: dict) -> dict:
    return json.loads(json.dumps(d))


@pytest.fixture(scope="module")
def planted():
    return {"CLASSIFICATION": planted_dataset(),
            "REGRESSION": planted_dataset(task="REGRESSION", seed=1)}


@pytest.fixture(scope="module")
def rf_cls(planted):
    return train_both("rf", "CLASSIFICATION", planted["CLASSIFICATION"])


# ------------------------------------------------------------ full reports

@pytest.mark.parametrize("kind", ["rf", "gbt", "cart"])
@pytest.mark.parametrize("task", ["CLASSIFICATION", "REGRESSION"])
def test_analysis_report_equals_reference(kind, task, planted):
    """``analyze()`` with a labelled dataset: structural, permutation (and
    OOB for the RF) importances, PDP curves and the evaluation; to_dict()
    and the report text equal the reference's."""
    data = planted[task]
    got, ref = train_both(kind, task, data)
    kw = dict(permutation_repetitions=2, sample_rows=64, grid_size=6)
    rep = got.analyze(data, device=CPU, **kw)
    want = ref.analyze(data, **kw)
    assert rep.to_dict() == want.to_dict()
    assert rep.report() == want.report()
    assert str(rep) == rep.report()
    # the planted signal leads every dataset-based table
    assert rep.importance(rep.importances[-1].kind).ranking()[0] == "x0"
    if kind == "rf":
        kinds = [t.kind for t in rep.importances]
        assert kinds[-1].startswith("OOB_") and any(
            "out-of-bag baseline" in n for n in rep.notes)
    payload = json.loads(json.dumps(rep.to_dict()))
    assert len(payload["partial_dependence"]) == len(got.features)


def test_structure_only_and_unlabelled_reports_equal_reference(rf_cls,
                                                               planted):
    got, ref = rf_cls
    assert got.analyze(device=CPU).to_dict() == ref.analyze().to_dict()
    feats_only = {k: v for k, v in planted["CLASSIFICATION"].items()
                  if k != "label"}
    rep = got.analyze(feats_only, sample_rows=32, device=CPU)
    want = ref.analyze(feats_only, sample_rows=32)
    assert rep.to_dict() == want.to_dict() and rep.report() == want.report()
    assert rep.evaluation is None
    assert all(t.source == "structure" for t in rep.importances)
    assert rep.pdp and any("label" in n for n in rep.notes)


def test_structural_importances_equal_reference(rf_cls):
    got, ref = rf_cls
    mine = [t.to_dict() for t in structural_importances(got)]
    theirs = [t.to_dict() for t in ref_analysis.structural_importances(ref)]
    assert mine == theirs


def test_structural_matches_inspector_oracle(rf_cls):
    """The SoA's structural pass against a traversal of the port's typed
    trees (the reference test's oracle)."""
    got, _ = rf_cls
    feats = got.features
    num_nodes = {f: 0.0 for f in feats}
    num_root = {f: 0.0 for f in feats}
    min_depth_sum = {f: 0.0 for f in feats}
    trees = got.inspect().trees()
    for tr in trees:
        tree_min = {}
        for node, d in tr.iter_nodes():
            if node.is_leaf:
                continue
            name = feats[node.condition.feature]
            num_nodes[name] += 1
            if d == 0:
                num_root[name] += 1
            tree_min[name] = min(tree_min.get(name, tr.depth), d)
        for f in feats:
            min_depth_sum[f] += tree_min.get(f, tr.depth)
    vi = got.variable_importances()
    assert vi["NUM_NODES"] == num_nodes
    assert vi["NUM_AS_ROOT"] == num_root
    for f in feats:
        inv = 1.0 / (1.0 + min_depth_sum[f] / len(trees))
        assert vi["INV_MEAN_MIN_DEPTH"][f] == pytest.approx(inv)


# ---------------------------------------------------- permutation importances

@pytest.mark.parametrize("row_budget", [DEFAULT_ROW_BUDGET, 1500])
def test_permutation_importances_equal_reference(rf_cls, planted,
                                                 row_budget):
    got, ref = rf_cls
    data = planted["CLASSIFICATION"]
    table, baseline = permutation_importances(got, data, repetitions=2,
                                              row_budget=row_budget,
                                              device=CPU)
    want, want_base = ref_analysis.permutation_importances(
        ref, data, repetitions=2, row_budget=row_budget)
    assert table.to_dict() == want.to_dict()
    assert table.report() == want.report()
    assert jsonable(baseline.to_dict()) == jsonable(want_base.to_dict())
    assert table.ranking()[0] == "x0"
    e = table.entries[0]
    assert e.importance > 0 and e.ci95[0] <= e.importance <= e.ci95[1]


def test_batched_replicas_equal_naive_per_feature_loop(rf_cls, planted):
    """The stacked-replica dispatch reproduces a loop that predicts one
    permuted copy at a time: same permutations, same engine, same scores."""
    model, _ = rf_cls
    data = planted["CLASSIFICATION"]
    reps = 2
    table, baseline = permutation_importances(model, data, repetitions=reps,
                                              row_budget=1500, device=CPU)
    pred = model.predictor(None, CPU)
    X = pred.encode(data)
    y = label_values(model, data)
    N = len(y)
    base_acc = float((np.asarray(pred.predict_encoded(X)).argmax(1) == y).mean())
    assert baseline["accuracy"] == pytest.approx(base_acc)
    for j, name in enumerate(model.features):
        drops = []
        for r in range(reps):
            Xp = X.copy()
            Xp[:, j] = X[_permutation(42, j, r, N), j]
            acc = float((np.asarray(pred.predict_encoded(Xp)).argmax(1)
                         == y).mean())
            drops.append(base_acc - acc)
        assert table[name] == pytest.approx(np.mean(drops), abs=1e-12), name


def test_permutation_through_serving_bundle(rf_cls, planted):
    from repro_torch.serving.forest import make_forest_server
    model, _ = rf_cls
    data = planted["CLASSIFICATION"]
    bundle = make_forest_server(model, buckets=(64, 256), device=CPU)
    direct, _ = permutation_importances(model, data, repetitions=1,
                                        device=CPU)
    via, _ = permutation_importances(model, data, repetitions=1,
                                     bundle=bundle, device=CPU)
    assert via.to_dict() == direct.to_dict()


def test_bundle_bulk_dispatch_matches_predictor(rf_cls, planted):
    from repro_torch.serving.forest import make_forest_server
    model, _ = rf_cls
    bundle = make_forest_server(model, buckets=(32, 128), device=CPU)
    pred = model.predictor(None, CPU)
    big = np.tile(pred.encode(planted["CLASSIFICATION"]), (3, 1))
    np.testing.assert_array_equal(bundle.predict_encoded_bulk(big),
                                  pred.predict_encoded(big))


@pytest.mark.parametrize("engine", ["vectorized", "bucketed", "naive"])
def test_permutation_is_engine_agnostic(rf_cls, planted, engine):
    """Importances are a model property: every CPU engine gives the
    default engine's table exactly."""
    model, _ = rf_cls
    data = planted["CLASSIFICATION"]
    want, _ = permutation_importances(model, data, repetitions=1, device=CPU)
    got, _ = permutation_importances(model, data, repetitions=1, device=CPU,
                                     engine=engine)
    assert got.to_dict() == want.to_dict()


# ------------------------------------------------------------ OOB importances

def test_oob_importances_equal_reference_and_self_evaluation(rf_cls,
                                                             planted):
    got, ref = rf_cls
    data = planted["CLASSIFICATION"]
    table, baseline = oob_permutation_importances(got, data, device=CPU)
    want, want_base = ref_analysis.oob_permutation_importances(ref, data)
    assert table.to_dict() == want.to_dict()
    assert jsonable(baseline.to_dict()) == jsonable(want_base.to_dict())
    se = got.self_evaluation
    assert se is not None and se.source == "out-of-bag"
    assert baseline.n_examples == se.n_examples
    assert baseline["accuracy"] == pytest.approx(se["accuracy"])
    assert table.ranking()[0] == "x0"


def test_oob_regression_equals_reference(planted):
    data = planted["REGRESSION"]
    kw = dict(num_trees=10, max_depth=8)
    got = RandomForestLearner(label="label", task=Task.REGRESSION,
                              device=CPU, **kw).train(data)
    ref = RefRF(label="label", task=RefTask.REGRESSION, **kw).train(data)
    table, baseline = oob_permutation_importances(got, data, repetitions=2,
                                                  device=CPU)
    want, _ = ref_analysis.oob_permutation_importances(ref, data,
                                                       repetitions=2)
    assert table.to_dict() == want.to_dict()
    assert table.ranking()[0] == "x0"
    assert baseline["rmse"] == pytest.approx(got.self_evaluation["rmse"])


def _refused(port_call, ref_call, match):
    with pytest.raises(RefYdfError, match=match) as ref_err:
        ref_call()
    with pytest.raises(YdfError, match=match) as err:
        port_call()
    assert str(err.value) == str(ref_err.value)


def test_oob_refusals_equal_reference(rf_cls, planted):
    got, ref = rf_cls
    data = planted["CLASSIFICATION"]
    small = {k: v[:100] for k, v in data.items()}
    _refused(lambda: oob_permutation_importances(got, small, device=CPU),
             lambda: ref_analysis.oob_permutation_importances(ref, small),
             "exact training dataset")
    other = planted_dataset(n=700, seed=77)
    _refused(lambda: oob_permutation_importances(got, other, device=CPU),
             lambda: ref_analysis.oob_permutation_importances(ref, other),
             "different content")
    rep = got.analyze(other, permutation_repetitions=1, sample_rows=32,
                      device=CPU)
    want = ref.analyze(other, permutation_repetitions=1, sample_rows=32)
    assert rep.to_dict() == want.to_dict()
    assert any("skipped" in n for n in rep.notes)
    _refused(lambda: got.analyze(oob=True, device=CPU),
             lambda: ref.analyze(oob=True), "oob=True")
    feats_only = {k: v for k, v in data.items() if k != "label"}
    _refused(lambda: got.analyze(feats_only, oob=True, device=CPU),
             lambda: ref.analyze(feats_only, oob=True), "absent")


def test_oob_requires_bag_info(planted):
    data = planted["CLASSIFICATION"]
    got = RandomForestLearner(label="label", num_trees=4, bootstrap=False,
                              device=CPU).train(data)
    ref = RefRF(label="label", num_trees=4, bootstrap=False).train(data)
    _refused(lambda: oob_permutation_importances(got, data, device=CPU),
             lambda: ref_analysis.oob_permutation_importances(ref, data),
             "bootstrap")


def test_analyze_forwards_repetitions_to_oob(rf_cls, planted):
    got, _ = rf_cls
    rep = got.analyze(planted["CLASSIFICATION"], permutation_repetitions=2,
                      sample_rows=32, grid_size=4, device=CPU)
    assert rep.importance("OOB_MEAN_DECREASE_ACCURACY").repetitions == 2


# --------------------------------------------------------- partial dependence

def test_pdp_monotone_target_equals_reference():
    rng = np.random.default_rng(3)
    n = 800
    x0 = rng.uniform(-2, 2, n)
    data = {"x0": x0.astype(object),
            "noise0": rng.normal(size=n).astype(object),
            "label": (2.0 * x0).astype(object)}
    kw = dict(num_trees=60)
    got = GradientBoostedTreesLearner(label="label", task=Task.REGRESSION,
                                      device=CPU, **kw).train(data)
    ref = RefGBT(label="label", task=RefTask.REGRESSION, **kw).train(data)
    [curve] = partial_dependence(got, data, features=["x0"], grid_size=12,
                                 device=CPU)
    [want] = ref_analysis.partial_dependence(ref, data, features=["x0"],
                                             grid_size=12)
    assert curve.to_dict() == want.to_dict()
    assert curve.report() == want.report()
    c = curve.curve()
    span = c.max() - c.min()
    assert c[-1] > c[0] and span > 1.0
    assert (np.diff(c) >= -0.02 * span).all()


def test_pdp_categorical_grid_equals_reference(tiny_adult):
    kw = dict(num_trees=5, max_depth=6)
    got = RandomForestLearner(label="income", device=CPU, **kw).train(tiny_adult)
    ref = RefRF(label="income", **kw).train(tiny_adult)
    [curve] = partial_dependence(got, tiny_adult, features=["workclass"],
                                 grid_size=8, sample_rows=50, device=CPU)
    [want] = ref_analysis.partial_dependence(
        ref, tiny_adult, features=["workclass"], grid_size=8, sample_rows=50)
    assert curve.to_dict() == want.to_dict()
    assert curve.report() == want.report()
    assert curve.semantic == "CATEGORICAL"
    assert curve.labels and all(l in got.spec["workclass"].vocab
                                for l in curve.labels)
    assert curve.mean.shape == (len(curve.grid), len(got.classes))
    assert curve.n_sample == 50


def test_pdp_ice_equals_reference(rf_cls, planted):
    got, ref = rf_cls
    data = planted["CLASSIFICATION"]
    [curve] = partial_dependence(got, data, features=["x0"], grid_size=6,
                                 sample_rows=40, ice=True, device=CPU)
    [want] = ref_analysis.partial_dependence(ref, data, features=["x0"],
                                             grid_size=6, sample_rows=40,
                                             ice=True)
    assert curve.to_dict() == want.to_dict()
    assert curve.ice.shape == (len(curve.grid), 40, 2)
    np.testing.assert_allclose(curve.ice.mean(axis=1), curve.mean)
    _refused(lambda: partial_dependence(got, data, features=["nope"],
                                        device=CPU),
             lambda: ref_analysis.partial_dependence(ref, data,
                                                     features=["nope"]),
             "not inputs")


def test_ranking_analysis_equals_reference():
    """The scalar-proxy permutation importance of a LambdaMART model
    (the reference's tasks scenario)."""
    from repro.data.tabular import grouped_relevance
    ds = grouped_relevance(n_groups=30, seed=3)
    got = GradientBoostedTreesLearner(label="rel", task=Task.RANKING,
                                      num_trees=4, seed=1,
                                      device=CPU).train(ds)
    ref = RefGBT(label="rel", task=RefTask.RANKING, num_trees=4,
                 seed=1).train(ds)
    rep = got.analyze(ds, permutation_repetitions=1, device=CPU)
    want = ref.analyze(ds, permutation_repetitions=1)
    assert rep.to_dict() == want.to_dict()
    assert "ndcg@5" in rep.evaluation.metrics
    assert "MEAN_INCREASE_RMSE" in {t.kind for t in rep.importances}


# ------------------------------------------------------------- the device

def test_every_entry_point_needs_a_card_unless_given_the_cpu(rf_cls,
                                                             planted):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without a card")
    got, _ = rf_cls
    data = planted["CLASSIFICATION"]
    for call in (lambda: got.analyze(data),
                 lambda: got.analyze(),
                 lambda: analyze_model(got, data),
                 lambda: permutation_importances(got, data),
                 lambda: oob_permutation_importances(got, data),
                 lambda: partial_dependence(got, data)):
        with pytest.raises(YdfError, match="device='cpu'"):
            call()


def test_sparkline_equals_reference():
    from repro.analysis.report import sparkline as ref_sparkline
    for v in ([0, 1], [1, 1, 1], [], np.arange(10), [3.0, np.nan, -1.0]):
        assert sparkline(v) == ref_sparkline(v)
    assert sparkline([0, 1]) == "▁█"
