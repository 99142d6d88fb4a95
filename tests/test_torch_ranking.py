"""The port's LambdaMART ranking (``repro_torch.tasks.ranking`` and the
RANKING path of ``core/gbt.py``) against the JAX package's.

Every comparison feeds both packages the same inputs made from numpy
seeds. Tolerances:
  * the group layout, the lambda gradients and hessians (batched, and the
    per-group loop padded to a common width), ``ndcg_padded``, the
    group-aware split and the metrics (``ndcg_at_k``,
    ``evaluate_predictions``): exact (``np.array_equal`` / ``==``). The
    sweep is the one of tests/test_tasks.py:81-104, widened with size-1
    groups, all-equal relevance and k in {1, 5, 10};
  * the ranking GBT on the batched engine (``device="cpu"``, numpy
    histograms): every Forest field, the train/valid loss logs, the
    self-evaluation and the predictions exact;
  * the ranking GBT on the device engine: the tolerance of
    tests/test_torch_grower_device.py — the structure fields and the
    thresholds identical, leaf values within 1e-5 (float32 sums in another
    order), predictions within 1e-4 (as tests/test_torch_gbt.py);
  * LambdaMART's edge over pointwise regression: >= 0.03 NDCG@5, the
    reference's pin (tests/test_tasks.py:121).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.core import GradientBoostedTreesLearner as RefGBT
from repro.core.api import Task as RefTask
from repro.core.evaluation import evaluate_predictions as ref_evaluate
from repro.core.evaluation import ndcg_at_k as ref_ndcg_at_k
from repro.tasks import ranking as ref_ranking
from repro_torch import convert
from repro_torch.core import GradientBoostedTreesLearner, Model, Task, YdfError
from repro_torch.core.evaluation import evaluate_predictions, ndcg_at_k
from repro_torch.core.tree import predict_naive
from repro_torch.data import tabular
from repro_torch.serving.forest import make_forest_server
from repro_torch.tasks import ranking
from repro_torch.train.checkpoint import CheckpointPolicy, resume_training

pytestmark = pytest.mark.tasks

FOREST_FIELDS = ("feature", "threshold", "cat_mask", "left_child",
                 "leaf_value", "n_nodes", "split_bin", "split_gain",
                 "tree_class", "init_pred")
STRUCT = ("feature", "split_bin", "cat_mask", "left_child", "n_nodes")


def assert_same_forest(got, want, msg=""):
    for k in FOREST_FIELDS:
        a, b = getattr(got, k), getattr(want, k)
        assert (a is None) == (b is None), f"{msg}: forest.{k}"
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=f"{msg}: forest.{k}")
    assert (got.depth, got.out_dim) == (want.depth, want.out_dim), msg


# ------------------------------------------------------ the lambda pass

def _sweep(trial: int):
    """Trial ``trial`` of the seeded sweep of tests/test_tasks.py:81-104:
    ragged groups (size-1 groups among them), shuffled rows, scores and
    relevances, every 4th trial all tied."""
    rng = np.random.default_rng(0)
    for t in range(trial + 1):
        n_groups = int(rng.integers(2, 40))
        sizes = rng.integers(1, 24, n_groups)
        groups = np.repeat(np.arange(n_groups), sizes)
        rng.shuffle(groups)
        scores = rng.normal(size=len(groups)) * float(rng.integers(1, 10))
        rel = rng.integers(0, 5, len(groups)).astype(np.float64)
        if t % 4 == 0:
            rel[:] = 2.0
        k = int(rng.integers(1, 8))
    return groups, scores, rel, k


EDGE_SEEDS = {"all_size_1": 1, "all_equal": 2, "one_group": 3, "mixed": 4}


def _edge(name: str):
    """Shapes the sweep draws rarely: every group of size 1 (no pair at
    all), all-equal relevance in large groups, one large group, and
    size-1 groups mixed with large ones."""
    rng = np.random.default_rng(EDGE_SEEDS[name])
    if name == "all_size_1":
        groups = rng.permutation(17)
    elif name == "all_equal":
        groups = np.repeat(np.arange(5), 30)
    elif name == "one_group":
        groups = np.zeros(64, np.int64)
    else:                                   # mixed
        groups = np.r_[np.arange(10), np.repeat(np.arange(10, 13), 25)]
        rng.shuffle(groups)
    scores = rng.normal(size=len(groups)) * 3.0
    rel = (np.full(len(groups), 3.0) if name == "all_equal"
           else rng.integers(0, 5, len(groups)).astype(np.float64))
    return groups, scores, rel, 5


CASES = [f"trial{t}" for t in range(12)] + ["all_size_1", "all_equal",
                                            "one_group", "mixed"]


def _case(name):
    return _sweep(int(name[5:])) if name.startswith("trial") else _edge(name)


@pytest.mark.parametrize("k", [None, 1, 5, 10], ids=["k_sweep", "k1", "k5",
                                                    "k10"])
@pytest.mark.parametrize("name", CASES)
def test_lambda_pass_equals_reference_and_naive_loop(name, k):
    groups, scores, rel, k_sweep = _case(name)
    k = k_sweep if k is None else k
    lay, ref_lay = ranking.group_layout(groups), ref_ranking.group_layout(groups)
    for f in ("sizes", "pad_index", "pad_mask"):
        np.testing.assert_array_equal(getattr(lay, f), getattr(ref_lay, f))
    assert (lay.n_rows, lay.n_groups, lay.max_size) == \
        (ref_lay.n_rows, ref_lay.n_groups, ref_lay.max_size)
    gb, hb = ranking.lambda_grad_batched(scores, rel, lay, k=k)
    rgb, rhb = ref_ranking.lambda_grad_batched(scores, rel, ref_lay, k=k)
    assert np.array_equal(gb, rgb) and np.array_equal(hb, rhb)
    # the batched pass bit-equals the per-group loop at the padded width
    gn, hn = ranking.lambda_grad_naive(scores, rel, lay, k=k,
                                       pad_to=lay.max_size)
    rgn, rhn = ref_ranking.lambda_grad_naive(scores, rel, ref_lay, k=k,
                                             pad_to=ref_lay.max_size)
    assert np.array_equal(gn, rgn) and np.array_equal(hn, rhn)
    assert np.array_equal(gb, gn) and np.array_equal(hb, hn)
    # at each group's own width only the reduction shapes differ
    gs, hs = ranking.lambda_grad_naive(scores, rel, lay, k=k)
    np.testing.assert_allclose(gs, gb, rtol=0, atol=1e-12)
    np.testing.assert_allclose(hs, hb, rtol=0, atol=1e-12)
    if (rel == rel[0]).all():
        assert np.all(gb == 0.0) and np.all(hb == 0.0)
    S, R = lay.pad(scores), lay.pad(rel)
    assert ranking.ndcg_padded(S, R, lay.pad_mask, k) == \
        ref_ranking.ndcg_padded(S, R, ref_lay.pad_mask, k)
    # the loss's value and its guarded hessian
    loss = ranking.LambdaMARTLoss(rel, lay, k=k)
    ref_loss = ref_ranking.LambdaMARTLoss(rel, ref_lay, k=k)
    pred = scores[:, None]
    g, h = loss.grad_hess(pred, rel, None)
    rg, rh = ref_loss.grad_hess(pred, rel, None)
    assert np.array_equal(g, rg) and np.array_equal(h, rh)
    assert (h > 0).all()
    assert loss.value(pred, rel, None) == ref_loss.value(pred, rel, None)


def test_padded_idcg_sums_elementwise_products_in_row_order():
    """``_padded_idcg`` multiplies elementwise and sums the last axis, one
    row at a time in the same order whether one group or many are in
    flight; a matmul would not keep the batched/looped bits equal."""
    rng = np.random.default_rng(4)
    gains = np.power(2.0, rng.integers(0, 5, (30, 13)).astype(np.float64)) - 1
    valid = rng.random((30, 13)) < 0.8
    full = ranking._padded_idcg(gains, valid, 10)
    rows = np.array([ranking._padded_idcg(gains[i:i + 1], valid[i:i + 1], 10)[0]
                     for i in range(30)])
    assert np.array_equal(full, rows)
    assert np.array_equal(full, ref_ranking._padded_idcg(gains, valid, 10))


def test_group_layout_round_trip_and_empty():
    groups = np.array([3, 0, 3, 1, 0, 3], np.int64)
    layout = ranking.group_layout(groups)
    flat = np.arange(6, dtype=np.float64)
    assert np.array_equal(layout.unpad(layout.pad(flat)), flat)
    assert layout.n_groups == 3 and layout.max_size == 3
    empty = ranking.group_layout(np.zeros(0, np.int64))
    assert (empty.n_rows, empty.n_groups, empty.max_size) == (0, 0, 0)


@pytest.mark.parametrize("ratio,seed", [(0.25, 3), (0.1, 1234), (0.3, 99),
                                        (0.0, 5), (1.0, 5)])
def test_group_aware_split_equals_reference(ratio, seed):
    gid = np.repeat(np.arange(40), np.random.default_rng(seed).integers(1, 9, 40))
    np.random.default_rng(seed).shuffle(gid)
    tr, va = ranking.group_aware_split(gid, ratio, seed)
    rtr, rva = ref_ranking.group_aware_split(gid, ratio, seed)
    assert np.array_equal(tr, rtr) and np.array_equal(va, rva)
    assert len(np.intersect1d(gid[tr], gid[va])) == 0
    assert len(tr) + len(va) == len(gid)


# ------------------------------------------------------------ metrics

def test_ndcg_goldens():
    """tests/test_tasks.py:34-65, through the port."""
    y = np.array([3.0, 1.0, 0.0, 2.0])
    score = np.array([0.1, 0.4, 0.2, 0.3])
    want = (1.0 + 3.0 / np.log2(3)) / (7.0 + 3.0 / np.log2(3) + 0.5)
    assert ndcg_at_k(y, score, np.zeros(4, np.int64), k=3) == \
        pytest.approx(want, abs=1e-12)
    y2 = np.array([0.0, 2.0])
    tie = (3.0 / np.log2(3)) / 3.0
    assert ndcg_at_k(y2, np.array([0.5, 0.5]), np.zeros(2, np.int64),
                     k=2) == pytest.approx(tie, abs=1e-12)
    g2 = np.r_[0, 0, 1, 1].astype(np.int64)
    assert ndcg_at_k(np.r_[y2, 0.0, 0.0], np.array([0.5, 0.5, 1.0, 2.0]), g2,
                     k=2) == pytest.approx(tie / 2, abs=1e-12)


@pytest.mark.parametrize("seed", range(4))
def test_ranking_metrics_equal_reference(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(20, 300))
    groups = rng.integers(0, max(2, n // 8), n)
    y = rng.integers(0, 5, n).astype(np.float64)
    score = np.round(rng.normal(size=n), 1)        # ties included
    for k in (1, 3, 5, 10):
        assert ndcg_at_k(y, score, groups, k) == \
            ref_ndcg_at_k(y, score, groups, k)
    got = evaluate_predictions(Task.RANKING, score, y, groups=groups)
    want = ref_evaluate(RefTask.RANKING, score, y, groups=groups)
    assert got.metrics == want.metrics
    assert got.primary == want.primary == got.metrics["ndcg@5"]
    with pytest.raises(YdfError, match="groups="):
        evaluate_predictions(Task.RANKING, score, y)


# ------------------------------------------------------------ the GBT

@pytest.fixture(scope="module")
def ranking_data():
    return tabular.grouped_relevance(n_groups=60, seed=7)


def test_port_task_data_equal_reference():
    from repro.data import tabular as ref_tabular
    for name, kw in (("grouped_relevance", dict(n_groups=30, seed=7)),
                     ("randomized_treatment", dict(n=200, seed=11)),
                     ("planted_anomaly", dict(n_inlier=90, n_anomaly=9,
                                              seed=13))):
        got = getattr(tabular, name)(**kw)
        want = getattr(ref_tabular, name)(**kw)
        assert list(got) == list(want), name
        for c in got:
            assert np.array_equal(got[c].astype(float),
                                  want[c].astype(float)), (name, c)


@pytest.mark.parametrize("valid_mode", ["self_split", "external", "no_valid"])
def test_ranking_gbt_batched_equals_reference(ranking_data, valid_mode):
    kw = dict(label="rel", task=Task.RANKING, num_trees=12, seed=1)
    if valid_mode == "no_valid":
        kw.update(early_stopping="NONE")
    train, valid = ranking_data, None
    if valid_mode == "external":
        gid = np.asarray(ranking_data["group"], np.int64)
        tr, va = ranking.group_aware_split(gid, 0.25, 4)
        train = {k: v[tr] for k, v in ranking_data.items()}
        valid = {k: v[va] for k, v in ranking_data.items()}
    ref_kw = dict(kw, task=RefTask.RANKING)
    want = RefGBT(**ref_kw).train(train, valid=valid)
    got = GradientBoostedTreesLearner(device="cpu", **kw).train(
        train, valid=valid)
    assert_same_forest(got.forest, want.forest, valid_mode)
    logs, rlogs = got.training_logs, want.training_logs
    assert logs["growth_engine"] == rlogs["growth_engine"] == "batched"
    assert logs["train_loss"] == rlogs["train_loss"]
    assert logs["valid_loss"] == rlogs["valid_loss"]
    if valid_mode == "no_valid":
        assert got.self_evaluation is None and want.self_evaluation is None
    else:
        assert got.self_evaluation.metrics == want.self_evaluation.metrics
        assert got.self_evaluation.primary == want.self_evaluation.primary
    assert got.ranking_group == want.ranking_group == "group"
    assert got.loss.name == "LAMBDA_MART_NDCG"
    assert not hasattr(got.loss, "_layout_train")   # the stripped head
    data = ranking_data
    np.testing.assert_array_equal(got.predict(data, device="cpu"),
                                  np.asarray(want.predict(data)))
    for engine in ("vectorized", "naive", "ref"):
        np.testing.assert_array_equal(
            got.predict(data, engine=engine, device="cpu"),
            np.asarray(want.predict(data)), err_msg=engine)
    ev, rev = got.evaluate(data, device="cpu"), want.evaluate(data)
    assert ev.metrics == rev.metrics and ev.task == Task.RANKING


def _pairless(n_groups=40, seed=5):
    """grouped_relevance with every third group's relevance flattened: its
    rows have no pair, so their lambdas are 0 and their hessians the 1e-12
    guard."""
    d = tabular.grouped_relevance(n_groups=n_groups, seed=seed)
    gid = np.asarray(d["group"], np.int64)
    rel = np.asarray(d["rel"], np.float64)
    rel[gid % 3 == 0] = 1.0
    return dict(d, rel=rel.astype(object))


@pytest.mark.parametrize("data_fn", ["grouped", "pairless"])
def test_ranking_gbt_device_engine_within_reference_tolerance(data_fn):
    data = (tabular.grouped_relevance(n_groups=40, seed=7)
            if data_fn == "grouped" else _pairless())
    kw = dict(label="rel", num_trees=3, max_depth=4, seed=1,
              growth_engine="device", early_stopping="NONE")
    want = RefGBT(task=RefTask.RANKING, **kw).train(data)
    got = GradientBoostedTreesLearner(task=Task.RANKING, device="cpu",
                                      **kw).train(data)
    assert got.training_logs["growth_engine"] == "device"
    assert want.training_logs["growth_engine"] == "device"
    for k in STRUCT:
        np.testing.assert_array_equal(getattr(got.forest, k),
                                      getattr(want.forest, k),
                                      err_msg=f"forest.{k}")
    np.testing.assert_array_equal(got.forest.threshold, want.forest.threshold)
    np.testing.assert_allclose(got.forest.leaf_value, want.forest.leaf_value,
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.predict(data, device="cpu"),
                               np.asarray(want.predict(data)), atol=1e-4)
    np.testing.assert_allclose(got.training_logs["train_loss"],
                               want.training_logs["train_loss"], rtol=1e-6)


def test_pairless_leaves_are_zero_on_every_engine():
    """A node whose rows have no pair sums g = 0: its Newton leaf is 0 on
    the batched and the device engine alike, whatever the 1e-12 hessians
    sum to."""
    d = tabular.grouped_relevance(n_groups=20, seed=3)
    d = dict(d, rel=np.full(len(d["rel"]), 2.0).astype(object))
    for engine in ("batched", "device"):
        m = GradientBoostedTreesLearner(
            label="rel", task=Task.RANKING, num_trees=2, device="cpu",
            growth_engine=engine, early_stopping="NONE").train(d)
        assert np.all(m.forest.leaf_value == 0.0), engine
        assert np.all(m.forest.n_nodes == 1), engine


def test_lambdamart_beats_pointwise_regression_on_ndcg():
    """The port's copy of tests/test_tasks.py:121: >= 0.03 NDCG@5 over a
    pointwise-regression GBT on grouped-relevance data, on the CPU."""
    ds = tabular.grouped_relevance()
    gid = np.asarray([int(v) for v in ds["group"]], np.int64)
    y = np.array([float(v) for v in ds["rel"]])
    tr_idx, te_idx = ranking.group_aware_split(gid, 0.3, 99)
    tr = {k: v[tr_idx] for k, v in ds.items()}
    te = {k: v[te_idx] for k, v in ds.items()}
    g_te, y_te = gid[te_idx], y[te_idx]
    lm = GradientBoostedTreesLearner(label="rel", task=Task.RANKING,
                                     num_trees=80, seed=1,
                                     device="cpu").train(tr)
    nd_lm = ndcg_at_k(y_te, np.asarray(lm.predict(te, device="cpu")), g_te, 5)
    reg = GradientBoostedTreesLearner(
        label="rel", task=Task.REGRESSION, num_trees=80, seed=1,
        device="cpu").train({k: v for k, v in tr.items() if k != "group"})
    nd_reg = ndcg_at_k(y_te, np.asarray(reg.predict(te, device="cpu")), g_te, 5)
    assert nd_lm - nd_reg >= 0.03, (nd_lm, nd_reg)
    ev = lm.evaluate(te, device="cpu")
    assert ev.task == Task.RANKING
    assert ev.metrics["ndcg@5"] == pytest.approx(nd_lm, abs=1e-12)


# ------------------------------------------------ guards, serving, I/O

@pytest.fixture(scope="module")
def tiny():
    ds = tabular.grouped_relevance(n_groups=25, seed=7)
    kw = dict(label="rel", num_trees=4, seed=1)
    got = GradientBoostedTreesLearner(task=Task.RANKING, device="cpu",
                                      **kw).train(ds)
    want = RefGBT(task=RefTask.RANKING, **kw).train(ds)
    return got, want, ds


def test_guards_fail_fast_with_directions(tiny):
    model, _, data = tiny
    with pytest.raises(YdfError, match="classification model"):
        model.predict_class(object())
    assert "Task: RANKING" in model.summary()
    with pytest.raises(YdfError, match="group"):
        model.evaluate({k: v for k, v in data.items() if k != "group"},
                       device="cpu")


def test_ranking_train_requires_group_column():
    ds = tabular.grouped_relevance(n_groups=20, seed=7)
    ds.pop("group")
    with pytest.raises(YdfError, match="group/query column"):
        GradientBoostedTreesLearner(label="rel", task=Task.RANKING,
                                    num_trees=2, device="cpu").train(ds)
    # the external validation set must carry it too (it is encoded with the
    # training dataspec, which names it)
    ds = tabular.grouped_relevance(n_groups=20, seed=7)
    valid = {k: v for k, v in ds.items() if k != "group"}
    with pytest.raises(YdfError, match="'group'"):
        GradientBoostedTreesLearner(label="rel", task=Task.RANKING,
                                    num_trees=2, device="cpu").train(
            ds, valid=valid)


def test_gbt_rejects_uplift_and_anomaly_with_directions():
    ds = tabular.grouped_relevance(n_groups=15, seed=7)
    ds["treatment"] = (np.arange(len(ds["rel"])) % 2).astype(object)
    for task, learner_name in ((Task.UPLIFT, "UPLIFT_TREES"),
                               (Task.ANOMALY, "ISOLATION_FOREST")):
        with pytest.raises(YdfError, match=learner_name):
            GradientBoostedTreesLearner(label="rel", task=task, num_trees=2,
                                        device="cpu").train(ds)


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
    for loss in (None, "LAMBDA_MART_NDCG"):
        got = convert.model_from_arrays(
            "gbt", arrays, spec_to_dict(want.spec), want.features,
            task=want.task, loss=loss)
        assert got.task == Task.RANKING and got.loss.name == "LAMBDA_MART_NDCG"
        np.testing.assert_array_equal(got.predict(data, device="cpu"),
                                      np.asarray(want.predict(data)))


def test_save_load_round_trip(tiny, tmp_path):
    model, _, data = tiny
    model.save(str(tmp_path / "m"))
    back = Model.load(str(tmp_path / "m"))
    assert type(back).__name__ == "GradientBoostedTreesModel"
    assert back.task == Task.RANKING and back.ranking_group == "group"
    assert back.loss.name == "LAMBDA_MART_NDCG"
    assert_same_forest(back.forest, model.forest)
    np.testing.assert_array_equal(back.predict(data, device="cpu"),
                                  model.predict(data, device="cpu"))
    assert back.evaluate(data, device="cpu").metrics == \
        model.evaluate(data, device="cpu").metrics
    assert back.self_evaluation.metrics == model.self_evaluation.metrics
    assert back.summary() == model.summary()


def test_stopped_and_resumed_equals_uninterrupted(tmp_path):
    """A ranking GBT stopped after some trees and resumed through the
    checkpoint seam grows the uninterrupted run's forest: the loss is
    rebuilt from the same split and layouts on resume."""
    ds = tabular.grouped_relevance(n_groups=40, seed=7)
    kw = dict(label="rel", task=Task.RANKING, num_trees=8, seed=3,
              device="cpu")
    clean = GradientBoostedTreesLearner(**kw).train(ds)
    calls = {"n": 0}

    def cancel():
        calls["n"] += 1
        return calls["n"] >= 2

    ck = str(tmp_path / "ck")
    part = GradientBoostedTreesLearner(**kw).train(
        ds, checkpoint=CheckpointPolicy(ck, every_n_trees=2, cancel=cancel))
    assert part.training_logs["interrupted"]
    assert part.forest.n_trees < clean.forest.n_trees
    back = resume_training(ck, ds, device="cpu")
    assert_same_forest(back.forest, clean.forest)
    assert back.training_logs["valid_loss"] == clean.training_logs["valid_loss"]
    assert back.ranking_group == "group"
    np.testing.assert_array_equal(back.predict(ds, device="cpu"),
                                  clean.predict(ds, device="cpu"))


def test_chip_smoke_ranking_phase_on_the_cpu(monkeypatch):
    """``chip_smoke.run_ranking`` rehearsed on the CPU at 300 groups (the
    gates at 120 groups, 3 trees; profiling, which reads the card's
    profiler, stubbed): the plain versions stand in for the kernels, so no
    launch is counted, and every gate holds."""
    import chip_smoke
    from repro_torch.core.hist_backend import resolve_backend
    monkeypatch.setattr(chip_smoke, "RANKING_COMPARE_GROUPS", 120)
    monkeypatch.setattr(chip_smoke, "RANKING_COMPARE_TREES", 3)
    monkeypatch.setattr(chip_smoke, "profile_training", lambda *a, **k: {
        "phases": {"gbt/grad_hess": {"total_s": 1.0},
                   "gbt/tree": {"total_s": 4.0}}})
    cpu = torch.device("cpu")
    models, run = chip_smoke.run_ranking(cpu, resolve_backend("auto", cpu),
                                         n_groups=300)
    assert run["lambdamart_edge"] > 0
    assert run["device"]["level_steps"] > 0
    assert run["batched"]["profile"]["grad_hess_share_of_tree_spans"] == 0.25
    assert all(run["gates"]["batched"]["fields_equal"].values())
    assert run["gates"]["device_pairless"]["card_runs_identical"]
    assert run["gates"]["all_pairless_roots"]["leaf_values"] == [0.0] * 2
    served = chip_smoke.serve_tasks({"ranking": models["batched"]},
                                    {"ranking": chip_smoke.ranking_data(300)[1]},
                                    cpu)
    assert served["ranking"]["rows"] > 0


def test_fixed_point_histograms_move_only_split_gain(monkeypatch):
    """Why ``chip_smoke.equal_but_gain`` holds ``split_gain`` to
    GAIN_RTOL: with the histogram kernel's rounding emulated on the CPU
    (each stat quantized as ``grower_device.exact_sums`` does, at
    2^(62 - bits(N) - e) for max |v| < 2^e, summed, rounded to float32) the
    LambdaMART forest keeps every field but ``split_gain``, and the gains
    stay within GAIN_RTOL."""
    import chip_smoke
    from repro_torch.core import hist_backend
    train, _ = chip_smoke.ranking_data(300)
    exact = chip_smoke.train_ranking(train, "cpu", num_trees=6)
    build = hist_backend.NumpyHistogramBackend.build

    def fixed_point(self, codes, stats, node_of, n_nodes, max_bins=256):
        s = np.asarray(stats, np.float32).astype(np.float64)
        m = np.abs(s).max(0)
        e = np.frexp(np.where(m > 0, m, 1.0))[1]
        scale = 2.0 ** (62 - int(len(s)).bit_length() - e)
        out = build(self, codes, np.round(s * scale) / scale, node_of,
                    n_nodes, max_bins)
        return out.astype(np.float32).astype(np.float64)

    monkeypatch.setattr(hist_backend.NumpyHistogramBackend, "build",
                        fixed_point)
    rounded = chip_smoke.train_ranking(train, "cpu", num_trees=6)
    got = chip_smoke.equal_but_gain(rounded, exact)
    assert got["split_gain_max_rel_diff"] < chip_smoke.GAIN_RTOL
