"""The port's Random Forest against the JAX package's.

Both learners train on the same raw columns with the same seed; the port
runs on ``device="cpu"``, where ``histogram_backend="auto"`` is numpy, so
the batched engine grows each block of ``tree_parallelism`` trees in
lockstep (one gathered bincount over every tree's sampled columns per
level), as the reference does on a host without a TPU. Tolerances:
  * the port's forest against the reference's (batched or oracle, SQRT
    keyed sampling, classification and regression, best-first and ONE_HOT):
    bit-identical on every forest field (``split_gain`` included), the
    reference's own contract between its engines
    (tests/test_grower_batched.py:63,77);
  * any ``tree_parallelism`` against the port's oracle: bit-identical
    (tests/test_grower_device.py:150);
  * the out-of-bag ``self_evaluation``, its training_logs entry and
    ``bag_info``: equal;
  * ``best_splits_gathered`` against the reference's on random gathered
    histograms: every Split field and the gain equal.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import pytest

from repro.core import RandomForestLearner as RefRF
from repro.core.api import Task as RefTask
from repro.core.binning import bin_features
from repro.core.dataspec import dataset_from_raw
from repro.core.splitters import SplitterParams as RefSplitterParams
from repro.core.splitters import best_splits_gathered as ref_gathered
from repro.data.tabular import SUITE, adult_like, make_dataset, train_test_split
from repro_torch import convert
from repro_torch.core import Task, YdfError
from repro_torch.core.api import _LEARNERS
from repro_torch.core.rf import RandomForestLearner
from repro_torch.core.splitters import SplitterParams, best_splits_gathered

FOREST_KEYS = ("feature", "threshold", "split_bin", "cat_mask", "left_child",
               "leaf_value", "n_nodes", "split_gain")


def assert_identical(a, b, msg=""):
    for k in FOREST_KEYS:
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k),
                                      err_msg=f"{msg}: forest.{k}")
    assert a.depth == b.depth, msg


@pytest.fixture(scope="module")
def adult():
    return train_test_split(adult_like(900), 0.3, 1)[0]


@pytest.fixture(scope="module")
def regression():
    return train_test_split(make_dataset(SUITE[7]), 0.3, SUITE[7].seed)[0]


@pytest.mark.parametrize("hp", [
    dict(num_trees=4, max_depth=10),                        # sqrt, keyed
    dict(num_trees=4, max_depth=10, growth_engine="oracle"),
    dict(num_trees=3, growing_strategy="BEST_FIRST_GLOBAL",
         max_num_nodes=128),
    dict(num_trees=3, max_depth=6, categorical_algorithm="ONE_HOT",
         num_candidate_attributes="ALL"),
    dict(num_trees=5, max_depth=7, bootstrap=False, compute_oob=False),
], ids=["sqrt", "oracle", "best_first", "one_hot_all", "no_bootstrap"])
def test_classification_equals_reference(adult, hp):
    ref = RefRF(label="income", **hp).train(adult)
    got = RandomForestLearner(label="income", device="cpu", **hp).train(adult)
    assert got.training_logs["growth_engine"] == ref.training_logs["growth_engine"]
    assert_identical(got.forest, ref.forest, str(hp))


@pytest.mark.parametrize("engine", ["batched", "oracle"])
def test_regression_equals_reference(regression, engine):
    kw = dict(label="label", num_trees=4, max_depth=9, growth_engine=engine)
    ref = RefRF(task=RefTask.REGRESSION, **kw).train(regression)
    got = RandomForestLearner(task=Task.REGRESSION, device="cpu",
                              **kw).train(regression)
    assert_identical(got.forest, ref.forest, engine)
    assert got.self_evaluation.metrics == ref.self_evaluation.metrics


def test_multiclass_equals_reference():
    spec = SUITE[4]                                  # synth_vowel, 11 classes
    train = train_test_split(make_dataset(spec), 0.3, spec.seed)[0]
    kw = dict(label="label", num_trees=3, max_depth=6)
    ref = RefRF(**kw).train(train)
    got = RandomForestLearner(device="cpu", **kw).train(train)
    assert got.forest.leaf_value.shape[-1] == 11
    assert_identical(got.forest, ref.forest, "vowel")


@pytest.mark.parametrize("block", [1, 3, 8])
def test_tree_parallelism_is_execution_only(adult, block):
    """Any block size grows the port's oracle forest bit for bit, and the
    reference's at the same block size."""
    kw = dict(label="income", num_trees=7, max_depth=8, compute_oob=False)
    oracle = RandomForestLearner(**kw, growth_engine="oracle",
                                 device="cpu").train(adult)
    got = RandomForestLearner(**kw, tree_parallelism=block,
                              device="cpu").train(adult)
    assert got.training_logs["tree_parallelism"] == block
    assert_identical(got.forest, oracle.forest, f"block={block}")
    ref = RefRF(**kw, tree_parallelism=block).train(adult)
    assert_identical(got.forest, ref.forest, f"reference block={block}")


def test_out_of_bag_evaluation_and_bag_info_equal_reference(adult):
    kw = dict(label="income", num_trees=6, max_depth=8)
    ref = RefRF(**kw).train(adult)
    got = RandomForestLearner(device="cpu", **kw).train(adult)
    se, rse = got.self_evaluation, ref.self_evaluation
    assert se.source == rse.source == "out-of-bag"
    assert se.n_examples == rse.n_examples
    assert se.metrics == rse.metrics
    np.testing.assert_array_equal(se.confusion, rse.confusion)
    assert got.bag_info == ref.bag_info
    for key in ("learner", "num_trees", "growth_engine", "engine_fallback",
                "tree_parallelism", "oob"):
        assert got.training_logs[key] == ref.training_logs[key], key
    assert got.training_logs["histogram_backend"] == "numpy"
    assert got.training_logs["device"] == "cpu"


def test_no_out_of_bag_without_bootstrap(adult):
    got = RandomForestLearner(label="income", num_trees=2, bootstrap=False,
                              device="cpu").train(adult)
    assert got.self_evaluation is None and got.bag_info is None
    assert "oob" not in got.training_logs


def test_trained_forest_serves_as_the_reference_model(adult):
    """The slice as a whole: the same raw rows through the reference's
    model and the port's (its engines, the head included) give the same
    probabilities."""
    test = train_test_split(adult_like(900), 0.3, 1)[1]
    kw = dict(label="income", num_trees=5)
    ref = RefRF(**kw).train(adult)
    got = RandomForestLearner(device="cpu", **kw).train(adult)
    want = ref.predict(test)
    for engine in ("ref", "vectorized", "naive"):
        np.testing.assert_array_equal(
            got.predict(test, engine=engine, device="cpu"), want)


@pytest.mark.parametrize("task,kw", [
    ("CLASSIFICATION", dict(template="benchmark_rank1")),
    ("REGRESSION", dict(split_axis="SPARSE_OBLIQUE")),
], ids=["benchmark_rank1", "sparse_oblique_regression"])
def test_oblique_rf_equals_reference(adult, regression, task, kw):
    """Sparse-oblique Random Forests grow tree by tree (their projections
    draw from each tree's rng stream, so no lockstep block): every forest
    field, the oblique tables and the out-of-bag evaluation equal the
    reference's."""
    data, label = (adult, "income") if task == "CLASSIFICATION" \
        else (regression, "label")
    common = dict(label=label, num_trees=3, max_depth=8, **kw)
    ref = RefRF(task=RefTask(task), **common).train(data)
    got = RandomForestLearner(task=Task(task), device="cpu",
                              **common).train(data)
    assert got.forest.has_oblique()
    assert_identical(got.forest, ref.forest, str(kw))
    for k in ("obl_weights", "obl_features"):
        np.testing.assert_array_equal(getattr(got.forest, k),
                                      getattr(ref.forest, k), err_msg=k)
    assert got.self_evaluation.metrics == ref.self_evaluation.metrics
    assert got.training_logs["oob"] == ref.training_logs["oob"]


@pytest.mark.parametrize("kw", [
    dict(histogram_backend="cuda"),
])
def test_unported_or_wrong_device_options_raise(adult, kw):
    with pytest.raises(YdfError):
        RandomForestLearner(label="income", num_trees=1, device="cpu",
                            **kw).train(adult)


def test_checkpoint_raises(adult, tmp_path):
    # checkpoint= is ported (tests/test_torch_checkpoint.py): an argument
    # that is neither a directory nor a CheckpointPolicy raises, a
    # directory checkpoints at the block boundaries
    with pytest.raises(YdfError, match="checkpoint must be"):
        RandomForestLearner(label="income", num_trees=1, device="cpu").train(
            adult, checkpoint=3.5)
    model = RandomForestLearner(label="income", num_trees=1,
                                device="cpu").train(adult,
                                                    checkpoint=str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == ["ckpt-00000001"]
    assert not model.training_logs["interrupted"]


def test_learners_register_and_export():
    import repro_torch
    from repro_torch import core
    from repro_torch.core.cart import CartLearner
    assert _LEARNERS["RANDOM_FOREST"] is RandomForestLearner
    assert _LEARNERS["CART"] is CartLearner
    assert core.RandomForestLearner is repro_torch.RandomForestLearner \
        is RandomForestLearner
    assert core.CartLearner is repro_torch.CartLearner is CartLearner
    with pytest.raises(AttributeError):
        core.NoSuchLearner


# ------------------------------------------- the gathered scan (lockstep)

@pytest.fixture(scope="module")
def adult_binned():
    ds = dataset_from_raw(adult_like(500, seed=8))
    feats = [c for c in ds.spec.columns if c != "income"]
    ref = bin_features(ds, feats)
    port = convert.binned_from_arrays(ref.codes, ref.n_bins, ref.is_cat,
                                      ref.boundaries, ref.names)
    return ref, port


def _gathered_inputs(binned, kind, seed, n_nodes=9, kf=3):
    """Random integer-valued (n_nodes, kf, 256, S) histograms over per-node
    sorted column subsets, zero beyond each column's bins: integer counts
    make exact gain ties common. The last node has no rows at all."""
    rng = np.random.default_rng(seed)
    F = len(binned.n_bins)
    feat_sel = np.sort(np.stack([rng.choice(F, kf, replace=False)
                                 for _ in range(n_nodes)]), 1).astype(np.int32)
    S = 3
    hist = np.zeros((n_nodes, kf, 256, S), np.float32)
    for i in range(n_nodes - 1):
        for j in range(kf):
            nb = int(binned.n_bins[feat_sel[i, j]])
            cnt = rng.integers(0, 6, nb).astype(np.float32)
            if kind == "class":
                pos = rng.binomial(cnt.astype(np.int64), 0.4).astype(np.float32)
                hist[i, j, :nb] = np.stack([cnt - pos, pos, cnt], 1)
            else:
                y = rng.integers(-3, 4, nb).astype(np.float32)
                hist[i, j, :nb] = np.stack([y * cnt, y * y * cnt, cnt], 1)
    # a duplicated column: node 0's two first candidates hold the same
    # histogram, so they tie exactly and the lower column must win
    hist[0, 1] = hist[0, 0]
    return hist, feat_sel


@pytest.mark.parametrize("kind", ["class", "moment"])
@pytest.mark.parametrize("cat_alg", ["CART", "ONE_HOT"])
@pytest.mark.parametrize("seed", range(3))
def test_best_splits_gathered_equals_reference(adult_binned, kind, cat_alg,
                                               seed):
    ref_b, port_b = adult_binned
    hist, feat_sel = _gathered_inputs(ref_b, kind, seed)
    kw = dict(stat_kind=kind, min_examples=3, categorical_algorithm=cat_alg)
    want = ref_gathered(hist, feat_sel, ref_b, RefSplitterParams(**kw))
    got = best_splits_gathered(hist, feat_sel, port_b, SplitterParams(**kw))
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert (g.valid, g.gain, g.feature, g.split_bin, g.threshold) == \
            (w.valid, w.gain, w.feature, w.split_bin, w.threshold), i
        if w.cat_right is None:
            assert g.cat_right is None
        else:
            np.testing.assert_array_equal(g.cat_right, w.cat_right)
    assert not got[-1].valid                     # the node with no rows
    assert any(s.valid for s in got)


def test_best_splits_gathered_refuses_random(adult_binned):
    _, port_b = adult_binned
    hist, feat_sel = _gathered_inputs(port_b, "class", 0)
    with pytest.raises(YdfError, match="RANDOM"):
        best_splits_gathered(hist, feat_sel, port_b, SplitterParams(
            stat_kind="class", categorical_algorithm="RANDOM"))


def test_gathered_scan_equals_masked_full_scan(adult_binned):
    """The gathered scan picks what ``best_splits`` picks on the full
    histogram under the matching feature mask."""
    from repro_torch.core.splitters import best_splits
    _, port_b = adult_binned
    hist, feat_sel = _gathered_inputs(port_b, "class", 5)
    n, kf = feat_sel.shape
    F = len(port_b.n_bins)
    full = np.zeros((n, F, 256, 3), np.float32)
    for i in range(n):
        full[i, feat_sel[i]] = hist[i]
    mask = np.zeros((n, F), bool)
    np.put_along_axis(mask, feat_sel, True, axis=1)
    sp = SplitterParams(stat_kind="class", min_examples=3)
    got = best_splits_gathered(hist, feat_sel, port_b, sp)
    want = best_splits(full, port_b, sp, np.random.default_rng(0),
                       feature_mask=mask)
    for g, w in zip(got, want):
        assert (g.valid, g.gain, g.feature, g.split_bin) == \
            (w.valid, w.gain, w.feature, w.split_bin)


# --------------------------------- the chip smoke run's phases, rehearsed

def test_chip_smoke_forest_checks_on_the_cpu():
    """chip_smoke.py's card-against-CPU check of the Random Forest and of
    CART, with the CPU on both sides: every field equal, the CPU's forest
    grown in lockstep on the numpy backend."""
    import chip_smoke
    r = chip_smoke.compare_exact(chip_smoke.train_rf, "cpu", n_rows=1500,
                                 num_trees=3)
    assert (r["identical"], r["cpu_engine"], r["cpu_backend"]) == \
        (True, "batched", "numpy")
    r = chip_smoke.compare_exact(chip_smoke.train_cart, "cpu", n_rows=1500)
    assert r["identical"] and r["nodes"] > 3


def test_lockstep_grow_trees_uses_the_gathered_path(adult, monkeypatch):
    """On the CPU a block of trees takes the lockstep path (not tree by
    tree), and a block of one tree takes the per-tree path."""
    from repro_torch.core import grower
    calls = []
    real = grower._grow_level_wise_lockstep
    monkeypatch.setattr(grower, "_grow_level_wise_lockstep",
                        lambda *a, **k: calls.append(len(a[1])) or real(*a, **k))
    RandomForestLearner(label="income", num_trees=5, max_depth=4,
                        tree_parallelism=3, device="cpu").train(adult)
    assert calls == [3, 2]
    calls.clear()
    RandomForestLearner(label="income", num_trees=2, max_depth=4,
                        tree_parallelism=1, device="cpu").train(adult)
    assert calls == []
    # any backend but numpy (the CUDA kernel's, or its plain version here)
    # grows tree by tree
    keyed = dataclasses.replace(grower.GrowthParams(), device="cpu",
                                feature_sampling="keyed")
    assert grower._lockstep_ok(keyed, None)
    assert not grower._lockstep_ok(
        dataclasses.replace(keyed, histogram_backend="torch"), None)
