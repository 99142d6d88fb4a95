"""The port's batched and oracle growth engines against the JAX package's.

Both learners train on the same raw columns with the same seed; the port
runs on ``device="cpu"``, where ``histogram_backend="auto"`` is numpy, as
it is for the reference on a host without a TPU. Tolerances:
  * the port's batched GBT against the reference's batched GBT, and against
    the port's oracle: bit-identical (every forest field, leaf values and
    thresholds included), the reference's own contract between its engines
    (tests/test_grower_batched.py);
  * the histogram kernel's plain version ("torch" backend, float32 sums
    of float64 accumulation) against the numpy backend: the same features
    and split bins, leaf values within atol 1e-5 (the reference's tolerance
    for its Pallas backend).
"""
from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import pytest

from repro.core import GradientBoostedTreesLearner as RefGBT
from repro.core.binning import bin_features
from repro.core.dataspec import dataset_from_raw
from repro.core.grower import GrowthParams as RefGrowthParams
from repro.core.grower import grow_trees as ref_grow_trees
from repro.core.grower import resolve_engine as ref_resolve_engine
from repro.core.splitters import SplitterParams as RefSplitterParams
from repro.core.tree import empty_forest as ref_empty_forest
from repro.data.tabular import SUITE, adult_like, make_dataset, train_test_split
from repro_torch import convert
from repro_torch.core import YdfError, grower
from repro_torch.core.gbt import GradientBoostedTreesLearner
from repro_torch.core.splitters import SplitterParams
from repro_torch.core.tree import empty_forest

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


@pytest.mark.parametrize("hp", [
    dict(),                                               # LOCAL, CART cats
    dict(growing_strategy="BEST_FIRST_GLOBAL"),           # subtraction trick
    dict(categorical_algorithm="ONE_HOT"),
    dict(subsample=0.7, use_hessian_gain=True),           # bagging + dup stats
    dict(categorical_algorithm="RANDOM", max_depth=8),    # rng drift
], ids=["local", "best_first", "one_hot", "subsample", "random_cats"])
def test_batched_gbt_equals_reference_and_oracle(adult, hp):
    kw = dict(label="income", num_trees=6, **hp)
    ref = RefGBT(**kw, growth_engine="batched").train(adult)
    got = GradientBoostedTreesLearner(**kw, device="cpu").train(adult)
    oracle = GradientBoostedTreesLearner(**kw, growth_engine="oracle",
                                         device="cpu").train(adult)
    assert got.training_logs["growth_engine"] == "batched"
    assert got.training_logs["histogram_backend"] == "numpy"
    assert oracle.training_logs["growth_engine"] == "oracle"
    assert got.forest.n_trees == ref.forest.n_trees
    assert_identical(got.forest, ref.forest, f"reference {hp}")
    assert_identical(got.forest, oracle.forest, f"oracle {hp}")
    for key in ("train_loss", "valid_loss"):
        assert got.training_logs[key] == ref.training_logs[key]


def test_default_gbt_on_numerical_data_equals_reference():
    """The slice as a whole on the training path's data shape (numerical
    columns only): the default learner, no override, 10 trees."""
    spec = SUITE[1]
    train, test = train_test_split(make_dataset(spec), 0.3, spec.seed)
    ref = RefGBT(label="label", num_trees=10).train(train)
    got = GradientBoostedTreesLearner(label="label", num_trees=10,
                                      device="cpu").train(train)
    assert_identical(got.forest, ref.forest)
    np.testing.assert_array_equal(got.predict(test, device="cpu"),
                                  ref.predict(test))


def test_default_learner_trains_with_no_override(adult):
    m = GradientBoostedTreesLearner(label="income", device="cpu").train(adult)
    logs = m.training_logs
    assert logs["growth_engine"] == "batched" and logs["engine_fallback"] is None
    assert logs["histogram_backend"] == "numpy" and logs["device"] == "cpu"
    assert 1 <= m.forest.n_trees <= 300
    assert m.self_evaluation["accuracy"] > 0.6


@pytest.mark.parametrize("strategy", ["LOCAL", "BEST_FIRST_GLOBAL"])
def test_torch_backend_grows_the_numpy_backend_trees(adult, strategy):
    small = {k: np.asarray(v)[:150] for k, v in adult.items()}
    kw = dict(label="income", num_trees=2, max_depth=3, validation_ratio=0.0,
              early_stopping="NONE", growing_strategy=strategy, device="cpu")
    m_np = GradientBoostedTreesLearner(**kw, histogram_backend="numpy").train(small)
    m_pl = GradientBoostedTreesLearner(**kw, histogram_backend="torch").train(small)
    assert m_pl.training_logs["histogram_backend"] == "torch"
    f_np, f_pl = m_np.forest, m_pl.forest
    np.testing.assert_array_equal(f_np.feature, f_pl.feature)
    np.testing.assert_array_equal(f_np.split_bin, f_pl.split_bin)
    np.testing.assert_allclose(f_np.leaf_value, f_pl.leaf_value, atol=1e-5)


@pytest.mark.parametrize("hp", [
    dict(template="benchmark_rank1"),       # oblique + RANDOM + best-first
    dict(split_axis="SPARSE_OBLIQUE"),      # oblique under LOCAL growth
], ids=["benchmark_rank1", "sparse_oblique_local"])
def test_oblique_gbt_equals_reference_and_oracle(adult, hp):
    """Sparse-oblique GBTs (the benchmark_rank1 rows of
    tests/test_grower_batched.py): the port's batched forest equals the
    reference's batched forest and the port's oracle on every field, the
    oblique tables included."""
    kw = dict(label="income", num_trees=6, **hp)
    ref = RefGBT(**kw, growth_engine="batched").train(adult)
    got = GradientBoostedTreesLearner(**kw, device="cpu").train(adult)
    oracle = GradientBoostedTreesLearner(**kw, growth_engine="oracle",
                                         device="cpu").train(adult)
    assert got.training_logs["growth_engine"] == "batched"
    assert got.forest.has_oblique()
    for other, name in ((ref, "reference"), (oracle, "oracle")):
        assert_identical(got.forest, other.forest, f"{name} {hp}")
        for k in ("obl_weights", "obl_features"):
            np.testing.assert_array_equal(getattr(got.forest, k),
                                          getattr(other.forest, k),
                                          err_msg=f"{name} {hp}: forest.{k}")
    assert got.training_logs["valid_loss"] == ref.training_logs["valid_loss"]


@pytest.mark.parametrize("kw", [
    dict(histogram_backend="cuda"),
    dict(histogram_backend="pallas_interpret"),
])
def test_unported_or_wrong_device_options_raise(adult, kw):
    with pytest.raises(YdfError):
        GradientBoostedTreesLearner(label="income", num_trees=1, device="cpu",
                                    **kw).train(adult)


ENGINE_GRID = list(itertools.product(
    ("batched", "oracle", "device"), ("LOCAL", "BEST_FIRST_GLOBAL"),
    ("CART", "ONE_HOT", "RANDOM"), (1.0, 0.5), ("stream", "keyed"),
    (False, True)))


def test_resolve_engine_equals_reference_everywhere():
    for engine, strategy, cat, ratio, sampling, oblique in ENGINE_GRID:
        sp = dict(categorical_algorithm=cat, num_candidate_ratio=ratio)
        gp = dict(engine=engine, growing_strategy=strategy,
                  feature_sampling=sampling)
        want = ref_resolve_engine(
            RefGrowthParams(splitter=RefSplitterParams(**sp), **gp),
            None, oblique)
        got = grower.resolve_engine(
            grower.GrowthParams(splitter=SplitterParams(**sp), device="cpu",
                                **gp), None, oblique)
        assert got == want, (gp, sp, oblique)
    with pytest.raises(YdfError, match="Unknown growth engine"):
        grower.resolve_engine(grower.GrowthParams(engine="warp"))


@pytest.fixture(scope="module")
def adult_binned():
    ds = dataset_from_raw(adult_like(600, seed=4))
    feats = [c for c in ds.spec.columns if c != "income"]
    binned = bin_features(ds, feats)
    y = (ds.categorical["income"] == 2).astype(np.float64)
    rng = np.random.default_rng(2)
    stats_list, actives = [], []
    for _ in range(3):
        w = rng.integers(0, 3, len(y)).astype(np.float64)
        stats_list.append(np.stack([(y == 0) * w, (y == 1) * w, w], 1))
        actives.append(w > 0)
    return binned, stats_list, actives


def _leaf_mean(s):
    return np.array([s[1] / max(s[-1], 1e-12)], np.float32)


def test_sequential_tree_block_equals_reference(adult_binned):
    """A block of three trees with stream feature sampling (one rng per
    tree) grows tree by tree on the batched engine, as in the reference;
    with keyed sampling the block grows in lockstep on the host, as in the
    reference."""
    binned, stats_list, actives = adult_binned
    kw = dict(max_depth=5, max_nodes=64, engine="batched")
    sp = dict(stat_kind="class", num_candidate_ratio=0.5)
    rf = ref_empty_forest(3, 64, 1, feature_names=binned.names)
    rnode = ref_grow_trees(rf, [0, 1, 2], binned, None, stats_list, actives,
                           _leaf_mean,
                           RefGrowthParams(splitter=RefSplitterParams(**sp),
                                           **kw),
                           [np.random.default_rng(s) for s in range(3)])
    pf = empty_forest(3, 64, 1, feature_names=binned.names)
    pbinned = convert.binned_from_arrays(binned.codes, binned.n_bins,
                                         binned.is_cat, binned.boundaries,
                                         binned.names)
    gp = grower.GrowthParams(splitter=SplitterParams(**sp), device="cpu", **kw)
    pnode = grower.grow_trees(pf, [0, 1, 2], pbinned, None, stats_list,
                              actives, _leaf_mean, gp,
                              [np.random.default_rng(s) for s in range(3)])
    np.testing.assert_array_equal(pnode, rnode)
    assert_identical(pf, rf)
    # the reference's host lockstep path (keyed sampling)
    keyed = dataclasses.replace(gp, feature_sampling="keyed")
    rf = ref_empty_forest(3, 64, 1, feature_names=binned.names)
    rnode = ref_grow_trees(rf, [0, 1, 2], binned, None, stats_list, actives,
                           _leaf_mean,
                           RefGrowthParams(splitter=RefSplitterParams(**sp),
                                           feature_sampling="keyed", **kw),
                           [None] * 3)
    pf = empty_forest(3, 64, 1, feature_names=binned.names)
    pnode = grower.grow_trees(pf, [0, 1, 2], pbinned, None, stats_list,
                              actives, _leaf_mean, keyed, [None] * 3)
    np.testing.assert_array_equal(pnode, rnode)
    assert_identical(pf, rf)
