"""The port's device growth engine against the JAX package's.

Both ``grow_trees_device`` grow from the same ``BinnedFeatures`` (carried
across with ``convert.binned_from_arrays``) and the same numpy stats:

  * a small numerical frontier, the reference with its Pallas kernel in
    interpret mode, the port with the fused route's plain version;
  * the Adult-like fixture (categorical CART and ONE_HOT scans, keyed
    feature sampling, K-tree lockstep blocks), the reference on its jnp path.

Tolerance: the structure fields and the final routing identical; leaf
values within 1e-5 (float32 sums in another order).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro.core.binning import BinnedFeatures, bin_features
from repro.core.dataspec import dataset_from_raw
from repro.core.grower import GrowthParams as RefGrowthParams
from repro.core.grower import grow_tree as ref_grow_tree
from repro.core.grower import grow_trees as ref_grow_trees
from repro.core.grower import resolve_engine as ref_resolve_engine
from repro.core.splitters import SplitterParams as RefSplitterParams
from repro.core.tree import empty_forest as ref_empty_forest
from repro.data.tabular import adult_like
from repro_torch import convert
from repro_torch.core import YdfError, grower, grower_device
from repro_torch.core.splitters import SplitterParams
from repro_torch.core.tree import empty_forest

STRUCT = ("feature", "split_bin", "cat_mask", "left_child", "n_nodes")
CPU = torch.device("cpu")


def to_port(binned: BinnedFeatures):
    return convert.binned_from_arrays(binned.codes, binned.n_bins,
                                      binned.is_cat, binned.boundaries,
                                      binned.names)


def params(ref: bool, **kw):
    """Device-engine GrowthParams of the reference (``ref``) or of the port
    on the CPU; ``splitter`` holds SplitterParams fields."""
    sp_kw = kw.pop("splitter", {})
    if ref:
        return RefGrowthParams(engine="device",
                               splitter=RefSplitterParams(**sp_kw), **kw)
    return grower.GrowthParams(engine="device", splitter=SplitterParams(**sp_kw),
                               device="cpu", **kw)


def assert_same(rf, pf, ref_node, port_node, atol=1e-5):
    for k in STRUCT:
        np.testing.assert_array_equal(getattr(pf, k), getattr(rf, k),
                                      err_msg=f"forest.{k}")
    np.testing.assert_array_equal(port_node, ref_node)
    np.testing.assert_allclose(pf.threshold, rf.threshold, atol=0)
    np.testing.assert_allclose(pf.leaf_value, rf.leaf_value, atol=atol)
    assert pf.depth == rf.depth


def leaf_mean(s):
    return np.array([s[0] / max(s[-1], 1e-12)], np.float32)


@pytest.fixture(scope="module")
def numerical_frontier():
    rng = np.random.default_rng(3)
    N, F = 300, 4
    X = rng.normal(size=(N, F))
    y = (X[:, 0] + 0.5 * X[:, 1] - 0.3 * X[:, 3] > 0).astype(np.float64)
    bounds = [np.sort(rng.choice(np.unique(X[:, j]), 31, replace=False))
              for j in range(F)]
    codes = np.stack([np.searchsorted(bounds[j], X[:, j], side="left")
                      for j in range(F)], 1).astype(np.uint8)
    binned = BinnedFeatures(
        codes=codes, n_bins=np.array([32] * F, np.int32),
        is_cat=np.zeros(F, bool),
        boundaries=[b.astype(np.float32) for b in bounds],
        names=[f"f{j}" for j in range(F)])
    stats = np.stack([y - 0.5, np.ones(N), np.full(N, 0.25), np.ones(N)], 1)
    active = rng.random(N) > 0.1
    return binned, X, stats, active


def test_interpret_frontier_equals_reference(numerical_frontier):
    """The reference's fused Pallas kernel (interpret mode) and the port's
    fused route (plain version on the CPU) grow the same tree."""
    binned, X, stats, active = numerical_frontier
    kw = dict(max_depth=3, max_nodes=64,
              splitter=dict(stat_kind="gh", min_examples=5))
    rf = ref_empty_forest(1, 64, 1, feature_names=binned.names)
    rnode = ref_grow_tree(rf, 0, binned, X, stats, active, leaf_mean,
                          params(True, device_impl="interpret", **kw),
                          np.random.default_rng(0))
    pf = empty_forest(1, 64, 1, feature_names=binned.names)
    pnode = grower.grow_tree(pf, 0, to_port(binned), X, stats, active,
                             leaf_mean, params(False, device_impl="torch", **kw),
                             np.random.default_rng(0))
    assert pf.n_nodes[0] > 1, "the tree did not grow"
    assert_same(rf, pf, rnode, pnode)


@pytest.fixture(scope="module")
def adult_binned():
    ds = dataset_from_raw(adult_like(700, seed=5))
    feats = [c for c in ds.spec.columns if c != "income"]
    binned = bin_features(ds, feats)
    y = (ds.categorical["income"] == 2).astype(np.float64)
    return binned, y


def _adult_stats(y, kind, seed):
    rng = np.random.default_rng(seed)
    n = len(y)
    w = rng.integers(0, 3, n).astype(np.float64)
    if kind == "gh":
        g = 0.5 - y
        return np.stack([g * w, w, 0.25 * w, w], 1), w > 0
    if kind == "class":
        return np.stack([(y == 0) * w, (y == 1) * w, w], 1), w > 0
    r = rng.normal(size=n) + y
    return np.stack([r * w, r * r * w, w], 1), w > 0


@pytest.mark.parametrize("kind,cat_alg,ratio,depth", [
    ("gh", "CART", 1.0, 4),
    ("gh", "ONE_HOT", 1.0, 3),
    ("class", "CART", 0.5, 4),     # keyed per-node sampling
    ("moment", "CART", 1.0, 3),
])
def test_jnp_path_on_adult_equals_reference(adult_binned, kind, cat_alg,
                                            ratio, depth):
    """Categorical data: the reference's jnp level step and the port's
    torch level step (explicit histogram, CART / ONE_HOT scans, keyed
    sampling) grow identical trees."""
    binned, y = adult_binned
    stats, active = _adult_stats(y, kind, seed=depth)
    kw = dict(max_depth=depth, max_nodes=2 ** (depth + 1),
              feature_sampling="keyed", sampling_key=99,
              splitter=dict(stat_kind=kind, min_examples=5,
                            categorical_algorithm=cat_alg,
                            num_candidate_ratio=ratio))
    M = 2 ** (depth + 1)
    X = np.zeros((len(y), binned.n_features), np.float32)
    rf = ref_empty_forest(1, M, 1, feature_names=binned.names)
    rnode = ref_grow_tree(rf, 0, binned, X, stats, active, leaf_mean,
                          params(True, device_impl="jnp", **kw),
                          np.random.default_rng(0))
    pf = empty_forest(1, M, 1, feature_names=binned.names)
    pnode = grower.grow_tree(pf, 0, to_port(binned), X, stats, active,
                             leaf_mean, params(False, device_impl="torch", **kw),
                             np.random.default_rng(0))
    assert pf.n_nodes[0] > 3
    assert_same(rf, pf, rnode, pnode)


def test_lockstep_block_equals_reference(adult_binned):
    """Three trees in one padded block of four (keyed sqrt-style sampling),
    as a Random Forest grows them."""
    binned, y = adult_binned
    ts = [0, 1, 2]
    stats_list, actives = zip(*(_adult_stats(y, "class", seed=s) for s in ts))
    kw = dict(max_depth=4, max_nodes=32, feature_sampling="keyed",
              sampling_key=5,
              splitter=dict(stat_kind="class", min_examples=5,
                            num_candidate_ratio=0.4))
    rf = ref_empty_forest(3, 32, 1, feature_names=binned.names)
    rnode = ref_grow_trees(rf, ts, binned, None, list(stats_list),
                           list(actives), leaf_mean,
                           params(True, device_impl="jnp", **kw),
                           [np.random.default_rng(0)] * 3, block=4)
    pf = empty_forest(3, 32, 1, feature_names=binned.names)
    pnode = grower.grow_trees(pf, ts, to_port(binned), None, list(stats_list),
                              list(actives), leaf_mean,
                              params(False, device_impl="torch", **kw),
                              [np.random.default_rng(0)] * 3, block=4)
    assert_same(rf, pf, rnode, pnode)


def test_resolve_impl_rules():
    cuda = torch.device("cuda")
    assert grower_device._resolve_impl("auto", False, CPU) == "torch"
    assert grower_device._resolve_impl(None, True, CPU) == "torch"
    assert grower_device._resolve_impl("auto", False, cuda) == "cuda"
    assert grower_device._resolve_impl("auto", True, cuda) == "torch"
    assert grower_device._resolve_impl("torch", False, cuda) == "torch"
    with pytest.raises(YdfError, match="categorical"):
        grower_device._resolve_impl("cuda", True, cuda)
    with pytest.raises(YdfError, match="CUDA device"):
        grower_device._resolve_impl("cuda", False, CPU)
    with pytest.raises(YdfError, match="Unknown device_impl"):
        grower_device._resolve_impl("jnp", False, CPU)


# The ids are those of the cases when the port had no host engines and each
# of these raised; they now resolve as the reference resolves them.
@pytest.mark.parametrize("change,want", [
    pytest.param(dict(engine="batched"), ("batched", None),
                 id="change0-not have yet"),
    pytest.param(dict(engine="oracle"), ("oracle", None),
                 id="change1-not have yet"),
    pytest.param(dict(engine="warp"), "Unknown growth engine",
                 id="change2-Unknown growth engine"),
    pytest.param(dict(growing_strategy="BEST_FIRST_GLOBAL"),
                 ("batched", "BEST_FIRST"), id="change3-BEST_FIRST"),
    pytest.param(dict(splitter=dict(categorical_algorithm="RANDOM")),
                 ("batched", "RANDOM"), id="change4-RANDOM"),
    pytest.param(dict(splitter=dict(num_candidate_ratio=0.5)),
                 ("batched", "keyed"), id="change5-keyed"),
])
def test_unported_engines_and_configurations_raise(change, want):
    """The reference's resolution: "batched" and "oracle" are honoured; a
    device-engine configuration it cannot run resolves to ("batched",
    reason) with the reference's reason; an unknown engine raises."""
    sp = change.pop("splitter", {})
    gp = dataclasses.replace(grower.GrowthParams(engine="device",
                                                 device="cpu"),
                             splitter=SplitterParams(**sp), **change)
    if isinstance(want, str):
        with pytest.raises(YdfError, match=want):
            grower.resolve_engine(gp)
        return
    rgp = dataclasses.replace(RefGrowthParams(engine="device"),
                              splitter=RefSplitterParams(**sp), **change)
    engine, reason = grower.resolve_engine(gp)
    assert (engine, reason) == ref_resolve_engine(rgp)
    assert engine == want[0]
    if want[1] is None:
        assert reason is None
    else:
        assert want[1] in reason


def test_level_steps_are_counted(numerical_frontier):
    binned, _, stats, active = numerical_frontier
    pf = empty_forest(1, 64, 1, feature_names=binned.names)
    before = grower_device.LEVEL_STEPS
    grower.grow_tree(pf, 0, to_port(binned), None, stats, active, leaf_mean,
                     params(False, max_depth=3, max_nodes=64),
                     np.random.default_rng(0))
    assert 1 <= grower_device.LEVEL_STEPS - before <= 3


@pytest.mark.parametrize("n,S,n_out", [(90_000, 4, 129), (7, 3, 2), (0, 4, 3)])
def test_exact_sums_are_the_rounded_float64_sums(n, S, n_out):
    """The card's order-free segment sums: the float32 value of the exact
    sum, the count channel exact, whatever the order of the rows."""
    rng = np.random.default_rng(n)
    v = rng.normal(size=(n, S)).astype(np.float32) * 3
    v[:, -1] = rng.integers(0, 3, n)
    idx = rng.integers(0, n_out, n)
    want = np.zeros((n_out, S))
    np.add.at(want, idx, v.astype(np.float64))
    perm = rng.permutation(n)
    for order in (np.arange(n), perm):
        got = grower_device.exact_sums(torch.from_numpy(v[order]),
                                       torch.from_numpy(idx[order]), n_out)
        np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))
