"""Sparse-oblique splits in the port (ROADMAP A3), against the JAX package.

Each case runs the reference and the port on the same seeded inputs (made
with numpy), the port on ``device="cpu"``. Tolerances: none. Training is
host numpy in both packages, so the splitters and every Forest field,
``obl_weights`` and ``obl_features`` included, are equal bit for bit.
Traversal selects leaves, so the port's engines ("naive", "vectorized",
"ref"), the kernels' plain version (``layout.walk``) and the CPU path of
both kernel wrappers equal the reference's ``predict_raw`` bit for bit
(``array_equal``): an oblique projection is the float32 sum of the
rounded products in numpy's pairwise order. ``predict_naive`` projects
with ``np.dot`` in both packages, whose BLAS order may differ in the last
bit: one constructed near-tie row pins that divergence of the reference
itself, and everywhere else the naive engine agrees too.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from repro.core import GradientBoostedTreesLearner as RefGBT
from repro.core import RandomForestLearner as RefRF
from repro.core import splitters as ref_splitters
from repro.core.api import Task as RefTask
from repro.core.binning import bin_features as ref_bin_features
from repro.core.dataspec import dataset_from_raw as ref_dataset_from_raw
from repro.core.dataspec import spec_to_dict
from repro.core.grower import GrowthParams as RefGrowthParams
from repro.core.grower import resolve_engine as ref_resolve_engine
from repro.core.tree import empty_forest as ref_empty_forest
from repro.core.tree import predict_naive as ref_predict_naive
from repro.core.tree import predict_raw as ref_predict_raw
from repro.data.tabular import SyntheticSpec, make_dataset, train_test_split
from repro_torch import convert
from repro_torch.core import (
    CheckpointPolicy,
    GradientBoostedTreesLearner,
    Model,
    RandomForestLearner,
    Task,
    YdfError,
    grower,
    resume_training,
    splitters,
)
from repro_torch.core import tree as port_tree
from repro_torch.kernels.forest_infer import forest_infer, layout, ops, plan, ref

CPU = torch.device("cpu")
FOREST_KEYS = ("feature", "threshold", "split_bin", "cat_mask", "left_child",
               "leaf_value", "n_nodes", "split_gain", "obl_weights",
               "obl_features")
ARRAYS = ("feature", "threshold", "split_bin", "cat_mask", "left_child",
          "leaf_value", "n_nodes", "split_gain", "tree_class", "init_pred",
          "obl_weights", "obl_features")
# the widths of synth_higgs_like (28 numerical columns), at a few thousand rows
HIGGS_SMALL = SyntheticSpec("synth_higgs_like", n=3000, n_num=28, n_cat=0,
                            n_classes=2, seed=9)


def assert_forests_equal(a, b, msg=""):
    for k in FOREST_KEYS:
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k),
                                      err_msg=f"{msg}: forest.{k}")
    assert a.depth == b.depth, msg


def to_ref(pf):
    """The reference's Forest holding a port Forest's arrays."""
    P = 0 if pf.obl_weights is None else pf.obl_weights.shape[-1]
    rf = ref_empty_forest(pf.n_trees, pf.max_nodes, pf.leaf_value.shape[-1],
                          oblique_dims=P, feature_names=pf.feature_names)
    for k in ("feature", "threshold", "cat_mask", "left_child", "leaf_value",
              "n_nodes", "obl_weights", "obl_features"):
        if getattr(pf, k) is not None:
            setattr(rf, k, getattr(pf, k))
    rf.depth = pf.depth
    return rf


def port_engines(pf, X) -> dict:
    """Every CPU traversal of the port: name -> (N, T, O) numpy."""
    Xt = torch.from_numpy(np.ascontiguousarray(X, np.float32))
    packed, soa = ops.device_packed(pf, CPU), ops.device_soa(pf, CPU)
    return {
        "vectorized": port_tree.compile_predict_raw(pf)(X),
        "predict_raw": port_tree.predict_raw(pf, X),
        "ref": ops.forest_predict(pf, X, "ref", CPU).numpy(),
        "cuda (CPU: walk)": ops.forest_predict(pf, X, "cuda", CPU).numpy(),
        "single (CPU: walk)": ops.forest_predict(pf, X, "single",
                                                 CPU).numpy(),
        "walk, packed": layout.walk(Xt, packed.layout,
                                    tree_order=True).numpy(),
        "walk, soa": layout.walk(Xt, soa.layout).numpy(),
        "packed table traversal": ref.forest_predict_packed_ref(
            Xt, *packed.tables, **packed.obl)[:, packed.inv_order].numpy(),
    }


def assert_traversals(pf, X, rf=None):
    """Every port traversal equals the reference's predict_raw; the port's
    naive engine equals the reference's."""
    rf = rf or to_ref(pf)
    want = ref_predict_raw(rf, X)
    for name, got in port_engines(pf, X).items():
        np.testing.assert_array_equal(got, want, err_msg=name)
    naive = port_tree.predict_naive(pf, X)
    np.testing.assert_array_equal(naive, ref_predict_naive(rf, X))
    return naive, want


# ------------------------------------------------------------- splitters

def _splitter_scenario():
    """tests/test_core_splitters.py's oblique scenario, with a second node
    and inactive rows added."""
    rng = np.random.default_rng(5)
    n, f = 300, 4
    X = rng.normal(size=(n, f)) * np.array([1, 10, 0.1, 3]) + 5
    w_true = np.array([1.0, -0.5, 2.0, 0.0])
    y = (X @ w_true > np.median(X @ w_true)).astype(float)
    stats = np.stack([0.5 - y, np.ones(n), np.ones(n)], 1)
    node_of = rng.integers(-1, 2, n).astype(np.int32)
    return X, stats, node_of


def _split_fields(s) -> dict:
    return {f.name: getattr(s, f.name) for f in dataclasses.fields(s)}


@pytest.mark.parametrize("exponent,density", [(1.5, 0.5), (1.0, 0.9),
                                              (2.0, 0.2)])
def test_oblique_splits_equal_reference(exponent, density):
    X, stats, node_of = _splitter_scenario()
    kw = dict(stat_kind="gh", min_examples=2, oblique=True,
              oblique_num_projections_exponent=exponent,
              oblique_density=density)
    for nodes, n_nodes in ((np.zeros(len(X), np.int32), 1), (node_of, 2)):
        want = ref_splitters.oblique_splits(
            X, X.min(0), X.max(0), stats, nodes, n_nodes,
            ref_splitters.SplitterParams(**kw), np.random.default_rng(0))
        got = splitters.oblique_splits(
            X, X.min(0), X.max(0), stats, nodes, n_nodes,
            splitters.SplitterParams(**kw), np.random.default_rng(0))
        assert len(got) == len(want) == n_nodes
        for g, w in zip(got, want):
            assert g.valid == w.valid
            gf, wf = _split_fields(g), _split_fields(w)
            assert gf.keys() == wf.keys()
            for k in gf:
                np.testing.assert_array_equal(gf[k], wf[k], err_msg=k)
    assert any(s.obl_features is not None for s in got)


def test_exact_best_split_and_apply_split_equal_reference():
    X, stats, _ = _splitter_scenario()
    ref_p = ref_splitters.SplitterParams(stat_kind="gh", min_examples=2,
                                         oblique=True)
    port_p = splitters.SplitterParams(stat_kind="gh", min_examples=2,
                                      oblique=True)
    for j in range(X.shape[1]):
        assert (splitters.exact_best_split_numerical(X[:, j], stats, port_p)
                == ref_splitters.exact_best_split_numerical(X[:, j], stats,
                                                            ref_p))
    ds = ref_dataset_from_raw({f"x{j}": X[:, j].astype(object)
                               for j in range(X.shape[1])})
    rb = ref_bin_features(ds, [f"x{j}" for j in range(X.shape[1])])
    pb = convert.binned_from_arrays(rb.codes, rb.n_bins, rb.is_cat,
                                    rb.boundaries, rb.names)
    X32 = X.astype(np.float32)
    obl = splitters.oblique_splits(
        X, X.min(0), X.max(0), stats, np.zeros(len(X), np.int32), 1,
        dataclasses.replace(port_p, oblique_num_projections_exponent=1.5),
        np.random.default_rng(0))[0]
    assert obl.obl_features is not None
    ref_obl = ref_splitters.Split(**_split_fields(obl))
    axis = splitters.Split(gain=1.0, feature=2, split_bin=40,
                           threshold=rb.threshold_value(2, 40))
    ref_axis = ref_splitters.Split(**_split_fields(axis))
    idx = np.arange(0, len(X), 2)
    for p_split, r_split in ((obl, ref_obl), (axis, ref_axis)):
        np.testing.assert_array_equal(
            splitters.apply_split(p_split, pb, X32, idx),
            ref_splitters.apply_split(r_split, rb, X32, idx))


def test_device_engine_resolves_oblique_to_batched_with_the_reference_reason():
    sp = dict(oblique=True)
    want = ref_resolve_engine(RefGrowthParams(
        engine="device", splitter=ref_splitters.SplitterParams(**sp)),
        None, True)
    got = grower.resolve_engine(grower.GrowthParams(
        engine="device", splitter=splitters.SplitterParams(**sp),
        device="cpu"), None, True)
    assert got == want and got[0] == "batched" and got[1]


# ----------------------------------------------------- the slice as a whole

@pytest.fixture(scope="module")
def higgs_small():
    return train_test_split(make_dataset(HIGGS_SMALL), 0.3, 9)


@pytest.fixture(scope="module")
def rank1(higgs_small):
    """Both benchmark_rank1 templates at synth_higgs_like's width, trained
    by each package: name -> (port model, reference model)."""
    train, _ = higgs_small
    out = {}
    for name, port_cls, ref_cls in (("gbt", GradientBoostedTreesLearner,
                                     RefGBT),
                                    ("rf", RandomForestLearner, RefRF)):
        kw = dict(label="label", template="benchmark_rank1", num_trees=3)
        if name == "rf":
            kw["max_depth"] = 10
        out[name] = (port_cls(device="cpu", **kw).train(train),
                     ref_cls(**kw).train(train))
    return out


@pytest.mark.parametrize("name", ["gbt", "rf"])
def test_rank1_templates_equal_reference_at_full_width(rank1, name):
    got, want = rank1[name]
    logs = got.training_logs
    assert logs["growth_engine"] == "batched"
    assert logs["histogram_backend"] == "numpy"
    assert got.forest.has_oblique()
    assert got.forest.obl_weights.shape[-1] == 28
    assert_forests_equal(got.forest, want.forest, name)
    assert got.self_evaluation.metrics == want.self_evaluation.metrics


@pytest.mark.parametrize("name", ["gbt", "rf"])
def test_trained_oblique_forests_serve_as_the_reference(rank1, higgs_small,
                                                        name):
    got, want = rank1[name]
    _, test = higgs_small
    for engine in ("ref", "vectorized", "naive"):
        np.testing.assert_array_equal(
            got.predict(test, engine=engine, device="cpu"),
            want.predict(test), err_msg=engine)
    X = chip_smoke.oblique_rows(400, 28, seed=3, cat_feats=())
    naive, raw = assert_traversals(got.forest, X, want.forest)
    np.testing.assert_array_equal(naive, raw)


def test_oblique_gbt_device_engine_records_the_fallback(higgs_small):
    train, _ = higgs_small
    small = {k: v[:500] for k, v in train.items()}
    kw = dict(label="label", split_axis="SPARSE_OBLIQUE", num_trees=1,
              growth_engine="device")
    got = GradientBoostedTreesLearner(device="cpu", **kw).train(small)
    want = RefGBT(**kw).train(small)
    assert got.training_logs["growth_engine"] == "batched"
    assert (got.training_logs["engine_fallback"]
            == want.training_logs["engine_fallback"])
    assert_forests_equal(got.forest, want.forest)


# ------------------------------------------------------------- traversal

@pytest.mark.parametrize("P", chip_smoke.OBLIQUE_DIMS)
def test_traversals_equal_reference_on_the_zoo(P):
    """A forest of numerical, categorical and oblique nodes of P slots over
    hostile rows (NaN, +-inf, +-1e20 in projected columns and column 0)."""
    pf, X = chip_smoke.oblique_zoo()[f"P={P}"]
    assert pf.has_oblique()
    naive, raw = assert_traversals(pf, X)
    np.testing.assert_array_equal(naive, raw)


def test_pairwise_sum_is_numpys_order():
    rng = np.random.default_rng(4)
    for P in chip_smoke.OBLIQUE_DIMS + (16, 256, 1000):
        w = (rng.normal(size=(64, 3, P))
             * 10.0 ** rng.uniform(-3, 3, (64, 3, P))).astype(np.float32)
        x = rng.normal(size=(64, 3, P)).astype(np.float32)
        got = ref.pairwise_sum(torch.from_numpy(w) * torch.from_numpy(x))
        np.testing.assert_array_equal(got.numpy(), (w * x).sum(-1),
                                      err_msg=f"P={P}")


def test_near_tie_pins_the_references_naive_divergence():
    """np.dot and the pairwise sum fall on opposite sides of the threshold:
    the reference's naive and vectorized engines disagree on that row, and
    each port engine follows its reference counterpart."""
    pf, X = chip_smoke.near_tie()
    rf = to_ref(pf)
    naive, raw = assert_traversals(pf, X, rf)
    assert not np.array_equal(ref_predict_naive(rf, X), ref_predict_raw(rf, X))
    assert not np.array_equal(naive, raw)
    rep = chip_smoke.naive_divergence(pf, X, raw)
    assert rep["pairs_differ"] == 1
    tie = rep["near_ties"][0]
    assert tie["dot"] != tie["pairwise"] and tie["margin"] == 0.0


def test_zoo_and_near_tie_pass_the_chip_checks_on_the_cpu():
    """chip_smoke's kernel_oblique checks, rehearsed with the plain version
    standing in for the kernels: every plan variant of both wrappers equals
    the vectorized engine, and only the near tie splits predict_naive."""
    cases = {**chip_smoke.oblique_zoo(), "near tie": chip_smoke.near_tie()}
    before = forest_infer.LAUNCHES, forest_infer.SINGLE_LAUNCHES
    res = chip_smoke.check_all_variants(cases, CPU, ("tiled", "single"))
    assert (forest_infer.LAUNCHES, forest_infer.SINGLE_LAUNCHES) == before
    assert res["max_abs_err"] == 0.0
    differ = {k: r["naive"]["pairs_differ"] for k, r in res["cases"].items()}
    assert differ.pop("near tie") == 1 and not any(differ.values())


# ---------------------------------------------------------------- layout

def test_layout_records_the_oblique_kind():
    pf, _ = chip_smoke.oblique_zoo()["P=9"]
    lay = ops.device_soa(pf, CPU).layout
    T, M = pf.feature.shape
    P = pf.obl_weights.shape[-1]
    rec = lay.records.view(T, M, 4).numpy()
    internal = pf.left_child >= 0
    obl = (pf.feature == -2) & internal
    assert lay.obl_dims == P
    k = np.cumsum(obl.ravel()).reshape(T, M) - 1
    assert np.array_equal(rec[..., 0][obl], (k[obl] - 2 ** 31).astype(np.int32))
    assert (rec[..., 0][~obl] >= -layout.KIND_LIMIT).all()
    assert np.array_equal(rec[..., 1][obl].view(np.float32), pf.threshold[obl])
    pairs = lay.obl.numpy().reshape(-1, P, 2)
    assert np.array_equal(pairs[..., 0], pf.obl_features[obl])
    assert np.array_equal(pairs[..., 1].view(np.float32), pf.obl_weights[obl])
    assert np.array_equal(lay.obl_start.numpy(),
                          np.concatenate([[0], np.cumsum(obl.sum(1))]))
    cols = np.concatenate([pf.feature[internal & ~obl],
                           pf.obl_features[obl].ravel()])
    assert lay.min_features == int(cols.max()) + 1
    assert lay.group_obl[0] == int(obl.sum(1).max()) * P


def test_min_features_covers_the_paddings_column_zero():
    pf, X = chip_smoke.near_tie(P=3)
    pf.obl_features[0, 0] = (5, 7, 0)
    pf.obl_weights[0, 0, 2] = 0.0                  # the padding reads column 0
    assert ops.device_soa(pf, CPU).layout.min_features == 8
    only = dataclasses.replace(pf, obl_features=pf.obl_features * 0 + 4,
                               obl_weights=pf.obl_weights.copy())
    assert ops.device_packed(only, CPU).layout.min_features == 5
    with pytest.raises(YdfError, match="columns"):
        ops.forest_predict(only, np.zeros((2, 4), np.float32), "cuda", CPU)


def test_plans_count_the_oblique_pairs():
    """A staged group holds its pairs: 8 bytes each, on top of records and
    masks, so enough pairs push a group to global memory."""
    assert plan.table_bytes(2, 100, 3, 10) == 2 * 101 * 16 + 3 * 32 + 10 * 8
    room = plan.STAGE_BUDGET - plan.table_bytes(1, 2000, 0)
    fits = plan.single_plan(100, 4, 2000, 1, (0,) * 8, None,
                            (room // plan.PAIR_BYTES,) * 8)
    over = plan.single_plan(100, 4, 2000, 1, (0,) * 8, None,
                            (room // plan.PAIR_BYTES + 1,) * 8)
    assert (fits.variant, fits.group) == ("staged", 1)
    assert over.variant == "global"
    assert plan.tiled_plan(100, 3, 8, 128, 0, None, 30_000).variant == "global"
    assert plan.tiled_plan(100, 3, 8, 128, 0, None, 100).variant == "staged"


def test_build_refuses_malformed_oblique_tables():
    pf, _ = chip_smoke.oblique_zoo()["P=7"]
    soa = ops.device_soa(pf, CPU)
    tabs = dict(zip(("feature", "threshold", "cat_mask", "left_child",
                     "leaf_value"), soa[:5]))
    with pytest.raises(YdfError, match="no oblique tables"):
        layout.build(**tabs, depth=pf.depth)
    bad = soa.obl_features.clone()
    bad[pf.feature == -2] = -1
    with pytest.raises(YdfError, match="negative column"):
        layout.build(**tabs, depth=pf.depth, obl_features=bad,
                     obl_weights=soa.obl_weights)
    with pytest.raises(TypeError):
        layout.build(**tabs, depth=pf.depth,
                     obl_features=soa.obl_features.long(),
                     obl_weights=soa.obl_weights)
    with pytest.raises(ValueError, match="together"):
        layout.build(**tabs, depth=pf.depth, obl_features=soa.obl_features)


def test_table_level_wrappers_take_the_oblique_tables():
    pf, X = chip_smoke.oblique_zoo()["P=28"]
    packed, soa = ops.device_packed(pf, CPU), ops.device_soa(pf, CPU)
    Xt = torch.from_numpy(X)
    assert torch.equal(
        forest_infer.forest_predict_tiled(Xt, *packed.tables, **packed.obl),
        forest_infer.run_tiled(Xt, packed.layout))
    assert torch.equal(
        forest_infer.forest_predict_single(Xt, *soa[:5], depth=pf.depth,
                                           **soa.obl),
        forest_infer.run_single(Xt, soa.layout))


# ----------------------------------------------- carrying a model across

@pytest.fixture(scope="module")
def planted_rank1():
    """tests/test_analysis.py's planted classification data (one informative
    column, four of noise) and the reference's 4-tree benchmark_rank1 GBT."""
    rng = np.random.default_rng(0)
    n = 700
    x0 = rng.normal(size=n)
    data = {"x0": x0.astype(object)}
    for j in range(4):
        data[f"noise{j}"] = rng.normal(size=n).astype(object)
    data["label"] = np.where(x0 + 0.2 * rng.normal(size=n) > 0, "pos",
                             "neg").astype(object)
    model = RefGBT(label="label", num_trees=4,
                   template="benchmark_rank1").train(data)
    return data, model


def test_reference_oblique_model_carried_across_saves_and_loads(
        planted_rank1, tmp_path):
    data, want = planted_rank1
    assert want.forest.has_oblique()
    arrays = {k: getattr(want.forest, k) for k in ARRAYS}
    arrays.update(depth=want.forest.depth, out_dim=want.forest.out_dim)
    got = convert.model_from_arrays(
        "gbt", arrays, spec_to_dict(want.spec), want.features,
        task=want.task, classes=want.classes, loss=want.loss.name)
    rows = {k: v for k, v in data.items() if k != "label"}
    for engine in ("ref", "vectorized", "naive"):
        np.testing.assert_array_equal(
            got.predict(rows, engine=engine, device="cpu"), want.predict(rows),
            err_msg=engine)
    vi = got.variable_importances()
    assert vi == want.variable_importances()
    assert sum(vi["NUM_NODES"].values()) > 0
    assert sum(vi["NUM_AS_ROOT"].values()) > 0
    path = str(tmp_path / "m")
    got.save(path)
    back = Model.load(path)
    for k in ("obl_weights", "obl_features"):
        np.testing.assert_array_equal(getattr(back.forest, k),
                                      getattr(got.forest, k))
    np.testing.assert_array_equal(back.predict(rows, device="cpu"),
                                  want.predict(rows))
    assert back.summary() == got.summary()
    assert back.variable_importances() == vi


@pytest.mark.parametrize("obl", [
    dict(obl_weights=np.zeros((1, 3, 2), np.float32)),
    dict(obl_weights=np.zeros((1, 3, 2), np.float32),
         obl_features=np.zeros((1, 3, 3), np.int32)),
    dict(obl_weights=np.zeros((1, 3, 2), np.float32),
         obl_features=np.full((1, 3, 2), -1, np.int32)),
], ids=["one_of_two", "shapes_differ", "negative_column"])
def test_convert_checks_the_oblique_tables(obl):
    arrays = dict(feature=np.array([[-2, -1, -1]], np.int32),
                  threshold=np.zeros((1, 3), np.float32),
                  cat_mask=np.zeros((1, 3, 8), np.uint32),
                  left_child=np.array([[1, -1, -1]], np.int32),
                  leaf_value=np.zeros((1, 3, 1), np.float32),
                  n_nodes=np.array([3], np.int32), depth=1, **obl)
    with pytest.raises(YdfError, match="obl_"):
        convert.forest_from_arrays(arrays, ["a", "b"])


# ------------------------------------------------------------ checkpoints

@pytest.mark.parametrize("kind", ["gbt", "rf"])
def test_oblique_stop_and_resume_equals_uninterrupted(higgs_small, kind,
                                                      tmp_path):
    train, _ = higgs_small
    small = {k: v[:800] for k, v in train.items()}
    cls = GradientBoostedTreesLearner if kind == "gbt" else RandomForestLearner
    kw = dict(label="label", template="benchmark_rank1", num_trees=4,
              max_depth=5, seed=3, device="cpu")
    if kind == "rf":
        kw["tree_parallelism"] = 2
    clean = cls(**kw).train(small)
    calls = {"n": 0}
    stop = 2 if kind == "gbt" else 1      # RF polls once a block of 2 trees

    def cancel():
        calls["n"] += 1
        return calls["n"] >= stop
    ckdir = str(tmp_path / "ck")
    part = cls(**kw).train(small, checkpoint=CheckpointPolicy(
        ckdir, every_n_trees=1, cancel=cancel))
    assert part.training_logs["interrupted"]
    assert 0 < part.forest.n_trees < clean.forest.n_trees
    resumed = resume_training(ckdir, small, device="cpu")
    assert clean.forest.has_oblique()
    assert_forests_equal(resumed.forest, clean.forest, kind)
    np.testing.assert_array_equal(resumed.predict(small, device="cpu"),
                                  clean.predict(small, device="cpu"))


def test_rf_regression_with_oblique_splits_equals_reference():
    spec = SyntheticSpec("synth_reg", n=1200, n_num=6, n_cat=2, n_classes=0,
                         seed=4)
    train, _ = train_test_split(make_dataset(spec), 0.3, 4)
    kw = dict(label="label", split_axis="SPARSE_OBLIQUE", num_trees=3,
              max_depth=7)
    got = RandomForestLearner(task=Task.REGRESSION, device="cpu",
                              **kw).train(train)
    want = RefRF(task=RefTask.REGRESSION, **kw).train(train)
    assert got.forest.has_oblique()
    assert_forests_equal(got.forest, want.forest)
    assert got.self_evaluation.metrics == want.self_evaluation.metrics


def test_plan_of_counts_a_layouts_oblique_pairs():
    """The wrappers' plan holds the side table: a tree of many oblique
    nodes whose records alone would fit a block cannot be staged."""
    pf = chip_smoke.oblique_forest(128, seed=3, n_trees=2, n_splits=900)
    for lay in (ops.device_packed(pf, CPU).layout,
                ops.device_soa(pf, CPU).layout):
        group = lay.group or 1
        M = lay.max_nodes
        assert plan.table_bytes(group, M, 0) <= plan.SMEM_LIMIT
        assert plan.table_bytes(group, M, 0, lay.group_obl[0]) \
            > plan.SMEM_LIMIT
        assert forest_infer.plan_of(lay, 100).variant == "global"
        with pytest.raises(ValueError, match="oblique pairs"):
            forest_infer.plan_of(lay, 100, "staged")
    assert chip_smoke.plan_variants(pf, np.zeros((4, 24), np.float32),
                                    "tiled", CPU) == ("global",)
