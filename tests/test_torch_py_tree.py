"""The port's typed tree API (``repro_torch.core.py_tree``) against the JAX
package's (``repro.core.py_tree``), on the scenarios of
``tests/test_py_tree.py``.

Each scenario runs in both packages on the same inputs (the factory forests
of ``conftest._make_random_forest`` copied field for field into a port
Forest, or the same learner trained by both on ``adult_like``, whose CPU
forests are bit-identical), the port on ``device="cpu"``. Tolerance: none.
  * round trips: the port's ``from_trees(to_trees(f), like=f)`` equals
    ``f`` on every field, its typed trees equal the reference's node for
    node (``_node``), and its rebuilt forest equals the reference's;
  * the rejections raise ``YdfError`` with the reference's message;
  * built models predict ``array_equal`` with the reference's builds, on
    every engine of the CPU and through a serving bundle;
  * the inspector's stats, ``plot_tree`` text and ``summary(verbose=)``
    equal the reference's strings;
  * a forest carried across without ``split_bin`` (``convert``) reads as
    ``split_bin=0``, the reference's hand-written default, and round-trips;
  * ``build`` and the trained model's predictor raise without a card unless
    given ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import CartLearner as RefCart
from repro.core import GradientBoostedTreesLearner as RefGBT
from repro.core import RandomForestLearner as RefRF
from repro.core import py_tree as ref_pt
from repro.core.api import Task as RefTask
from repro.core.api import YdfError as RefYdfError
from repro.core.tree import Forest as RefForest
from repro.core.tree import predict_raw as ref_predict_raw
from repro_torch import convert
from repro_torch.core import CartLearner, GradientBoostedTreesLearner, \
    RandomForestLearner, Task, YdfError
from repro_torch.core import py_tree as pt
from repro_torch.core.models import _as_vertical, raw_matrix
from repro_torch.core.tree import Forest, predict_raw

FIELDS = ("feature", "threshold", "split_bin", "cat_mask", "left_child",
          "leaf_value", "n_nodes")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The CPU engines' small torch ops run on one thread: test workers
    share the host, and a thread pool per worker oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_forest_equal(a, b, tree_class: bool = True) -> None:
    """The reference test's field list (split_gain is not carried by typed
    trees in either package). ``tree_class=False`` skips that field: the
    port's trained RF and CART forests carry zeros where the reference's
    carry None."""
    for f in FIELDS:
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert a.depth == b.depth
    assert a.out_dim == b.out_dim
    if tree_class:
        assert (a.tree_class is None) == (b.tree_class is None)
        if a.tree_class is not None:
            assert np.array_equal(a.tree_class, b.tree_class)
    assert np.array_equal(a.init_pred, b.init_pred)
    assert a.feature_names == b.feature_names
    for f in ("obl_weights", "obl_features"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert np.array_equal(x, y), f


def to_port(f: RefForest) -> Forest:
    """The reference Forest copied field for field into a port Forest."""
    return Forest(**{k: (getattr(f, k).copy()
                         if isinstance(getattr(f, k), np.ndarray)
                         else getattr(f, k))
                     for k in Forest.__dataclass_fields__})


def _node(n):
    """A typed node (either package) as nested plain tuples."""
    if n.is_leaf:
        return ("Leaf", type(n.value).__name__,
                dataclasses.astuple(n.value))
    return ("NonLeaf", type(n.condition).__name__,
            dataclasses.astuple(n.condition),
            None if n.value is None else (type(n.value).__name__,
                                          dataclasses.astuple(n.value)),
            n.split_order, _node(n.neg_child), _node(n.pos_child))


def trees_key(trees) -> list:
    return [(_node(t.root), t.tree_class) for t in trees]


def assert_roundtrips_as_reference(ref_forest: RefForest, **kw) -> Forest:
    """Port and reference: the same typed trees, the same rebuilt forest,
    and the port's round trip equal to its input. Returns the rebuilt."""
    f = to_port(ref_forest)
    trees = f.to_trees(**kw)
    ref_trees = ref_forest.to_trees(**kw)
    assert trees_key(trees) == trees_key(ref_trees)
    back = Forest.from_trees(trees, like=f)
    assert_forest_equal(back, RefForest.from_trees(ref_trees, like=ref_forest))
    return back


def raises_like_reference(port_call, ref_call, match: str) -> None:
    with pytest.raises(RefYdfError, match=match) as ref_err:
        ref_call()
    with pytest.raises(YdfError, match=match) as err:
        port_call()
    assert str(err.value) == str(ref_err.value)


# ------------------------------------------------------------- round-trips

def test_roundtrip_factory_forests_bit_identical(random_forest_factory):
    rf = random_forest_factory(6, [9, 3, 17], 7, out_dim=3, seed=3,
                               cat_feats=(2, 5))
    assert_forest_equal(to_port(rf), assert_roundtrips_as_reference(rf))


@pytest.mark.parametrize("seed", range(5))
def test_roundtrip_property_sweep(random_forest_factory, seed):
    rf = random_forest_factory(4, [1 + seed, 2 * seed + 3], 5,
                               out_dim=1 + seed % 3, seed=seed,
                               cat_feats=(0,) if seed % 2 else ())
    assert_forest_equal(to_port(rf), assert_roundtrips_as_reference(rf))


def test_roundtrip_single_leaf_tree(random_forest_factory):
    rf = random_forest_factory(2, [0], 3)
    assert_forest_equal(to_port(rf), assert_roundtrips_as_reference(rf))


@pytest.fixture(scope="module")
def trained(tiny_adult):
    """RF, GBT, oblique RF and CART trained by both packages:
    name -> (port model, reference model)."""
    out = {}
    for name, port_cls, ref_cls, kw in (
            ("rf", RandomForestLearner, RefRF,
             dict(num_trees=5, max_depth=5, compute_oob=False)),
            ("gbt", GradientBoostedTreesLearner, RefGBT,
             dict(num_trees=4, max_depth=4)),
            ("oblique", RandomForestLearner, RefRF,
             dict(num_trees=4, max_depth=5, split_axis="SPARSE_OBLIQUE",
                  compute_oob=False)),
            ("cart", CartLearner, RefCart, dict(max_depth=8))):
        out[name] = (port_cls(label="income", device="cpu", **kw)
                     .train(tiny_adult),
                     ref_cls(label="income", **kw).train(tiny_adult))
    return out


@pytest.mark.parametrize("name", ["rf", "gbt", "oblique"])
def test_roundtrip_trained_forests(trained, name):
    got, ref = trained[name]
    gbt = name == "gbt"
    assert_forest_equal(got.forest, to_port(ref.forest), tree_class=gbt)
    assert_forest_equal(got.forest, assert_roundtrips_as_reference(ref.forest),
                        tree_class=gbt)
    f = got.forest
    assert_forest_equal(Forest.from_trees(f.to_trees(), like=f), f)
    assert trees_key(got.inspect().trees()) == \
        trees_key(ref.inspect().trees())
    if name == "oblique":
        assert got.forest.has_oblique()
        assert any(isinstance(n.condition, pt.Oblique)
                   for tr in got.forest.to_trees()
                   for n, _ in tr.iter_nodes() if not n.is_leaf)


def test_pruned_cart_roundtrip_semantics_then_idempotent(trained, tiny_adult):
    got, ref = trained["cart"]
    f = got.forest
    f2 = assert_roundtrips_as_reference(ref.forest)
    X = raw_matrix(_as_vertical(tiny_adult), got.features)
    np.testing.assert_array_equal(predict_raw(f, X), predict_raw(f2, X))
    np.testing.assert_array_equal(predict_raw(f2, X),
                                  ref_predict_raw(ref.forest, X))
    assert_forest_equal(f2, Forest.from_trees(f2.to_trees(), like=f2))


def test_roundtrip_without_like_is_semantically_equal(random_forest_factory):
    rf = random_forest_factory(3, [6, 2], 5, out_dim=2, seed=9, cat_feats=(1,))
    f = to_port(rf)
    f2 = Forest.from_trees(f.to_trees())
    assert_forest_equal(f2, RefForest.from_trees(rf.to_trees()))
    X = np.random.default_rng(0).normal(size=(50, 5)).astype(np.float32)
    X[:, 1] = np.random.default_rng(1).integers(0, 8, 50)
    np.testing.assert_array_equal(predict_raw(f, X), predict_raw(f2, X))


def _hand_tree(m):
    return m.Tree(root=m.NonLeaf(
        condition=m.NumericalHigherThan(feature=0, threshold=1.0),
        pos_child=m.Leaf(m.RegressionValue(2.0)),
        neg_child=m.NonLeaf(
            condition=m.NumericalHigherThan(feature=1, threshold=-1.0),
            pos_child=m.Leaf(m.RegressionValue(1.0)),
            neg_child=m.Leaf(m.RegressionValue(0.0)))))


def test_hand_written_trees_get_level_order_allocation():
    f = pt.forest_from_trees([_hand_tree(pt)])
    assert_forest_equal(f, ref_pt.forest_from_trees([_hand_tree(ref_pt)]))
    assert f.n_nodes[0] == 5 and f.depth == 2
    assert f.left_child[0, 0] == 1
    X = np.array([[2.0, 0.0], [0.0, 0.0], [0.0, -2.0]], np.float32)
    np.testing.assert_allclose(predict_raw(f, X)[:, 0, 0], [2.0, 1.0, 0.0])


def test_edit_that_deepens_tree_raises_traversal_bound(random_forest_factory):
    rf = random_forest_factory(1, [1], 2, seed=0)
    out = []
    for m, f in ((pt, to_port(rf)), (ref_pt, rf)):
        trees = f.to_trees()
        leaf = trees[0].root.pos_child
        assert leaf.is_leaf
        trees[0].root.pos_child = m.NonLeaf(
            condition=m.NumericalHigherThan(feature=1, threshold=0.0),
            pos_child=m.Leaf(m.RegressionValue(4.0)), neg_child=leaf)
        out.append(type(f).from_trees(trees, like=f, max_nodes=8))
    assert_forest_equal(*out)
    assert out[0].depth == 2
    X = np.full((1, 2), 10.0, np.float32)
    np.testing.assert_allclose(predict_raw(out[0], X)[:, 0, 0], [4.0])


def test_split_order_preserved_over_edit_roundtrip(random_forest_factory):
    rf = random_forest_factory(2, [8], 4, seed=5)
    out = []
    for m, f in ((pt, to_port(rf)), (ref_pt, rf)):
        trees = f.to_trees()
        node = trees[0].root
        while not node.is_leaf:
            node = node.pos_child
        node.value = m.RegressionValue(123.0)
        out.append(type(f).from_trees(trees, like=f))
    assert_forest_equal(*out)
    f, f2 = to_port(rf), out[0]
    assert not np.array_equal(f.leaf_value, f2.leaf_value)
    for fld in ("feature", "threshold", "left_child", "n_nodes"):
        assert np.array_equal(getattr(f, fld), getattr(f2, fld))


# ----------------------------------------------------- carried-across forests

def _carried(ref_forest: RefForest, with_split_bin: bool) -> Forest:
    arrays = {k: getattr(ref_forest, k) for k in (
        "feature", "threshold", "cat_mask", "left_child", "leaf_value",
        "n_nodes", "depth", "out_dim", "tree_class", "init_pred",
        "obl_weights", "obl_features")}
    if with_split_bin:
        arrays["split_bin"] = ref_forest.split_bin
    return convert.forest_from_arrays(arrays, ref_forest.feature_names)


def test_forest_carried_across_without_split_bin_reads_split_bin_zero(trained):
    """A forest from ``convert`` has no split_bin: its numerical conditions
    read as split_bin=0 (the reference's default for a hand-written
    condition), exactly what the reference gives once split_bin is zero."""
    _, ref = trained["gbt"]
    f = _carried(ref.forest, with_split_bin=False)
    assert f.split_bin is None
    trees = f.to_trees()
    conds = [n.condition for tr in trees for n, _ in tr.iter_nodes()
             if not n.is_leaf]
    assert conds and all(c.split_bin == 0 for c in conds
                         if isinstance(c, pt.NumericalHigherThan))
    zeroed = dataclasses.replace(
        ref.forest, split_bin=np.zeros_like(ref.forest.split_bin))
    assert trees_key(trees) == trees_key(zeroed.to_trees())
    back = Forest.from_trees(trees, like=f)
    assert not back.split_bin.any()
    for fld in FIELDS:
        if fld != "split_bin":
            assert np.array_equal(getattr(back, fld), getattr(f, fld)), fld
    X = np.random.default_rng(2).normal(size=(64, len(f.feature_names))
                                        ).astype(np.float32)
    np.testing.assert_array_equal(predict_raw(back, X), predict_raw(f, X))
    # with its split_bin carried, the forest round-trips bit for bit
    g = _carried(ref.forest, with_split_bin=True)
    assert_forest_equal(Forest.from_trees(g.to_trees(), like=g), g)


def test_inspector_on_a_model_carried_without_split_bin(trained):
    _, ref = trained["rf"]
    from repro.core.dataspec import spec_to_dict
    arrays = {k: getattr(ref.forest, k) for k in (
        "feature", "threshold", "cat_mask", "left_child", "leaf_value",
        "n_nodes", "depth", "out_dim", "init_pred")}
    m = convert.model_from_arrays("rf", arrays, spec_to_dict(ref.spec),
                                  ref.features, task="CLASSIFICATION",
                                  classes=ref.classes, winner_take_all=True)
    m.label = ref.label
    assert m.forest.split_bin is None
    assert m.inspect().plot_tree(0, max_depth=3) == \
        ref.inspect().plot_tree(0, max_depth=3)
    assert m.inspect().tree_stats() == ref.inspect().tree_stats()


# --------------------------------------------------------------- validation

def _one_split(m, cond, pos, neg):
    return m.Tree(root=m.NonLeaf(condition=cond, pos_child=m.Leaf(pos),
                                 neg_child=m.Leaf(neg)))


REJECTIONS = {
    "empty_categorical_set": (
        lambda m: [_one_split(m, m.CategoricalIsIn(feature=0, categories=()),
                              m.RegressionValue(1.0), m.RegressionValue(0.0))],
        {}, "empty category set"),
    "out_of_range_category": (
        lambda m: [_one_split(m, m.CategoricalIsIn(feature=0,
                                                   categories=(999,)),
                              m.RegressionValue(1.0), m.RegressionValue(0.0))],
        {}, r"\[0, 255\]"),
    "bad_feature_reference": (
        lambda m: [_one_split(m, m.NumericalHigherThan(feature=7,
                                                       threshold=0.0),
                              m.RegressionValue(1.0), m.RegressionValue(0.0))],
        {"feature_names": ["a", "b"]}, "only 2 input feature"),
    "node_budget": (
        lambda m: [_one_split(m, m.NumericalHigherThan(feature=0,
                                                       threshold=0.0),
                              m.RegressionValue(1.0), m.RegressionValue(0.0))],
        {"max_nodes": 1}, "node budget"),
    "leaf_dim_mismatch": (
        lambda m: [_one_split(m, m.NumericalHigherThan(feature=0,
                                                       threshold=0.0),
                              m.ProbabilityValue((0.5, 0.5)),
                              m.RegressionValue(0.0))],
        {}, "dimension"),
    "shared_subtrees": (
        lambda m: [(lambda shared: m.Tree(root=m.NonLeaf(
            condition=m.NumericalHigherThan(feature=0, threshold=0.0),
            pos_child=shared, neg_child=shared)))(
                m.Leaf(m.RegressionValue(1.0)))],
        {}, "not DAGs"),
    "oblique_arity_mismatch": (
        lambda m: [_one_split(m, m.Oblique(features=(0, 1), weights=(1.0,),
                                           threshold=0.0),
                              m.RegressionValue(1.0), m.RegressionValue(0.0))],
        {}, "weight"),
}


@pytest.mark.parametrize("case", sorted(REJECTIONS))
def test_from_trees_rejections_match_the_reference(case):
    make, kw, match = REJECTIONS[case]
    raises_like_reference(lambda: pt.forest_from_trees(make(pt), **kw),
                          lambda: ref_pt.forest_from_trees(make(ref_pt), **kw),
                          match)


# ------------------------------------------------------------------ builder

def _rf_builder(m, task_enum):
    return m.RandomForestBuilder(
        label="y", task=task_enum.CLASSIFICATION, classes=["no", "yes"],
        features=["age", ("color", "CATEGORICAL", ["red", "blue"])])


def _cat_tree(m):
    return m.NonLeaf(
        condition=m.CategoricalIsIn(feature=1, categories=("red",)),
        pos_child=m.Leaf(m.ProbabilityValue((0.2, 0.8))),
        neg_child=m.NonLeaf(
            condition=m.NumericalHigherThan(feature=0, threshold=30.0),
            pos_child=m.Leaf(m.ProbabilityValue((0.5, 0.5))),
            neg_child=m.Leaf(m.ProbabilityValue((0.9, 0.1)))))


@pytest.fixture(scope="module")
def built():
    """The categorical RandomForestBuilder model, built by both packages."""
    b = _rf_builder(pt, Task)
    b.add_tree(_cat_tree(pt))
    rb = _rf_builder(ref_pt, RefTask)
    rb.add_tree(_cat_tree(ref_pt))
    return b.build(device="cpu"), rb.build()


def test_builder_end_to_end_with_categorical_strings(built):
    model, ref = built
    assert_forest_equal(model.forest, to_port(ref.forest))
    batch = {"age": [25, 40, 10], "color": ["red", "blue", "blue"]}
    p = model.predict(batch, device="cpu")
    np.testing.assert_array_equal(p, ref.predict(batch))
    np.testing.assert_allclose(p, [[0.2, 0.8], [0.5, 0.5], [0.9, 0.1]],
                               atol=1e-6)
    missing = {"age": [None], "color": [None]}
    np.testing.assert_array_equal(model.predict(missing, device="cpu"),
                                  ref.predict(missing))
    np.testing.assert_allclose(model.predict(missing, device="cpu"),
                               [[0.2, 0.8]], atol=1e-6)
    assert model.predict_class({"age": [25], "color": ["red"]},
                               device="cpu")[0] == 1


def test_builder_model_serves_through_engines_and_bundle(built):
    from repro_torch.core.engines import available_engines
    from repro_torch.serving.forest import make_forest_server
    model, ref = built
    batch = {"age": [10, 50, 31, None], "color": ["red", "blue", None, "x"]}
    want = ref.predict(batch)
    engines = available_engines("cpu", model.forest)
    assert {"ref", "bucketed", "leaf_path", "vectorized", "naive"} <= \
        set(engines)
    for engine in engines:
        np.testing.assert_array_equal(
            model.predict(batch, engine=engine, device="cpu"), want)
    bundle = make_forest_server(model, "vectorized", device="cpu")
    np.testing.assert_array_equal(bundle.predict(batch), want)


def test_builder_validates_probability_sums():
    b, rb = _rf_builder(pt, Task), _rf_builder(ref_pt, RefTask)
    b.add_tree(pt.Leaf(pt.ProbabilityValue((0.9, 0.9))))
    rb.add_tree(ref_pt.Leaf(ref_pt.ProbabilityValue((0.9, 0.9))))
    raises_like_reference(lambda: b.build(device="cpu"), rb.build, "sums to")


def test_builder_requires_classes_for_classification():
    raises_like_reference(
        lambda: pt.RandomForestBuilder(label="y", features=["a"],
                                       classes=None),
        lambda: ref_pt.RandomForestBuilder(label="y", features=["a"],
                                           classes=None), "classes")


def test_builder_rejects_unknown_category_string():
    out = []
    for m, task_enum in ((pt, Task), (ref_pt, RefTask)):
        b = _rf_builder(m, task_enum)
        b.add_tree(m.NonLeaf(
            condition=m.CategoricalIsIn(feature=1, categories=("green",)),
            pos_child=m.Leaf(m.ProbabilityValue((0.5, 0.5))),
            neg_child=m.Leaf(m.ProbabilityValue((0.5, 0.5)))))
        out.append(b)
    raises_like_reference(lambda: out[0].build(device="cpu"), out[1].build,
                          "green")


def test_cart_builder_single_tree_only():
    out = []
    for m, task_enum in ((pt, Task), (ref_pt, RefTask)):
        b = m.CartBuilder(label="y", task=task_enum.REGRESSION, features=["x"])
        b.add_tree(m.Leaf(m.RegressionValue(1.0)))
        b.add_tree(m.Leaf(m.RegressionValue(2.0)))
        out.append(b)
    raises_like_reference(lambda: out[0].build(device="cpu"), out[1].build,
                          "exactly one")


def _gbt_builders(m, task_enum, classes, **kw):
    return m.GradientBoostedTreesBuilder(
        label="y", task=task_enum.CLASSIFICATION, classes=classes,
        features=["x"], **kw)


def test_gbt_builder_binary_and_multiclass():
    models = []
    for m, task_enum in ((pt, Task), (ref_pt, RefTask)):
        b = _gbt_builders(m, task_enum, ["a", "b"], init_pred=[0.5])
        b.add_tree(m.NonLeaf(
            condition=m.NumericalHigherThan(feature=0, threshold=0.0),
            pos_child=m.Leaf(m.LogitValue(1.0)),
            neg_child=m.Leaf(m.LogitValue(-1.0))))
        models.append(b.build(device="cpu") if m is pt else b.build())
    x = {"x": [2.0, -2.0, 0.0]}
    p = models[0].predict(x, device="cpu")
    np.testing.assert_array_equal(p, models[1].predict(x))
    sig = 1 / (1 + np.exp(-(0.5 + np.array([1.0, -1.0]))))
    np.testing.assert_allclose(p[:2, 1], sig, atol=1e-6)

    b3s = [_gbt_builders(m, task_enum, ["a", "b", "c"])
           for m, task_enum in ((pt, Task), (ref_pt, RefTask))]
    b3s[0].add_tree(pt.Leaf(pt.LogitValue(0.0)))
    b3s[1].add_tree(ref_pt.Leaf(ref_pt.LogitValue(0.0)))
    raises_like_reference(lambda: b3s[0].build(device="cpu"), b3s[1].build,
                          "tree_class")
    for b3, m in zip(b3s, (pt, ref_pt)):
        b3.trees.clear()
        for k in range(3):
            b3.add_tree(m.Leaf(m.LogitValue(float(k))), tree_class=k)
    p3 = b3s[0].build(device="cpu").predict({"x": [0.0]}, device="cpu")
    np.testing.assert_array_equal(p3, b3s[1].build().predict({"x": [0.0]}))
    z = np.array([0.0, 1.0, 2.0])
    np.testing.assert_allclose(p3[0], np.exp(z) / np.exp(z).sum(), atol=1e-6)


def test_builder_needs_a_card_unless_given_the_cpu(built):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without a card")
    b = _rf_builder(pt, Task)
    b.add_tree(_cat_tree(pt))
    with pytest.raises(YdfError, match="device='cpu'"):
        b.build()
    g = _gbt_builders(pt, Task, ["a", "b"])
    g.add_tree(pt.Leaf(pt.LogitValue(0.0)))
    with pytest.raises(YdfError, match="device='cpu'"):
        g.build()
    with pytest.raises(YdfError, match="device='cpu'"):
        built[0].predict({"age": [1], "color": ["red"]})


# ---------------------------------------------------------------- inspector

def test_inspector_stats_and_render(tiny_adult):
    kw = dict(num_trees=3, max_depth=4, compute_oob=False)
    m = RandomForestLearner(label="income", device="cpu", **kw).train(tiny_adult)
    ref = RefRF(label="income", **kw).train(tiny_adult)
    insp, ref_insp = m.inspect(), ref.inspect()
    stats = insp.tree_stats()
    assert stats == ref_insp.tree_stats()
    assert insp.stats_summary() == ref_insp.stats_summary()
    assert len(stats) == 3
    for s in stats:
        assert s["n_nodes"] == 2 * s["n_leaves"] - 1
        assert s["depth"] <= 4
    for i in range(3):
        for depth in (2, 3, 8):
            assert insp.plot_tree(i, max_depth=depth) == \
                ref_insp.plot_tree(i, max_depth=depth)
    art = insp.plot_tree(0, max_depth=3)
    assert "(pos)" in art and "(neg)" in art
    assert any(f'"{f}"' in art for f in m.features)
    for verbose in (True, 2, 5):
        assert m.summary(verbose=verbose) == ref.summary(verbose=verbose)
    assert "Tree depths:" in m.summary(verbose=2)
    assert insp.tree(0).n_leaves >= 2
    raises_like_reference(lambda: insp.tree(99), lambda: ref_insp.tree(99),
                          "out of range")


def test_inspector_value_kinds(trained):
    got, ref = trained["gbt"]
    leaf = got.inspect().tree(0).leaves()[0]
    assert isinstance(leaf.value, pt.LogitValue)
    assert trees_key(got.inspect().trees()) == trees_key(ref.inspect().trees())
    assert got.summary(verbose=True) == ref.summary(verbose=True)


def test_to_trees_value_kind_matches_leaf_dim(random_forest_factory):
    f = random_forest_factory(1, [2], 3, out_dim=2)
    assert isinstance(pt.forest_to_trees(to_port(f))[0].leaves()[0].value,
                      pt.ProbabilityValue)
    f1 = random_forest_factory(1, [2], 3, out_dim=1)
    assert isinstance(pt.forest_to_trees(to_port(f1))[0].leaves()[0].value,
                      pt.RegressionValue)
    for kind in ("probability", "regression", "logit"):
        assert trees_key(to_port(f).to_trees(value_kind=kind)) == \
            trees_key(f.to_trees(value_kind=kind))
    raises_like_reference(lambda: pt.value_from_vector([1.0], "bogus"),
                          lambda: ref_pt.value_from_vector([1.0], "bogus"),
                          "leaf-value kind")
