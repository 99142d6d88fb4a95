"""The port's depth-bucketed traversal against the JAX package's, bit for bit.

The same numpy inputs go through the reference (``repro.core.tree``'s
``pack_depth_buckets`` and ``repro.kernels.forest_infer.ops.
forest_predict_bucketed``, XLA on the CPU) and through the port
(``repro_torch.core.tree.pack_depth_buckets`` and ``ops.
forest_predict_bucketed``, PyTorch on the CPU). Reference forests cross to
the port as plain arrays (``convert.forest_from_arrays``). Tolerance:
none (``np.array_equal``), the reference's contract for every traversal
strategy (DESIGN.md §10.5); hostile inputs (NaN, +-inf, 3e38 in numerical
and categorical columns) included.

Also here, in port form, the reference's pins of the engine layer
(``tests/test_traversal_strategies.py``): the selection rules, the bucket
plan, the engine gates, ``CompiledPredictor`` pickling, and
``benchmark_inference``; and the serving bundle's ``warm_ladder`` and
``predict_encoded_bulk``.
"""
from __future__ import annotations

import pickle

import numpy as np
import pytest
import torch

from repro.core.tree import pack_depth_buckets as ref_pack_depth_buckets
from repro.kernels.forest_infer.ops import (
    forest_predict_bucketed as ref_forest_predict_bucketed,
)
from repro_torch import convert
from repro_torch.core import engines
from repro_torch.core.api import EngineFailure, Task, YdfError
from repro_torch.core.engines import (
    BUCKETED_MIN_WORK,
    available_engines,
    benchmark_inference,
    compile_predictor,
    select_cpu_engine,
)
from repro_torch.core.tree import (
    LEAF_PATH_BUDGET,
    leaf_path_sizes,
    pack_depth_buckets,
    plan_depth_buckets,
    predict_naive,
    select_block_strategy,
    tree_depths,
)
from repro_torch.kernels.forest_infer import bucketed, ops
from repro_torch.serving.forest import ForestServeBundle, make_forest_server

from conftest import _make_random_forest
from test_traversal_strategies import _inputs_for

CPU = torch.device("cpu")
FIELDS = ("feature", "threshold", "cat_mask", "left_child", "leaf_value",
          "n_nodes", "depth", "tree_class", "init_pred", "out_dim")
ZOO = ("depth_skewed_forest", "stump_forest", "all_categorical_forest",
       "ragged_mixed_forest")
CAT_FEATS = {"all_categorical_forest": (0, 1, 2, 3),
             "ragged_mixed_forest": (2, 5)}
STRATEGIES = (None, "scan", "leaf_path")


@pytest.fixture(scope="module")
def ragged_mixed_forest():
    """Mixed depths, 3-wide leaves and two categorical columns."""
    return _make_random_forest(15, [0, 1, 4, 9, 6], 7, out_dim=3, seed=31,
                               cat_feats=(2, 5))


def to_port(forest):
    """The reference Forest's fields, carried across as plain arrays."""
    return convert.forest_from_arrays(
        {k: getattr(forest, k) for k in FIELDS}, forest.feature_names)


def _zoo(request, name):
    return request.getfixturevalue(name)


# ------------------------------------------------------------ the layout

@pytest.mark.parametrize("matmul_cheap", [False, True],
                         ids=["cpu_cost", "matmul_cheap"])
@pytest.mark.parametrize("strategy", STRATEGIES, ids=["auto", "scan",
                                                      "leaf_path"])
@pytest.mark.parametrize("name", ZOO)
def test_pack_depth_buckets_matches_reference(request, name, strategy,
                                              matmul_cheap):
    ref_f = _zoo(request, name)
    want = ref_pack_depth_buckets(ref_f, strategy=strategy,
                                  matmul_cheap=matmul_cheap)
    got = pack_depth_buckets(to_port(ref_f), strategy=strategy,
                             matmul_cheap=matmul_cheap)
    assert np.array_equal(got.inv_order, want.inv_order)
    assert (got.n_trees, got.out_dim) == (want.n_trees, want.out_dim)
    assert len(got.buckets) == len(want.buckets)
    for gb, wb in zip(got.buckets, want.buckets):
        assert (gb.depth, gb.strategy) == (wb.depth, wb.strategy)
        assert np.array_equal(gb.trees, wb.trees)
        assert gb.tables.keys() == wb.tables.keys()
        for key, w in wb.tables.items():
            g = gb.tables[key]
            assert np.asarray(g).dtype == np.asarray(w).dtype, key
            assert np.array_equal(g, w), key


def test_pack_depth_buckets_layout(depth_skewed_forest):
    """The reference's layout pin, on the port."""
    f = to_port(depth_skewed_forest)
    bf = pack_depth_buckets(f)
    assert [b.depth for b in bf.buckets] == [2, 12]   # per-bucket early exit
    assert all(b.strategy == "scan" for b in bf.buckets)
    lp = pack_depth_buckets(f, strategy="leaf_path")
    assert all(b.strategy == "leaf_path" for b in lp.buckets)
    order = np.concatenate([b.trees for b in bf.buckets])
    assert np.array_equal(order[bf.inv_order], np.arange(f.n_trees))


def test_pack_depth_buckets_refuses_oblique_forests():
    from repro_torch.core.tree import empty_forest
    f = empty_forest(2, 3, 1, oblique_dims=2)
    f.feature[0, 0], f.left_child[0, 0], f.n_nodes[0] = -2, 1, 3
    f.obl_weights[0, 0] = [1.0, -1.0]
    with pytest.raises(ValueError, match="oblique"):
        pack_depth_buckets(f)


# ----------------------------------------------------- the traversal

@pytest.mark.parametrize("strategy", STRATEGIES, ids=["auto", "scan",
                                                      "leaf_path"])
@pytest.mark.parametrize("name", ZOO)
def test_forest_predict_bucketed_matches_reference(request, name, strategy):
    ref_f = _zoo(request, name)
    pf = to_port(ref_f)
    X = _inputs_for(ref_f, 64, cat_feats=CAT_FEATS.get(name, ()))
    want = np.asarray(ref_forest_predict_bucketed(ref_f, X, strategy))
    got = ops.forest_predict_bucketed(pf, X, strategy, CPU)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.array_equal(got, want)
    assert np.array_equal(got, predict_naive(pf, X))


@pytest.mark.parametrize("strategy", STRATEGIES, ids=["auto", "scan",
                                                      "leaf_path"])
@pytest.mark.parametrize("n", [0, 1])
def test_zero_and_one_row_batches(depth_skewed_forest, strategy, n):
    pf = to_port(depth_skewed_forest)
    X = _inputs_for(depth_skewed_forest, n)
    got = ops.forest_predict_bucketed(pf, X, strategy, CPU)
    assert got.shape == (n, pf.n_trees, 1)
    assert np.array_equal(got, np.asarray(
        ref_forest_predict_bucketed(depth_skewed_forest, X, strategy)))
    assert np.array_equal(got, predict_naive(pf, X))


def test_leaf_path_row_chunks_give_the_same_bits(ragged_mixed_forest,
                                                 monkeypatch):
    """A bulk batch over a wide bucket runs in row chunks: same output."""
    pf = to_port(ragged_mixed_forest)
    X = _inputs_for(ragged_mixed_forest, 200, cat_feats=(2, 5))
    whole = ops.forest_predict_bucketed(pf, X, "leaf_path", CPU)
    monkeypatch.setattr(bucketed, "LEAF_PATH_CHUNK_ELEMS", 1000)
    runner = bucketed.build_bucketed_runner(
        pack_depth_buckets(pf, strategy="leaf_path"), CPU)
    assert np.array_equal(runner(X), whole)
    assert np.array_equal(whole, predict_naive(pf, X))


def test_too_narrow_request_raises_before_running(depth_skewed_forest):
    pf = to_port(depth_skewed_forest)
    with pytest.raises(YdfError, match=r"needs \(N, >= 6\) columns"):
        ops.forest_predict_bucketed(pf, np.zeros((4, 5), np.float32),
                                    None, CPU)


def test_a_failed_run_is_an_engine_failure_naming_the_engine(
        stump_forest, monkeypatch):
    pf = to_port(stump_forest)

    def broken(*args, **kwargs):
        raise RuntimeError("gather failed")

    monkeypatch.setattr(bucketed, "_run", broken)
    for strategy, name in ((None, "bucketed"), ("leaf_path", "leaf_path")):
        with pytest.raises(EngineFailure) as info:
            ops.forest_predict_bucketed(pf, np.zeros((3, 4), np.float32),
                                        strategy, CPU)
        assert info.value.engine == name and not info.value.transient


def test_cuda_request_raises_without_a_card(stump_forest, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.forest_predict_bucketed(to_port(stump_forest),
                                    np.zeros((3, 4), np.float32), None,
                                    "cuda")


# ---------------------------------------- trained models through every engine

def _port_models(tiny_adult):
    from repro_torch.core.cart import CartLearner
    from repro_torch.core.gbt import GradientBoostedTreesLearner
    from repro_torch.core.rf import RandomForestLearner
    out = []
    for fam, learner in (("rf", RandomForestLearner),
                         ("gbt", GradientBoostedTreesLearner),
                         ("cart", CartLearner)):
        kw = {} if fam == "cart" else {"num_trees": 6}
        out.append((f"{fam}_cls", learner(label="income", device="cpu",
                                          **kw).train(tiny_adult)))
        out.append((f"{fam}_reg", learner(label="age", task=Task.REGRESSION,
                                          device="cpu", **kw)
                    .train(tiny_adult)))
    return out


@pytest.fixture(scope="module")
def port_models(tiny_adult):
    return _port_models(tiny_adult)


def test_trained_models_bit_identical_through_every_engine(port_models,
                                                           tiny_adult):
    """RF/GBT/CART x classification/regression, trained by the port: every
    engine's per-tree outputs and predictions equal ``predict_naive``'s,
    and the bucketed traversal equals the reference's on the same forest."""
    from repro.core.tree import Forest as RefForest
    for name, model in port_models:
        f = model.forest
        base = compile_predictor(model, "naive", device=CPU)
        X = base.encode(tiny_adult)[:80]
        want = predict_naive(f, X)
        want_pred = base.predict_encoded(X)
        names = available_engines(CPU, f)
        assert {"bucketed", "vectorized", "naive", "ref"} <= set(names)
        for engine in names:
            pred = compile_predictor(model, engine, device=CPU)
            assert pred.name == engine
            assert np.array_equal(pred.per_tree(X), want), (name, engine)
            assert np.array_equal(pred.predict_encoded(X), want_pred), \
                (name, engine)
        ref_f = RefForest(**{k: getattr(f, k) for k in FIELDS},
                          split_bin=f.split_bin,
                          feature_names=list(f.feature_names))
        for strategy in STRATEGIES:
            i, l = leaf_path_sizes(f)
            if strategy == "leaf_path" and i * l > LEAF_PATH_BUDGET:
                continue
            assert np.array_equal(
                ops.forest_predict_bucketed(f, X, strategy, CPU),
                np.asarray(ref_forest_predict_bucketed(ref_f, X, strategy)))


def test_task_models_bit_identical_through_the_bucketed_engines():
    """Ranking, uplift and isolation models serve bit for bit through both
    bucketed engines (the reference's ``test_task_model_matrix``)."""
    from repro_torch.core.gbt import GradientBoostedTreesLearner
    from repro_torch.data.tabular import (grouped_relevance, planted_anomaly,
                                          randomized_treatment)
    from repro_torch.tasks import IsolationForestLearner, UpliftTreesLearner
    ds_r = grouped_relevance(n_groups=30, seed=7)
    ds_u = randomized_treatment(n=400, seed=11)
    ds_a = planted_anomaly(n_inlier=150, n_anomaly=8, seed=13)
    models = [
        (GradientBoostedTreesLearner(label="rel", task=Task.RANKING,
                                     num_trees=6, seed=1, device="cpu")
         .train(ds_r), ds_r),
        (UpliftTreesLearner(label="outcome", num_trees=4, seed=2,
                            device="cpu").train(ds_u), ds_u),
        (IsolationForestLearner(label="anomaly", num_trees=6, seed=3,
                                device="cpu").train(ds_a), ds_a),
    ]
    for model, data in models:
        base = compile_predictor(model, "naive", device=CPU)
        X = base.encode(data)[:80]
        want = base.predict_encoded(X)
        for engine in ("bucketed", "leaf_path"):
            got = compile_predictor(model, engine, device=CPU)
            assert np.array_equal(got.per_tree(X), predict_naive(model.forest,
                                                                 X))
            assert np.array_equal(got.predict_encoded(X), want)


# --------------------------------------------- the reference's pins, ported

def test_select_cpu_engine_pins():
    shallow = to_port(_make_random_forest(8, [3], 4, seed=1, chain=True))
    deep = to_port(_make_random_forest(40, [12], 4, seed=2, chain=True))
    mixed = to_port(_make_random_forest(30, [2, 12], 4, seed=3, chain=True))
    assert select_cpu_engine(shallow) == "vectorized"
    assert select_cpu_engine(deep) == "bucketed"
    assert select_cpu_engine(mixed) == "bucketed"
    assert 8 * 3 < BUCKETED_MIN_WORK <= 40 * 12


def test_select_block_strategy_pins():
    for depth in (0, 1, 2, 6, 12):
        assert select_block_strategy(depth, 2 ** max(1, depth) - 1,
                                     2 ** max(1, depth)) == "scan"
    assert select_block_strategy(2, 3, 4, matmul_cheap=True) == "leaf_path"
    assert select_block_strategy(6, 63, 64, matmul_cheap=True) == "leaf_path"
    assert select_block_strategy(12, 4095, 4096, matmul_cheap=True) == "scan"
    assert select_block_strategy(4, 200, 200, matmul_cheap=True) == "scan"


def test_plan_depth_buckets_partition_and_bounds():
    depths = np.array([2] * 12 + [12] * 12 + [5] * 3 + [0] * 2)
    buckets = plan_depth_buckets(depths)
    assert 1 <= len(buckets) <= 4
    assert all(len(b) >= 8 for b in buckets)
    assert np.array_equal(np.sort(np.concatenate(buckets)),
                          np.arange(len(depths)))
    ceilings = [depths[b].max() for b in buckets]
    assert ceilings == sorted(ceilings)
    assert plan_depth_buckets(np.zeros(0, np.int32)) == []


def test_available_engines_gates():
    shallow = to_port(_make_random_forest(6, [2], 4, seed=7))
    assert available_engines(CPU, shallow) == [
        "ref", "bucketed", "leaf_path", "vectorized", "naive"]
    big = to_port(_make_random_forest(2, [400], 4, seed=8))
    names = available_engines(CPU, big)
    assert "leaf_path" not in names and "bucketed" in names
    # without a forest only the engines every forest has
    assert available_engines(CPU) == ["ref", "vectorized", "naive"]
    assert max(tree_depths(shallow)) <= 2


def test_incompatible_engines_raise_naming_the_compatible_ones(tiny_adult):
    from repro_torch.core.gbt import GradientBoostedTreesLearner
    model = GradientBoostedTreesLearner(
        label="income", num_trees=2, split_axis="SPARSE_OBLIQUE",
        device="cpu").train(tiny_adult)
    assert model.forest.has_oblique()
    assert available_engines(CPU, model.forest) == ["ref", "vectorized",
                                                    "naive"]
    for engine in ("bucketed", "leaf_path"):
        with pytest.raises(YdfError, match=(
                rf"not compatible with the '{engine}' engine: oblique.*"
                r"Compatible engines: \['ref', 'vectorized', 'naive'\]")):
            compile_predictor(model, engine, device=CPU)
    big = _make_random_forest(2, [400], 4, seed=8)
    holder = type("M", (), {"forest": to_port(big)})()
    with pytest.raises(YdfError, match="predicate matrix"):
        engines.compile_model(holder, "leaf_path", CPU)


# ------------------------------------------------------ predictor pickling

def test_compiled_predictor_pickle_round_trip(tiny_adult):
    from repro_torch.core.rf import RandomForestLearner
    model = RandomForestLearner(label="income", num_trees=5, max_depth=6,
                                device="cpu").train(tiny_adult)
    for engine in ("vectorized", "ref", "bucketed"):
        pred = compile_predictor(model, engine, device=CPU)
        clone = pickle.loads(pickle.dumps(pred))
        # the CHOSEN engine survives, not a fresh default
        assert clone.name == pred.name == engine
        assert clone.engine.device == CPU
        X = pred.encode(tiny_adult)[:40]
        assert np.array_equal(clone.predict_encoded(X),
                              pred.predict_encoded(X))
        assert clone.out_shape == pred.out_shape


def test_engine_auto_pickle_keeps_choice(tiny_adult):
    from repro_torch.core.gbt import GradientBoostedTreesLearner
    model = GradientBoostedTreesLearner(label="income", num_trees=4,
                                        device="cpu").train(tiny_adult)
    pred = compile_predictor(model, device=CPU)
    clone = pickle.loads(pickle.dumps(pred))
    assert clone.name == pred.name == "ref"


def test_predictor_pickled_for_the_card_raises_without_one(tiny_adult,
                                                           monkeypatch):
    from repro_torch.core.gbt import GradientBoostedTreesLearner
    model = GradientBoostedTreesLearner(label="income", num_trees=2,
                                        device="cpu").train(tiny_adult)
    pred = compile_predictor(model, "bucketed", device=CPU)
    pred.engine.device = torch.device("cuda")   # as compiled on the card
    blob = pickle.dumps(pred)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(YdfError, match="device='cpu'"):
        pickle.loads(blob)


# ---------------------------------------------------------- benchmark

def test_benchmark_inference_report(port_models, tiny_adult):
    _, gbt = port_models[2]
    rep = benchmark_inference(gbt, tiny_adult, repetitions=1, device=CPU)
    assert rep.startswith("benchmark_inference on cpu")
    assert "us/example" in rep and "compile" in rep
    listed = [ln.split()[0] for ln in rep.splitlines()[1:]]
    assert listed == available_engines(CPU, gbt.forest)
    assert {"ref", "bucketed", "vectorized", "naive"} <= set(listed)


# ------------------------------------------------- the serving bundle

class _Counting:
    """A predictor stand-in that records the batch sizes it is given."""

    def __init__(self, pred):
        self.pred, self.sizes = pred, []
        self.out_shape = pred.out_shape

    def encode(self, batch):
        return self.pred.encode(batch)

    def predict_encoded(self, X):
        self.sizes.append(len(X))
        return self.pred.predict_encoded(X)


@pytest.mark.parametrize("up_to, touched", [
    (None, [32, 64, 128, 256, 512, 1024]), (1024, [32, 64, 128, 256, 512,
                                                   1024]),
    (100, [32, 64, 128]), (1, [32]), (5000, [32, 64, 128, 256, 512, 1024])])
def test_warm_ladder_touches_the_ladder_up_to(port_models, up_to, touched):
    _, gbt = port_models[2]
    pred = _Counting(compile_predictor(gbt, "bucketed", device=CPU))
    bundle = ForestServeBundle(pred)
    assert bundle.warm_ladder(len(gbt.features), up_to=up_to) == touched
    assert pred.sizes == touched


def test_predict_encoded_bulk_equals_one_call_in_top_bucket_chunks(
        port_models, tiny_adult):
    _, gbt = port_models[2]
    inner = compile_predictor(gbt, "bucketed", device=CPU)
    X = np.concatenate([inner.encode(tiny_adult)] * 7)[:2_600]
    want = inner.predict_encoded(X)
    pred = _Counting(inner)
    bundle = ForestServeBundle(pred, buckets=(64, 256))
    got = bundle.predict_encoded_bulk(X, chunk_rows=1_000)   # -> 768 rows
    assert np.array_equal(got, want)
    assert pred.sizes == [768, 768, 768, 512]    # last: 296 rows padded
    pred.sizes.clear()
    assert np.array_equal(bundle.predict_encoded_bulk(X[:100]), want[:100])
    assert pred.sizes == [256]
    pred.sizes.clear()
    assert np.array_equal(bundle.predict_encoded_bulk(X[:600]), want[:600])
    assert pred.sizes == [256, 256, 256]         # default chunk: top bucket


def test_make_forest_server_on_the_bucketed_engine(port_models, tiny_adult):
    _, gbt = port_models[2]
    bundle = make_forest_server(gbt, "bucketed", device=CPU)
    assert bundle.predictor.name == "bucketed"
    feats = {k: v[:50] for k, v in tiny_adult.items() if k in gbt.features}
    assert np.array_equal(bundle.predict(feats),
                          gbt.predict(feats, engine="naive", device=CPU))
