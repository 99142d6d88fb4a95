"""The traversal kernels' node layout (``kernels/forest_infer/layout.py``)
and launch plan (``plan.py``), on the CPU.

The layout's plain walk is the function of both CUDA traversal kernels.
It is held bit for bit (``array_equal``; traversal selects leaves, so no
tolerance) to the port's table traversals (``forest_predict_packed_ref``,
``forest_predict_ref``), to the reference's ``predict_naive`` and, on
finite inputs of forests whose mask words float32 holds, to the JAX
package's Pallas kernels in interpret mode (``forest_predict_pallas_tiled``
through its ``impl="interpret"``, and ``forest_predict_pallas``). Inputs are
made with numpy from seeds; interpret-mode batches stay at 64 rows or
fewer.
"""
from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

from repro.core.tree import predict_naive as ref_predict_naive
from repro.kernels.forest_infer.forest_infer import (
    forest_predict_pallas as ref_forest_predict_pallas,
)
from repro.kernels.forest_infer.ops import forest_predict as ref_forest_predict
from repro_torch.core import tree as port_tree
from repro_torch.core.api import YdfError
from repro_torch.kernels.forest_infer import layout, ops, plan, ref

from conftest import _make_random_forest
from test_torch_forest_infer import ZOO, inputs, to_port

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def ragged_mixed_forest():
    """Mixed depths, 3-wide leaves and two categorical columns."""
    return _make_random_forest(15, [0, 1, 4, 9, 6], 7, out_dim=3, seed=31,
                               cat_feats=(2, 5))


def _exact_masks(forest):
    """The forest with every mask word cut to its low 24 bits, which the
    reference's single-tree kernel carries exactly through float32."""
    f = copy.deepcopy(forest)
    f.cat_mask = f.cat_mask & np.uint32(0x00FFFFFF)
    return f


def _walks(pf, X):
    """Both layouts' plain walks of X, with the table traversals they must
    equal: name -> (got, want) numpy arrays."""
    Xt = torch.from_numpy(np.ascontiguousarray(X, np.float32))
    packed = ops.device_packed(pf, CPU)
    soa = ops.device_soa(pf, CPU)
    table_packed = ref.forest_predict_packed_ref(Xt, *packed.tables)
    table_soa = ref.forest_predict_ref(Xt, *soa[:5], depth=int(pf.depth))
    return {
        "packed": (layout.walk(Xt, packed.layout), table_packed),
        "tree order": (layout.walk(Xt, packed.layout, tree_order=True),
                       table_packed[:, packed.inv_order]),
        "soa": (layout.walk(Xt, soa.layout), table_soa),
    }


def _assert_walks(pf, X, naive):
    for name, (got, want) in _walks(pf, X).items():
        assert got.dtype == torch.float32, name
        assert torch.equal(got, want), name
        if name != "packed":
            assert np.array_equal(got.numpy(), naive), name


# ------------------------------------------------------------------ walks

@pytest.mark.parametrize("hostile", [False, True])
@pytest.mark.parametrize("name", ZOO)
def test_walk_equals_table_traversals_and_predict_naive(request, name,
                                                        hostile):
    forest = request.getfixturevalue(name)
    X = inputs(forest, 96, seed=13, hostile=hostile)
    _assert_walks(to_port(forest), X, ref_predict_naive(forest, X))


@pytest.mark.parametrize("name", ZOO)
def test_walk_equals_the_interpret_mode_kernels(request, name):
    forest = _exact_masks(request.getfixturevalue(name))
    X = inputs(forest, 48, seed=17)
    pf = to_port(forest)
    Xt = torch.from_numpy(X)
    tiled = np.asarray(ref_forest_predict(forest, X, impl="interpret"))
    single = np.asarray(ref_forest_predict_pallas(
        X, forest.feature, forest.threshold, forest.cat_mask,
        forest.left_child, forest.leaf_value, depth=max(1, forest.depth),
        interpret=True))
    packed = ops.device_packed(pf, CPU).layout
    assert np.array_equal(layout.walk(Xt, packed, tree_order=True).numpy(),
                          tiled)
    assert np.array_equal(layout.walk(Xt, ops.device_soa(pf, CPU).layout)
                          .numpy(), single)


def _empty_mask_node(pf):
    """The forest with one categorical split's mask emptied: the node then
    compares the code column against its threshold, set to 2.5."""
    f = copy.deepcopy(pf)
    t, n = map(int, np.argwhere(f.cat_mask.any(-1) & (f.left_child >= 0))[0])
    f.cat_mask[t, n] = 0
    f.threshold[t, n] = 2.5
    return f, (t, n)


@pytest.mark.parametrize("learner", ["rf", "cart"])
def test_walk_on_trained_models(tiny_adult, learner):
    """The port's trained Random Forest and CART tree on the Adult-like
    columns (categorical splits), hostile rows included, and the same
    forest with one categorical node's mask emptied."""
    from repro_torch.core.cart import CartLearner
    from repro_torch.core.rf import RandomForestLearner
    if learner == "rf":
        m = RandomForestLearner(label="income", num_trees=4, max_depth=8,
                                device="cpu").train(tiny_adult)
    else:
        m = CartLearner(label="income", device="cpu").train(tiny_adult)
    pf = m.forest
    assert pf.cat_mask.any(), "no categorical split to exercise"
    X = inputs(pf, 80, seed=3, hostile=True)
    _assert_walks(pf, X, port_tree.predict_naive(pf, X))
    emptied, (t, n) = _empty_mask_node(pf)
    col = int(emptied.feature[t, n])
    X[:, col] = np.arange(len(X)) % 6          # codes on both sides of 2.5
    got = layout.walk(torch.from_numpy(X), ops.device_soa(emptied, CPU).layout)
    assert np.array_equal(got.numpy(), port_tree.predict_naive(emptied, X))
    rec = ops.device_soa(emptied, CPU).layout.records.view(
        emptied.n_trees, emptied.max_nodes, 4)[t, n]
    assert int(rec[0]) == col                  # numerical: column, not ~column
    assert rec[1:2].view(torch.float32).item() == 2.5


def test_walk_on_reference_trained_forest_matches_interpret_kernel(
        tiny_adult):
    """A Random Forest trained by the JAX package, carried across as plain
    arrays: the walks against the interpret-mode tiled kernel, which is
    exact on any mask word."""
    from repro.core import RandomForestLearner
    forest = RandomForestLearner(label="income", num_trees=2,
                                 max_depth=6).train(tiny_adult).forest
    X = inputs(forest, 32, seed=8)
    want = np.asarray(ref_forest_predict(forest, X, impl="interpret"))
    assert np.array_equal(want, ref_predict_naive(forest, X))
    _assert_walks(to_port(forest), X, want)


def test_records_carry_the_node_fields(ragged_mixed_forest):
    pf = to_port(ragged_mixed_forest)
    lay = ops.device_soa(pf, CPU).layout
    T, M = pf.feature.shape
    rec = lay.records.view(T, M, 4).numpy()
    is_cat = pf.cat_mask.any(-1) & (pf.left_child >= 0)
    col = np.maximum(pf.feature, 0)
    assert np.array_equal(rec[..., 0], np.where(is_cat, ~col, col))
    assert np.array_equal(rec[..., 2], pf.left_child)
    thr = rec[..., 1].view(np.float32)
    assert np.array_equal(thr[~is_cat], pf.threshold[~is_cat])
    assert np.array_equal(rec[..., 1][is_cat], np.arange(is_cat.sum()))
    words = lay.masks.numpy().view(np.uint32)
    assert np.array_equal(words[:is_cat.sum()], pf.cat_mask[is_cat])
    assert np.array_equal(lay.mask_start.numpy(),
                          np.concatenate([[0], np.cumsum(is_cat.sum(1))]))
    assert np.array_equal(rec[..., 3].ravel(), np.arange(T * M))   # O = 3
    assert lay.min_features == int(pf.feature[pf.left_child >= 0].max()) + 1


def test_single_output_records_hold_the_leaf_value(stump_forest):
    pf = to_port(stump_forest)
    lay = ops.device_soa(pf, CPU).layout
    leaf = lay.records[:, 3].contiguous().view(torch.float32)
    assert torch.equal(leaf, torch.from_numpy(pf.leaf_value.reshape(-1)))
    assert lay.masks.shape == (1, 8) and not lay.masks.any()   # none: a pad


# ------------------------------------------------------------- validation

def _tables(forest):
    soa = ops.device_soa(to_port(forest), CPU)
    return dict(zip(("feature", "threshold", "cat_mask", "left_child",
                     "leaf_value"), soa[:5]))


@pytest.mark.parametrize("field,bad,exc", [
    ("feature", lambda t: t.long(), TypeError),
    ("threshold", lambda t: t.double(), TypeError),
    ("cat_mask", lambda t: t[..., :4].contiguous(), ValueError),
    ("left_child", lambda t: t.t().contiguous(), ValueError),
    ("leaf_value", lambda t: t.transpose(0, 1), ValueError),
    ("threshold", lambda t: t.to("meta"), ValueError),
    ("leaf_value", lambda t: t[..., 0], ValueError),
    ("feature", lambda t: t[0], ValueError),
])
def test_build_rejects_bad_tables(all_categorical_forest, field, bad, exc):
    args = _tables(all_categorical_forest)
    args[field] = bad(args[field])
    with pytest.raises(exc):
        layout.build(**args, depth=3)


def test_build_rejects_children_outside_the_capacity(stump_forest):
    args = _tables(stump_forest)
    lc = args["left_child"].clone()
    lc[0, 0] = lc.shape[1] - 1
    args["left_child"] = lc
    with pytest.raises(YdfError, match="node capacity"):
        layout.build(**args, depth=1)


def test_build_takes_block_depth_iff_packed(stump_forest):
    packed = ops.device_packed(to_port(stump_forest), CPU)
    with pytest.raises(ValueError, match="block_depth"):
        layout.build(*packed.tables[:5])
    with pytest.raises(ValueError, match="block_depth"):
        layout.build(**_tables(stump_forest), block_depth=packed.block_depth)


def test_layout_is_immutable(stump_forest):
    lay = ops.device_soa(to_port(stump_forest), CPU).layout
    with pytest.raises(AttributeError):
        lay.depth = 5


# ------------------------------------------------------------------ plans

GBT = dict(B=38, TB=8, M=128)        # the default GBT, depth-packed


def test_plan_stages_the_default_gbt_blocks():
    for N in (32, 1024, 4096, 65_536):
        p = plan.tiled_plan(N, **GBT, block_masks=200)
        assert p.variant == "staged" and p.group == 8 and p.n_groups == 38
        assert p.smem == 8 * 129 * 16 + 200 * 32
        resident = min(8, plan.SMEM_PER_SM // (p.smem + 1024))
        assert p.blocks == 38 * p.chunks <= plan.SMS * resident   # one wave
    assert plan.tiled_plan(65_536, **GBT, block_masks=200).rows == 128


def test_plan_reads_the_rf_blocks_from_global_memory():
    """B2 over pack_by_depth's blocks of 8 Random Forest trees of 4,096
    nodes: 512 KB of records pass the block's shared memory."""
    p = plan.tiled_plan(10_000, B=2, TB=8, M=4096, block_masks=0)
    assert p.variant == "global" and p.smem == 0
    with pytest.raises(ValueError, match="shared bytes"):
        plan.tiled_plan(10_000, B=2, TB=8, M=4096, block_masks=0,
                        variant="staged")


def test_plan_boundary_of_one_staged_tree():
    """B4: the plan stages one tree while its records and masks fit
    STAGE_BUDGET (four blocks an SM); a mask more and it reads them from
    global memory in groups of ceil(8 / O) trees."""
    room = plan.STAGE_BUDGET - plan.table_bytes(1, 3000, 0)
    masks = room // plan.MASK_BYTES
    fits = plan.single_plan(100, 16, 3000, 2, (masks,) * 8)
    over = plan.single_plan(100, 16, 3000, 2, (masks + 1,) * 8)
    assert (fits.variant, fits.group) == ("staged", 1)
    assert fits.smem <= plan.STAGE_BUDGET < fits.smem + plan.MASK_BYTES
    assert over.variant == "global"
    assert over.group == 4 and over.n_groups == 4    # ceil(8 / O) trees
    assert plan.STAGE_BUDGET * 4 <= plan.SMEM_PER_SM


@pytest.mark.parametrize("M,variant", [(1024, "staged"), (3500, "staged"),
                                       (3600, "global"), (4096, "global"),
                                       (16_384, "global")])
def test_plan_single_tree_sizes(M, variant):
    assert plan.single_plan(10_000, 16, M, 2, (0,) * 8).variant == variant


@pytest.mark.parametrize("M,ok", [(4096, True), (14_500, True),
                                  (14_600, False), (16_384, False)])
def test_plan_forced_staging_up_to_the_block_limit(M, ok):
    """A forced "staged" takes up to the 232,448 bytes a block may have."""
    if ok:
        p = plan.single_plan(10_000, 16, M, 2, (0,) * 8, "staged")
        assert p.variant == "staged" and p.smem <= plan.SMEM_LIMIT
    else:
        with pytest.raises(ValueError, match="shared bytes"):
            plan.single_plan(10_000, 16, M, 2, (0,) * 8, "staged")


def test_plan_groups_gbt_trees_for_whole_sectors():
    p = plan.single_plan(4096, 300, 128, 1, (60,) * 8)
    assert (p.variant, p.group, p.n_groups) == ("staged", 8, 38)
    p3 = plan.single_plan(4096, 300, 128, 3, (60,) * 8)
    assert p3.group == 3                              # ceil(8 / 3)


def test_plan_tile_rows():
    """About TILE_PAIRS (example, tree) pairs a tile, a power of 2 within
    [MIN_TILE_ROWS, MAX_TILE_ROWS]; no tile of X takes shared bytes."""
    assert plan.tile_rows(8) == 128 and plan.tile_rows(4) == 256
    assert plan.tile_rows(3) == 512                      # 512 * 3 >= 1024
    assert plan.tile_rows(1) == 1024 == plan.MAX_TILE_ROWS
    assert plan.tile_rows(64) == plan.MIN_TILE_ROWS == 32
    p = plan.single_plan(1 << 20, 16, 4096, 2, (0,) * 8)
    assert (p.variant, p.smem, p.rows) == ("global", 0, 256)


def test_plan_never_asks_more_than_a_block_holds():
    rng = np.random.default_rng(3)
    for _ in range(400):
        N = int(rng.integers(0, 200_000))
        M = int(rng.integers(1, 20_000))
        masks = int(rng.integers(0, 8 * M))
        TB = int(rng.integers(1, 9))
        for p in (plan.tiled_plan(N, 5, TB, M, masks),
                  plan.single_plan(N, 40, M, int(rng.integers(1, 5)),
                                   tuple(sorted(rng.integers(0, M, 8))))):
            assert p.smem <= plan.SMEM_LIMIT == 232_448
            assert 1 <= p.chunks <= max(1, -(-N // p.rows))
            assert p.blocks == p.n_groups * p.chunks < 2 ** 31


def test_plan_grid_holds_more_than_65535_groups():
    p = plan.single_plan(64, 600_000, 8, 1, (2,) * 8)
    assert p.n_groups == 75_000 and p.blocks >= p.n_groups
    assert plan.tiled_plan(64, 70_000, 1, 128, 3).blocks == 70_000


def test_plan_rejects_unknown_variant():
    with pytest.raises(ValueError, match="unknown variant"):
        plan.tiled_plan(10, **GBT, block_masks=0, variant="fast")


# --------------------------------------------------------- forest_predict

def test_forest_predict_builds_the_layout_once_per_forest(
        ragged_mixed_forest, monkeypatch):
    builds = []
    real = layout.build

    def counting(*a, **k):
        builds.append(k.get("block_depth") is not None)
        return real(*a, **k)

    monkeypatch.setattr(layout, "build", counting)
    pf = to_port(ragged_mixed_forest)
    X = inputs(ragged_mixed_forest, 20)
    for _ in range(3):
        for impl in ("cuda", "single"):
            ops.forest_predict(pf, X, impl, CPU)
    assert sorted(builds) == [False, True]     # one SoA and one packed build


def test_cuda_impl_stores_tree_order_without_index_select(
        ragged_mixed_forest, monkeypatch):
    """The tree-order output equals the packed output taken by inv_order
    (the path before the store was fused), and nothing calls
    index_select."""
    pf = to_port(ragged_mixed_forest)
    X = inputs(ragged_mixed_forest, 40, seed=2, hostile=True)
    packed = ops.device_packed(pf, CPU)
    Xt = torch.from_numpy(X)
    before = torch.index_select(ref.forest_predict_packed_ref(
        Xt, *packed.tables), 1, packed.inv_order)

    def refuse(*a, **k):
        raise AssertionError("index_select on the traversal path")

    monkeypatch.setattr(torch, "index_select", refuse)
    got = ops.forest_predict(pf, X, "cuda", CPU)
    assert got.shape == (40, pf.n_trees, 3)
    assert torch.equal(got, before)
    assert np.array_equal(got.numpy(), port_tree.predict_naive(pf, X))
