"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``: each test needs an NVIDIA GPU with nvcc and skips without
one (the decision is made in a fixture, at run time). On the card:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Imports neither ``jax`` nor ``repro``, so it runs where only the port's
dependencies are installed. Tolerances: the traversal kernel none
(``torch.equal``) — it selects the same leaves as its plain version; the
split-search kernel the tie rule of ``chip_smoke.check_fused_case`` (gain
within REL_GAIN_EPS * |score(parent)| + 1e-6 * |gain| of the plain
version's, the same split wherever the plain runner-up is clearly below),
and the same bits over three launches; the histogram kernel the rule of
``chip_smoke.check_hist_case`` (the count channel equal, the rest within
rtol 1e-6 + 1e-6 * the stat's max |v|), and the same bits over launches;
the single-tree traversal kernel none (``torch.equal`` against its plain
version, ``array_equal`` against ``predict_naive``). A Random Forest and a
CART tree trained on the card equal the CPU's on every forest field (their
stats are integer counts, so every histogram cell is exact), with 26
classes too; the device engine's 26-class forest repeats its bits and
agrees with the CPU's on >= 99.5% of each structure field, as the device
engine's other card-against-CPU checks (its float32 entropy terms take the
card's ``logf`` and the CPU's ``torch.log``). Models trained on the card
predict the same bits after a save and a load, and a training stopped and
resumed on the card equals the uninterrupted card run on every Forest
field (no tolerance: the kernels' sums are exact, so card runs repeat).
Both traversal kernels serve sparse-oblique forests bit for bit with their
plain versions and the vectorized engine, whose projection sums follow
numpy's pairwise order as the kernels do. The tasks: an uplift forest
trained on the card equals the CPU's on every field; a LambdaMART GBT on
the batched engine too, but for ``split_gain``, within
``chip_smoke.GAIN_RTOL`` of the CPU's (its stats are float gradients,
which the histogram kernel's fixed-point sums round); the device engine's
LambdaMART repeats its bits and agrees on >= 99.5% of each structure
field; an isolation forest serves through both traversal kernels bit for
bit with ``predict_naive``.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda")


def _forest(n_trees, n_splits, n_features, out_dim, seed, cat_feats=()):
    """A random axis-aligned forest: each tree splits random leaves
    ``n_splits`` times, category masks over all 256 codes."""
    from repro_torch.core.tree import empty_forest
    rng = np.random.default_rng(seed)
    f = empty_forest(n_trees, 2 * n_splits + 1, out_dim,
                     feature_names=[f"f{j}" for j in range(n_features)])
    depth = 0
    for t in range(n_trees):
        f.leaf_value[t, 0] = rng.normal(size=out_dim)
        leaves, count = [(0, 0)], 1
        for _ in range(int(rng.integers(0, n_splits + 1))):
            node, d = leaves.pop(int(rng.integers(len(leaves))))
            j = int(rng.integers(n_features))
            f.feature[t, node] = j
            if j in cat_feats:
                mask = rng.integers(0, 2 ** 32, size=8, dtype=np.uint64)
                f.cat_mask[t, node] = mask.astype(np.uint32) | np.uint32(1)
            else:
                f.threshold[t, node] = rng.normal()
            f.left_child[t, node] = count
            f.leaf_value[t, count:count + 2] = rng.normal(size=(2, out_dim))
            leaves += [(count, d + 1), (count + 1, d + 1)]
            count += 2
            depth = max(depth, d + 1)
        f.n_nodes[t] = count
    f.depth = depth
    return f


def _hostile(n, F, seed, cat_feats=()):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, F)).astype(np.float32)
    for j in cat_feats:
        X[:, j] = rng.integers(-5, 300, n)
    bad = np.array([np.nan, np.inf, -np.inf, 1e20, -3, 255.9, 256, 300,
                    3e38, -1e20], np.float32)
    X[::3] = bad[(np.arange(0, n, 3)[:, None] + np.arange(F)) % len(bad)]
    return X


def _check(forest, X, cuda):
    from repro_torch.core.tree import predict_naive
    from repro_torch.kernels.forest_infer import forest_infer, ops
    from repro_torch.kernels.forest_infer.ref import forest_predict_packed_ref
    packed = ops.device_packed(forest, cuda)
    Xd = torch.from_numpy(X).to(cuda)
    before = forest_infer.LAUNCHES
    got = forest_infer.forest_predict_tiled(Xd, *packed.tables)
    want = forest_predict_packed_ref(Xd, *packed.tables)
    torch.cuda.synchronize()
    assert forest_infer.LAUNCHES == before + (1 if len(X) else 0)
    assert torch.equal(got, want)
    full = ops.forest_predict(forest, Xd, "cuda", cuda).cpu().numpy()
    rows = min(len(X), 40)
    assert np.array_equal(full[:rows], predict_naive(forest, X[:rows]))


@pytest.mark.parametrize("n", [0, 1, 7, 255, 2049])
def test_default_gbt_kernel_equals_plain_version(cuda, n):
    import chip_smoke
    model = chip_smoke.build_default_gbt()
    _check(model.forest, chip_smoke.encoded_inputs(n, seed=n), cuda)


def test_wide_multi_output_forest(cuda):
    """Large node capacity (M > 128), 3-wide leaves, every category bit in
    play: the shapes a trained random forest brings."""
    f = _forest(37, 700, 9, 3, seed=4, cat_feats=(1, 5))
    _check(f, _hostile(300, 9, seed=5, cat_feats=(1, 5)), cuda)


def test_short_block_of_deep_trees(cuda):
    """Fewer trees than a block holds (TB = 5) and depths past 20."""
    from repro_torch.core.tree import pack_by_depth
    f = _forest(5, 3000, 4, 1, seed=6, cat_feats=(0,))
    assert pack_by_depth(f).trees_per_block == 5
    _check(f, _hostile(97, 4, seed=7, cat_feats=(0,)), cuda)


def test_server_on_the_card_goes_through_the_kernel(cuda):
    import chip_smoke
    from repro_torch.kernels.forest_infer import forest_infer
    model = chip_smoke.build_default_gbt()
    forest_infer.LAUNCHES = 0
    stats = chip_smoke.serve(model, cuda, n_requests=8, wave=4)
    assert stats["engine_dispatches"] == {"cuda": 2}
    assert forest_infer.LAUNCHES >= 2


# ------------------------------------------------ split search (B1)

@pytest.mark.parametrize("n,width,kind", [
    (90_000, 1, "gh"), (90_000, 8, "gh"), (90_000, 64, "gh"),
    (4_999, 16, "class"), (4_999, 16, "moment"), (3, 2, "gh")])
def test_fused_split_kernel_matches_plain_version(cuda, n, width, kind):
    import chip_smoke
    args = chip_smoke.fused_inputs(n, 28, width, kind, seed=n + width,
                                   device=cuda)
    r = chip_smoke.check_fused_case(*args, width, kind=kind,
                                    min_examples=1 if n < 10 else 5)
    assert r["slots"] == width


def test_fused_split_hostile_cases(cuda):
    import chip_smoke
    r = chip_smoke.check_fused(cuda)
    assert r["cases"]["all rows inactive"]["scoreable"] == 0


def test_fused_split_counts_launches_and_never_takes_the_plain_version(
        cuda, monkeypatch):
    from repro_torch.kernels.histogram import fused, ops
    import chip_smoke

    def refuse(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(fused, "fused_split_ref", refuse)
    args = chip_smoke.fused_inputs(1000, 5, 4, "gh", seed=1, device=cuda)
    before = fused.LAUNCHES
    fused.fused_split(*args, 4)
    ops.fused_best_split(*args, 4)
    ops.fused_best_split(*args, 4, impl="cuda")
    torch.cuda.synchronize()
    assert fused.LAUNCHES == before + 3


def test_training_on_the_card_goes_through_the_kernel(cuda, monkeypatch):
    import chip_smoke
    from repro_torch.core import grower_device
    from repro_torch.kernels.histogram import fused

    def refuse(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")

    data = chip_smoke.higgs_like(5_000)
    monkeypatch.setattr(fused, "fused_split_ref", refuse)
    launches, steps = fused.LAUNCHES, grower_device.LEVEL_STEPS
    model = chip_smoke.train_gbt(data, cuda, num_trees=3)
    steps = grower_device.LEVEL_STEPS - steps
    assert model.training_logs["device_impl"] == "cuda"
    assert steps > 0 and fused.LAUNCHES - launches == steps
    rows = {k: v[:500] for k, v in data.items() if k != "label"}
    from repro_torch.core.dataspec import BatchEncoder
    from repro_torch.core.tree import predict_naive
    X = BatchEncoder(model.spec, model.features).encode(rows)
    want = model._compile_finalize()(predict_naive(model.forest, X))
    assert np.array_equal(model.predict(rows, engine="cuda", device=cuda), want)


# ------------------------------------------------------- histogram (B3)

def _refuse(*a, **k):
    raise AssertionError("a CUDA tensor reached the plain version")


@pytest.mark.parametrize("n,n_nodes", [(90_000, 1), (90_000, 8),
                                       (90_000, 32), (4_999, 5), (1, 1)])
def test_histogram_kernel_matches_plain_version(cuda, n, n_nodes):
    import chip_smoke
    codes, stats, node_of = chip_smoke.fused_inputs(n, 28, n_nodes, "gh",
                                                    seed=n + n_nodes,
                                                    device=cuda)
    codes[0] = 255
    r = chip_smoke.check_hist_case(codes, stats, node_of, n_nodes)
    assert r["n_nodes"] == n_nodes and r["active"] > 0


def test_histogram_kernel_repeats_its_bits(cuda):
    import chip_smoke
    from repro_torch.kernels.histogram.histogram import histogram
    args = chip_smoke.fused_inputs(90_000, 28, 12, "gh", seed=3, device=cuda)
    outs = [histogram(*args, 12) for _ in range(3)]
    torch.cuda.synchronize()
    assert all(torch.equal(outs[0], o) for o in outs[1:])


def test_histogram_counts_launches_and_never_takes_the_plain_version(
        cuda, monkeypatch):
    import chip_smoke
    from repro_torch.kernels.histogram import histogram, ops
    monkeypatch.setattr(histogram, "histogram_f32_ref", _refuse)
    args = chip_smoke.fused_inputs(1000, 5, 4, "gh", seed=1, device=cuda)
    before = histogram.LAUNCHES
    histogram.histogram(*args, 4)
    ops.histogram(*args, 4)
    ops.histogram(*args, 4, impl="cuda")
    torch.cuda.synchronize()
    assert histogram.LAUNCHES == before + 3
    empty = histogram.histogram(*(a[:0] for a in args), 4)
    assert histogram.LAUNCHES == before + 3 and not bool(empty.any())


def test_default_gbt_on_the_card_builds_every_histogram_with_the_kernel(
        cuda, monkeypatch):
    import chip_smoke
    from repro_torch.core.dataspec import BatchEncoder
    from repro_torch.core.hist_backend import resolve_backend
    from repro_torch.core.tree import predict_naive
    from repro_torch.kernels.histogram import histogram
    monkeypatch.setattr(histogram, "histogram_f32_ref", _refuse)
    backend = resolve_backend("auto", cuda)
    assert backend.name == "cuda"
    data = chip_smoke.higgs_like(5_000)
    launches, builds = histogram.LAUNCHES, backend.builds
    model = chip_smoke.train_default(data, cuda, num_trees=3)
    logs = model.training_logs
    assert logs["growth_engine"] == "batched"
    assert logs["histogram_backend"] == "cuda"
    builds = backend.builds - builds
    assert builds > 0 and histogram.LAUNCHES - launches == builds
    rows = {k: v[:500] for k, v in data.items() if k != "label"}
    X = BatchEncoder(model.spec, model.features).encode(rows)
    want = model._compile_finalize()(predict_naive(model.forest, X))
    assert np.array_equal(model.predict(rows, engine="cuda", device=cuda), want)


# ---------------------------- C1: wide stats and many nodes (B1, B3)

@pytest.mark.parametrize("S", [17, 27, 130])
def test_histogram_kernel_takes_wide_stats(cuda, S):
    """S past the old limit of 16 (class counts + the count): the kernel
    against its plain version, and the same bits over two launches."""
    import chip_smoke
    args = chip_smoke.fused_inputs(20_000, 28, 32, "class", seed=S,
                                   device=cuda, n_classes=S - 1)
    r = chip_smoke.check_hist_case(*args, 32)
    assert r["active"] > 0


@pytest.mark.parametrize("S", [17, 27, 130])
def test_fused_split_kernel_takes_wide_stats(cuda, S):
    import chip_smoke
    args = chip_smoke.fused_inputs(20_000, 28, 16, "class", seed=S,
                                   device=cuda, n_classes=S - 1)
    r = chip_smoke.check_fused_case(*args, 16, kind="class")
    assert r["scoreable"] > 0


def test_kernels_take_more_nodes_than_a_grid_axis_held(cuda):
    """70,000 nodes / slots (the old kernels put them on a 65,535-wide
    grid axis) at small N."""
    import chip_smoke
    from repro_torch.kernels.histogram import fused, histogram
    args = chip_smoke.fused_inputs(3_000, 2, 70_000, "gh", seed=5,
                                   device=cuda)
    before = (histogram.LAUNCHES, fused.LAUNCHES)
    r = chip_smoke.check_hist_case(*args, 70_000)
    assert r["n_nodes"] == 70_000 and r["active"] > 0
    r = chip_smoke.check_fused_case(*args, 70_000, min_examples=1)
    assert r["slots"] == 70_000 and r["scoreable"] > 0
    assert histogram.LAUNCHES > before[0] and fused.LAUNCHES > before[1]


def test_hot_bin_and_one_node(cuda):
    """Every row in one node, then also in one bin of every column."""
    import chip_smoke
    codes, stats, node_of = chip_smoke.fused_inputs(
        90_000, 28, 1, "gh", seed=9, device=cuda, inactive=0.0)
    chip_smoke.check_hist_case(codes, stats, node_of, 1)
    hot = torch.full_like(codes, 17)
    chip_smoke.check_hist_case(hot, stats, node_of, 1)
    r = chip_smoke.check_fused_case(hot, stats, node_of, 1)
    assert r["scoreable"] == 0
    hot[::10] = codes[::10]
    chip_smoke.check_fused_case(hot, stats, node_of, 1)


def test_launches_per_call(cuda):
    """B3 is prep + accumulate, B1 prep + accumulate-and-scan + column
    fold: no memset, no separate convert or scan pass."""
    import chip_smoke
    from repro_torch.kernels.histogram import fused, histogram
    args = chip_smoke.fused_inputs(5_000, 28, 8, "gh", seed=2, device=cuda)
    hist = histogram.library().histogram_kernel_launches
    split = fused.library().fused_split_kernel_launches
    assert chip_smoke.launches_per_call(
        lambda: histogram.histogram(*args, 8), hist) == 2
    assert chip_smoke.launches_per_call(
        lambda: fused.fused_split(*args, 8), split) == 3


def test_26_class_forests_on_the_card_equal_the_cpu(cuda):
    """26 classes (S = 27): the Random Forest on both engines and CART."""
    import chip_smoke
    from repro_torch.data.tabular import SyntheticSpec, make_dataset
    data = make_dataset(SyntheticSpec(**{**chip_smoke.WIDE, "n": 4_000}))
    for fit, kw in ((chip_smoke.train_rf, dict(num_trees=2)),
                    (chip_smoke.train_cart, {})):
        card = fit(data, cuda, max_depth=5, **kw)
        assert card.training_logs["histogram_backend"] == "cuda"
        assert chip_smoke.identical(card, fit(data, "cpu", max_depth=5, **kw))
    card = chip_smoke.train_rf_device(data, cuda, num_trees=2, max_depth=5)
    assert card.training_logs["device_impl"] == "cuda"
    again = chip_smoke.train_rf_device(data, cuda, num_trees=2, max_depth=5)
    assert chip_smoke.identical(card, again)
    cpu = chip_smoke.train_rf_device(data, "cpu", num_trees=2, max_depth=5)
    agree = chip_smoke.agreement(card, cpu)
    assert min(agree.values()) >= 0.995, agree


# ------------------------------------------ single-tree traversal (B4)

@pytest.mark.parametrize("n", [0, 1, 7, 255, 2049])
def test_single_kernel_equals_plain_version_on_the_default_gbt(cuda, n):
    import chip_smoke
    model = chip_smoke.build_default_gbt()
    chip_smoke.check_single_case(model.forest,
                                 chip_smoke.encoded_inputs(n, seed=n), cuda)


def test_single_kernel_zoo_and_wide_forests(cuda):
    """The hand-built zoo (mask words float32 cannot hold, codes 0, 31, 32
    and 255, hostile values, stumps, 0 rows) and a random forest of M > 128
    nodes with 3-wide leaves."""
    import chip_smoke
    from repro_torch.kernels.forest_infer import forest_infer
    before = forest_infer.SINGLE_LAUNCHES
    r = chip_smoke.check_single(chip_smoke.single_zoo(), cuda)
    assert r["max_abs_err"] == 0.0
    assert forest_infer.SINGLE_LAUNCHES == before + 2     # 0 rows: none
    f = _forest(37, 700, 9, 3, seed=4, cat_feats=(1, 5))
    chip_smoke.check_single_case(f, _hostile(300, 9, seed=5, cat_feats=(1, 5)),
                                 cuda)


def test_single_counts_launches_and_never_takes_the_plain_version(
        cuda, monkeypatch):
    import chip_smoke
    from repro_torch.kernels.forest_infer import forest_infer, layout, ops
    monkeypatch.setattr(layout, "walk", _refuse)      # the plain version
    model = chip_smoke.build_default_gbt()
    X = chip_smoke.encoded_inputs(100, seed=2)
    soa = ops.device_soa(model.forest, cuda)
    before = forest_infer.SINGLE_LAUNCHES
    forest_infer.forest_predict_single(torch.from_numpy(X).to(cuda), *soa[:5],
                                       depth=model.forest.depth)
    ops.forest_predict(model.forest, X, "single", cuda)
    torch.cuda.synchronize()
    assert forest_infer.SINGLE_LAUNCHES == before + 2


def test_single_runs_more_trees_than_a_grid_axis_held(cuda):
    """The grid is one-dimensional, so 70,000 trees (more than the 65,535
    of a y axis; one split each, on alternating columns) run in each
    variant and equal the plain version."""
    from repro_torch.kernels.forest_infer import forest_infer, layout, plan
    from repro_torch.kernels.forest_infer.ref import forest_predict_ref
    T, M = 70_000, 4
    rng = np.random.default_rng(12)
    feature = np.full((T, M), -1, np.int32)
    feature[:, 0] = np.arange(T) % 2
    left = np.full((T, M), -1, np.int32)
    left[:, 0] = 1
    tabs = [torch.from_numpy(a).to(cuda) for a in (
        feature, rng.normal(size=(T, M)).astype(np.float32),
        np.zeros((T, M, 8), np.int32), left,
        rng.normal(size=(T, M, 1)).astype(np.float32))]
    X = torch.from_numpy(rng.normal(size=(40, 2)).astype(np.float32)).to(cuda)
    want = forest_predict_ref(X, *tabs, depth=1)
    lay = layout.build(*tabs, depth=1)
    for variant in plan.VARIANTS:
        got = forest_infer.run_single(X, lay, variant=variant)
        torch.cuda.synchronize()
        assert torch.equal(got, want), variant
    assert torch.equal(forest_infer.forest_predict_single(X, *tabs, depth=1),
                       want)


# ------------------------------------------ both traversal kernels, redesigned

def test_traversal_variants_on_the_zoo_big_trees_and_wide_leaves(cuda):
    """Both kernels in each plan variant their shapes allow against their
    plain versions (``torch.equal``, the tiled kernel in packed and tree
    order) and predict_naive: the hand-built zoo, trees of 16,384 nodes
    (record-global only) and O = 3."""
    import chip_smoke
    cases = chip_smoke.traversal_cases()
    r = chip_smoke.check_all_variants(cases, cuda, ("tiled", "single"))
    assert r["max_abs_err"] == 0.0
    big = r["cases"][f"{chip_smoke.BIG_NODES} nodes"]["variants"]
    assert set(big["tiled"]) == set(big["single"]) == {"global"}
    assert set(r["cases"]["O=3"]["variants"]["single"]) == {"staged", "global"}


@pytest.mark.parametrize("n", [1, 1024, 4099])
def test_traversal_variants_on_the_default_gbt(cuda, n):
    import chip_smoke
    model = chip_smoke.build_default_gbt()
    r = chip_smoke.check_variants(model.forest,
                                  chip_smoke.encoded_inputs(n, seed=n), cuda)
    assert all(set(v) == {"staged", "global"} for v in r["variants"].values())


def test_forest_predict_is_one_launch_with_the_tree_order_store(
        cuda, monkeypatch):
    """impl="cuda" launches the tiled kernel once a call and stores tree
    order itself: no index_select, no plain version, and 0 rows launch
    nothing."""
    import chip_smoke
    from repro_torch.kernels.forest_infer import forest_infer, layout, ops
    from repro_torch.kernels.forest_infer.ref import forest_predict_packed_ref
    monkeypatch.setattr(layout, "walk", _refuse)
    monkeypatch.setattr(torch, "index_select", _refuse)
    model = chip_smoke.build_default_gbt()
    packed = ops.device_packed(model.forest, cuda)
    X = torch.from_numpy(chip_smoke.encoded_inputs(300, seed=4)).to(cuda)
    before = forest_infer.LAUNCHES
    got = ops.forest_predict(model.forest, X, "cuda", cuda)
    torch.cuda.synchronize()
    assert forest_infer.LAUNCHES == before + 1
    want = forest_predict_packed_ref(X, *packed.tables)[:, packed.inv_order]
    assert torch.equal(got, want)
    empty = ops.forest_predict(model.forest, X[:0], "cuda", cuda)
    single = forest_infer.run_single(X[:0], ops.device_soa(model.forest,
                                                          cuda).layout)
    assert empty.shape == (0, 300, 1) and single.shape == (0, 300, 1)
    assert forest_infer.LAUNCHES == before + 1


# ------------------------------------- Random Forest and CART on the card

def test_random_forest_on_the_card_equals_the_cpu(cuda, monkeypatch):
    """The default Random Forest, short: every level histogram built by the
    kernel (launches == builds), the forest equal to the CPU's lockstep
    block on every field, and served through both traversal kernels."""
    import chip_smoke
    from repro_torch.core.hist_backend import resolve_backend
    from repro_torch.kernels.forest_infer import ops
    from repro_torch.kernels.histogram import histogram
    monkeypatch.setattr(histogram, "histogram_f32_ref", _refuse)
    backend = resolve_backend("auto", cuda)
    data = chip_smoke.higgs_like(5_000)
    launches, builds = histogram.LAUNCHES, backend.builds
    card = chip_smoke.train_rf(data, cuda, num_trees=3)
    assert card.training_logs["histogram_backend"] == "cuda"
    builds = backend.builds - builds
    assert builds > 0 and histogram.LAUNCHES - launches == builds
    cpu = chip_smoke.train_rf(data, "cpu", num_trees=3)
    assert chip_smoke.identical(card, cpu)
    assert card.self_evaluation.metrics == cpu.self_evaluation.metrics
    rows = {k: v[:400] for k, v in data.items() if k != "label"}
    from repro_torch.core.dataspec import BatchEncoder
    X = BatchEncoder(card.spec, card.features).encode(rows)
    chip_smoke.check_single_case(card.forest, X, cuda)
    assert torch.equal(ops.forest_predict(card.forest, X, "single", cuda),
                       ops.forest_predict(card.forest, X, "cuda", cuda))


def test_cart_on_the_card_equals_the_cpu(cuda):
    import chip_smoke
    data = chip_smoke.higgs_like(5_000)
    card = chip_smoke.train_cart(data, cuda)
    cpu = chip_smoke.train_cart(data, "cpu")
    assert card.training_logs["histogram_backend"] == "cuda"
    assert chip_smoke.identical(card, cpu)



# ------------------------------------- saving and checkpointed training

def test_saved_models_predict_the_same_on_the_card(cuda, tmp_path):
    """``chip_smoke.check_model_io`` at a small size: the loaded GBT, RF
    and CART predict through the tiled kernel ``array_equal`` with their
    predictions before the save, with equal metrics, summary and
    importances; the loaded RF through the single-tree kernel equals the
    saved forest's and ``predict_naive``."""
    import chip_smoke
    data = chip_smoke.higgs_like(5_000)
    rows = {k: v[:1_000] for k, v in data.items()}
    models = {"gbt": chip_smoke.train_gbt(data, cuda, num_trees=10),
              "rf": chip_smoke.train_rf(data, cuda, num_trees=2, max_depth=8),
              "cart": chip_smoke.train_cart(data, cuda, max_depth=8)}
    out = chip_smoke.check_model_io(models, rows, cuda, str(tmp_path))
    assert out["tiled_launches"] >= 3 and out["single_launches"] == 2


@pytest.mark.parametrize("fit,stop,hparams", [
    ("train_gbt", 4, dict(num_trees=8)),
    ("train_default", 4, dict(num_trees=8)),
    ("train_rf_device", 1, dict(num_trees=4, tree_parallelism=2)),
    ("train_rf", 1, dict(num_trees=4, tree_parallelism=2, max_depth=8)),
    ("train_cart", 1, dict(max_depth=8)),
], ids=["gbt_device", "gbt_batched", "rf_device", "rf_batched", "cart"])
def test_resumed_training_on_the_card_equals_uninterrupted(cuda, tmp_path,
                                                          fit, stop, hparams):
    import chip_smoke
    fit = getattr(chip_smoke, fit)
    data = chip_smoke.higgs_like(5_000)
    clean = fit(data, cuda, **hparams)
    resumed, info = chip_smoke.stop_and_resume(
        fit, data, cuda, str(tmp_path), "ck", stop, 2, **hparams)
    assert 0 < info["trees_at_stop"] <= info["trees"]
    assert resumed.training_logs["resilience"]
    assert chip_smoke.same_forest(resumed.forest, clean.forest)


# ------------------------------------------- sparse-oblique forests (A3)

def test_oblique_traversal_variants_on_the_zoo(cuda):
    """Both kernels on oblique forests in each plan variant against their
    plain versions (``torch.equal``) and the vectorized engine
    (``array_equal`` on every row): P = 1, 7, 8, 9, 28, 128, 129 and 300
    over hostile rows, and the near tie, where only ``predict_naive``
    (``np.dot``) differs."""
    import chip_smoke
    cases = {**chip_smoke.oblique_zoo(), "near tie": chip_smoke.near_tie()}
    r = chip_smoke.check_all_variants(cases, cuda, ("tiled", "single"))
    assert r["max_abs_err"] == 0.0
    assert r["cases"]["near tie"]["naive"]["pairs_differ"] == 1


def test_oblique_forest_trained_on_the_card_serves_through_the_kernels(
        cuda, tmp_path):
    """The benchmark_rank1 Random Forest, short, trained on the card (B3
    builds its histograms, launches == builds) equals the CPU's forest,
    compiles to the cuda engine with no engine named, and both kernels in
    each plan variant equal their plain versions and the vectorized
    engine; its save and load predict the same."""
    import chip_smoke
    from repro_torch.core.engines import compile_predictor
    from repro_torch.core.hist_backend import resolve_backend
    from repro_torch.kernels.histogram import histogram
    data = chip_smoke.higgs_like(4_000)
    kw = dict(template="benchmark_rank1", num_trees=2, max_depth=8)
    backend = resolve_backend("auto", cuda)
    histogram.LAUNCHES, backend.builds = 0, 0
    card = chip_smoke.train_rf(data, cuda, **kw)
    assert histogram.LAUNCHES == backend.builds > 0
    assert card.forest.has_oblique()
    assert chip_smoke.identical(card, chip_smoke.train_rf(data, "cpu", **kw))
    rows = {k: v[:2_000] for k, v in data.items()}
    pred = compile_predictor(card, device=cuda)
    assert pred.name == "cuda"
    X = pred.encode({k: rows[k] for k in card.features})
    r = chip_smoke.check_variants(card.forest, X, cuda)
    assert r["max_abs_err"] == 0.0
    out = chip_smoke.serve_rank1({"rf": card}, rows, cuda, str(tmp_path))
    assert out["tiled_launches"] == out["single_launches"] == 1


# ------------------------------------------------------- the tasks (A4)

def test_ranking_forests_trained_on_the_card_equal_the_cpu(cuda):
    """LambdaMART, short: the batched engine (B3, launches == builds)
    equals the CPU's numpy run on every field but ``split_gain``, which
    agrees within ``chip_smoke.GAIN_RTOL`` (``equal_but_gain``: B3's
    fixed-point rounding of float gradients), with equal loss logs; the
    device engine (B1) repeats its bits and agrees with the CPU's plain
    version on >= 99.5% of each structure field."""
    import chip_smoke
    from repro_torch.core.hist_backend import resolve_backend
    from repro_torch.kernels.histogram import histogram
    train, _ = chip_smoke.ranking_data(400)
    backend = resolve_backend("auto", cuda)
    histogram.LAUNCHES, backend.builds = 0, 0
    card = chip_smoke.train_ranking(train, cuda, num_trees=6)
    assert histogram.LAUNCHES == backend.builds > 0
    cpu = chip_smoke.train_ranking(train, "cpu", num_trees=6)
    chip_smoke.equal_but_gain(card, cpu)
    assert card.training_logs["valid_loss"] == cpu.training_logs["valid_loss"]
    kw = dict(num_trees=4)
    a = chip_smoke.train_ranking_device(train, cuda, **kw)
    b = chip_smoke.train_ranking_device(train, cuda, **kw)
    c = chip_smoke.train_ranking_device(train, "cpu", **kw)
    assert a.training_logs["device_impl"] == "cuda"
    assert chip_smoke.identical(a, b)
    assert min(chip_smoke.agreement(a, c).values()) >= 0.995


def test_uplift_forest_trained_on_the_card_equals_the_cpu(cuda):
    """Uplift trees, short: B3 builds every histogram of the four uplift
    stats (launches == builds), the forest equals the CPU's lockstep run
    on every field, and the device engine is refused."""
    import chip_smoke
    from repro_torch.core import YdfError
    from repro_torch.core.hist_backend import resolve_backend
    from repro_torch.data.tabular import randomized_treatment
    from repro_torch.kernels.histogram import histogram
    data = randomized_treatment(n=5_000, seed=11)
    backend = resolve_backend("auto", cuda)
    histogram.LAUNCHES, backend.builds = 0, 0
    card = chip_smoke.train_uplift(data, cuda, num_trees=4)
    assert card.training_logs["histogram_backend"] == "cuda"
    assert histogram.LAUNCHES == backend.builds > 0
    assert chip_smoke.identical(card, chip_smoke.train_uplift(
        data, "cpu", num_trees=4))
    with pytest.raises(YdfError, match="growth_engine='batched'"):
        chip_smoke.train_uplift(data, cuda, num_trees=1,
                                growth_engine="device")


def test_numerical_uplift_on_the_card_moves_only_split_gain(cuda):
    """Uplift trees on a numerical outcome: B3 rounds the float stats'
    exact sums to float32, so the card's forest equals the CPU's on every
    field but ``split_gain``, which agrees within ``chip_smoke.GAIN_RTOL``
    (``equal_but_gain`` raises otherwise)."""
    import chip_smoke
    data = chip_smoke.numerical_uplift(20_000)
    card = chip_smoke.train_uplift(data, cuda, num_trees=4)
    assert card.training_logs["histogram_backend"] == "cuda"
    r = chip_smoke.equal_but_gain(card, chip_smoke.train_uplift(
        data, "cpu", num_trees=4))
    assert r["split_gain_max_rel_diff"] <= chip_smoke.GAIN_RTOL


def test_isolation_forest_serves_through_both_kernels(cuda):
    """The isolation forest's shape (513-node capacity, depth <= 8,
    path-length leaves) through B2 and B4 in each plan variant: equal to
    their plain versions and to ``predict_naive``; served through the
    bundle equal to ``finalize(predict_naive(...))``."""
    import chip_smoke
    from repro_torch.core.tree import predict_naive
    from repro_torch.data.tabular import planted_anomaly
    from repro_torch.serving.forest import make_forest_server
    from repro_torch.tasks import IsolationForestLearner
    data = planted_anomaly(n_inlier=3_000, n_anomaly=120, seed=13)
    model = IsolationForestLearner(label="anomaly", device=cuda).train(data)
    bundle = make_forest_server(model, device=cuda)
    feats = {k: data[k] for k in model.features}
    X = bundle.predictor.encode(feats)
    r = chip_smoke.check_variants(model.forest, X, cuda)
    assert r["max_abs_err"] == 0.0
    want = model._compile_finalize()(predict_naive(model.forest, X[:600]))
    got = bundle.predict({k: v[:600] for k, v in feats.items()})
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("tf32", [True, False], ids=["tf32", "fp32"])
def test_bucketed_engines_on_the_card_equal_predict_naive(cuda, tf32,
                                                          monkeypatch):
    """The depth-bucketed engines on the card, each strategy, with TF32
    matmuls allowed and not: equal to ``predict_naive`` and to the cuda
    engine (the leaf-path matmul sums 0/+-1 products exactly either way)."""
    import chip_smoke
    from repro_torch.core.tree import predict_naive
    from repro_torch.kernels.forest_infer import ops
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", tf32)
    cases = {"gbt": (chip_smoke.build_default_gbt(n_trees=40).forest,
                     chip_smoke.encoded_inputs(3_000, seed=5)),
             **chip_smoke.single_zoo()}
    for name, (forest, X) in cases.items():
        want = predict_naive(forest, X[:300])
        cuda_out = ops.forest_predict(forest, X, "cuda", cuda).cpu().numpy()
        for strategy in (None, "scan", "leaf_path"):
            got = ops.forest_predict_bucketed(forest, X, strategy, cuda)
            np.testing.assert_array_equal(got[:300], want, err_msg=name)
            np.testing.assert_array_equal(got, cuda_out, err_msg=name)


def test_async_server_and_pickled_predictor_on_the_card(cuda):
    """``chip_smoke.serve_async`` at a small size on the card: the async
    fan-in with sheds through B2, the warmed ladder, the bulk sweep, and a
    bucketed predictor pickled and loaded on the card."""
    import pickle

    import chip_smoke
    from repro_torch.core.engines import compile_predictor
    model = chip_smoke.build_default_gbt(n_trees=24)
    out = chip_smoke.serve_async(model, cuda, n_requests=12,
                                 bulk_rows=5_000, chunk_rows=2_048)
    assert out["shed"] == out["expected_shed"] > 0
    assert out["async_launches"] == out["dispatches"] > 0
    pred = compile_predictor(model, "bucketed", cuda)
    clone = pickle.loads(pickle.dumps(pred))
    assert clone.name == "bucketed" and clone.engine.device.type == "cuda"
    X = chip_smoke.encoded_inputs(500, seed=9)
    np.testing.assert_array_equal(clone.predict_encoded(X),
                                  pred.predict_encoded(X))
