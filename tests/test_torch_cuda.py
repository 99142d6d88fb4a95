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
card's ``logf`` and the CPU's ``torch.log``).
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
    from repro_torch.kernels.forest_infer import forest_infer, ops
    monkeypatch.setattr(forest_infer, "forest_predict_ref", _refuse)
    model = chip_smoke.build_default_gbt()
    X = chip_smoke.encoded_inputs(100, seed=2)
    soa = ops.device_soa(model.forest, cuda)
    before = forest_infer.SINGLE_LAUNCHES
    forest_infer.forest_predict_single(torch.from_numpy(X).to(cuda), *soa[:5],
                                       depth=model.forest.depth)
    ops.forest_predict(model.forest, X, "single", cuda)
    torch.cuda.synchronize()
    assert forest_infer.SINGLE_LAUNCHES == before + 2


def test_single_refuses_more_trees_than_a_grid_axis_holds(cuda):
    from repro_torch.kernels.forest_infer import forest_infer
    T = 65536
    X = torch.zeros((4, 2), device=cuda)
    i32 = dict(dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="65535"):
        forest_infer.forest_predict_single(
            X, torch.full((T, 1), -1, **i32), torch.zeros((T, 1), device=cuda),
            torch.zeros((T, 1, 8), **i32), torch.full((T, 1), -1, **i32),
            torch.zeros((T, 1, 1), device=cuda), depth=1)


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

