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
rtol 1e-6 + 1e-6 * the stat's max |v|), and the same bits over launches.
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
