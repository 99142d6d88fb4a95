"""The port's forest traversal against the JAX package's, bit for bit.

The same numpy inputs go through the reference (``repro.core.tree``'s
``pack_by_depth`` and ``predict_naive``, and the tiled Pallas kernel in
interpret mode) and through the port (``repro_torch``'s packing, its numpy
engines, its plain PyTorch traversals, and the CUDA kernel's wrapper, which
takes the plain version on CPU tensors). Tolerance: none — traversal
selects leaves, so every path must agree exactly (``array_equal``).

Hostile numerics (NaN, +-inf, huge values in categorical columns) are held
to ``predict_naive`` only: the interpret-mode kernel clips in float before
its cast, a divergence of the reference recorded in ROADMAP.md (C).
Interpret-mode batches stay at 64 rows or fewer.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.core.tree import pack_by_depth as ref_pack_by_depth
from repro.core.tree import predict_naive as ref_predict_naive
from repro.kernels.forest_infer.ops import forest_predict as ref_forest_predict
from repro_torch import convert
from repro_torch.core import tree as port_tree
from repro_torch.kernels import _build
from repro_torch.kernels.forest_infer import forest_infer, ops, ref

from conftest import _make_random_forest

CPU = torch.device("cpu")
ZOO = ("depth_skewed_forest", "stump_forest", "all_categorical_forest",
       "ragged_mixed_forest")
FIELDS = ("feature", "threshold", "cat_mask", "left_child", "leaf_value",
          "n_nodes", "depth", "tree_class", "init_pred", "out_dim")


@pytest.fixture(scope="module")
def ragged_mixed_forest():
    """Mixed depths, 3-wide leaves and two categorical columns."""
    return _make_random_forest(15, [0, 1, 4, 9, 6], 7, out_dim=3, seed=31,
                               cat_feats=(2, 5))


def _zoo(request, name):
    return request.getfixturevalue(name)


def to_port(forest):
    """The reference Forest's fields, carried across as plain arrays."""
    return convert.forest_from_arrays(
        {k: getattr(forest, k) for k in FIELDS}, forest.feature_names)


def _cat_cols(forest):
    return sorted({int(f) for f in forest.feature[forest.cat_mask.any(-1)]})


def inputs(forest, n, seed=5, hostile=False):
    rng = np.random.default_rng(seed)
    F = len(forest.feature_names)
    X = (rng.normal(size=(n, F)) * 2).astype(np.float32)
    cats = _cat_cols(forest)
    for j in cats:
        X[:, j] = rng.integers(-2, 300, size=n)
    if hostile and n:
        bad = np.array([np.nan, np.inf, -np.inf, 3e38, 1e20, -1e20, 255.9,
                        256.0, -3.0, 2.0 ** 63], np.float32)
        for r in range(0, n, 2):
            X[r, :] = bad[(r // 2 + np.arange(F)) % len(bad)]
    return X


def port_paths(pf, X):
    """Every port traversal of ``X``: name -> (N, T, O) numpy."""
    return {
        "predict_naive": port_tree.predict_naive(pf, X),
        "vectorized": port_tree.compile_predict_raw(pf)(X),
        "packed_plain": ops.forest_predict(pf, X, "cuda", CPU).numpy(),
        "soa_plain": ops.forest_predict(pf, X, "ref", CPU).numpy(),
    }


# ------------------------------------------------------------------ layout

@pytest.mark.parametrize("name", ZOO)
def test_pack_by_depth_matches_reference(request, name):
    forest = _zoo(request, name)
    want = ref_pack_by_depth(forest)
    got = port_tree.pack_by_depth(to_port(forest))
    for field in ("feature", "threshold", "cat_mask", "left_child",
                  "leaf_value", "block_depth", "inv_order"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field
    assert (got.n_trees, got.out_dim) == (want.n_trees, want.out_dim)


def test_pack_by_depth_matches_reference_on_trained_forest(tiny_adult):
    from repro.core import RandomForestLearner
    forest = RandomForestLearner(label="income", num_trees=3).train(
        tiny_adult).forest
    want = ref_pack_by_depth(forest)
    got = port_tree.pack_by_depth(to_port(forest))
    assert got.feature.shape == want.feature.shape
    for field in ("feature", "threshold", "cat_mask", "left_child",
                  "leaf_value", "block_depth", "inv_order"):
        assert np.array_equal(getattr(got, field), getattr(want, field)), field


# ---------------------------------------------------------------- traversal

@pytest.mark.parametrize("name", ZOO)
def test_plain_versions_match_naive_and_interpret_kernel(request, name):
    forest = _zoo(request, name)
    X = inputs(forest, 64)
    naive = ref_predict_naive(forest, X)
    interp = np.asarray(ref_forest_predict(forest, X, impl="interpret"))
    assert np.array_equal(naive, interp)
    for path, got in port_paths(to_port(forest), X).items():
        assert got.dtype == np.float32 and got.shape == naive.shape, path
        assert np.array_equal(got, naive), path


@pytest.mark.parametrize("n", [0, 1])
def test_zero_and_one_row_batches(depth_skewed_forest, n):
    """The reference tiled kernel refuses a 0-row batch (its compiled
    predictor never sends one), so 0 rows are held to predict_naive."""
    forest = depth_skewed_forest
    X = inputs(forest, n)
    naive = ref_predict_naive(forest, X)
    assert naive.shape == (n, forest.n_trees, 1)
    if n:
        interp = np.asarray(ref_forest_predict(forest, X, impl="interpret"))
        assert np.array_equal(interp, naive)
    for path, got in port_paths(to_port(forest), X).items():
        assert got.shape == naive.shape and np.array_equal(got, naive), path


@pytest.mark.parametrize("name", ZOO)
def test_hostile_numerics_match_predict_naive(request, name):
    forest = _zoo(request, name)
    X = inputs(forest, 96, seed=9, hostile=True)
    naive = ref_predict_naive(forest, X)
    for path, got in port_paths(to_port(forest), X).items():
        assert np.array_equal(got, naive), path


def test_packed_plain_honours_block_depth(depth_skewed_forest):
    """The kernel's plain version stops each block at its own depth: with
    the bound cut to one round, deep trees stop after their root split."""
    pf = to_port(depth_skewed_forest)
    packed = ops.device_packed(pf, CPU)
    X = torch.from_numpy(inputs(depth_skewed_forest, 16))
    one = torch.ones_like(packed.block_depth)
    cut = ref.forest_predict_packed_ref(X, *packed.tables[:5], one)
    full = ref.forest_predict_packed_ref(X, *packed.tables)
    assert not torch.equal(cut, full)
    p = port_tree.pack_by_depth(pf)
    shallow = (p.block_depth[:, 0] == 1)
    S = p.trees_per_block
    for b in np.flatnonzero(shallow):
        assert torch.equal(cut[:, b * S:(b + 1) * S], full[:, b * S:(b + 1) * S])


# ---------------------------------------------------- categorical code rule

CODE_CASES = [(np.nan, 0), (np.inf, 0), (-np.inf, 0), (1e20, 0), (-1e20, 0),
              (3e38, 0), (2.0 ** 63, 0), (2.0 ** 62, 255), (-3.0, 0),
              (-0.5, 0), (0.0, 0), (3.7, 3), (31.0, 31), (32.0, 32),
              (255.9, 255), (256.0, 255), (300.0, 255)]


@pytest.mark.parametrize("x,code", CODE_CASES)
def test_cat_code_follows_numpy_cast_then_clip(x, code):
    xs = np.float32(x)
    assert int(port_tree.cat_code(xs)) == code
    assert int(ref.cat_code(torch.tensor([xs]))[0]) == code


def test_cat_code_matches_the_reference_cast_on_this_host():
    """The reference engines cast with numpy (``astype(int64)`` then clip);
    on an x86 host that is exactly the written-out rule."""
    import platform
    if platform.machine() not in ("x86_64", "AMD64"):
        pytest.skip("numpy's out-of-range float->int cast is x86-specific")
    xs = np.array([c[0] for c in CODE_CASES], np.float32)
    with np.errstate(invalid="ignore"):
        numpy_cast = np.clip(xs.astype(np.int64), 0, 255)
    assert np.array_equal(port_tree.cat_code(xs), numpy_cast)


# ------------------------------------------------------------ the wrapper

def _packed_cpu(forest):
    return ops.device_packed(to_port(forest), CPU)


def test_wrapper_counts_no_launch_on_cpu(all_categorical_forest):
    packed = _packed_cpu(all_categorical_forest)
    X = torch.from_numpy(inputs(all_categorical_forest, 8))
    before = forest_infer.LAUNCHES
    out = forest_infer.forest_predict_tiled(X, *packed.tables)
    B, TB, M = packed.feature.shape
    assert out.shape == (8, B * TB, 1)
    assert forest_infer.LAUNCHES == before       # plain version, no launch


@pytest.mark.parametrize("field,bad,exc", [
    ("X", lambda t: t.double(), TypeError),
    ("X", lambda t: t.t(), ValueError),                 # not contiguous
    ("feature", lambda t: t.long(), TypeError),
    ("threshold", lambda t: t[:, :, :-1].contiguous(), ValueError),
    ("cat_mask", lambda t: t.float(), TypeError),
    ("leaf_value", lambda t: t.reshape(t.shape[:-1]), ValueError),
    ("block_depth", lambda t: t.reshape(-1, 1), ValueError),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(
        all_categorical_forest, field, bad, exc):
    packed = _packed_cpu(all_categorical_forest)
    X = torch.from_numpy(inputs(all_categorical_forest, 8))
    if field == "X":
        X = torch.from_numpy(inputs(all_categorical_forest, 4)[:, :4].copy())
    args = {"X": X, **dict(zip(("feature", "threshold", "cat_mask",
                                "left_child", "leaf_value", "block_depth"),
                               packed.tables))}
    args[field] = bad(args[field])
    with pytest.raises(exc):
        forest_infer.forest_predict_tiled(**args)


def test_wrapper_raises_on_a_device_it_does_not_run_on(stump_forest):
    packed = _packed_cpu(stump_forest)
    meta = [t.to("meta") for t in packed.tables]
    with pytest.raises(ValueError, match="CUDA or CPU"):
        forest_infer.forest_predict_tiled(
            torch.empty((3, 4), device="meta"), *meta)


def test_cuda_request_without_a_card_raises(stump_forest, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X = inputs(stump_forest, 4)
    for impl in ("cuda", "ref"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ops.forest_predict(to_port(stump_forest), X, impl, "cuda")


def test_forest_predict_rejects_too_narrow_requests(depth_skewed_forest):
    from repro_torch.core.api import YdfError
    X = inputs(depth_skewed_forest, 4)[:, :2]
    with pytest.raises(YdfError, match="columns"):
        ops.forest_predict(to_port(depth_skewed_forest), X, "cuda", CPU)
    with pytest.raises(ValueError, match="unknown impl"):
        ops.forest_predict(to_port(depth_skewed_forest), X, "pallas", CPU)


def test_device_tables_upload_once_and_free_with_the_forest(stump_forest):
    import gc
    pf = to_port(stump_forest)
    first = ops.device_packed(pf, CPU)
    assert ops.device_packed(pf, CPU) is first
    assert ops.device_soa(pf, CPU) is ops.device_soa(pf, CPU)
    key = id(pf)
    assert key in ops._CACHE
    del pf, first
    gc.collect()
    assert key not in ops._CACHE


# ------------------------------------------------------------------ build

def test_build_without_nvcc_raises_runtime_error(tmp_path, monkeypatch):
    src = tmp_path / "k.cu"
    src.write_text('extern "C" int k() { return 0; }\n')
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc was not found"):
        _build.build(src)
    assert not (tmp_path / "build").exists()


def test_build_reports_nvcc_failure_as_runtime_error(tmp_path, monkeypatch):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: bad kernel' >&2\nexit 2\n")
    fake.chmod(0o755)
    src = tmp_path / "k.cu"
    src.write_text("broken\n")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build.shutil, "which", lambda name: str(fake))
    with pytest.raises(RuntimeError, match="bad kernel"):
        _build.build(src)
    assert list((tmp_path / "build").iterdir()) == []
