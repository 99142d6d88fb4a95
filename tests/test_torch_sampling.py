"""The port's keyed feature sampling against the JAX package's, bit for bit.

The same (key, tree, nodes, F, k), drawn with numpy, go through the
reference's numpy ``keyed_feature_select`` and its jnp mirror
``keyed_feature_select_jnp``, and through the port's numpy copy and its
torch mirror (int64 arithmetic cut to 32 bits). Tolerance: none — the
subsets select features, so every path must agree exactly.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.core import sampling as ref_sampling
from repro_torch.core import sampling

CASES = [
    # (key, tree, F, k, node ids)
    (0, 0, 1, 1, "small"),
    (1234, 7, 28, 5, "small"),
    (2 ** 31 + 5, 3, 10, 3, "high"),
    (2 ** 32 - 1, 2 ** 31 - 1, 64, 8, "high"),
    (0xDEADBEEF, 11, 17, 17, "small"),
    (2 ** 40 + 9, 1, 6, 2, "high"),      # key beyond 32 bits: taken mod 2^32
]


def _nodes(kind: str, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "small":
        return rng.integers(0, 4096, 200).astype(np.int64)
    return np.concatenate([
        rng.integers(2 ** 32 - 300, 2 ** 32, 100),
        rng.integers(2 ** 31 - 50, 2 ** 31 + 50, 100),
        [0, 1, 2 ** 32 - 1]]).astype(np.int64)


@pytest.mark.parametrize("key,tree,F,k,kind", CASES)
def test_torch_select_equals_numpy_and_jnp(key, tree, F, k, kind):
    import jax.numpy as jnp
    nodes = _nodes(kind, seed=F * 31 + k)
    want = ref_sampling.keyed_feature_select(key, tree, nodes, F, k)
    port_np = sampling.keyed_feature_select(key, tree, nodes, F, k)
    port_t = sampling.keyed_feature_select_torch(
        key, torch.tensor(tree), torch.from_numpy(nodes), F, k)
    jnp_sel = ref_sampling.keyed_feature_select_jnp(
        key, jnp.asarray(tree, jnp.uint32),
        jnp.asarray(nodes.astype(np.uint32)), F, k)
    np.testing.assert_array_equal(port_np, want)
    np.testing.assert_array_equal(port_t.numpy(), want)
    np.testing.assert_array_equal(np.asarray(jnp_sel), want)
    assert port_t.dtype == torch.int64 and port_t.shape == (len(nodes), k)


def test_hash_lattice_equals_reference():
    nodes = _nodes("high", seed=3)
    np.testing.assert_array_equal(
        sampling.feature_hash(99, 5, nodes, 13),
        ref_sampling.feature_hash(99, 5, nodes, 13))


def test_torch_select_broadcasts_trees_over_a_frontier():
    """The level step's call shape: tree ids (K, 1) against node ids
    (K, P) -> (K, P, k), each tree keyed by its own id."""
    rng = np.random.default_rng(0)
    trees = np.array([0, 3, 2 ** 32 - 2])
    nodes = rng.integers(0, 2 ** 32, (3, 9)).astype(np.int64)
    got = sampling.keyed_feature_select_torch(
        77, torch.from_numpy(trees)[:, None], torch.from_numpy(nodes), 20, 4)
    assert got.shape == (3, 9, 4)
    for i, t in enumerate(trees):
        np.testing.assert_array_equal(
            got[i].numpy(),
            ref_sampling.keyed_feature_select(77, int(t), nodes[i], 20, 4))


@pytest.mark.parametrize("ratio,F", [(1.0, 28), (0.5, 7), (0.01, 10),
                                     (0.3, 28)])
def test_sample_size_equals_reference(ratio, F):
    assert sampling.sample_size(ratio, F) == ref_sampling.sample_size(ratio, F)
