"""Plain PyTorch forest traversal: the oracle for the CUDA kernel.

Semantics of ``repro.core.tree.predict_naive`` over axis-aligned forests:
numerical ``x >= threshold``; a node with a non-empty 256-bit category mask
goes right when the code's bit is set; leaves (``left_child < 0``)
self-loop. Every (example, tree) pair advances in lockstep by gathers.

Two entry points share one traversal:

  * ``forest_predict_ref`` — over the raw (T, M) SoA at one global depth,
    the counterpart of the JAX package's jnp oracle; packing is not on its
    path, so it checks ``pack_by_depth`` too.
  * ``forest_predict_packed_ref`` — over the depth-packed layout with the
    per-block depth bound: exactly the function of the CUDA kernel in
    ``forest_infer.py``, which falls back to nothing but this on CPU tensors.

Category masks arrive as int32 tensors holding the uint32 words bit for
bit (torch's uint32 has no shift on the CPU). An arithmetic shift right by
k still leaves bit k in the lowest place, so ``(word >> k) & 1`` is exact.
"""
from __future__ import annotations

import torch

MASK_WORDS = 8


def cat_code(x: torch.Tensor) -> torch.Tensor:
    """Category code of float32 values, int64: numpy's float32 -> int64
    cast (NaN, +-inf and |x| >= 2^63 give INT64_MIN), then a clip to
    [0, 255] — so all of those give 0."""
    bad = torch.isnan(x) | (x >= 2.0 ** 63) | (x < -(2.0 ** 63))
    return torch.where(bad, 0.0, x.clamp(0, MASK_WORDS * 32 - 1)).to(
        torch.int64)


def _traverse(X, feature, threshold, cat_mask, left_child, leaf_value,
              tree_depth):
    """X (N, F) f32; tables (S, M) / (S, M, W) / (S, M, O); tree_depth (S,)
    rounds per tree -> (N, S, O) leaf values."""
    N = X.shape[0]
    S, M = feature.shape
    O = leaf_value.shape[-1]
    flat = lambda a: a.reshape((S * M,) + a.shape[2:])
    feat, thr, cat, lc, leaf = map(flat, (feature, threshold, cat_mask,
                                          left_child, leaf_value))
    base = torch.arange(S, device=X.device) * M             # (S,)
    node = torch.zeros((N, S), dtype=torch.int64, device=X.device)
    rounds = int(tree_depth.max()) if S else 0
    for r in range(rounds):
        idx = node + base                                    # (N, S)
        f = feat[idx].clamp_min(0).to(torch.int64)
        x = torch.gather(X, 1, f)                            # (N, S)
        words = cat[idx]                                     # (N, S, W)
        code = cat_code(x)
        word = torch.gather(words, 2, (code >> 5).unsqueeze(-1)).squeeze(-1)
        bit = ((word.to(torch.int64) >> (code & 31)) & 1).bool()
        go = torch.where((words != 0).any(-1), bit, x >= thr[idx])
        child = lc[idx].to(torch.int64)
        live = (child >= 0) & (r < tree_depth)               # (N, S)
        node = torch.where(live, child + go.to(torch.int64), node)
    return leaf[node + base].reshape(N, S, O)


def forest_predict_ref(X, feature, threshold, cat_mask, left_child,
                       leaf_value, depth: int):
    """X: (N, F) f32; feature/left_child: (T, M) i32; threshold: (T, M) f32;
    cat_mask: (T, M, 8) i32 words; leaf_value: (T, M, O) f32
    -> (N, T, O), ``max(1, depth)`` rounds for every tree."""
    T = feature.shape[0]
    tree_depth = torch.full((T,), max(1, depth), dtype=torch.int64,
                            device=X.device)
    return _traverse(X, feature, threshold, cat_mask, left_child, leaf_value,
                     tree_depth)


def forest_predict_packed_ref(X, feature, threshold, cat_mask, left_child,
                              leaf_value, block_depth):
    """The CUDA kernel's function. X: (N, F) f32; feature/left_child
    (B, TB, M) i32; threshold (B, TB, M) f32; cat_mask (B, TB, M, 8) i32
    words; leaf_value (B, TB, M, O) f32; block_depth (B,) or (B, 1) i32
    -> (N, B*TB, O) in packed tree order."""
    B, TB, M = feature.shape
    S = B * TB
    tree_depth = block_depth.reshape(B, 1).expand(B, TB).reshape(S).to(
        torch.int64)
    return _traverse(X, feature.reshape(S, M), threshold.reshape(S, M),
                     cat_mask.reshape(S, M, MASK_WORDS),
                     left_child.reshape(S, M),
                     leaf_value.reshape(S, M, leaf_value.shape[-1]),
                     tree_depth)
