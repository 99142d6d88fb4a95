"""Plain PyTorch forest traversal: the oracle for the CUDA kernel.

Semantics of ``repro.core.tree.predict_raw``: numerical
``x >= threshold``; a node with a non-empty 256-bit category mask goes
right when the code's bit is set; a sparse-oblique node (``feature == -2``)
when ``proj >= threshold``, ``proj`` being the float32 sum over all P slots
of ``w[k] * x[col[k]]`` in numpy's pairwise order (``pairwise_sum``: the
order of the reference's ``(w * xs).sum(-1)`` and of the CUDA kernels);
leaves (``left_child < 0``) self-loop. Every (example, tree) pair advances
in lockstep by gathers.

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
PAIRWISE_BLOCK = 128     # numpy's PW_BLOCKSIZE: longer sums split in two


def pairwise_sum(p: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in numpy's float32 pairwise order, with
    elementwise adds only (never ``torch.sum``, ``matmul`` or ``einsum``,
    whose orders differ): n < 8 adds in order from -0.0; n <= 128 seeds
    eight accumulators with the first 8 values, adds the next ones 8 at a
    time, combines them as ((r0+r1)+(r2+r3))+((r4+r5)+(r6+r7)) and adds the
    remainder in order; a longer sum splits at n/2 rounded down to a
    multiple of 8 and adds the halves' sums."""
    n = p.shape[-1]
    if n < 8:
        res = torch.full(p.shape[:-1], -0.0, dtype=p.dtype, device=p.device)
        for i in range(n):
            res = res + p[..., i]
        return res
    if n <= PAIRWISE_BLOCK:
        r = p[..., :8]
        i = 8
        while i < n - n % 8:
            r = r + p[..., i:i + 8]
            i += 8
        res = (((r[..., 0] + r[..., 1]) + (r[..., 2] + r[..., 3]))
               + ((r[..., 4] + r[..., 5]) + (r[..., 6] + r[..., 7])))
        for k in range(i, n):
            res = res + p[..., k]
        return res
    n2 = n // 2
    n2 -= n2 % 8
    return pairwise_sum(p[..., :n2]) + pairwise_sum(p[..., n2:])


def oblique_proj(X: torch.Tensor, cols: torch.Tensor,
                 weights: torch.Tensor) -> torch.Tensor:
    """X (N, F) f32; cols (N, S, P) int64 and weights (N, S, P) f32 ->
    (N, S) projections: the products rounded to float32, then
    ``pairwise_sum``."""
    N, S, P = cols.shape
    xs = torch.gather(X, 1, cols.reshape(N, S * P)).reshape(N, S, P)
    return pairwise_sum(weights * xs)


def cat_code(x: torch.Tensor) -> torch.Tensor:
    """Category code of float32 values, int64: numpy's float32 -> int64
    cast (NaN, +-inf and |x| >= 2^63 give INT64_MIN), then a clip to
    [0, 255] — so all of those give 0."""
    bad = torch.isnan(x) | (x >= 2.0 ** 63) | (x < -(2.0 ** 63))
    return torch.where(bad, 0.0, x.clamp(0, MASK_WORDS * 32 - 1)).to(
        torch.int64)


def _traverse(X, feature, threshold, cat_mask, left_child, leaf_value,
              tree_depth, obl_features=None, obl_weights=None):
    """X (N, F) f32; tables (S, M) / (S, M, W) / (S, M, O), oblique tables
    (S, M, P) or None; tree_depth (S,) rounds per tree -> (N, S, O) leaf
    values."""
    N = X.shape[0]
    S, M = feature.shape
    O = leaf_value.shape[-1]
    flat = lambda a: a.reshape((S * M,) + a.shape[2:])
    feat, thr, cat, lc, leaf = map(flat, (feature, threshold, cat_mask,
                                          left_child, leaf_value))
    oblique = obl_features is not None and obl_features.shape[-1] > 0
    if oblique:
        ofeat, owt = flat(obl_features).to(torch.int64), flat(obl_weights)
    base = torch.arange(S, device=X.device) * M             # (S,)
    node = torch.zeros((N, S), dtype=torch.int64, device=X.device)
    rounds = int(tree_depth.max()) if S else 0
    for r in range(rounds):
        idx = node + base                                    # (N, S)
        fr = feat[idx]
        f = fr.clamp_min(0).to(torch.int64)
        x = torch.gather(X, 1, f)                            # (N, S)
        words = cat[idx]                                     # (N, S, W)
        code = cat_code(x)
        word = torch.gather(words, 2, (code >> 5).unsqueeze(-1)).squeeze(-1)
        bit = ((word.to(torch.int64) >> (code & 31)) & 1).bool()
        go = torch.where((words != 0).any(-1), bit, x >= thr[idx])
        if oblique:
            proj = oblique_proj(X, ofeat[idx], owt[idx])
            go = torch.where(fr == -2, proj >= thr[idx], go)
        child = lc[idx].to(torch.int64)
        live = (child >= 0) & (r < tree_depth)               # (N, S)
        node = torch.where(live, child + go.to(torch.int64), node)
    return leaf[node + base].reshape(N, S, O)


def forest_predict_ref(X, feature, threshold, cat_mask, left_child,
                       leaf_value, depth: int, obl_features=None,
                       obl_weights=None):
    """X: (N, F) f32; feature/left_child: (T, M) i32; threshold: (T, M) f32;
    cat_mask: (T, M, 8) i32 words; leaf_value: (T, M, O) f32;
    obl_features (T, M, P) i32 and obl_weights (T, M, P) f32, or None
    -> (N, T, O), ``max(1, depth)`` rounds for every tree."""
    T = feature.shape[0]
    tree_depth = torch.full((T,), max(1, depth), dtype=torch.int64,
                            device=X.device)
    return _traverse(X, feature, threshold, cat_mask, left_child, leaf_value,
                     tree_depth, obl_features, obl_weights)


def forest_predict_packed_ref(X, feature, threshold, cat_mask, left_child,
                              leaf_value, block_depth, obl_features=None,
                              obl_weights=None):
    """The CUDA kernel's function. X: (N, F) f32; feature/left_child
    (B, TB, M) i32; threshold (B, TB, M) f32; cat_mask (B, TB, M, 8) i32
    words; leaf_value (B, TB, M, O) f32; block_depth (B,) or (B, 1) i32;
    obl_features / obl_weights (B, TB, M, P) or None
    -> (N, B*TB, O) in packed tree order."""
    B, TB, M = feature.shape
    S = B * TB
    tree_depth = block_depth.reshape(B, 1).expand(B, TB).reshape(S).to(
        torch.int64)
    obl = (None, None) if obl_features is None else (
        obl_features.reshape(S, M, -1), obl_weights.reshape(S, M, -1))
    return _traverse(X, feature.reshape(S, M), threshold.reshape(S, M),
                     cat_mask.reshape(S, M, MASK_WORDS),
                     left_child.reshape(S, M),
                     leaf_value.reshape(S, M, leaf_value.shape[-1]),
                     tree_depth, *obl)
