"""Decision forests as structure-of-arrays (SoA), the port's copy.

The same layout as ``repro.core.tree``: per tree, arrays of capacity
``max_nodes``; children are allocated in pairs so ``right = left_child + 1``;
leaves have ``left_child == -1``. Two condition kinds are served:

  * numerical axis-aligned:  x[f] >= threshold
  * categorical set:         bit code(x[f]) of the node's 256-bit cat_mask

(sparse oblique conditions are not carried over; ``convert`` refuses them).

The numpy engines here (``predict_naive``, ``compile_predict_raw``) and the
aggregation heads are host code, as in the reference. ``pack_by_depth``
builds the depth-packed layout the CUDA traversal kernel reads
(kernels/forest_infer), array for array equal to the reference's.

Categorical codes follow numpy's float32 -> int64 cast as the reference's
CPU engines see it on x86: NaN, +-inf and |x| >= 2^63 cast to INT64_MIN,
which the clip to [0, 255] maps to 0 (so +inf gives code 0, not 255).
``cat_code`` writes that rule out instead of relying on the cast, whose
result for those values the C standard leaves undefined.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import numpy as np

MASK_WORDS = 8  # 8 * 32 = 256 category bits
_TWO_63 = np.float32(2.0 ** 63)


@dataclass
class Forest:
    """A stack of T trees with capacity M nodes each."""
    feature: np.ndarray        # (T, M) int32; -1 = leaf
    threshold: np.ndarray      # (T, M) float32 (raw-value domain)
    cat_mask: np.ndarray       # (T, M, MASK_WORDS) uint32; bit set -> go right
    left_child: np.ndarray     # (T, M) int32; -1 = leaf
    leaf_value: np.ndarray     # (T, M, leaf_dim) float32
    n_nodes: np.ndarray        # (T,) int32
    depth: int                 # max depth over trees
    out_dim: int = 1
    tree_class: np.ndarray | None = None  # (T,) int32: GBT multiclass tree->class
    init_pred: np.ndarray | None = None   # (out_dim,) float32 bias (GBT)
    feature_names: list[str] = field(default_factory=list)
    # training-side fields (None on forests carried across from the JAX
    # package): the binned-domain threshold, and the split gain recorded
    # for structural importances
    split_bin: np.ndarray | None = None   # (T, M) uint16
    split_gain: np.ndarray | None = None  # (T, M) float32

    @property
    def n_trees(self) -> int:
        return self.feature.shape[0]

    @property
    def max_nodes(self) -> int:
        return self.feature.shape[1]

    def truncated(self, n_trees: int) -> "Forest":
        sl = lambda a: None if a is None else a[:n_trees]
        return dataclasses.replace(
            self, feature=sl(self.feature), threshold=sl(self.threshold),
            split_bin=sl(self.split_bin), cat_mask=sl(self.cat_mask),
            left_child=sl(self.left_child), leaf_value=sl(self.leaf_value),
            n_nodes=sl(self.n_nodes), split_gain=sl(self.split_gain),
            tree_class=sl(self.tree_class))


def empty_forest(n_trees: int, max_nodes: int, out_dim: int, *,
                 feature_names: list[str] | None = None) -> Forest:
    T, M = n_trees, max_nodes
    return Forest(
        feature=np.full((T, M), -1, np.int32),
        threshold=np.zeros((T, M), np.float32),
        cat_mask=np.zeros((T, M, MASK_WORDS), np.uint32),
        left_child=np.full((T, M), -1, np.int32),
        leaf_value=np.zeros((T, M, out_dim), np.float32),
        n_nodes=np.ones(T, np.int32),
        depth=0,
        out_dim=out_dim,
        tree_class=np.zeros(T, np.int32),
        init_pred=np.zeros(out_dim, np.float32),
        feature_names=list(feature_names or []),
        split_bin=np.zeros((T, M), np.uint16),
        split_gain=np.zeros((T, M), np.float32),
    )


def node_depths(forest: Forest) -> np.ndarray:
    """Per-node depth, (T, M) int32, -1 for unreachable slots: one
    level-order frontier propagation. First visit wins, and already-visited
    children are dropped from the frontier, so a corrupt SoA with a child
    back-edge terminates instead of looping."""
    T, M = forest.feature.shape
    depth = np.full((T, M), -1, np.int32)
    if T == 0:
        return depth
    depth[:, 0] = 0
    cur_t = np.arange(T, dtype=np.int64)
    cur_n = np.zeros(T, np.int64)
    level = 0
    while cur_t.size:
        lc = forest.left_child[cur_t, cur_n]
        m = (lc >= 0) & (lc + 1 < M)
        if not m.any():
            break
        level += 1
        ct, cl = cur_t[m], lc[m]
        fresh = (depth[ct, cl] < 0) & (depth[ct, cl + 1] < 0)
        ct, cl = ct[fresh], cl[fresh]
        if not ct.size:
            break
        depth[ct, cl] = level
        depth[ct, cl + 1] = level
        cur_t = np.concatenate([ct, ct])
        cur_n = np.concatenate([cl, cl + 1])
    return depth


def tree_depths(forest: Forest) -> np.ndarray:
    """Per-tree depth, (T,) int32: the deepest reachable level of each tree."""
    if forest.n_trees == 0:
        return np.zeros(0, np.int32)
    return np.maximum(node_depths(forest).max(axis=1), 0).astype(np.int32)


def cat_code(x) -> np.ndarray:
    """Category code of raw values: numpy's float32 -> int64 cast (x86),
    then a clip to [0, 255]. NaN, +-inf and |x| >= 2^63 give 0."""
    x = np.asarray(x, np.float32)
    bad = np.isnan(x) | (x >= _TWO_63) | (x < -_TWO_63)
    clipped = np.clip(np.where(bad, np.float32(0), x), 0, MASK_WORDS * 32 - 1)
    return np.where(bad, 0, np.trunc(clipped)).astype(np.int64)


# =====================================================================
# Reference engines (numpy).
# =====================================================================

def eval_node_conditions(forest: Forest, X: np.ndarray, t: np.ndarray,
                         node: np.ndarray) -> np.ndarray:
    """Go-right decisions of nodes ``(t, node)`` (broadcast (N, T)) for rows
    ``X`` ((N, 1, F) or broadcastable); False at leaves."""
    f = forest.feature[t, node]                       # (N, T)
    x = np.take_along_axis(X, np.maximum(f, 0)[..., None], axis=-1)[..., 0]
    go = x >= forest.threshold[t, node]
    cat = forest.cat_mask[t, node]                    # (N, T, MASK_WORDS)
    code = cat_code(x)
    word = np.take_along_axis(cat, (code // 32)[..., None], axis=-1)[..., 0]
    bit = (word >> (code % 32).astype(np.uint32)) & 1
    go = np.where(cat.any(axis=-1), bit.astype(bool), go)
    return np.where(f == -1, False, go)


def predict_raw(forest: Forest, X: np.ndarray) -> np.ndarray:
    """Lockstep traversal of every (example, tree) pair for ``depth`` rounds
    of gathers. X: (N, F) float32 -> (N, T, leaf_dim)."""
    N = X.shape[0]
    T = forest.n_trees
    t = np.arange(T)[None, :].repeat(N, 0)        # (N, T)
    node = np.zeros((N, T), np.int64)
    Xe = X[:, None, :]                             # (N, 1, F) over trees
    for _ in range(max(1, forest.depth)):
        go = eval_node_conditions(forest, Xe, t, node)
        child = forest.left_child[t, node]
        node = np.where(child >= 0, child + go, node)
    return forest.leaf_value[t, node]


def predict_naive(forest: Forest, X: np.ndarray) -> np.ndarray:
    """Algorithm 1 of the paper: per-example while-loop. The readable
    oracle. X: (N, F) float32 -> (N, T, leaf_dim).

    The node tables and rows are read as Python lists (float32 values widen
    to float exactly, so every comparison is the float32 one); the leaf
    values are gathered once at the end."""
    N, T = X.shape[0], forest.n_trees
    left, feature = forest.left_child.tolist(), forest.feature.tolist()
    threshold = forest.threshold.tolist()
    is_cat = forest.cat_mask.any(axis=-1).tolist()
    leaf = np.zeros((N, T), np.int64)
    for n, x in enumerate(np.asarray(X, np.float32).tolist()):
        for t in range(T):
            lc, ft, th, ic = left[t], feature[t], threshold[t], is_cat[t]
            node = 0
            while lc[node] >= 0:
                f = ft[node]
                if ic[node]:
                    code = int(cat_code(x[f]))
                    go = bool((forest.cat_mask[t, node, code // 32]
                               >> (code % 32)) & 1)
                else:
                    go = x[f] >= th[node]
                node = lc[node] + int(go)
            leaf[n, t] = node
    return forest.leaf_value[np.arange(T)[None, :], leaf]


def compile_predict_raw(forest: Forest):
    """One-time specialization of the lockstep numpy traversal for serving
    (the "vectorized" engine, paper §5.1): node tables flattened once and
    trimmed to the live node capacity, gathers into reused scratch buffers,
    one 32-bit mask word gathered per categorical test, and the categorical
    path dropped when the forest has none.
    Returns ``run(X: (N, F) float32) -> (N, T, leaf_dim) float32``."""
    T = forest.n_trees
    O = forest.leaf_value.shape[-1]
    if T == 0:
        return lambda X: np.zeros((X.shape[0], 0, O), np.float32)
    M = max(1, int(forest.n_nodes.max()))      # live-capacity trim
    depth = max(1, forest.depth)
    has_cat = bool(forest.cat_mask.any())
    # tree-blocked tables: each block's node tables stay cache-resident
    # through all `depth` gather rounds
    TB = int(np.clip(16384 // M, 1, T))
    blocks = []
    for b0 in range(0, T, TB):
        k = min(TB, T - b0)
        sl = slice(b0, b0 + k)
        blk = {
            "k": k,
            "feat": np.ascontiguousarray(
                np.maximum(forest.feature[sl, :M], 0).astype(np.intp).ravel()),
            "thr": np.ascontiguousarray(forest.threshold[sl, :M].ravel()),
            "lc": np.ascontiguousarray(
                forest.left_child[sl, :M].astype(np.intp).ravel()),
            "leaf": np.ascontiguousarray(
                forest.leaf_value[sl, :M].reshape(k * M, O)),
            "off": (np.arange(k, dtype=np.intp) * M)[None, :],
        }
        if has_cat:
            blk["iscat"] = forest.cat_mask[sl, :M].any(-1).ravel()
            blk["catw"] = np.ascontiguousarray(forest.cat_mask[sl, :M].ravel())
        blocks.append(blk)

    def run(X: np.ndarray) -> np.ndarray:
        N = X.shape[0]
        Xf = np.ascontiguousarray(X, np.float32).ravel()
        row_base = (np.arange(N, dtype=np.intp) * X.shape[1])[:, None]
        out = np.empty((N, T, O), np.float32)
        c0 = 0
        for blk in blocks:
            k, off = blk["k"], blk["off"]
            node = np.zeros((N, k), np.intp)
            idx = np.empty((N, k), np.intp)
            gat = np.empty((N, k), np.intp)   # shared int gather scratch
            x = np.empty((N, k), np.float32)
            for _ in range(depth):
                np.add(node, off, out=idx)                     # (N, k) flat
                blk["feat"].take(idx, out=gat)
                np.add(gat, row_base, out=gat)
                Xf.take(gat, out=x)
                go = x >= blk["thr"].take(idx)
                if has_cat:
                    code = cat_code(x)
                    word = blk["catw"].take(idx * MASK_WORDS + (code >> 5))
                    bit = (word >> (code & 31).astype(np.uint32)) & 1
                    go = np.where(blk["iscat"].take(idx),
                                  bit.astype(bool), go)
                blk["lc"].take(idx, out=gat)
                node = np.where(gat >= 0, gat + go, node)
            out[:, c0:c0 + k] = blk["leaf"][node + off]
            c0 += k
        return out

    return run


# ------------------------------------------------- depth-packed layout (§5.3)

@dataclass
class PackedForest:
    """Depth-packed SoA: trees sorted by depth, grouped into ``n_blocks``
    blocks of ``trees_per_block``, node capacity trimmed to the forest's
    live node count (padded to ``node_tile``). ``block_depth`` bounds the
    traversal loop per block, and ``inv_order`` restores the original tree
    order after the kernel."""
    feature: np.ndarray      # (B, TB, M) int32
    threshold: np.ndarray    # (B, TB, M) float32
    cat_mask: np.ndarray     # (B, TB, M, MASK_WORDS) uint32
    left_child: np.ndarray   # (B, TB, M) int32
    leaf_value: np.ndarray   # (B, TB, M, leaf_dim) float32
    block_depth: np.ndarray  # (B, 1) int32: max tree depth within the block
    inv_order: np.ndarray    # (T,) int32: original tree t lives at packed
                             # slot inv_order[t] (flat over (B, TB))
    n_trees: int             # original T (packed slots beyond are padding)
    out_dim: int             # trailing leaf dim

    @property
    def n_blocks(self) -> int:
        return self.feature.shape[0]

    @property
    def trees_per_block(self) -> int:
        return self.feature.shape[1]

    @property
    def max_nodes(self) -> int:
        return self.feature.shape[2]


def pack_by_depth(forest: Forest, *, trees_per_block: int | None = None,
                  node_tile: int = 128,
                  block_budget_bytes: int = 4 * 1024 * 1024) -> PackedForest:
    """Pack a Forest for the traversal kernel.

    Trees are sorted by depth (stable) so each block is depth-homogeneous
    and the kernel runs ``block_depth[b]`` rounds instead of the global
    max. ``trees_per_block`` defaults to as many trees (at most 8) as fit
    ``block_budget_bytes`` at the reference's per-tree byte count, so both
    packages pack a forest into the same blocks."""
    T = forest.n_trees
    O = forest.leaf_value.shape[-1]
    depths = tree_depths(forest)
    live = int(forest.n_nodes.max()) if T else 1
    M = max(node_tile, -(-live // node_tile) * node_tile)
    bytes_per_tree = M * (4 * 3 + 2 * 4 * MASK_WORDS + 4 * O)
    if trees_per_block is None:
        trees_per_block = int(max(1, min(8, block_budget_bytes
                                         // max(1, bytes_per_tree))))
    TB = min(trees_per_block, max(1, T))
    order = np.argsort(depths, kind="stable").astype(np.int32)  # slot -> tree
    B = -(-max(1, T) // TB)
    S = B * TB

    def take(a, fill=0):
        # (T, M_old, ...) -> (B, TB, M, ...) in sorted order, padded trees
        out_shape = (S, M) + a.shape[2:]
        out = np.full(out_shape, fill, a.dtype)
        if T:
            m = min(M, a.shape[1])
            out[:T, :m] = a[order][:, :m]
        return out.reshape((B, TB) + out_shape[1:])

    block_depth = np.zeros((B, 1), np.int32)
    if T:
        sorted_d = np.zeros(S, np.int32)
        sorted_d[:T] = depths[order]
        block_depth[:, 0] = np.maximum(sorted_d.reshape(B, TB).max(axis=1), 1)
    inv_order = np.empty(T, np.int32)
    inv_order[order] = np.arange(T, dtype=np.int32)
    return PackedForest(feature=take(forest.feature, -1),
                        threshold=take(forest.threshold),
                        cat_mask=take(forest.cat_mask),
                        left_child=take(forest.left_child, -1),
                        leaf_value=take(forest.leaf_value),
                        block_depth=block_depth, inv_order=inv_order,
                        n_trees=T, out_dim=O)


# ------------------------------------------------------------ aggregation

def aggregate_gbt(per_tree: np.ndarray, forest: Forest) -> np.ndarray:
    """Sum tree outputs into (N, out_dim) logits/score, adding init_pred."""
    N, T = per_tree.shape[:2]
    out = np.tile(forest.init_pred[None, :], (N, 1)).astype(np.float32)
    if forest.out_dim == 1 or forest.tree_class is None:
        out += per_tree.sum(axis=1)[:, : forest.out_dim]
    else:
        for c in range(forest.out_dim):
            sel = forest.tree_class == c
            out[:, c] += per_tree[:, sel, 0].sum(axis=1)
    return out


def aggregate_rf(per_tree: np.ndarray, winner_take_all: bool) -> np.ndarray:
    """per_tree: (N, T, C) leaf distributions -> (N, C) probabilities."""
    if winner_take_all and per_tree.shape[-1] > 1:
        votes = per_tree.argmax(-1)                     # (N, T)
        C = per_tree.shape[-1]
        out = np.zeros((per_tree.shape[0], C), np.float32)
        for c in range(C):
            out[:, c] = (votes == c).mean(axis=1)
        return out
    return per_tree.mean(axis=1)
