"""Decision forests as structure-of-arrays (SoA), the port's copy.

The same layout as ``repro.core.tree``: per tree, arrays of capacity
``max_nodes``; children are allocated in pairs so ``right = left_child + 1``;
leaves have ``left_child == -1``. Three condition kinds (paper §3.8):

  * numerical axis-aligned:  x[f] >= threshold
  * categorical set:         bit code(x[f]) of the node's 256-bit cat_mask
  * sparse oblique:          sum_k w_k * x[f_k] >= threshold (feature == -2;
                             Tomita et al.), the weights and columns in
                             ``obl_weights`` / ``obl_features``, (T, M, P)

An oblique node's projection is the float32 sum over all P slots (the
padding's weight 0 on column 0 included) in numpy's pairwise order, as the
reference's vectorized engine computes ``(w * xs).sum(-1)``;
``predict_naive`` takes ``np.dot`` as the reference's does, whose BLAS order
may differ in the last bit, and so may disagree at a near-tie with the
threshold (ROADMAP C).

The numpy engines here (``predict_naive``, ``compile_predict_raw``) and the
aggregation heads are host code, as in the reference. ``pack_by_depth``
builds the depth-packed layout the CUDA traversal kernel reads
(kernels/forest_infer), array for array equal to the reference's, plus the
port's oblique tables in slot order.

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
    feature: np.ndarray        # (T, M) int32; -1 = leaf, -2 = oblique
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
    # sparse-oblique conditions (None when the forest has none)
    obl_weights: np.ndarray | None = None   # (T, M, P) float32
    obl_features: np.ndarray | None = None  # (T, M, P) int32

    @property
    def n_trees(self) -> int:
        return self.feature.shape[0]

    @property
    def max_nodes(self) -> int:
        return self.feature.shape[1]

    def has_oblique(self) -> bool:
        """True when any node carries a sparse-oblique condition (the
        single source of truth for engine-compatibility checks)."""
        return bool(self.obl_weights is not None and self.obl_weights.shape[-1]
                    and (self.feature == -2).any())

    def to_trees(self, *, value_kind: str | None = None) -> list:
        """The SoA as typed ``py_tree.Tree`` nodes (inspect/edit format)."""
        from repro_torch.core.py_tree import forest_to_trees
        return forest_to_trees(self, value_kind=value_kind)

    @staticmethod
    def from_trees(trees: list, **kw) -> "Forest":
        """Typed trees -> SoA; ``from_trees(f.to_trees(), like=f)`` is
        bit-identical for compact forests. See py_tree.forest_from_trees."""
        from repro_torch.core.py_tree import forest_from_trees
        return forest_from_trees(trees, **kw)

    def truncated(self, n_trees: int) -> "Forest":
        sl = lambda a: None if a is None else a[:n_trees]
        return dataclasses.replace(
            self, feature=sl(self.feature), threshold=sl(self.threshold),
            split_bin=sl(self.split_bin), cat_mask=sl(self.cat_mask),
            left_child=sl(self.left_child), leaf_value=sl(self.leaf_value),
            n_nodes=sl(self.n_nodes), split_gain=sl(self.split_gain),
            obl_weights=sl(self.obl_weights),
            obl_features=sl(self.obl_features),
            tree_class=sl(self.tree_class))

    # -------------------------------------------------- structure stats
    def node_counts(self) -> dict:
        # a leaf is any reachable node without children, including CART-
        # pruned nodes, which keep their stale condition but no children
        leaves = (self.left_child < 0) & _reachable(self)
        per_tree = leaves.sum(1)
        return {"n_trees": self.n_trees, "total_nodes": int(self.n_nodes.sum()),
                "leaves_per_tree_mean": float(per_tree.mean()),
                "nodes_per_tree_mean": float(self.n_nodes.mean())}

    def variable_importances(self) -> dict[str, dict[str, float]]:
        """Structural variable importances (paper App. B.2), one vectorized
        pass over the SoA:

          * NUM_NODES          — #splits using the feature
          * NUM_AS_ROOT        — #trees whose root splits on it
          * SUM_SCORE          — total split gain (recorded at training time;
                                 omitted when no gains were recorded)
          * INV_MEAN_MIN_DEPTH — 1 / (1 + mean over trees of the minimal
                                 depth at which the feature appears; a tree
                                 not using the feature contributes its own
                                 depth). Higher = closer to the roots.

        Every kind is higher-is-more-important so reports can share one
        sort order. A pruned node (CART: left_child reset to -1 while the
        stale condition remains) is a leaf and counts toward nothing.
        """
        depth = node_depths(self)
        reach = depth >= 0
        internal = (self.left_child >= 0) & reach
        F = len(self.feature_names)
        name_of = self.feature_names

        def table(counts: np.ndarray) -> dict[str, float]:
            return {name_of[j]: float(counts[j]) for j in range(F)}

        t_idx, n_idx = np.nonzero(internal)
        feats = self.feature[t_idx, n_idx]
        # oblique nodes (feature == -2) reference several columns each
        if (feats == -2).any() and self.obl_features is not None:
            ax = feats >= 0
            obl = feats == -2
            w = self.obl_weights[t_idx[obl], n_idx[obl]]       # (n_obl, P)
            fo = self.obl_features[t_idx[obl], n_idx[obl]]
            live = w != 0.0
            t_ax = np.concatenate([t_idx[ax], np.repeat(t_idx[obl], live.sum(1))])
            n_ax = np.concatenate([n_idx[ax], np.repeat(n_idx[obl], live.sum(1))])
            f_ax = np.concatenate([feats[ax], fo[live]])
        else:
            keep = feats >= 0
            t_ax, n_ax, f_ax = t_idx[keep], n_idx[keep], feats[keep]
        ok = (f_ax >= 0) & (f_ax < F)
        t_ax, n_ax, f_ax = t_ax[ok], n_ax[ok], f_ax[ok]

        out = {"NUM_NODES": table(np.bincount(f_ax, minlength=F))}
        roots = self.feature[:, 0]
        root_counts = np.bincount(
            roots[(roots >= 0) & (roots < F)], minlength=F).astype(np.float64)
        if (roots == -2).any() and self.obl_features is not None:
            # oblique roots credit every feature they project over, matching
            # the NUM_NODES / min-depth expansion above
            ow = self.obl_weights[roots == -2, 0]
            of = self.obl_features[roots == -2, 0]
            fr = of[ow != 0.0]
            root_counts += np.bincount(fr[(fr >= 0) & (fr < F)], minlength=F)
        out["NUM_AS_ROOT"] = table(root_counts)
        sg = self.split_gain
        if sg is not None and len(f_ax) and sg[t_ax, n_ax].any():
            out["SUM_SCORE"] = table(np.bincount(
                f_ax, weights=np.maximum(sg[t_ax, n_ax], 0.0), minlength=F))
        if F:
            # min depth of each feature per tree; absent -> the tree's depth
            T = self.n_trees
            tree_depth = np.maximum(depth.max(axis=1), 0).astype(np.float64)
            min_depth = np.tile(tree_depth[:, None], (1, F))
            np.minimum.at(min_depth, (t_ax, f_ax),
                          depth[t_ax, n_ax].astype(np.float64))
            out["INV_MEAN_MIN_DEPTH"] = table(
                1.0 / (1.0 + min_depth.mean(axis=0))) if T else table(
                np.ones(F))
        return out


def empty_forest(n_trees: int, max_nodes: int, out_dim: int, *,
                 oblique_dims: int = 0,
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
        obl_weights=(np.zeros((T, M, oblique_dims), np.float32)
                     if oblique_dims else None),
        obl_features=(np.zeros((T, M, oblique_dims), np.int32)
                      if oblique_dims else None),
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


def _reachable(forest: Forest) -> np.ndarray:
    return node_depths(forest) >= 0


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
    ``X`` ((N, 1, F) or broadcastable); False at leaves. An oblique node's
    projection sums all P products in numpy's pairwise order (the
    reference's ``(w * xs).sum(-1)``)."""
    f = forest.feature[t, node]                       # (N, T)
    x = np.take_along_axis(X, np.maximum(f, 0)[..., None], axis=-1)[..., 0]
    go = x >= forest.threshold[t, node]
    cat = forest.cat_mask[t, node]                    # (N, T, MASK_WORDS)
    code = cat_code(x)
    word = np.take_along_axis(cat, (code // 32)[..., None], axis=-1)[..., 0]
    bit = (word >> (code % 32).astype(np.uint32)) & 1
    go = np.where(cat.any(axis=-1), bit.astype(bool), go)
    if forest.obl_weights is not None and forest.obl_weights.shape[-1]:
        w = forest.obl_weights[t, node]               # (N, T, P)
        fo = forest.obl_features[t, node]             # (N, T, P)
        xs = np.take_along_axis(np.broadcast_to(X, fo.shape[:2] + X.shape[-1:]),
                                fo, axis=-1)
        proj = (w * xs).sum(-1)
        go = np.where(f == -2, proj >= forest.threshold[t, node], go)
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
    values are gathered once at the end. An oblique node projects with
    ``np.dot`` over the float32 row, as the reference's does."""
    N, T = X.shape[0], forest.n_trees
    left, feature = forest.left_child.tolist(), forest.feature.tolist()
    threshold = forest.threshold.tolist()
    is_cat = forest.cat_mask.any(axis=-1).tolist()
    X32 = np.asarray(X, np.float32)
    leaf = np.zeros((N, T), np.int64)
    for n, x in enumerate(X32.tolist()):
        for t in range(T):
            lc, ft, th, ic = left[t], feature[t], threshold[t], is_cat[t]
            node = 0
            while lc[node] >= 0:
                f = ft[node]
                if f == -2:
                    proj = float(np.dot(forest.obl_weights[t, node],
                                        X32[n, forest.obl_features[t, node]]))
                    go = proj >= forest.threshold[t, node]
                elif ic[node]:
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
    path dropped when the forest has none. An oblique forest keeps the
    generic lockstep traversal, as the reference's does.
    Returns ``run(X: (N, F) float32) -> (N, T, leaf_dim) float32``."""
    if forest.has_oblique():
        return lambda X: predict_raw(forest, X)
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


# --------------------------------------------- depth-bucketed layout (§10)
#
# The compiled numpy traversal and the depth-packed kernel layout both pay
# a block's (or the forest's) max depth in lockstep rounds. The bucketed
# layout groups trees into a handful of depth-homogeneous BUCKETS so each
# bucket runs exactly its own depth of rounds, and each bucket chooses its
# scoring strategy:
#
#   * "scan"      — flat-table lockstep traversal with sentinel leaves
#                   (leaves self-loop via a zero-valued sentinel feature
#                   column, so a round is gather + compare + advance with
#                   no leaf masking);
#   * "leaf_path" — root-to-leaf paths enumerated as a signed predicate
#                   matrix plus leaf-value table: every internal condition
#                   is evaluated in one pass and a batched matmul counts
#                   per-path predicate hits, with no traversal loop (the
#                   SIMD decision-tree transform, arXiv:2205.07307).
#
# The tables here are host numpy, array for array the reference's;
# kernels/forest_infer/bucketed.py uploads them and runs them in PyTorch.

LEAF_PATH_BUDGET = 1 << 14   # max internal x leaf predicate entries per tree


@dataclass
class TreeBucket:
    """One depth-homogeneous group of trees plus its scoring tables."""
    trees: np.ndarray        # original tree indices in this bucket
    depth: int               # max actual depth within the bucket
    strategy: str            # "scan" | "leaf_path"
    tables: dict             # strategy-specific numpy tables


@dataclass
class BucketedForest:
    """Depth-bucketed layout (DESIGN.md §10.1)."""
    buckets: list
    inv_order: np.ndarray    # original tree t lives at packed slot inv_order[t]
    n_trees: int
    out_dim: int             # trailing leaf dim


def plan_depth_buckets(depths: np.ndarray, *, max_buckets: int = 4,
                       min_trees: int = 8) -> list[np.ndarray]:
    """Group trees into <= ``max_buckets`` depth-homogeneous buckets.

    Trees are sorted by actual depth; runs of equal depth seed the buckets,
    then adjacent buckets merge greedily by least extra traversal cost
    (trees in the shallower bucket x the depth gap) until the bucket count
    and the ``min_trees`` floor (tiny buckets are pure dispatch overhead)
    are both satisfied. Deterministic, so engine selection is testable."""
    T = len(depths)
    if T == 0:
        return []
    order = np.argsort(depths, kind="stable")
    sd = np.asarray(depths)[order]
    bounds = [0] + [i for i in range(1, T) if sd[i] != sd[i - 1]] + [T]
    buckets = [[bounds[i], bounds[i + 1]] for i in range(len(bounds) - 1)]

    def merge_cost(i: int) -> int:
        a, b = buckets[i], buckets[i + 1]
        return int((sd[b[1] - 1] - sd[a[0]:a[1]]).sum())

    while len(buckets) > 1:
        small = any(e - s < min_trees for s, e in buckets)
        if len(buckets) <= max_buckets and not small:
            break
        i = int(np.argmin([merge_cost(j) for j in range(len(buckets) - 1)]))
        buckets[i] = [buckets[i][0], buckets[i + 1][1]]
        del buckets[i + 1]
    return [order[s:e] for s, e in buckets]


def _bucket_path_sizes(forest: Forest, sub) -> tuple[int, int]:
    """(max internal nodes, max leaves) over the trees ``sub``."""
    reach = _reachable(forest)[sub]
    lc = forest.left_child[sub]
    internal = reach & (lc >= 0)
    leaves = reach & (lc < 0)
    return int(internal.sum(1).max()), max(1, int(leaves.sum(1).max()))


def leaf_path_sizes(forest: Forest) -> tuple[int, int]:
    """(max internal nodes, max leaves) over trees: the predicate-matrix
    footprint that gates the leaf_path engine (engines.py)."""
    if forest.n_trees == 0:
        return 0, 1
    return _bucket_path_sizes(forest, slice(None))


def select_block_strategy(depth: int, n_internal: int, n_leaves: int, *,
                          matmul_cheap: bool = False,
                          leaf_path_budget: int = LEAF_PATH_BUDGET) -> str:
    """Pick the scoring strategy for one bucket.

    The matmul evaluates all ``n_internal`` conditions of a tree where the
    scan evaluates ``depth``, so leaf_path is chosen only where the matmul
    is cheap on the device (``matmul_cheap``, decided per device by
    ``kernels/forest_infer/ops.MATMUL_CHEAP`` from a measurement) and the
    predicate matrix of a shallow tree stays small."""
    if matmul_cheap and depth <= 6 and n_internal * n_leaves <= leaf_path_budget:
        return "leaf_path"
    return "scan"


def _flatten_scan_bucket(forest: Forest, sub: np.ndarray) -> dict:
    """Flat global-id tables for the scan strategy. Leaves become sentinel
    nodes: feature -1 (rewritten at run time to a zero-valued sentinel
    column appended to X), threshold +inf, child = the node's own flat id,
    so a finished (example, tree) lane keeps gathering ``0 >= inf -> stay``
    with no leaf mask or conditional select in the round."""
    k = len(sub)
    M = max(1, int(forest.n_nodes[sub].max()))
    O = forest.leaf_value.shape[-1]
    feat = forest.feature[sub][:, :M].astype(np.int32)
    thr = forest.threshold[sub][:, :M].astype(np.float32)
    lc = forest.left_child[sub][:, :M].astype(np.int32)
    cat = forest.cat_mask[sub][:, :M]
    node_ids = np.broadcast_to(np.arange(M, dtype=np.int32)[None, :], (k, M))
    off = (np.arange(k, dtype=np.int32) * M)[:, None]
    is_leaf = lc < 0
    iscat = cat.any(-1) & ~is_leaf   # a stale mask on a leaf slot must not
    #                                  override the sentinel 0 >= inf self-loop
    return {
        "feature": np.where(is_leaf, np.int32(-1), feat).ravel(),
        "threshold": np.where(is_leaf, np.float32(np.inf), thr).ravel(),
        "child": (np.where(is_leaf, node_ids, lc) + off).ravel(),
        "leaf_value": np.ascontiguousarray(
            forest.leaf_value[sub][:, :M]).reshape(k * M, O),
        "root": np.ascontiguousarray(off[:, 0]),
        "is_cat": iscat.ravel(),
        "cat_words": np.ascontiguousarray(cat).reshape(k * M, MASK_WORDS),
        "has_cat": bool(iscat.any()),
    }


def enumerate_leaf_paths(forest: Forest, sub: np.ndarray) -> dict:
    """Root-to-leaf paths of every tree in ``sub`` as predicate tables.

    Per tree: internal-node conditions (feature/threshold/category mask,
    padded to the bucket-wide ``I`` with never-true sentinels) and a signed
    path matrix ``P`` (I, L): +1 where leaf l's path turns RIGHT at internal
    node i, -1 where it turns LEFT, 0 off-path. With C the 0/1 condition
    vector, ``C @ P + base`` counts correct decisions along each path
    (``base[l]`` = number of left turns); exactly the true leaf reaches its
    ``path_len``, so argmax(hits - path_len) selects it. All sums are small
    integers in float32, hence exact, hence bit-identical to traversal."""
    k = len(sub)
    O = forest.leaf_value.shape[-1]
    per = []
    for t in sub:
        lc = forest.left_child[t]
        internal: list[int] = []
        leaves: list[tuple[int, list]] = []
        stack: list[tuple[int, list]] = [(0, [])]
        while stack:
            node, path = stack.pop()
            if lc[node] < 0:
                leaves.append((node, path))
            else:
                li = len(internal)
                internal.append(node)
                stack.append((lc[node] + 1, path + [(li, 1)]))
                stack.append((lc[node], path + [(li, 0)]))
        per.append((internal, leaves))
    I = max(1, max(len(p[0]) for p in per))
    L = max(1, max(len(p[1]) for p in per))
    feat = np.zeros((k, I), np.int32)
    thr = np.full((k, I), np.inf, np.float32)
    iscat = np.zeros((k, I), bool)
    catw = np.zeros((k, I, MASK_WORDS), np.uint32)
    P = np.zeros((k, I, L), np.float32)
    base = np.zeros((k, L), np.float32)
    plen = np.full((k, L), np.float32(2 ** 20), np.float32)  # pads never match
    leafv = np.zeros((k, L, O), np.float32)
    for j, (t, (internal, leaves)) in enumerate(zip(sub, per)):
        for li, node in enumerate(internal):
            feat[j, li] = forest.feature[t, node]
            thr[j, li] = forest.threshold[t, node]
            cm = forest.cat_mask[t, node]
            if cm.any():
                iscat[j, li] = True
                catw[j, li] = cm
        for l, (node, path) in enumerate(leaves):
            plen[j, l] = len(path)
            leafv[j, l] = forest.leaf_value[t, node]
            for li, go in path:
                P[j, li, l] = 1.0 if go else -1.0
                if not go:
                    base[j, l] += 1.0
    return {"feature": feat, "threshold": thr, "is_cat": iscat,
            "cat_words": catw, "paths": P, "base": base, "path_len": plen,
            "leaf_value": leafv, "has_cat": bool(iscat.any()),
            "n_internal": I, "n_leaves": L}


def pack_depth_buckets(forest: Forest, *, strategy: str | None = None,
                       max_buckets: int = 4, min_trees: int = 8,
                       matmul_cheap: bool = False) -> BucketedForest:
    """Pack a Forest into the depth-bucketed layout (DESIGN.md §10.1).

    ``strategy`` forces "scan" or "leaf_path" for every bucket; None lets
    ``select_block_strategy`` choose per bucket. Oblique forests raise
    ``ValueError`` (the engine layer refuses them first, naming the
    engines that serve them)."""
    if forest.has_oblique():
        raise ValueError("bucketed packing does not support oblique forests")
    T = forest.n_trees
    O = forest.leaf_value.shape[-1]
    depths = tree_depths(forest)
    subs = plan_depth_buckets(depths, max_buckets=max_buckets,
                              min_trees=min_trees)
    buckets = []
    for sub in subs:
        d = int(depths[sub].max())
        if strategy is not None:
            strat = strategy
        else:
            strat = select_block_strategy(
                d, *_bucket_path_sizes(forest, sub), matmul_cheap=matmul_cheap)
        if strat == "leaf_path":
            tables = enumerate_leaf_paths(forest, sub)
        else:
            strat = "scan"
            tables = _flatten_scan_bucket(forest, sub)
        buckets.append(TreeBucket(trees=sub, depth=max(1, d), strategy=strat,
                                  tables=tables))
    order = (np.concatenate([b.trees for b in buckets])
             if buckets else np.zeros(0, np.int64))
    inv_order = np.empty(T, np.int64)
    inv_order[order] = np.arange(T)
    return BucketedForest(buckets=buckets, inv_order=inv_order, n_trees=T,
                          out_dim=O)


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
    # the port's oblique tables in slot order, (B, TB, M, P); None when the
    # forest has none (the reference's pack carries no oblique fields)
    obl_weights: np.ndarray | None = None
    obl_features: np.ndarray | None = None

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
    obl = forest.has_oblique()
    return PackedForest(feature=take(forest.feature, -1),
                        threshold=take(forest.threshold),
                        cat_mask=take(forest.cat_mask),
                        left_child=take(forest.left_child, -1),
                        leaf_value=take(forest.leaf_value),
                        block_depth=block_depth, inv_order=inv_order,
                        n_trees=T, out_dim=O,
                        obl_weights=take(forest.obl_weights) if obl else None,
                        obl_features=take(forest.obl_features) if obl else None)


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


def aggregate_rf(per_tree: np.ndarray, winner_take_all: bool,
                 nan_free: bool = False) -> np.ndarray:
    """per_tree: (N, T, C) leaf distributions -> (N, C) probabilities.

    Winner-take-all (C > 1): each tree votes for the class of its largest
    leaf value, and a class's probability is its share of the T votes,
    ``count / T`` in float64 rounded once to float32. A tie goes to the
    lowest class index, as ``argmax`` gives it. ``nan_free`` says that no
    leaf can read NaN (``RandomForestModel._compile_finalize`` knows it
    from the forest's leaves): the votes are then counted by strict
    comparisons of the class slices. Otherwise the votes are taken by
    ``argmax``, where the first NaN along the class axis wins. Both give the
    same bits where both apply. Without winner-take-all: the mean over
    trees."""
    if not (winner_take_all and per_tree.shape[-1] > 1):
        return per_tree.mean(axis=1)
    N, T, C = per_tree.shape
    out = np.empty((N, C), np.float32)
    if not nan_free:
        votes = per_tree.argmax(-1)                     # (N, T)
        for c in range(C):
            out[:, c] = (votes == c).mean(axis=1)
        return out
    if C == 2:
        one = np.count_nonzero(per_tree[..., 1] > per_tree[..., 0], axis=1)
        out[:, 1] = one / T
        out[:, 0] = (T - one) / T
        return out
    # a running best over the class slices: a class takes the vote only
    # where it beats every lower class strictly, so each winner is larger
    # than the one it replaces and np.maximum writes it
    best = per_tree[..., 0]
    votes = np.zeros((N, T), np.uint8 if C < 256 else np.intp)
    for c in range(1, C):
        v = per_tree[..., c]
        np.maximum(votes, (v > best) * votes.dtype.type(c), out=votes)
        if c < C - 1:
            best = np.maximum(best, v)
    for c in range(C):
        out[:, c] = np.count_nonzero(votes == c, axis=1) / T
    return out
