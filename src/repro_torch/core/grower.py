"""Tree growth engine shared by the port's learners, the port of
``repro.core.grower``.

Two strategies (paper §3.11 templates):
  * LOCAL              — divide-and-conquer, level-wise: every frontier node of
                         the current depth is split in one histogram pass.
  * BEST_FIRST_GLOBAL  — leaf-wise (Shi 2007): repeatedly split the leaf with
                         the best gain until the node budget is exhausted.

Three engines, as in the reference:
  * "batched" (the default) — level-wise: one histogram build per level over
    every frontier node, through a pluggable backend (hist_backend.py): on a
    CUDA device the hand-written CUDA histogram kernel, on the CPU numpy.
    The gain scans (splitters.py), routing and leaf statistics are host
    numpy, as in the reference. Best-first: per-node example index lists
    ride the heap; the smaller child's histogram is built and the sibling is
    derived as ``parent - child`` only on backends that accumulate in
    float64 (``exact_subtraction``), else both are built.
  * "oracle"  — the seed-equivalent simple module (paper §2.3: the simple
    implementation is the ground truth): per-node partition loops and full-N
    histogram rebuilds, host numpy only. With the numpy backend the batched
    engine produces bit-identical trees at equal seeds (tested).
  * "device"  — the level loop on the device (grower_device.py), with the
    fused split-search kernel. A configuration it cannot run resolves to
    ("batched", reason), and the learner records the reason.

Not ported yet: the host lockstep path of Random Forest blocks
(``_grow_level_wise_lockstep``, ROADMAP A8; a request for it raises) and
sparse-oblique splits (raise).

The grower owns node allocation in the Forest SoA and the per-example
``node_of`` routing; leaf values come from a caller-provided ``leaf_fn``
over aggregated node stats.
"""
from __future__ import annotations

import dataclasses
import heapq
from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from repro_torch.core.api import YdfError
from repro_torch.core.binning import BinnedFeatures
from repro_torch.core.grower_device import (
    device_unsupported_reason,
    grow_trees_device,
)
from repro_torch.core.hist_backend import HistogramBackend, resolve_backend
from repro_torch.core.sampling import keyed_feature_select, sample_size
from repro_torch.core.splitters import (
    Split,
    SplitterParams,
    apply_split,
    best_splits,
    build_histogram,
)
from repro_torch.core.tree import Forest
from repro_torch.obs import trace

ENGINES = ("batched", "oracle", "device")


@dataclass
class GrowthParams:
    max_depth: int = 6
    max_nodes: int = 2048            # total node budget per tree
    growing_strategy: str = "LOCAL"  # LOCAL | BEST_FIRST_GLOBAL
    splitter: SplitterParams = field(default_factory=SplitterParams)
    engine: str = "batched"          # batched | oracle | device
    histogram_backend: str = "auto"  # auto | numpy | simple | cuda | torch
    # per-node feature sampling policy: "stream" draws masks from the shared
    # rng (seed-faithful; couples draws to the growth schedule), "keyed"
    # hashes (sampling_key, tree, node) — sampling.py — so every engine and
    # execution order derives identical subsets (lockstep/device-safe).
    feature_sampling: str = "stream"
    sampling_key: int = 0
    device_impl: str = "auto"        # auto | torch | cuda
    device: str | None = None        # None: cuda


def _set_split(forest: Forest, t: int, node: int, split: Split,
               binned: BinnedFeatures) -> None:
    if forest.split_gain is not None:
        # recorded for the SUM_SCORE structural importance (DESIGN.md §8);
        # never read back by training, so it cannot perturb growth
        forest.split_gain[t, node] = max(float(split.gain), 0.0)
    forest.feature[t, node] = split.feature
    if split.cat_right is not None:
        for c in split.cat_right:
            forest.cat_mask[t, node, c // 32] |= np.uint32(1) << np.uint32(c % 32)
    else:
        forest.threshold[t, node] = split.threshold
        forest.split_bin[t, node] = split.split_bin


def _feature_sample_mask(n_nodes: int, F: int, ratio: float,
                         rng: np.random.Generator) -> np.ndarray | None:
    if ratio >= 1.0:
        return None
    k = sample_size(ratio, F)
    mask = np.zeros((n_nodes, F), bool)
    for i in range(n_nodes):
        mask[i, rng.choice(F, size=k, replace=False)] = True
    return mask


def _candidate_mask(nodes, t: int, F: int, params: GrowthParams,
                    rng: np.random.Generator) -> np.ndarray | None:
    """Per-node candidate-feature mask for frontier ``nodes`` of tree ``t``
    under the active sampling policy (stream rng draws vs keyed hashes)."""
    sp = params.splitter
    if sp.num_candidate_ratio >= 1.0:
        return None
    if params.feature_sampling == "keyed":
        sel = keyed_feature_select(params.sampling_key, int(t),
                                   np.asarray(nodes, np.int64), F,
                                   sample_size(sp.num_candidate_ratio, F))
        mask = np.zeros((len(sel), F), bool)
        np.put_along_axis(mask, sel, True, axis=1)
        return mask
    return _feature_sample_mask(len(nodes), F, sp.num_candidate_ratio, rng)


def resolve_engine(params: GrowthParams, binned: BinnedFeatures | None = None,
                   oblique_active: bool = False) -> tuple[str, str | None]:
    """Map ``params.engine`` to the engine that will actually run, plus a
    fallback reason (None when the request is honored). The "device" engine
    supports the level-wise axis-aligned CART/ONE_HOT configurations; other
    configurations resolve to the "batched" engine, which on a CUDA device
    still builds every histogram with the CUDA kernel."""
    if params.engine not in ENGINES:
        raise YdfError(f"Unknown growth engine {params.engine!r}. "
                       f"Expected one of: {', '.join(map(repr, ENGINES))}.")
    if params.engine != "device":
        return params.engine, None
    reason = device_unsupported_reason(params, binned, oblique_active)
    return ("batched", reason) if reason else ("device", None)


def _check_ported(params: GrowthParams) -> None:
    if params.splitter.oblique:
        raise YdfError(
            "split_axis='SPARSE_OBLIQUE' (and so the benchmark_rank1 "
            "template) is not ported yet: the port's Forest carries no "
            "oblique nodes. Solution: use split_axis='AXIS_ALIGNED'.")


def grow_tree(forest: Forest, t: int, binned: BinnedFeatures, X_raw: np.ndarray,
              stats: np.ndarray, active: np.ndarray,
              leaf_fn: Callable[[np.ndarray], np.ndarray],
              params: GrowthParams, rng: np.random.Generator,
              num_lo: np.ndarray | None = None,
              num_hi: np.ndarray | None = None) -> np.ndarray:
    """Grow tree `t` in place. `active`: (N,) bool/float example weights > 0
    mask; `stats` must already include bagging weights. Returns the final
    ``node_of`` array ((N,) int32, -1 for inactive examples) so boosting can
    read leaf assignments without re-traversal. ``num_lo``/``num_hi`` (the
    min-max bounds of sparse-oblique projections) are accepted for the
    reference's signature; oblique splits raise."""
    _check_ported(params)
    node_of = np.where(active, 0, -1).astype(np.int32)
    root_stats = stats[active].sum(0)
    forest.leaf_value[t, 0] = leaf_fn(root_stats)
    forest.n_nodes[t] = 1
    best_first = params.growing_strategy == "BEST_FIRST_GLOBAL"
    engine, _ = resolve_engine(params, binned)
    if engine == "oracle":
        fn = _grow_best_first_oracle if best_first else _grow_level_wise_oracle
        depth = fn(forest, t, binned, X_raw, stats, node_of, params, rng,
                   leaf_fn)
    elif engine == "device":
        return grow_trees_device(forest, [t], binned, [stats], [active],
                                 leaf_fn, params)[0]
    else:
        backend = resolve_backend(params.histogram_backend, params.device)
        fn = _grow_best_first_batched if best_first else _grow_level_wise_batched
        depth = fn(forest, t, binned, X_raw, stats, node_of, params, rng,
                   leaf_fn, backend)
    forest.depth = max(forest.depth, depth)
    return node_of


def _lockstep_ok(params: GrowthParams) -> bool:
    """Lockstep (K trees per level pass) is semantics-free only when growth
    consumes no sequential rng: keyed (or no) feature sampling, no RANDOM
    categorical trials — and level-wise strategy. The reference's gathered
    bincount is a host-numpy formulation, so other histogram backends keep
    the per-tree path."""
    sp = params.splitter
    return (params.growing_strategy == "LOCAL"
            and sp.categorical_algorithm != "RANDOM"
            and (sp.num_candidate_ratio >= 1.0
                 or params.feature_sampling == "keyed")
            and resolve_backend(params.histogram_backend,
                                params.device).name == "numpy")


def grow_trees(forest: Forest, ts, binned: BinnedFeatures, X_raw: np.ndarray,
               stats_list, actives, leaf_fn, params: GrowthParams, rngs,
               num_lo=None, num_hi=None, block: int | None = None
               ) -> np.ndarray:
    """Grow a block of independent trees (Random Forest §3.6). With the
    "device" engine the whole block advances one LEVEL at a time (tree axis
    through the frontier state); otherwise trees grow sequentially. The
    reference's host lockstep path (the "batched" engine on numpy under
    ``_lockstep_ok``) is not ported yet and raises. ``block`` is the NOMINAL
    block width (e.g. tree_parallelism): the device engine pads a short
    final block up to it. Returns per-tree final routing, (len(ts), N)
    int32."""
    _check_ported(params)
    engine, _ = resolve_engine(params, binned)
    if engine == "device" and params.growing_strategy == "LOCAL":
        for b, t in enumerate(ts):
            forest.leaf_value[t, 0] = leaf_fn(stats_list[b][actives[b]].sum(0))
            forest.n_nodes[t] = 1
        return grow_trees_device(forest, ts, binned, stats_list, actives,
                                 leaf_fn, params, block=block or len(ts))
    if engine == "batched" and _lockstep_ok(params) and len(ts) > 1:
        raise YdfError(
            "Lockstep growth of a block of trees on the host (the batched "
            "engine's Random Forest path) is not ported yet (ROADMAP A8). "
            "Solutions: (1) use growth_engine='device', (2) grow one tree at "
            "a time.")
    params_seq = (params if engine == params.engine
                  else dataclasses.replace(params, engine=engine))
    return np.stack([
        grow_tree(forest, t, binned, X_raw, stats_list[b], actives[b],
                  leaf_fn, params_seq, rngs[b], num_lo, num_hi)
        for b, t in enumerate(ts)])


# =====================================================================
# Batched-frontier engine (the fast path)
# =====================================================================

# Sibling-subtraction cache cap (both growth strategies): above this many
# cached float64s, histograms are rebuilt from scratch instead of cached.
_HIST_CACHE_BUDGET = 1 << 25  # 32M f64 = 256 MB


def _grow_level_wise_batched(forest, t, binned, X_raw, stats, node_of, params,
                             rng, leaf_fn, backend: HistogramBackend) -> int:
    sp = params.splitter
    F = binned.n_features
    S = stats.shape[1]
    B = 256
    codes = binned.codes
    frontier = [0]
    depth = 0
    hist64 = None      # (n_front, F, B, S) f64 cache for sibling subtraction
    # per current slot: parent's previous-level slot and sibling's current
    # slot (-1 when the sibling left the frontier), example counts
    par_of = sib_of = n_ex = None
    for level in range(params.max_depth):
        if not frontier:
            break
        n_front = len(frontier)
        slot = np.full(forest.max_nodes, -1, np.int32)
        slot[np.asarray(frontier)] = np.arange(n_front, dtype=np.int32)
        node_of_c = np.where(node_of >= 0, slot[np.maximum(node_of, 0)], -1)
        hist64_prev, hist64 = hist64, None
        # subtraction pays only when accumulation (examples) outweighs the
        # per-level cache assembly (n_front * B buckets per feature-stat).
        # RANDOM categorical trials can tie exactly (masks differing only on
        # empty categories), where the subtraction's 1-ulp drift could flip
        # the argmax — build directly there to stay bit-identical.
        sub_pays = (par_of is not None
                    and backend.exact_subtraction
                    and sp.categorical_algorithm != "RANDOM"
                    and int(n_ex.sum()) > 4 * n_front * B)
        with trace.span("grower/hist_build", level=level, frontier=n_front,
                        subtraction=bool(sub_pays and hist64_prev is not None)):
            if hist64_prev is None or not sub_pays:
                hist64 = backend.build(codes, stats, node_of_c, n_front)
            else:
                # -- histogram subtraction across levels: accumulate only the
                # smaller child of each pair, derive the sibling as
                # parent - child
                build_slot = np.full(n_front, -1, np.int32)
                derive = []
                nb = 0
                for j in range(n_front):
                    sib = int(sib_of[j])
                    if sib < 0 or n_ex[j] < n_ex[sib] or (
                            n_ex[j] == n_ex[sib] and j < sib):
                        build_slot[j] = nb
                        nb += 1
                        if sib >= 0:
                            derive.append(sib)
                bmap = np.full(forest.max_nodes, -1, np.int32)
                bmap[np.asarray(frontier)] = build_slot
                node_of_b = np.where(node_of >= 0,
                                     bmap[np.maximum(node_of, 0)], -1)
                built = backend.build(codes, stats, node_of_b, nb)
                hist64 = np.empty((n_front, F, B, S), np.float64)
                built_rows = np.where(build_slot >= 0)[0]
                hist64[built_rows] = built[build_slot[built_rows]]
                if derive:
                    der = np.asarray(derive, np.int32)
                    hist64[der] = (hist64_prev[par_of[der]]
                                   - hist64[sib_of[der]])
                del hist64_prev
            hist = hist64.astype(np.float32)
        with trace.span("grower/gain_scan", level=level, frontier=n_front):
            mask = _candidate_mask(frontier, t, F, params, rng)
            splits = best_splits(hist, binned, sp, rng, feature_mask=mask)
        # -- allocate children (frontier order, shared node budget)
        left_of = np.full(n_front, -1, np.int32)
        for i, node in enumerate(frontier):
            s = splits[i]
            if not s.valid or forest.n_nodes[t] + 2 > params.max_nodes:
                continue
            left_of[i] = int(forest.n_nodes[t])
            forest.n_nodes[t] += 2
            _set_split(forest, t, node, s, binned)
            forest.left_child[t, node] = left_of[i]
            depth = level + 1
        split_slots = np.where(left_of >= 0)[0]
        if not len(split_slots):
            break
        # -- one vectorized apply_split pass over every routed example:
        # axis-aligned conditions collapse to a per-slot (256,) go-right
        # lookup over bin codes (b >= split_bin for numerical, set membership
        # for categorical).
        with trace.span("grower/routing", level=level,
                        splits=len(split_slots)):
            feat = np.array([s.feature for s in splits], np.int32)
            table = np.zeros((n_front, 256), bool)
            for i in split_slots:
                s = splits[i]
                if s.cat_right is not None:
                    table[i, s.cat_right] = True
                else:
                    table[i, s.split_bin:] = True
            ex = np.where((node_of_c >= 0)
                          & (left_of[np.maximum(node_of_c, 0)] >= 0))[0]
            sl = node_of_c[ex]
            go = table[sl, codes[ex, np.maximum(feat[sl], 0)]]
            node_of[ex] = left_of[sl] + go
        # -- all child leaf stats in one flattened bincount over node_of
        with trace.span("grower/leaf_stats", level=level,
                        examples=len(ex)):
            ci_of = np.full(n_front, -1, np.int64)
            ci_of[split_slots] = np.arange(len(split_slots))
            child_code = 2 * ci_of[sl] + go
            n_child = 2 * len(split_slots)
            csum = np.bincount(
                (child_code[:, None] * S + np.arange(S)).ravel(),
                weights=np.ascontiguousarray(stats[ex], np.float64).ravel(),
                minlength=n_child * S).reshape(n_child, S)
            child_n_ex = np.bincount(child_code, minlength=n_child)
        # -- next frontier. A child below 2 * min_examples total weight can
        # never produce a valid split, so it is pruned from the frontier
        # (identical output, skipped work) — but only when the splitter
        # consumes no randomness the pruning could shift: the per-node
        # feature-sampling mask (one rng.choice per frontier node — unless
        # masks are KEYED by (tree, node), which pruning cannot perturb),
        # RANDOM categorical trials (per-level draws that the oracle still
        # makes for a frontier of unsplittable nodes).
        prune = ((sp.num_candidate_ratio >= 1.0
                  or params.feature_sampling == "keyed")
                 and sp.categorical_algorithm != "RANDOM")
        keep = csum[:, -1] >= 2 * sp.min_examples if prune else \
            np.ones(n_child, bool)
        new_frontier = []
        par_l, sib_l, nex_l = [], [], []
        for ci, i in enumerate(split_slots):
            left = int(left_of[i])
            forest.leaf_value[t, left] = leaf_fn(csum[2 * ci])
            forest.leaf_value[t, left + 1] = leaf_fn(csum[2 * ci + 1])
            kl, kr = bool(keep[2 * ci]), bool(keep[2 * ci + 1])
            jl = len(new_frontier)
            jr = jl + kl
            if kl:
                new_frontier.append(left)
                par_l.append(i)
                sib_l.append(jr if kr else -1)
                nex_l.append(child_n_ex[2 * ci])
            if kr:
                new_frontier.append(left + 1)
                par_l.append(i)
                sib_l.append(jl if kl else -1)
                nex_l.append(child_n_ex[2 * ci + 1])
        frontier = new_frontier
        if (len(new_frontier) * F * B * S > _HIST_CACHE_BUDGET):
            hist64 = None  # cache too large: next level rebuilds from scratch
        par_of = np.asarray(par_l, np.int32)
        sib_of = np.asarray(sib_l, np.int32)
        n_ex = np.asarray(nex_l, np.int64)
    return depth


def _grow_best_first_batched(forest, t, binned, X_raw, stats, node_of, params,
                             rng, leaf_fn, backend: HistogramBackend) -> int:
    """Leaf-wise growth with the parent-minus-sibling subtraction trick.

    The heap holds (-gain, counter, node, depth, Split); a side store keeps,
    per open leaf, its example index list and float64 histogram. On split,
    only the smaller child's histogram is accumulated (over its own examples)
    and the sibling's is derived as ``parent - child`` — O(smaller child)
    per split instead of two O(N) passes.
    """
    sp = params.splitter
    F = binned.n_features

    def build(idx: np.ndarray) -> np.ndarray:
        with trace.span("grower/hist_build", examples=len(idx)):
            return backend.build(binned.codes[idx], stats[idx],
                                 np.zeros(len(idx), np.int32), 1)

    def eval_node(node: int, idx: np.ndarray, hist64: np.ndarray) -> Split:
        with trace.span("grower/gain_scan", node=node):
            m = _candidate_mask([node], t, F, params, rng)
            return best_splits(hist64.astype(np.float32), binned, sp, rng,
                               feature_mask=m)[0]

    heap: list = []
    counter = 0
    # per open leaf: (example indices, f64 histogram or None). Histograms are
    # cached only while the total stays under _HIST_CACHE_BUDGET; evicted
    # entries (None) are rebuilt from the index list on pop.
    store: dict[int, tuple[np.ndarray, np.ndarray | None]] = {}
    hist_elems = F * 256 * stats.shape[1]
    cached = 0

    def stash(node: int, idx: np.ndarray, hist64: np.ndarray) -> None:
        nonlocal cached
        if (cached + 1) * hist_elems <= _HIST_CACHE_BUDGET:
            store[node] = (idx, hist64)
            cached += 1
        else:
            store[node] = (idx, None)

    root_idx = np.where(node_of == 0)[0]
    h0 = build(root_idx)
    s0 = eval_node(0, root_idx, h0)
    if s0.valid:
        heapq.heappush(heap, (-s0.gain, counter, 0, 0, s0))
        counter += 1
        stash(0, root_idx, h0)
    depth = 0
    while heap and forest.n_nodes[t] + 2 <= params.max_nodes:
        ngain, _, node, d, s = heapq.heappop(heap)
        idx, hist_p = store.pop(node)
        if hist_p is None:
            hist_p = build(idx)
        else:
            cached -= 1
        left = int(forest.n_nodes[t])
        forest.n_nodes[t] += 2
        _set_split(forest, t, node, s, binned)
        forest.left_child[t, node] = left
        with trace.span("grower/routing", node=node, examples=len(idx)):
            go = apply_split(s, binned, X_raw, idx)
            node_of[idx] = np.where(go, left + 1, left)
        depth = max(depth, d + 1)
        child_idx = {left: idx[~go], left + 1: idx[go]}
        with trace.span("grower/leaf_stats", node=node):
            for child, cidx in child_idx.items():
                forest.leaf_value[t, child] = leaf_fn(stats[cidx].sum(0))
        want = {c: d + 1 < params.max_depth and len(ci) >= 2 * sp.min_examples
                for c, ci in child_idx.items()}
        if not any(want.values()):
            continue
        small = min((left, left + 1), key=lambda c: len(child_idx[c]))
        big = 2 * left + 1 - small
        hists = {small: build(child_idx[small])}
        if want[big]:
            # Build directly instead of subtracting when the backend does
            # not accumulate in f64, or under RANDOM categoricals, whose
            # trials can tie exactly (a 1-ulp drift could flip the argmax)
            if (sp.categorical_algorithm == "RANDOM"
                    or not backend.exact_subtraction):
                hists[big] = build(child_idx[big])
            else:
                hists[big] = hist_p - hists[small]
        for child in (left, left + 1):  # fixed order keeps the rng sequence
            if not want[child]:
                continue
            cs = eval_node(child, child_idx[child], hists[child])
            if cs.valid:
                heapq.heappush(heap, (-cs.gain, counter, child, d + 1, cs))
                counter += 1
                stash(child, child_idx[child], hists[child])
    return depth


# =====================================================================
# Oracle engine — the seed-equivalent simple module (paper §2.3)
# =====================================================================

def _grow_level_wise_oracle(forest, t, binned, X_raw, stats, node_of, params,
                            rng, leaf_fn) -> int:
    sp = params.splitter
    F = binned.n_features
    frontier = [0]
    depth = 0
    for level in range(params.max_depth):
        if not frontier:
            break
        slot_of_node = {n: i for i, n in enumerate(frontier)}
        slot = np.full(forest.max_nodes, -1, np.int32)
        for n, i in slot_of_node.items():
            slot[n] = i
        node_of_c = np.where(node_of >= 0, slot[np.maximum(node_of, 0)], -1)
        hist = build_histogram(binned.codes, stats, node_of_c, len(frontier),
                               backend="simple")
        mask = _candidate_mask(frontier, t, F, params, rng)
        splits = best_splits(hist, binned, sp, rng, feature_mask=mask,
                             simple=True)
        new_frontier = []
        for i, node in enumerate(frontier):
            s = splits[i]
            if not s.valid or forest.n_nodes[t] + 2 > params.max_nodes:
                continue
            left = int(forest.n_nodes[t])
            forest.n_nodes[t] += 2
            _set_split(forest, t, node, s, binned)
            forest.left_child[t, node] = left
            idx = np.where(node_of == node)[0]
            go = apply_split(s, binned, X_raw, idx)
            node_of[idx] = np.where(go, left + 1, left)
            for child, sel in ((left, ~go), (left + 1, go)):
                cs = stats[idx[sel]].sum(0)
                forest.leaf_value[t, child] = leaf_fn(cs)
                new_frontier.append(child)
            depth = level + 1
        frontier = new_frontier
    return depth


def _grow_best_first_oracle(forest, t, binned, X_raw, stats, node_of, params,
                            rng, leaf_fn) -> int:
    """Leaf-wise growth. Heap holds (-gain, node, depth, Split)."""
    sp = params.splitter
    F = binned.n_features

    def eval_node(node: int) -> Split:
        mask01 = (node_of == node).astype(np.int32)
        node_of_c = np.where(mask01 > 0, 0, -1).astype(np.int32)
        hist = build_histogram(binned.codes, stats, node_of_c, 1,
                               backend="simple")
        m = _candidate_mask([node], t, F, params, rng)
        return best_splits(hist, binned, sp, rng, feature_mask=m,
                           simple=True)[0]

    heap: list = []
    counter = 0
    s0 = eval_node(0)
    if s0.valid:
        heapq.heappush(heap, (-s0.gain, counter, 0, 0, s0))
        counter += 1
    depth = 0
    while heap and forest.n_nodes[t] + 2 <= params.max_nodes:
        ngain, _, node, d, s = heapq.heappop(heap)
        left = int(forest.n_nodes[t])
        forest.n_nodes[t] += 2
        _set_split(forest, t, node, s, binned)
        forest.left_child[t, node] = left
        idx = np.where(node_of == node)[0]
        go = apply_split(s, binned, X_raw, idx)
        node_of[idx] = np.where(go, left + 1, left)
        depth = max(depth, d + 1)
        for child in (left, left + 1):
            cidx = np.where(node_of == child)[0]
            forest.leaf_value[t, child] = leaf_fn(stats[cidx].sum(0))
            if d + 1 < params.max_depth and len(cidx) >= 2 * sp.min_examples:
                cs = eval_node(child)
                if cs.valid:
                    heapq.heappush(heap, (-cs.gain, counter, child, d + 1, cs))
                    counter += 1
    return depth
