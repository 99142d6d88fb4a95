"""Device-resident training engine, the port of ``repro.core.grower_device``.

One training level = one level step on the device. The host never sees a
histogram: per level the step samples candidate features (hash-keyed,
sampling.py), finds the best split per frontier slot, allocates children,
routes every example, derives child stats, and writes the chosen
conditions into device-resident forest arrays. The only per-level host
traffic is one int32 — the compacted frontier width, which picks the next
power-of-two frontier — and the forest arrays are fetched once per tree
block at the end.

The best split per slot:
  * numerical-only data ("cuda" and "torch" impls): the fused split search
    (kernels/histogram) — per-slot histogram, ordered-bin gain scan and
    argmax in one call, on the card the hand-written CUDA kernel; the
    "torch" impl runs its plain PyTorch version on either device;
  * data with categorical features (always "torch"): an explicit
    (slots, columns, bins, stats) histogram by ``index_add_`` and both
    scans in PyTorch — the numerical cumulative sum, and the categorical
    CART (stable argsort) or ONE_HOT scan — as the reference's jnp path.

Everything else is plain PyTorch on the same device, as the reference's is
jnp inside its jit: ``index_add_`` for segment sums, ``gather`` for
take-along-axis, and a sink slot at index M for the reference's
``mode="drop"`` scatters. The forest arrays are updated in place. Stats
stay float32 on the device, as under JAX without x64. On the card the
segment sums are exact (64-bit fixed point), because float atomics would
add in a different order on every run and training would not repeat.

Frontiers are padded to a power of two and inactive slots are masked, as in
the reference; wide frontiers are searched in ``_W_CAP``-slot chunks. Random
Forests grow a block of K trees in lockstep (a leading tree axis); feature
subsets are keyed by (tree, node), so blocking changes no result.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.api import YdfError
from repro_torch.core.binning import BinnedFeatures
from repro_torch.core.sampling import keyed_feature_select_torch, sample_size
from repro_torch.core.splitters import REL_GAIN_EPS as _REL_EPS
from repro_torch.core.tree import MASK_WORDS, Forest
from repro_torch.kernels.histogram.fused import (
    NEG_INF,
    _numerical_gains,
    score_stats,
)
from repro_torch.kernels.histogram.ops import fused_best_split
from repro_torch.obs import trace

_B = 256          # bin axis (uint8 codes)
_W_CAP = 512      # per-chunk slot width inside the level step
IMPLS = ("auto", "torch", "cuda")

#: level steps run since the last reset (one per tree block and level)
LEVEL_STEPS = 0


def device_unsupported_reason(params, binned: BinnedFeatures | None = None,
                              oblique_active: bool = False) -> str | None:
    """None when the device engine supports this configuration, else a
    human-readable reason."""
    sp = params.splitter
    if params.growing_strategy != "LOCAL":
        return ("growing_strategy=BEST_FIRST_GLOBAL is heap-ordered and "
                "host-sequential; device engine is level-wise (LOCAL) only")
    if oblique_active or sp.oblique:
        return "sparse-oblique projections scan raw columns on the host"
    if sp.categorical_algorithm == "RANDOM":
        return ("categorical_algorithm=RANDOM draws per-feature trial masks "
                "from the host rng stream")
    if sp.num_candidate_ratio < 1.0 and params.feature_sampling != "keyed":
        return ("per-node feature sampling on device requires keyed "
                "(hash-based) sampling; feature_sampling='stream' draws from "
                "the host rng")
    return None


def _resolve_impl(impl: str | None, has_cat: bool,
                  device: torch.device) -> str:
    """auto -> "cuda" for numerical data on a CUDA device, else "torch".
    "cuda" needs a CUDA device and numerical data; "torch" runs anywhere."""
    if impl in (None, "auto"):
        return "cuda" if device.type == "cuda" and not has_cat else "torch"
    if impl not in IMPLS:
        raise YdfError(f"Unknown device_impl {impl!r}. Expected one of: "
                       f"{', '.join(repr(i) for i in IMPLS)}.")
    if impl == "cuda" and has_cat:
        raise YdfError(
            "device_impl='cuda' uses the fused numerical kernel, which does "
            "not handle categorical features. Solutions: (1) use "
            "device_impl='torch', (2) drop categorical features.")
    if impl == "cuda" and device.type != "cuda":
        raise YdfError(
            f"device_impl='cuda' launches the CUDA kernel and needs a CUDA "
            f"device, but training runs on {device}. Solutions: (1) train "
            "with device='cuda', (2) use device_impl='torch'.")
    return impl


@dataclass(frozen=True)
class _StepConfig:
    kind: str
    l2: float
    min_examples: int
    min_gain: float
    cat_mode: str          # none | cart | onehot
    sample: bool           # per-node keyed feature sampling active
    sampling_key: int
    kf: int                # candidate features per node
    F: int
    S: int
    M: int                 # node capacity
    max_nodes: int         # allocation budget (<= M)
    impl: str              # torch | cuda


@dataclass
class _DeviceForest:
    """The forest arrays of a K-tree block on the device, with a sink slot
    at index M that absorbs the writes of slots that do not split."""
    feature: torch.Tensor     # (K, M + 1) int64
    split_bin: torch.Tensor   # (K, M + 1) int64
    cat_mask: torch.Tensor    # (K, M + 1, MASK_WORDS) int64 (uint32 words)
    left_child: torch.Tensor  # (K, M + 1) int64
    gain: torch.Tensor        # (K, M + 1) float32
    leaf_stats: torch.Tensor  # (K, M + 1, S) float32


def _segment_sum(values: torch.Tensor, seg: torch.Tensor,
                 n_segments: int) -> torch.Tensor:
    """Per-tree segment sums: values (K, N, S) float32, seg (K, N) in
    [0, n_segments) -> (K, n_segments, S) float32.

    On the CPU, ``index_add_`` adds in row order, as the reference's
    segment sums do. On the card its float atomics add in an order that
    changes from run to run, so there the sums are exact instead: each stat
    in 64-bit fixed point (``exact_sums``), whose integer atomics give the
    same bits on every run."""
    K, N, S = values.shape
    flat = (seg + torch.arange(K, device=seg.device)[:, None] * n_segments
            ).reshape(-1)
    if values.is_cuda:
        return exact_sums(values.reshape(K * N, S), flat,
                          K * n_segments).reshape(K, n_segments, S)
    out = torch.zeros((K * n_segments, S), dtype=values.dtype,
                      device=values.device)
    out.index_add_(0, flat, values.reshape(K * N, S))
    return out.reshape(K, n_segments, S)


def exact_sums(values: torch.Tensor, index: torch.Tensor,
               n_out: int) -> torch.Tensor:
    """Order-free sums of float32 rows: values (N, S), index (N,) in
    [0, n_out) -> (n_out, S) float32, the float32 value of each sum to
    ~2^-45 of the stat's largest |value|. Stat s is scaled by
    2^(62 - e_s - ceil(log2(N + 1))), where max |v_s| < 2^e_s, and rounded
    to int64, so no sum of N rows overflows and integer addition makes the
    order irrelevant. The values must be finite."""
    N, S = values.shape
    m = values.abs().amax(dim=0) if N else values.new_zeros(S)
    _, e = torch.frexp(torch.where(m > 0, m, 1.0))
    scale = torch.pow(2.0, (62 - int(N).bit_length() - e).to(torch.float64))
    q = torch.round(values.to(torch.float64) * scale).to(torch.int64)
    out = torch.zeros((n_out, S), dtype=torch.int64, device=values.device)
    out.index_add_(0, index, q)
    return (out.to(torch.float64) / scale).to(torch.float32)


def _order_key(h: torch.Tensor, kind: str) -> torch.Tensor:
    """Fisher order of categories on (..., B, S) histograms."""
    n = torch.clamp_min(h[..., -1], 1e-12)
    if kind == "gh":
        return h[..., 0] / torch.clamp_min(h[..., 1], 1e-12)
    if kind == "class":
        return h[..., 1] / n
    return h[..., 0] / n


def _chunk_best(cfg: _StepConfig, codes, nbins, iscat, stats,
                fsel_c, loc, w_slots):
    """Best split per slot for one W-wide slot chunk.

    codes (N, F) uint8; stats (K, N, S) f32; fsel_c (K, W, kf) int64;
    loc (K, N) int64 local slot in [-1, W). Returns per (K, W): gain f32,
    feature (original column) int64, split_bin int64, iscat bool, the
    (K, W, B) go-right-by-code table, and the parent score.
    """
    kind, l2, min_ex = cfg.kind, cfg.l2, cfg.min_examples
    K, N = loc.shape
    kf = cfg.kf
    dev = stats.device
    act = loc >= 0
    locc = loc.clamp(min=0)
    # per-example candidate codes: codes[i, fsel_c[k, loc[k, i], j]]
    if cfg.sample:
        fex = fsel_c.gather(1, locc[:, :, None].expand(K, N, kf))
        cex = torch.stack([codes.gather(1, fex[k])
                           for k in range(K)])                 # (K, N, kf)
    else:
        cex = None                    # every column is a candidate

    if cfg.cat_mode == "none":
        # fused split search: histogram + numerical scan + argmax per slot
        impl = "cuda" if cfg.impl == "cuda" else "ref"
        gains, js, sbins = [], [], []
        for k in range(K):
            ck = codes if cex is None else cex[k].contiguous()
            gk, jk, bk = fused_best_split(
                ck, stats[k].contiguous(), loc[k].to(torch.int32), w_slots,
                _B, kind=kind, l2=l2, min_examples=min_ex, impl=impl)
            gains.append(gk), js.append(jk), sbins.append(bk)
        gain = torch.stack(gains)                              # (K, W)
        jwin = torch.stack(js).to(torch.int64).clamp(min=0)
        sbin = torch.stack(sbins).to(torch.int64)
        feat = fsel_c.gather(2, jwin[:, :, None])[:, :, 0]
        tbl = torch.arange(_B, device=dev)[None, None, :] >= sbin[:, :, None]
        iscat_w = torch.zeros(gain.shape, dtype=torch.bool, device=dev)
        seg = torch.where(act, loc, w_slots)
        pstats = _segment_sum(torch.where(act[:, :, None], stats, 0.0), seg,
                              w_slots + 1)
        ps = score_stats(pstats[:, :w_slots], kind, l2)       # (K, W)
        return gain, feat, sbin, iscat_w, tbl, ps

    # ---- explicit histogram + both scans
    if cex is None:
        cex = codes.to(torch.int64)[None].expand(K, N, kf)
    else:
        cex = cex.to(torch.int64)
    ws = torch.where(act[:, :, None], stats, 0.0)             # (K, N, S)
    S = stats.shape[2]
    n_seg = w_slots * kf * _B
    seg = ((locc[:, :, None] * kf + torch.arange(kf, device=dev)) * _B + cex)
    seg = torch.where(act[:, :, None], seg, n_seg)            # (K, N, kf)
    hist = _segment_sum(
        ws[:, :, None, :].expand(K, N, kf, S).reshape(K, N * kf, S),
        seg.reshape(K, N * kf), n_seg + 1)
    hist = hist[:, :n_seg].reshape(K, w_slots, kf, _B, S)
    parent = hist.sum(dim=3)                                  # (K, W, kf, S)

    g_num = _numerical_gains(hist, parent, kind, l2, min_ex)
    pos = torch.arange(_B, device=dev)[None, None, None, :]
    nb_sel = nbins[fsel_c][..., None]                         # (K, W, kf, 1)
    iscat_sel = iscat[fsel_c]                                 # (K, W, kf)
    if cfg.cat_mode == "cart":
        key = torch.where(pos >= nb_sel, float("inf"), _order_key(hist, kind))
        order = torch.argsort(key, dim=3, stable=True)
        hs = hist.gather(3, order[..., None].expand(hist.shape))
        cum = torch.cumsum(hs, dim=3)
        right = parent[:, :, :, None, :] - cum
        g_cat = (score_stats(cum, kind, l2) + score_stats(right, kind, l2)
                 - score_stats(parent, kind, l2)[..., None])
        ok = ((cum[..., -1] >= min_ex) & (right[..., -1] >= min_ex)
              & (pos < nb_sel - 1))
    else:  # one category vs rest
        order = None
        right = parent[:, :, :, None, :] - hist
        g_cat = (score_stats(hist, kind, l2) + score_stats(right, kind, l2)
                 - score_stats(parent, kind, l2)[..., None])
        ok = ((hist[..., -1] >= min_ex) & (right[..., -1] >= min_ex)
              & (pos < nb_sel))
    g_cat = torch.where(ok, g_cat, NEG_INF)
    g = torch.where(iscat_sel[..., None], g_cat, g_num)

    flat = g.reshape(K, w_slots, kf * _B)
    fi = torch.argmax(flat, dim=2)                            # lowest (j, b)
    gain = flat.amax(dim=2)
    ps = score_stats(parent[:, :, 0], kind, l2)               # (K, W)
    jwin = fi // _B
    bwin = fi % _B
    feat = fsel_c.gather(2, jwin[:, :, None])[:, :, 0]
    iscat_w = iscat_sel.gather(2, jwin[:, :, None])[:, :, 0]
    sbin = torch.where(iscat_w, 0, bwin + 1)

    # go-right-by-code table for routing + the forest's category mask
    bins = torch.arange(_B, device=dev)[None, None, :]
    tbl_num = bins >= sbin[:, :, None]
    nb_win = nb_sel[..., 0].gather(2, jwin[:, :, None])       # (K, W, 1)
    if cfg.cat_mode == "cart":
        owin = order.gather(
            2, jwin[:, :, None, None].expand(K, w_slots, 1, _B))[:, :, 0]
        rank = torch.argsort(owin, dim=2, stable=True)        # inverse perm
        tbl_cat = (rank > bwin[:, :, None]) & (bins < nb_win)
    else:
        tbl_cat = bins == bwin[:, :, None]
    tbl = torch.where(iscat_w[:, :, None], tbl_cat, tbl_num)
    return gain, feat, sbin, iscat_w, tbl, ps


def _level_step(cfg: _StepConfig, codes, nbins, iscat, stats,
                tree_ids, slot_of, slot_node, fa: _DeviceForest, nn, node_of,
                depth):
    """One level for a K-tree block. Updates ``fa`` in place and returns
    (slot_of, slot_node, nn, node_of, depth, nv) for the next level."""
    global LEVEL_STEPS
    LEVEL_STEPS += 1
    K, P = slot_node.shape
    M = cfg.M
    dev = stats.device
    kar = torch.arange(K, device=dev)[:, None]

    # 1. candidate features per (tree, slot), keyed by (tree, node id)
    if cfg.sample:
        fsel = keyed_feature_select_torch(
            cfg.sampling_key, tree_ids[:, None], slot_node.clamp(min=0),
            cfg.F, cfg.kf)                                     # (K, P, kf)
    else:
        fsel = torch.arange(cfg.F, device=dev).expand(K, P, cfg.F)

    # 2. best split per slot, W slots at a time (bounds the histogram)
    W = min(P, _W_CAP)
    outs = []
    for g0 in range(0, P, W):
        loc = torch.where((slot_of >= g0) & (slot_of < g0 + W),
                          slot_of - g0, -1)
        outs.append(_chunk_best(cfg, codes, nbins, iscat, stats,
                                fsel[:, g0:g0 + W], loc, W))
    gain, feat_w, sbin_w, iscat_w, tbl, ps = (
        torch.cat([o[i] for o in outs], dim=1) if len(outs) > 1
        else outs[0][i] for i in range(6))

    # 3. validity + child allocation (frontier order, budget-capped). The
    # gain floor is scale-aware (splitters.REL_GAIN_EPS): float32 noise
    # around a true gain of 0 must not read as a valid split.
    floor = torch.clamp_min(_REL_EPS * ps.abs(), cfg.min_gain)
    valid = (gain > floor) & torch.isfinite(gain) & (slot_node >= 0)
    vi = valid.to(torch.int64)
    rank = torch.cumsum(vi, dim=1) - vi                       # exclusive
    valid &= nn[:, None] + 2 * (rank + 1) <= cfg.max_nodes
    left_id = torch.where(valid, nn[:, None] + 2 * rank, -1)
    nv = valid.sum(dim=1)
    nn = nn + 2 * nv
    depth = depth + (nv > 0).to(depth.dtype)

    # 4. write the chosen conditions into the device forest arrays
    pidx = torch.where(valid, slot_node, M)                   # M: the sink
    fa.feature[kar, pidx] = feat_w
    fa.split_bin[kar, pidx] = sbin_w
    fa.left_child[kar, pidx] = left_id
    fa.gain[kar, pidx] = torch.clamp_min(gain, 0.0)
    bits = 1 << torch.arange(32, device=dev)
    packed = (tbl.reshape(K, P, MASK_WORDS, 32).to(torch.int64)
              * bits).sum(dim=3)                              # uint32 words
    cidx = torch.where(valid & iscat_w, slot_node, M)
    fa.cat_mask[kar, cidx] = packed

    # 5. route every example of a split slot to its child
    slotc = slot_of.clamp(min=0)
    route = (slot_of >= 0) & valid.gather(1, slotc)
    f_ex = feat_w.gather(1, slotc)                            # (K, N)
    c_ex = torch.stack([codes.gather(1, f_ex[k][:, None])[:, 0]
                        for k in range(K)]).to(torch.int64)
    go = tbl[kar, slotc, c_ex].to(torch.int64)
    l_ex = left_id.gather(1, slotc)
    node_of = torch.where(route, l_ex + go, node_of)
    r_ex = rank.gather(1, slotc)
    slot_of = torch.where(route, 2 * r_ex + go, -1)

    # 6. child stats in one segment sum; new frontier = compacted children
    seg = torch.where(slot_of >= 0, slot_of, 2 * P)
    csum = _segment_sum(torch.where(slot_of[:, :, None] >= 0, stats, 0.0),
                        seg, 2 * P + 1)[:, :2 * P]            # (K, 2P, S)
    child_node = torch.full((K, 2 * P + 1), -1, dtype=torch.int64, device=dev)
    child_node[kar, torch.where(valid, 2 * rank, 2 * P)] = left_id
    child_node[kar, torch.where(valid, 2 * rank + 1, 2 * P)] = left_id + 1
    child_node = child_node[:, :2 * P]
    nidx = torch.where(child_node >= 0, child_node, M)
    fa.leaf_stats[kar, nidx] = csum
    return slot_of, child_node, nn, node_of, depth, nv


def _next_pow2(x: int) -> int:
    return 1 << max(0, int(x) - 1).bit_length()


def _device_codes(binned: BinnedFeatures, device: torch.device):
    """(codes (N, F) uint8, n_bins (F,) int64, is_cat (F,) bool) on
    ``device``, cached on the BinnedFeatures instance per device (shared
    across trees, blocks and boosting iterations)."""
    cache = binned.__dict__.setdefault("_device_codes", {})
    key = str(device)
    if key not in cache:
        cache[key] = (
            torch.from_numpy(np.ascontiguousarray(binned.codes, np.uint8)).to(device),
            torch.from_numpy(binned.n_bins.astype(np.int64)).to(device),
            torch.from_numpy(binned.is_cat.astype(bool)).to(device))
    return cache[key]


def _step_config(binned: BinnedFeatures, S: int, M: int, params,
                device: torch.device) -> _StepConfig:
    """The level step's configuration for a dataset and GrowthParams."""
    sp = params.splitter
    F = binned.codes.shape[1]
    has_cat = bool(binned.is_cat.any())
    impl = _resolve_impl(getattr(params, "device_impl", "auto"), has_cat,
                         device)
    one_hot = sp.categorical_algorithm == "ONE_HOT" or (
        sp.stat_kind == "class" and S > 3)
    return _StepConfig(
        kind=sp.stat_kind, l2=float(sp.l2), min_examples=int(sp.min_examples),
        min_gain=float(sp.min_gain),
        cat_mode=("none" if not has_cat else "onehot" if one_hot else "cart"),
        sample=sp.num_candidate_ratio < 1.0,
        sampling_key=int(params.sampling_key),
        kf=(sample_size(sp.num_candidate_ratio, F)
            if sp.num_candidate_ratio < 1.0 else F),
        F=F, S=S, M=M, max_nodes=int(params.max_nodes), impl=impl)


def grow_trees_device(forest: Forest, ts, binned: BinnedFeatures,
                      stats_list, actives, leaf_fn, params,
                      block: int | None = None, device=None) -> np.ndarray:
    """Grow trees ``ts`` of ``forest`` in device-resident lockstep on
    ``device`` (None: ``params.device``, and None there is cuda). The
    block is padded to ``block`` trees. Returns the final ``node_of``
    routing, (len(ts), N) int32."""
    from repro_torch.core.engines import resolve_device
    dev = resolve_device(device if device is not None
                         else getattr(params, "device", None))
    Kr = len(ts)
    K = max(Kr, block or Kr)
    N, F = binned.codes.shape
    S = stats_list[0].shape[1]
    M = min(forest.max_nodes, params.max_nodes)
    cfg = _step_config(binned, S, M, params, dev)
    codes, nbins, iscat = _device_codes(binned, dev)

    stats_np = np.zeros((K, N, S), np.float32)
    act_np = np.zeros((K, N), bool)
    for b in range(Kr):
        stats_np[b] = stats_list[b].astype(np.float32)
        act_np[b] = actives[b]
    stats = torch.from_numpy(stats_np).to(dev)
    node_of = torch.from_numpy(np.where(act_np, 0, -1).astype(np.int64)).to(dev)
    slot_of = node_of
    slot_node = torch.zeros((K, 1), dtype=torch.int64, device=dev)
    tree_ids = torch.tensor([int(t) for t in ts] + [0] * (K - Kr),
                            dtype=torch.int64, device=dev)
    i64 = dict(dtype=torch.int64, device=dev)
    fa = _DeviceForest(
        feature=torch.full((K, M + 1), -1, **i64),
        split_bin=torch.zeros((K, M + 1), **i64),
        cat_mask=torch.zeros((K, M + 1, MASK_WORDS), **i64),
        left_child=torch.full((K, M + 1), -1, **i64),
        gain=torch.zeros((K, M + 1), dtype=torch.float32, device=dev),
        leaf_stats=torch.zeros((K, M + 1, S), dtype=torch.float32, device=dev))
    fa.leaf_stats[:, 0] = stats.sum(dim=1)
    nn = torch.ones(K, **i64)
    depth = torch.zeros(K, **i64)

    for level in range(params.max_depth):
        # while tracing, the span closes after a CUDA sync so it holds the
        # level's device time; untraced, launches queue without a sync
        with trace.span("grower_device/level_step", level=level,
                        P=int(slot_node.shape[1])):
            slot_of, slot_node, nn, node_of, depth, nv = _level_step(
                cfg, codes, nbins, iscat, stats, tree_ids, slot_of,
                slot_node, fa, nn, node_of, depth)
            if trace.enabled() and dev.type == "cuda":
                torch.cuda.synchronize(dev)
        # the single per-level host sync: the compacted frontier width,
        # which picks the next power-of-two frontier
        with trace.span("grower_device/host_sync", level=level):
            nv_max = int(nv.max().item())
        if nv_max == 0:
            break
        slot_node = slot_node[:, :_next_pow2(2 * nv_max)]

    # one fetch per block: decode device arrays into the host Forest
    with trace.span("grower_device/fetch", trees=Kr):
        (feat_h, sbin_h, catm_h, left_h, gain_h, lstats_h, nn_h, node_h,
         depth_h) = (a.cpu().numpy() for a in (
             fa.feature[:, :M], fa.split_bin[:, :M], fa.cat_mask[:, :M],
             fa.left_child[:, :M], fa.gain[:, :M], fa.leaf_stats[:, :M], nn,
             node_of, depth))
    for b, t in enumerate(ts):
        n_t = int(nn_h[b])
        forest.n_nodes[t] = n_t
        forest.feature[t, :M] = feat_h[b]
        forest.left_child[t, :M] = left_h[b]
        forest.cat_mask[t, :M] = catm_h[b].astype(np.uint32)
        forest.split_bin[t, :M] = np.maximum(sbin_h[b], 0).astype(np.uint16)
        if forest.split_gain is not None:
            forest.split_gain[t, :M] = gain_h[b]
        for n in range(1, n_t):
            forest.leaf_value[t, n] = leaf_fn(lstats_h[b, n].astype(np.float64))
        for n in np.where((feat_h[b, :n_t] >= 0)
                          & ~binned.is_cat[np.maximum(feat_h[b, :n_t], 0)])[0]:
            f, sb = int(feat_h[b, n]), int(sbin_h[b, n])
            sb = min(sb, len(binned.boundaries[f]))
            forest.threshold[t, n] = binned.threshold_value(f, sb)
        forest.depth = max(forest.depth, int(depth_h[b]))
    return node_h[:Kr].astype(np.int32)
