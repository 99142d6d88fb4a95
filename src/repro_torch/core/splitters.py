"""Splitters (paper §3.8), the port's copy of ``repro.core.splitters``: find
the best condition per frontier node from per-node stat histograms.

Host numpy, bit-identical to the reference: the batched and oracle growth
engines (core/grower.py) scan the histograms that a backend
(core/hist_backend.py) built. Stat layouts ("label type" modules, §2.3):

  * "gh"     — [grad, hess, ..., count]       (GBT, any smooth loss)
  * "class"  — [count_class_0..C-1, count]    (RF/CART classification)
  * "moment" — [sum_y, sum_y^2, count]        (RF/CART regression)

Feature-type modules: numerical (ordered-bin scan), categorical CART
(Fisher-ordered prefix scan), categorical RANDOM (random-set projections,
Breiman) and one-hot (single category vs rest). Not ported yet: the
lockstep Random Forest scan ``best_splits_gathered`` (ROADMAP A8), sparse
oblique projections and the exact in-sorting splitter.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.binning import BinnedFeatures
from repro_torch.core.hist_backend import HistogramBackend, resolve_backend

NEG_INF = -1e30

# Scale-aware validity floor for split gains. Gains are evaluated in float32
# (score(L) + score(R) - score(P) — a catastrophic cancellation when the
# split is worthless), so a node whose true gain is 0 reads as noise of order
# eps_f32 * |score(P)| accumulated over the cumulative scan. Any fixed
# min_gain below that floor turns pure-noise argmax flips into spurious
# splits that differ between backends. All engines gate on
# max(min_gain, REL_GAIN_EPS * |score(parent)|) so they agree that such
# splits are invalid.
REL_GAIN_EPS = 4e-6


def gain_floor(min_gain: float, parent_score) -> np.ndarray:
    return np.maximum(min_gain, REL_GAIN_EPS * np.abs(parent_score))


@dataclass
class SplitterParams:
    stat_kind: str = "gh"            # gh | class | moment
    min_examples: int = 5
    l2: float = 0.0                  # lambda (gh gain)
    min_gain: float = 1e-12
    categorical_algorithm: str = "CART"   # CART | RANDOM | ONE_HOT
    random_cat_trials: int = 32
    num_candidate_ratio: float = 1.0  # per-node feature sampling (RF: sqrt rule)
    # sparse oblique (benchmark_rank1 template)
    oblique: bool = False
    oblique_num_projections_exponent: float = 1.0
    oblique_density: float = 0.5     # P(feature in projection)
    oblique_bins: int = 128


@dataclass
class Split:
    """Best split decision for one node. feature == -1 -> no valid split."""
    gain: float = NEG_INF
    feature: int = -1
    split_bin: int = 0                     # numerical: codes >= split_bin go right
    threshold: float = 0.0                 # raw-value threshold
    cat_right: np.ndarray | None = None    # categorical: codes going right

    @property
    def valid(self) -> bool:
        return self.feature != -1


# =====================================================================
# Histogram building (host path; kernels/histogram is the device path)
# =====================================================================

def build_histogram(codes: np.ndarray, stats: np.ndarray, node_of: np.ndarray,
                    n_nodes: int, max_bins: int = 256,
                    backend: str | HistogramBackend | None = None) -> np.ndarray:
    """codes: (N, F) uint8; stats: (N, S) float32; node_of: (N,) int32 in
    [-1, n_nodes) (-1 = inactive example). -> (n_nodes, F, B, S) float32.

    Accumulation is delegated to a histogram backend (hist_backend.py): one
    flattened bincount on the host, the CUDA histogram kernel on the card.
    ``backend=None`` keeps the host path (the seed-equivalent oracle)."""
    be = resolve_backend("numpy" if backend is None else backend)
    return be.build(codes, stats, node_of, n_nodes, max_bins).astype(np.float32)


# =====================================================================
# Gain functions per stat layout
# =====================================================================

def _score(stats: np.ndarray, kind: str, l2: float) -> np.ndarray:
    """'Goodness' of a node given aggregated stats (..., S). Gain of a split =
    score(L) + score(R) - score(P) (all formulations arranged to be additive)."""
    if kind == "gh":
        g, h = stats[..., 0], stats[..., 1]
        return 0.5 * np.square(g) / (h + l2 + 1e-12)
    if kind == "class":
        counts = stats[..., :-1]
        n = stats[..., -1]
        tot = np.maximum(n, 1e-12)[..., None]
        p = counts / tot
        ent = -(p * np.log(np.maximum(p, 1e-12))).sum(-1)
        return -n * ent  # negative weighted entropy: gain = info gain * n
    if kind == "moment":
        sy, sy2, n = stats[..., 0], stats[..., 1], stats[..., 2]
        return np.square(sy) / np.maximum(n, 1e-12) - 0.0 * sy2  # -SSE + const
    raise ValueError(kind)


def _counts(stats: np.ndarray, kind: str) -> np.ndarray:
    return stats[..., -1]


def _order_key(stats: np.ndarray, kind: str) -> np.ndarray:
    """Per-bin ordering key for categorical CART (Fisher 1958 grouping)."""
    n = np.maximum(stats[..., -1], 1e-12)
    if kind == "gh":
        return stats[..., 0] / np.maximum(stats[..., 1], 1e-12)
    if kind == "class":
        return stats[..., 1] / n  # P(second class); multiclass handled by caller
    return stats[..., 0] / n      # mean target


# =====================================================================
# Best-split search over a histogram
# =====================================================================

def best_splits(hist: np.ndarray, binned: BinnedFeatures, params: SplitterParams,
                rng: np.random.Generator,
                feature_mask: np.ndarray | None = None,
                simple: bool = False) -> list[Split]:
    """hist: (n_nodes, F, B, S) -> one Split per node (numerical+categorical).
    feature_mask: optional (n_nodes, F) bool of candidate features per node.
    simple=True evaluates categorical features one at a time (the readable
    ground-truth module, paper §2.3) instead of the batched scan; results are
    bit-identical (tested)."""
    n_nodes, F, B, S = hist.shape
    kind, l2 = params.stat_kind, params.l2
    parent = hist.sum(axis=2)                       # (n_nodes, F, S)
    parent_score = _score(parent, kind, l2)         # (n_nodes, F)
    n_parent = _counts(parent, kind)

    is_cat = binned.is_cat
    num_idx = np.where(~is_cat)[0]
    cat_idx = np.where(is_cat)[0]

    gains = np.full((n_nodes, F), NEG_INF, np.float64)
    best_bin = np.zeros((n_nodes, F), np.int32)
    cat_sets: dict[tuple[int, int], tuple] = {}     # lazy payloads (see below)

    # ---- numerical: ordered cumulative scan; split s: bins < s left
    if len(num_idx):
        h = hist[:, num_idx]                        # (n, Fn, B, S)
        cum = np.cumsum(h, axis=2)
        left = cum[:, :, :-1]                       # split after bin b -> s = b+1
        right = parent[:, num_idx, None, :] - left
        g = (_score(left, kind, l2) + _score(right, kind, l2)
             - parent_score[:, num_idx, None])
        ok = ((_counts(left, kind) >= params.min_examples)
              & (_counts(right, kind) >= params.min_examples))
        g = np.where(ok, g, NEG_INF)
        bi = np.argmax(g, axis=2)                   # (n, Fn)
        gains[:, num_idx] = np.take_along_axis(g, bi[..., None], 2)[..., 0]
        best_bin[:, num_idx] = bi + 1

    # ---- categorical: all features of one algorithm evaluated in one batch
    # (RANDOM keeps a per-feature loop so the rng draw order is unchanged;
    # simple=True keeps the per-feature ground-truth handlers for all three)
    if len(cat_idx):
        one_hot = params.categorical_algorithm == "ONE_HOT" or (
            kind == "class" and parent.shape[-1] > 3)
        if params.categorical_algorithm == "RANDOM":
            for f in cat_idx:
                nb = int(binned.n_bins[f])
                _cat_random(f, hist[:, f, :nb], parent[:, f],
                            parent_score[:, f], params, rng, gains, cat_sets)
        elif simple:
            for f in cat_idx:
                nb = int(binned.n_bins[f])
                handler = _cat_one_hot_simple if one_hot else _cat_cart_simple
                handler(f, hist[:, f, :nb], parent[:, f], parent_score[:, f],
                        params, gains, cat_sets, kind)
        elif one_hot:
            _cat_one_hot_batch(cat_idx, hist, binned, parent, parent_score,
                               params, gains, cat_sets)
        else:
            _cat_cart_batch(cat_idx, hist, binned, parent, parent_score,
                            params, gains, cat_sets, kind)

    if feature_mask is not None:
        gains = np.where(feature_mask, gains, NEG_INF)

    out: list[Split] = []
    for i in range(n_nodes):
        j = int(np.argmax(gains[i]))
        gain = float(gains[i, j])
        floor = float(gain_floor(params.min_gain, parent_score[i, j]))
        if gain <= floor or gain <= NEG_INF or not np.isfinite(gain):
            out.append(Split())
            continue
        if is_cat[j]:
            out.append(Split(gain=gain, feature=j,
                             cat_right=_materialize_cat(cat_sets[(i, j)])))
        else:
            sb = int(best_bin[i, j])
            out.append(Split(gain=gain, feature=j, split_bin=sb,
                             threshold=binned.threshold_value(j, sb)))
    return out


def _materialize_cat(payload) -> np.ndarray:
    """Candidate category sets are kept as lazy payloads during the scan and
    only turned into sorted index arrays for the winning feature per node."""
    tag = payload[0]
    if tag == "cart":
        _, order_row, bi, nb = payload
        tail = order_row[bi + 1:]
        return np.sort(tail[tail < nb]).astype(np.int32)
    if tag == "onehot":
        return np.array([payload[1]], np.int32)
    return payload[1]                               # "set": precomputed


def _cat_cart_simple(f, hf, parent, parent_score, params, gains, cat_sets,
                     kind):
    """Per-feature Fisher-ordered prefix scan — the seed ground-truth module
    (paper §2.3) that `_cat_cart_batch` is verified against."""
    n_nodes, nb, S = hf.shape
    key = _order_key(hf, kind)                      # (n, nb)
    order = np.argsort(key, axis=1, kind="stable")  # (n, nb)
    hs = np.take_along_axis(hf, order[..., None], axis=1)
    cum = np.cumsum(hs, axis=1)[:, :-1]             # prefixes (n, nb-1, S)
    right = parent[:, None, :] - cum
    g = (_score(cum, kind, params.l2) + _score(right, kind, params.l2)
         - parent_score[:, None])
    ok = ((_counts(cum, kind) >= params.min_examples)
          & (_counts(right, kind) >= params.min_examples))
    g = np.where(ok, g, NEG_INF)
    if g.shape[1] == 0:
        return
    bi = np.argmax(g, axis=1)
    gv = np.take_along_axis(g, bi[:, None], 1)[:, 0]
    for i in range(n_nodes):
        if gv[i] > gains[i, f]:
            gains[i, f] = gv[i]
            cat_sets[(i, f)] = ("set",
                                np.sort(order[i, bi[i] + 1:]).astype(np.int32))


def _cat_one_hot_simple(f, hf, parent, parent_score, params, gains, cat_sets,
                        kind):
    """Per-feature single-category-vs-rest scan — the seed ground-truth module
    that `_cat_one_hot_batch` is verified against."""
    l2 = params.l2
    left = parent[:, None, :] - hf                  # all but category b
    g = (_score(hf, kind, l2) + _score(left, kind, l2) - parent_score[:, None])
    ok = ((_counts(hf, kind) >= params.min_examples)
          & (_counts(left, kind) >= params.min_examples))
    g = np.where(ok, g, NEG_INF)
    bi = np.argmax(g, axis=1)
    gv = np.take_along_axis(g, bi[:, None], 1)[:, 0]
    for i in range(hf.shape[0]):
        if gv[i] > gains[i, f]:
            gains[i, f] = gv[i]
            cat_sets[(i, f)] = ("onehot", int(bi[i]))


def _cat_cart_batch(cat_idx, hist, binned, parent, parent_score, params,
                    gains, cat_sets, kind):
    """Fisher-ordered prefix scan (Fisher 1958 grouping; exact for
    binary/regression), batched over every categorical feature at once.
    Features are padded to the widest dictionary; padded bins sort last
    (+inf key) and padded cut positions are masked, so per-feature results
    are bit-identical to a per-feature scan."""
    n_nodes = hist.shape[0]
    nb = binned.n_bins[cat_idx].astype(np.int64)    # (Fc,)
    Bmax = int(nb.max())
    if Bmax < 2:
        return
    hf = hist[:, cat_idx, :Bmax]                    # (n, Fc, Bmax, S)
    pad = np.arange(Bmax)[None, :] >= nb[:, None]   # (Fc, Bmax)
    key = np.where(pad[None], np.inf, _order_key(hf, kind))
    order = np.argsort(key, axis=2, kind="stable")  # (n, Fc, Bmax)
    hs = np.take_along_axis(hf, order[..., None], axis=2)
    cum = np.cumsum(hs, axis=2)[:, :, :-1]          # prefixes (n, Fc, Bmax-1, S)
    right = parent[:, cat_idx, None, :] - cum
    g = (_score(cum, kind, params.l2) + _score(right, kind, params.l2)
         - parent_score[:, cat_idx, None])
    ok = ((_counts(cum, kind) >= params.min_examples)
          & (_counts(right, kind) >= params.min_examples)
          & (np.arange(Bmax - 1)[None, :] < nb[:, None] - 1)[None])
    g = np.where(ok, g, NEG_INF)
    bi = np.argmax(g, axis=2)                       # (n, Fc)
    gv = np.take_along_axis(g, bi[..., None], 2)[..., 0]
    improve = gv > gains[:, cat_idx]
    for i, fi in zip(*np.nonzero(improve)):
        cat_sets[(i, cat_idx[fi])] = ("cart", order[i, fi], int(bi[i, fi]),
                                      int(nb[fi]))
    gains[:, cat_idx] = np.where(improve, gv, gains[:, cat_idx])


def _cat_one_hot_batch(cat_idx, hist, binned, parent, parent_score, params,
                       gains, cat_sets):
    """Single category vs rest (== one-hot encoding splits), batched over
    every categorical feature at once (padded bins masked)."""
    kind, l2 = params.stat_kind, params.l2
    nb = binned.n_bins[cat_idx].astype(np.int64)
    Bmax = int(nb.max())
    hf = hist[:, cat_idx, :Bmax]                    # (n, Fc, Bmax, S)
    left = parent[:, cat_idx, None, :] - hf         # all but category b
    g = (_score(hf, kind, l2) + _score(left, kind, l2)
         - parent_score[:, cat_idx, None])
    ok = ((_counts(hf, kind) >= params.min_examples)
          & (_counts(left, kind) >= params.min_examples)
          & (np.arange(Bmax)[None, :] < nb[:, None])[None])
    g = np.where(ok, g, NEG_INF)
    bi = np.argmax(g, axis=2)
    gv = np.take_along_axis(g, bi[..., None], 2)[..., 0]
    improve = gv > gains[:, cat_idx]
    for i, fi in zip(*np.nonzero(improve)):
        cat_sets[(i, cat_idx[fi])] = ("onehot", int(bi[i, fi]))
    gains[:, cat_idx] = np.where(improve, gv, gains[:, cat_idx])


def _cat_random(f, hf, parent, parent_score, params, rng, gains, cat_sets):
    """Breiman-style random category subsets (benchmark_rank1 categorical)."""
    kind, l2 = params.stat_kind, params.l2
    n_nodes, nb, S = hf.shape
    T = params.random_cat_trials
    masks = rng.random((T, nb)) < 0.5               # True -> right
    right = np.einsum("tb,nbs->nts", masks.astype(np.float64), hf)
    left = parent[:, None, :] - right
    g = (_score(left, kind, l2) + _score(right, kind, l2) - parent_score[:, None])
    ok = ((_counts(left, kind) >= params.min_examples)
          & (_counts(right, kind) >= params.min_examples))
    g = np.where(ok, g, NEG_INF)
    ti = np.argmax(g, axis=1)
    gv = np.take_along_axis(g, ti[:, None], 1)[:, 0]
    for i in range(n_nodes):
        if gv[i] > gains[i, f]:
            gains[i, f] = gv[i]
            cat_sets[(i, f)] = ("set",
                                np.where(masks[ti[i]])[0].astype(np.int32))


# =====================================================================
# Partition application
# =====================================================================

def apply_split(split: Split, binned: BinnedFeatures, X_raw: np.ndarray,
                idx: np.ndarray) -> np.ndarray:
    """go-right decision for examples `idx` under an axis-aligned split.
    X_raw: (N, F) raw-valued matrix (same column order as binned), which
    only sparse-oblique conditions read."""
    codes = binned.codes[idx, split.feature]
    if split.cat_right is not None:
        return np.isin(codes, split.cat_right)
    return codes >= split.split_bin
