"""LambdaMART ranking (DESIGN.md §12.1; Burges 2010), the port's copy of
``repro.tasks.ranking`` (host numpy, bit-identical to the reference).

The RANKING task rides the ordinary GBT learner: the only new piece is the
loss. Pairwise lambda gradients weighted by |ΔNDCG@k| are computed as ONE
padded ``(groups, max_group, max_group)`` tensor pass — no per-group Python
loop on the training path. The naive per-group loop lives here too, as the
differential oracle (the tests assert bit-equality).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


# ------------------------------------------------------------ group layout

@dataclass(frozen=True)
class GroupLayout:
    """Padded gather/scatter plan for per-group segment ops.

    ``pad_index[g, i]`` is a ROW index into the flat (N,) arrays; invalid
    (padding) slots repeat the group's last row and are masked out by
    ``pad_mask``. Scatter back with ``flat[pad_index[pad_mask]] =
    padded[pad_mask]`` — every valid slot maps to a distinct row.
    """
    n_rows: int
    sizes: np.ndarray       # (G,) group sizes
    pad_index: np.ndarray   # (G, m) int64 row indices
    pad_mask: np.ndarray    # (G, m) bool: True for real rows

    @property
    def n_groups(self) -> int:
        return len(self.sizes)

    @property
    def max_size(self) -> int:
        return self.pad_index.shape[1] if self.pad_index.ndim == 2 else 0

    def pad(self, flat: np.ndarray, fill: float = 0.0) -> np.ndarray:
        out = flat[self.pad_index].astype(np.float64)
        out[~self.pad_mask] = fill
        return out

    def unpad(self, padded: np.ndarray) -> np.ndarray:
        out = np.zeros(self.n_rows, np.float64)
        out[self.pad_index[self.pad_mask]] = padded[self.pad_mask]
        return out


def group_layout(groups: np.ndarray) -> GroupLayout:
    """Build the padded layout from per-row group ids (any order)."""
    groups = np.asarray(groups, np.int64).reshape(-1)
    order = np.argsort(groups, kind="stable")
    sg = groups[order]
    if len(sg) == 0:
        return GroupLayout(0, np.zeros(0, np.int64),
                           np.zeros((0, 0), np.int64),
                           np.zeros((0, 0), bool))
    starts = np.flatnonzero(np.r_[True, sg[1:] != sg[:-1]])
    sizes = np.diff(np.r_[starts, len(sg)]).astype(np.int64)
    m = int(sizes.max())
    ar = np.arange(m)
    pad_mask = ar[None, :] < sizes[:, None]
    idx = starts[:, None] + np.minimum(ar[None, :], sizes[:, None] - 1)
    return GroupLayout(len(groups), sizes, order[idx], pad_mask)


# ------------------------------------------------------- padded NDCG pieces

def _padded_rank_discounts(S: np.ndarray, valid: np.ndarray,
                           k: int) -> np.ndarray:
    """(G, m) rank discounts: d_i = 1/log2(1+rank_i) for rank_i <= k else 0,
    ranks 1-based by score descending with stable index tie-break. Padding
    slots sort last (score -> -inf) and get discount 0 via the rank cut."""
    s = np.where(valid, S, -np.inf)
    order = np.argsort(-s, axis=1, kind="stable")
    G, m = S.shape
    rank = np.empty((G, m), np.int64)
    np.put_along_axis(rank, order, np.broadcast_to(np.arange(1, m + 1), (G, m)),
                      axis=1)
    d = np.where(rank <= k, 1.0 / np.log2(1.0 + rank), 0.0)
    return np.where(valid, d, 0.0)


def _padded_idcg(gains: np.ndarray, valid: np.ndarray, k: int) -> np.ndarray:
    """(G,) ideal DCG@k from padded gains (2^rel - 1, zero on padding)."""
    g = np.where(valid, gains, -np.inf)
    top = -np.sort(-g, axis=1)[:, :k]
    disc = 1.0 / np.log2(np.arange(2, top.shape[1] + 2, dtype=np.float64))
    # elementwise * + last-axis sum (NOT a matmul): the same per-row
    # reduction order whether one group or G are in flight — bit-equality
    # between the batched pass and the per-group oracle depends on it
    return (np.where(np.isfinite(top), top, 0.0) * disc).sum(axis=1)


def ndcg_padded(S: np.ndarray, R: np.ndarray, valid: np.ndarray,
                k: int) -> float:
    """Mean NDCG@k over padded groups (IDCG==0 groups score 0)."""
    gains = np.where(valid, np.power(2.0, R) - 1.0, 0.0)
    disc = _padded_rank_discounts(S, valid, k)
    dcg = (gains * disc).sum(axis=1)
    idcg = _padded_idcg(gains, valid, k)
    return float(np.where(idcg > 0, dcg / np.maximum(idcg, 1e-300), 0.0).mean())


# -------------------------------------------------------- lambda gradients

def _lambda_pass(S: np.ndarray, R: np.ndarray, valid: np.ndarray,
                 k: int) -> tuple[np.ndarray, np.ndarray]:
    """The shared pairwise kernel over ALREADY-PADDED (G, m) tensors.

    For each ordered pair (i, j) with rel_i > rel_j (both valid):
      rho   = 1 / (1 + exp(s_i - s_j))              (RankNet crossing prob.)
      |ΔZ|  = |gain_i - gain_j| * |d_i - d_j| / IDCG (NDCG@k swap delta)
      g_i -= rho*|ΔZ|;  g_j += rho*|ΔZ|
      h_i += rho*(1-rho)*|ΔZ|;  h_j likewise
    Newton leaves (-Σg/Σh) then push winners' scores up.

    The naive per-group oracle calls this SAME kernel one group at a time;
    because every elementwise op and every reduction sees the same values in
    the same order per row, batched and looped results are bit-equal.
    """
    gains = np.where(valid, np.power(2.0, R) - 1.0, 0.0)
    disc = _padded_rank_discounts(S, valid, k)
    idcg = _padded_idcg(gains, valid, k)                       # (G,)
    inv_idcg = np.where(idcg > 0, 1.0 / np.maximum(idcg, 1e-300), 0.0)

    sdiff = S[:, :, None] - S[:, None, :]                      # s_i - s_j
    with np.errstate(over="ignore"):
        rho = 1.0 / (1.0 + np.exp(sdiff))
    dz = (np.abs(gains[:, :, None] - gains[:, None, :])
          * np.abs(disc[:, :, None] - disc[:, None, :])
          * inv_idcg[:, None, None])
    M = ((R[:, :, None] > R[:, None, :])
         & valid[:, :, None] & valid[:, None, :])
    lam = np.where(M, rho * dz, 0.0)
    hlam = np.where(M, rho * (1.0 - rho) * dz, 0.0)
    g = lam.sum(axis=1) - lam.sum(axis=2)       # loser gets +, winner gets -
    h = hlam.sum(axis=1) + hlam.sum(axis=2)
    return g, h


def lambda_grad_batched(scores: np.ndarray, rel: np.ndarray,
                        layout: GroupLayout, k: int = 5
                        ) -> tuple[np.ndarray, np.ndarray]:
    """Flat (N,) lambda gradients/hessians via one padded (G, m, m) pass."""
    S = layout.pad(scores, fill=0.0)
    R = layout.pad(rel, fill=0.0)
    g, h = _lambda_pass(S, R, layout.pad_mask, k)
    return layout.unpad(g), layout.unpad(h)


def lambda_grad_naive(scores: np.ndarray, rel: np.ndarray,
                      layout: GroupLayout, k: int = 5,
                      pad_to: int | None = None
                      ) -> tuple[np.ndarray, np.ndarray]:
    """The per-group Python loop the batched pass replaces.

    ``pad_to`` pads every group to a common width before calling the shared
    kernel — the configuration the bit-equality test uses. With ``pad_to``
    None each group runs at its own (m_g, m_g) size: the honest per-group
    baseline (scores then agree to 1e-12, not bits, since reduction shapes
    differ).
    """
    g_out = np.zeros(layout.n_rows, np.float64)
    h_out = np.zeros(layout.n_rows, np.float64)
    S = layout.pad(scores, fill=0.0)
    R = layout.pad(rel, fill=0.0)
    for gi in range(layout.n_groups):
        size = int(layout.sizes[gi])
        width = size if pad_to is None else max(pad_to, size)
        Sg = np.zeros((1, width)); Rg = np.zeros((1, width))
        Vg = np.zeros((1, width), bool)
        Sg[0, :size] = S[gi, :size]
        Rg[0, :size] = R[gi, :size]
        Vg[0, :size] = True
        gg, hg = _lambda_pass(Sg, Rg, Vg, k)
        rows = layout.pad_index[gi, :size]
        g_out[rows] = gg[0, :size]
        h_out[rows] = hg[0, :size]
    return g_out, h_out


# ----------------------------------------------------------------- the loss

@dataclass
class RankingActivation:
    """The ranking model's serving head (losses.Loss ``activation``
    contract): raw GBT scores ARE the ranking scores. A saved model names
    it by ``name``, and ``losses.loss_by_name`` rebuilds it."""
    name = "LAMBDA_MART_NDCG"
    out_dim = 1

    def activation(self, scores: np.ndarray) -> np.ndarray:
        return np.asarray(scores)[:, 0]


class LambdaMARTLoss:
    """The GBT ``Loss`` for task=RANKING (drop-in for losses.Loss).

    Holds the train/validation group layouts; ``value`` reports
    ``1 - mean NDCG@k`` (lower is better, so LOSS_INCREASE early stopping
    works unchanged) and dispatches train vs valid by label-array identity.
    ``serving_head()`` strips the group arrays: the model keeps only the
    head, which saves as its name.
    """
    name = "LAMBDA_MART_NDCG"
    out_dim = 1

    def __init__(self, y_train: np.ndarray, layout_train: GroupLayout,
                 k: int = 5, y_valid: np.ndarray | None = None,
                 layout_valid: GroupLayout | None = None):
        self._y_train = y_train
        self._layout_train = layout_train
        self._y_valid = y_valid
        self._layout_valid = layout_valid
        self.k = int(k)

    def _layout_for(self, y) -> GroupLayout:
        if y is self._y_train:
            return self._layout_train
        if self._y_valid is not None and y is self._y_valid:
            return self._layout_valid
        raise ValueError(
            "LambdaMARTLoss saw a label array it has no group layout for; "
            "it is bound to the training/validation sets it was built with.")

    def init_pred(self, y, w):
        return np.zeros(1, np.float32)

    def grad_hess(self, pred, y, w):
        layout = self._layout_for(y)
        g, h = lambda_grad_batched(np.asarray(pred)[:, 0], y, layout, self.k)
        # ranking groups are the weighting unit; per-example w stays 1 —
        # guard h away from 0 so Newton leaves stay finite in pairless nodes
        return g[:, None], np.maximum(h, 1e-12)[:, None]

    def value(self, pred, y, w):
        layout = self._layout_for(y)
        S = layout.pad(np.asarray(pred)[:, 0])
        R = layout.pad(np.asarray(y, np.float64))
        return 1.0 - ndcg_padded(S, R, layout.pad_mask, self.k)

    def activation(self, scores):
        return np.asarray(scores)[:, 0]

    def serving_head(self):
        return RankingActivation()


def group_aware_split(groups: np.ndarray, ratio: float, seed: int
                      ) -> tuple[np.ndarray, np.ndarray]:
    """Train/valid row split that keeps every group WHOLE (a group torn
    across the split would corrupt both its lambda pairs and its NDCG)."""
    groups = np.asarray(groups, np.int64)
    uniq = np.unique(groups)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(uniq))
    n_valid = int(round(len(uniq) * ratio))
    valid_groups = set(uniq[perm[:n_valid]].tolist())
    in_valid = np.isin(groups, list(valid_groups))
    return np.flatnonzero(~in_valid), np.flatnonzero(in_valid)
