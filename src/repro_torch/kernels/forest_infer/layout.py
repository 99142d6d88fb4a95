"""The traversal kernels' node layout: one 16-byte record per node.

Built once per forest and device (``ops.device_packed`` for the tiled
kernel, B2; ``ops.device_soa`` for the single-tree kernel, B4) from the
(S, M) node tables, S being the packed slots or the trees. A record is four
32-bit words, so a round of a walk is one 16-byte load. Three node kinds,
told apart by the range of ``x``:

  * numerical, ``x >= 0``: the column the node reads, ``max(feature, 0)``
    as the walk has always clamped it; ``y`` the threshold's float32 bits;
  * categorical, ``-2^30 <= x < 0``: ``x = ~column``. A node is
    categorical iff its 256-bit mask is non-empty (a categorical column
    with an empty mask still compares its threshold); ``y`` the index of
    its mask in ``masks``;
  * sparse oblique (``feature == -2``, taking precedence over a mask),
    ``x < -2^30``: ``x = k - 2^31`` with ``k`` the node's index in the
    oblique side table; ``y`` the threshold's float32 bits;

and in every record ``z`` = ``left_child`` (negative marks a leaf) and
``w`` the leaf value's float32 bits for ``O == 1``, else the row of the
node's leaf values in ``leaf`` ((S * M, O), the node's own row).

``masks`` holds only the non-empty masks of internal categorical nodes,
eight uint32 words each (as int32, bit for bit), in slot order, so the
masks of consecutive slots are consecutive and ``mask_start[s]`` is the
first mask of slot ``s``. ``obl`` holds P (column, weight bits) int32
pairs per internal oblique node, node ``k``'s at rows ``k * P`` onward,
slot-ordered the same way with ``obl_start`` (padding slots: weight 0 on
column 0, summed like the others). A layout is validated when it is built
(``build``) and is immutable; the kernels' wrappers trust it and check
only X per call.

``walk`` is the plain version of a walk over the records: the kernels'
function on CPU tensors, held by the tests to the table traversals of
``ref``, to ``predict_raw`` and, off the near-ties of ``np.dot``, to
``predict_naive``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.api import YdfError
from repro_torch.kernels.forest_infer.ref import (
    MASK_WORDS,
    cat_code,
    oblique_proj,
)

RECORD_WORDS = 4
MAX_GROUP = 8        # most trees of a single-kernel group (group_masks' k)
_INT32_MAX = 2 ** 31 - 1
KIND_LIMIT = 2 ** 30     # columns and oblique nodes a record can name


@dataclass(frozen=True, eq=False)
class NodeLayout:
    records: torch.Tensor     # (S * M, 4) int32
    masks: torch.Tensor       # (max(K, 1), 8) int32 words; K non-empty masks
    mask_start: torch.Tensor  # (S + 1,) int32: first mask of each slot
    obl: torch.Tensor         # (max(J * P, 1), 2) int32: (column, weight
                              # bits) of J oblique nodes, P pairs each
    obl_start: torch.Tensor   # (S + 1,) int32: first oblique node of a slot
    obl_dims: int             # P (0 when the forest has no oblique node)
    leaf: torch.Tensor        # (S * M, O) float32, read when O > 1
    block_depth: torch.Tensor | None  # (S // group,) int32 rounds (packed)
    slot_tree: torch.Tensor | None    # (S,) int32: tree of a slot, -1 = pad
    slots: int                # S
    max_nodes: int            # M
    out_dim: int              # O
    group: int                # trees per block of a packed layout, else 0
    n_trees: int              # output columns in tree order
    depth: int                # rounds of an unpacked layout (>= 1); a
                              # packed one takes block_depth
    min_features: int         # columns X must have
    group_masks: tuple        # most masks of a group: of a block (packed),
                              # of k consecutive trees for k = 1..MAX_GROUP
    group_obl: tuple          # most oblique pairs of a group, the same way

    @property
    def device(self) -> torch.device:
        return self.records.device

    @property
    def packed(self) -> bool:
        return self.group > 0


def check_children(left_child, max_nodes: int) -> None:
    """Raise YdfError unless every child (numpy or torch) is < M - 1."""
    if bool((left_child >= max_nodes - 1).any()):
        raise YdfError(
            "The forest has a child index outside its node capacity "
            f"({max_nodes}); its SoA is corrupt. Rebuild or re-convert "
            "the model.")


def _expect(name, t, dtype, shape, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, feature is on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _group_masks(per_slot: np.ndarray, sizes) -> tuple:
    """The most masks any group of ``k`` consecutive slots holds, for each
    ``k`` of ``sizes`` (groups start at multiples of ``k``)."""
    out = []
    for k in sizes:
        pad = np.zeros(-(-len(per_slot) // k) * k, np.int64)
        pad[:len(per_slot)] = per_slot
        out.append(int(pad.reshape(-1, k).sum(1).max()) if len(pad) else 0)
    return tuple(out)


def build(feature, threshold, cat_mask, left_child, leaf_value, *,
          block_depth=None, inv_order=None, depth: int = 1,
          obl_features=None, obl_weights=None) -> NodeLayout:
    """The layout of the node tables ``feature`` / ``left_child`` (S, M)
    int32, ``threshold`` (S, M) float32, ``cat_mask`` (S, M, 8) int32 words
    and ``leaf_value`` (S, M, O) float32, on their device, and, for a forest
    with sparse-oblique nodes, ``obl_features`` (S, M, P) int32 and
    ``obl_weights`` (S, M, P) float32. A packed forest passes its tables as
    (B, TB, M, ...) with ``block_depth`` (B,) int32 and, for tree-order
    output, ``inv_order`` (T,) (the packed slot of each tree); an unpacked
    one passes ``depth``, its global depth.

    Validates once: shapes, dtypes, one device, contiguity, every child
    inside the node capacity, an oblique table for every oblique node with
    no negative column, and the sizes the kernels index in int32. Raises
    TypeError / ValueError on malformed tables and YdfError on a corrupt
    forest."""
    if not isinstance(feature, torch.Tensor) or feature.dim() not in (2, 3):
        raise ValueError("feature must be a (S, M) or (B, TB, M) tensor")
    packed = feature.dim() == 3
    if packed != (block_depth is not None):
        raise ValueError("a packed (B, TB, M) layout takes block_depth, an "
                         "unpacked (T, M) one does not")
    lead = tuple(feature.shape[:-1])
    M = int(feature.shape[-1])
    S = int(np.prod(lead))
    dev = feature.device
    if not isinstance(leaf_value, torch.Tensor) or leaf_value.dim() != feature.dim() + 1:
        raise ValueError("leaf_value must be the node tables' shape plus O")
    O = int(leaf_value.shape[-1])
    _expect("feature", feature, torch.int32, lead + (M,), dev)
    _expect("threshold", threshold, torch.float32, lead + (M,), dev)
    _expect("cat_mask", cat_mask, torch.int32, lead + (M, MASK_WORDS), dev)
    _expect("left_child", left_child, torch.int32, lead + (M,), dev)
    _expect("leaf_value", leaf_value, torch.float32, lead + (M, O), dev)
    if packed:
        _expect("block_depth", block_depth, torch.int32, lead[:1], dev)
    if (obl_features is None) != (obl_weights is None):
        raise ValueError("obl_features and obl_weights come together")
    P = 0 if obl_features is None else int(obl_features.shape[-1])
    if obl_features is not None:
        _expect("obl_features", obl_features, torch.int32, lead + (M, P), dev)
        _expect("obl_weights", obl_weights, torch.float32, lead + (M, P), dev)
    if M < 1 or O < 1 or S * M > _INT32_MAX // RECORD_WORDS:
        raise ValueError(f"no layout for S={S}, M={M}, O={O}: the kernels "
                         "index S * M * 4 words in int32")
    check_children(left_child, M)

    feat = feature.reshape(S, M)
    lc = left_child.reshape(S, M)
    words = cat_mask.reshape(S, M, MASK_WORDS)
    internal = lc >= 0
    is_obl = (feat == -2) & internal                           # (S, M)
    n_obl = int(is_obl.sum())
    if n_obl and P == 0:
        raise YdfError("The forest has sparse-oblique nodes (feature == -2) "
                       "but no oblique tables (obl_features, obl_weights); "
                       "its SoA is corrupt. Rebuild or re-convert the model.")
    is_cat = (words != 0).any(-1) & internal & ~is_obl         # (S, M)
    col = feat.clamp_min(0)
    if bool((col[internal] >= KIND_LIMIT).any()) or n_obl >= KIND_LIMIT \
            or n_obl * P > _INT32_MAX // 2:
        raise ValueError(f"no layout for columns past {KIND_LIMIT} or "
                         f"{n_obl} oblique nodes of {P} pairs: records name "
                         "them in 30 bits, the kernels index pairs in int32")
    flat_cat = is_cat.reshape(-1)
    flat_obl = is_obl.reshape(-1)
    mask_idx = torch.cumsum(flat_cat.to(torch.int64), 0) - 1   # (S * M,)
    obl_idx = torch.cumsum(flat_obl.to(torch.int64), 0) - 1
    per_slot = is_cat.sum(1).to(torch.int64)
    obl_slot = is_obl.sum(1).to(torch.int64)
    mask_start = torch.zeros(S + 1, dtype=torch.int64, device=dev)
    mask_start[1:] = torch.cumsum(per_slot, 0)
    obl_start = torch.zeros(S + 1, dtype=torch.int64, device=dev)
    obl_start[1:] = torch.cumsum(obl_slot, 0)
    rec = torch.empty((S * M, RECORD_WORDS), dtype=torch.int32, device=dev)
    rec[:, 0] = torch.where(
        flat_obl, obl_idx - 2 ** 31,
        torch.where(flat_cat, ~col.reshape(-1), col.reshape(-1)).to(
            torch.int64)).to(torch.int32)
    rec[:, 1] = torch.where(flat_cat, mask_idx.to(torch.int32),
                            threshold.reshape(-1).view(torch.int32))
    rec[:, 2] = lc.reshape(-1)
    leaf = leaf_value.reshape(S * M, O)
    rec[:, 3] = (leaf[:, 0].view(torch.int32) if O == 1 else
                 torch.arange(S * M, dtype=torch.int32, device=dev))
    masks = words.reshape(S * M, MASK_WORDS)[flat_cat]
    if masks.shape[0] == 0:
        masks = torch.zeros((1, MASK_WORDS), dtype=torch.int32, device=dev)
    masks = masks.contiguous()
    if n_obl:
        ocols = obl_features.reshape(S * M, P)[flat_obl]       # (J, P)
        if bool((ocols < 0).any()):
            raise YdfError("An oblique node reads a negative column; the "
                           "forest's SoA is corrupt. Rebuild or re-convert "
                           "the model.")
        obl = torch.stack([ocols, obl_weights.reshape(S * M, P)[flat_obl]
                           .view(torch.int32)], -1).reshape(n_obl * P, 2)
    else:
        ocols = None
        obl = torch.zeros((1, 2), dtype=torch.int32, device=dev)
    obl = obl.contiguous()
    for name, t in (("records", rec), ("masks", masks), ("obl", obl)):
        if t.data_ptr() % 16:
            raise ValueError(f"the layout's {name} are not 16-byte aligned")
    host_slot = per_slot.cpu().numpy()
    host_obl = (obl_slot * P).cpu().numpy()
    internal_feat = feat[internal]
    min_features = int(internal_feat.max()) + 1 if internal_feat.numel() else 0
    if n_obl:   # every column an oblique node reads, the padding's 0 too
        min_features = max(min_features, int(ocols.max()) + 1)
    if packed:
        TB = lead[1]
        slot_tree = None
        if inv_order is not None:
            inv = torch.as_tensor(inv_order, device=dev).to(torch.int64)
            slot_tree = torch.full((S,), -1, dtype=torch.int32, device=dev)
            slot_tree[inv] = torch.arange(inv.numel(), dtype=torch.int32,
                                          device=dev)
        n_trees = len(inv_order) if inv_order is not None else S
        sizes = (TB,)
    else:
        TB, slot_tree, n_trees = 0, None, S
        sizes = range(1, MAX_GROUP + 1)
    return NodeLayout(
        records=rec, masks=masks, mask_start=mask_start.to(torch.int32),
        obl=obl, obl_start=obl_start.to(torch.int32),
        obl_dims=P if n_obl else 0,
        leaf=leaf, block_depth=block_depth, slot_tree=slot_tree, slots=S,
        max_nodes=M, out_dim=O, group=TB, n_trees=n_trees,
        depth=max(1, int(depth)),
        min_features=min_features,
        group_masks=_group_masks(host_slot, sizes),
        group_obl=_group_masks(host_obl, sizes))


def walk(X: torch.Tensor, layout: NodeLayout, *,
         tree_order: bool = False) -> torch.Tensor:
    """The plain version of a walk over the records: every (example, slot)
    pair advances in lockstep for its rounds (a packed slot its block's
    ``block_depth``, an unpacked one ``depth``) and stops at the first leaf.
    X (N, F) float32 -> (N, S, O) in slot order, or (N, T, O) in tree order
    when ``tree_order`` (a packed layout with ``slot_tree``)."""
    S, M, O = layout.slots, layout.max_nodes, layout.out_dim
    N = X.shape[0]
    dev = X.device
    rec = layout.records
    if layout.packed:
        slot_rounds = layout.block_depth.to(torch.int64).repeat_interleave(
            layout.group)
    else:
        slot_rounds = torch.full((S,), layout.depth, dtype=torch.int64,
                                 device=dev)
    base = torch.arange(S, device=dev) * M                   # (S,)
    node = torch.zeros((N, S), dtype=torch.int64, device=dev)
    rounds = int(slot_rounds.max()) if S else 0
    P = layout.obl_dims
    if P:
        obl_col = layout.obl[:, 0].to(torch.int64)
        obl_w = layout.obl[:, 1].contiguous().view(torch.float32)
        slot_pairs = torch.arange(P, device=dev)
    for r in range(rounds):
        d = rec[node + base]                                 # (N, S, 4)
        obl = d[..., 0] < -KIND_LIMIT
        cat = (d[..., 0] < 0) & ~obl
        col = torch.where(cat, ~d[..., 0],
                          d[..., 0].clamp_min(0)).to(torch.int64)
        x = torch.gather(X, 1, col)                          # (N, S)
        code = cat_code(x)
        midx = torch.where(cat, d[..., 1], 0).to(torch.int64)
        word = layout.masks[midx, code >> 5]
        bit = ((word.to(torch.int64) >> (code & 31)) & 1).bool()
        thr = d[..., 1].view(torch.float32)
        go = torch.where(cat, bit, x >= thr)
        if P:
            k = torch.where(obl, d[..., 0].to(torch.int64) + 2 ** 31, 0)
            pair = k.unsqueeze(-1) * P + slot_pairs          # (N, S, P)
            proj = oblique_proj(X, obl_col[pair], obl_w[pair])
            go = torch.where(obl, proj >= thr, go)
        child = d[..., 2].to(torch.int64)
        live = (child >= 0) & (r < slot_rounds)
        node = torch.where(live, child + go.to(torch.int64), node)
    final = rec[node + base]                                 # (N, S, 4)
    if O == 1:
        out = final[..., 3].contiguous().view(torch.float32).unsqueeze(-1)
    else:
        out = layout.leaf[final[..., 3].to(torch.int64)]
    if not tree_order:
        return out
    if layout.slot_tree is None:
        raise ValueError("tree order needs a packed layout built with "
                         "inv_order")
    res = torch.empty((N, layout.n_trees, O), dtype=torch.float32, device=dev)
    keep = layout.slot_tree >= 0
    res[:, layout.slot_tree[keep].to(torch.int64)] = out[:, keep]
    return res
