"""Dispatch and per-forest device caches for forest traversal.

A compiled forest is uploaded to its device ONCE: ``forest_predict`` keeps
a small id-keyed cache mapping a live Forest to its tables on each device —
(a) the raw SoA (the "ref" impl) and (b) the depth-packed layout (the
"cuda" impl) — so repeat predictions do no host-to-device table transfers
and no re-packing. Entries are validated against a weakref (id reuse after
GC cannot alias), evicted the moment the forest is collected, and LRU-capped.

impls:
  * "cuda" — the traversal kernel over the depth-packed layout
    (``forest_infer.forest_predict_tiled``). On a CUDA device it launches
    the kernel or raises; on the CPU it runs the kernel's plain version.
  * "ref"  — the plain PyTorch gather traversal over the raw SoA
    (``ref.forest_predict_ref``), on either device.
"""
from __future__ import annotations

import weakref
from collections import OrderedDict
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.api import YdfError
from repro_torch.core.tree import Forest, pack_by_depth
from repro_torch.kernels.forest_infer.forest_infer import forest_predict_tiled
from repro_torch.kernels.forest_infer.ref import forest_predict_ref

_CACHE: "OrderedDict[int, tuple]" = OrderedDict()
_CACHE_CAP = 8


def _forest_cache(forest) -> dict:
    """Per-forest payload dict, id-keyed + weakref-validated, LRU-capped.
    A weakref finalizer evicts the entry the moment the forest is GC'd, so
    a retired model's device tables free immediately instead of lingering
    until LRU pressure pushes them out."""
    key = id(forest)
    ent = _CACHE.get(key)
    if ent is not None and ent[0]() is forest:
        _CACHE.move_to_end(key)
        return ent[1]
    payload: dict = {}

    def _evict(_ref, key=key):
        _CACHE.pop(key, None)

    _CACHE[key] = (weakref.ref(forest, _evict), payload)
    _CACHE.move_to_end(key)
    while len(_CACHE) > _CACHE_CAP:
        _CACHE.popitem(last=False)
    return payload


def _mask_words(cat_mask: np.ndarray) -> np.ndarray:
    """uint32 mask words as int32, bit for bit (torch's uint32 has no
    shifts on the CPU; the kernel reads the same bits as uint32)."""
    return np.ascontiguousarray(cat_mask, np.uint32).view(np.int32)


def _min_features(feature: np.ndarray, left_child: np.ndarray) -> int:
    """Columns X must have: 1 + the largest feature of an internal node."""
    internal = left_child >= 0
    return int(feature[internal].max()) + 1 if internal.any() else 0


class DeviceSoA(NamedTuple):
    feature: torch.Tensor      # (T, M) int32
    threshold: torch.Tensor    # (T, M) float32
    cat_mask: torch.Tensor     # (T, M, 8) int32 words
    left_child: torch.Tensor   # (T, M) int32
    leaf_value: torch.Tensor   # (T, M, O) float32
    min_features: int


class DevicePacked(NamedTuple):
    feature: torch.Tensor      # (B, TB, M) int32
    threshold: torch.Tensor    # (B, TB, M) float32
    cat_mask: torch.Tensor     # (B, TB, M, 8) int32 words
    left_child: torch.Tensor   # (B, TB, M) int32
    leaf_value: torch.Tensor   # (B, TB, M, O) float32
    block_depth: torch.Tensor  # (B,) int32
    inv_order: torch.Tensor    # (T,) int64: original tree t at packed slot
    min_features: int

    @property
    def tables(self) -> tuple:
        """The kernel's table arguments, in ``forest_predict_tiled`` order."""
        return (self.feature, self.threshold, self.cat_mask, self.left_child,
                self.leaf_value, self.block_depth)


def _check_device(device: torch.device) -> None:
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"forest tables were asked for on {device}, but torch sees no "
            "CUDA device; pass device='cpu' to run on the CPU.")


def device_soa(forest: Forest, device) -> DeviceSoA:
    """Raw Forest SoA on ``device``, uploaded once per (forest, device)."""
    device = torch.device(device)
    c = _forest_cache(forest)
    key = ("soa", str(device))
    if key not in c:
        _check_device(device)
        up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
        c[key] = DeviceSoA(
            up(forest.feature.astype(np.int32)),
            up(forest.threshold.astype(np.float32)),
            up(_mask_words(forest.cat_mask)),
            up(forest.left_child.astype(np.int32)),
            up(forest.leaf_value.astype(np.float32)),
            _min_features(forest.feature, forest.left_child))
    return c[key]


def device_packed(forest: Forest, device) -> DevicePacked:
    """Depth-packed layout (``pack_by_depth``) on ``device``, packed and
    uploaded once per (forest, device). Checks the kernel's preconditions
    on the host: children inside the node capacity."""
    device = torch.device(device)
    c = _forest_cache(forest)
    key = ("packed", str(device))
    if key not in c:
        _check_device(device)
        p = pack_by_depth(forest)
        if (p.left_child >= p.max_nodes - 1).any():
            raise YdfError(
                "The forest has a child index outside its node capacity "
                f"({p.max_nodes}); its SoA is corrupt. Rebuild or re-convert "
                "the model.")
        up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
        c[key] = DevicePacked(
            up(p.feature), up(p.threshold), up(_mask_words(p.cat_mask)),
            up(p.left_child), up(p.leaf_value),
            up(p.block_depth.reshape(-1)), up(p.inv_order.astype(np.int64)),
            _min_features(p.feature, p.left_child))
    return c[key]


def forest_predict(forest: Forest, X, impl: str = "cuda",
                   device="cuda") -> torch.Tensor:
    """forest: ``core.tree.Forest``; X: (N, F) raw-value matrix (numpy or
    tensor). -> (N, T, O) per-tree outputs on ``device``, original tree
    order. Unknown impls and too-narrow X raise ``ValueError``/``YdfError``
    (caller errors); kernel faults propagate as they are, and the compiled
    predictor lets them propagate too (no chain serves around them)."""
    if impl not in ("cuda", "ref"):
        raise ValueError(f"unknown impl {impl!r}; expected 'cuda' or 'ref'")
    device = torch.device(device)
    tabs = device_packed(forest, device) if impl == "cuda" \
        else device_soa(forest, device)      # raises on cuda without a card
    if isinstance(X, torch.Tensor):
        Xd = X.to(device=device, dtype=torch.float32).contiguous()
    else:
        Xd = torch.from_numpy(np.ascontiguousarray(X, np.float32)).to(device)
    if Xd.dim() != 2 or Xd.shape[1] < tabs.min_features:
        raise YdfError(
            f"The request matrix has shape {tuple(Xd.shape)}; the forest "
            f"splits on feature index {tabs.min_features - 1}, so it needs "
            f"(N, >= {tabs.min_features}) columns.")
    if impl == "ref":
        return forest_predict_ref(Xd, *tabs[:5], depth=int(forest.depth))
    out = forest_predict_tiled(Xd, *tabs.tables)
    return torch.index_select(out, 1, tabs.inv_order)
