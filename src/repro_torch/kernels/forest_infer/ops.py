"""Dispatch and per-forest device caches for forest traversal.

A compiled forest is uploaded to its device ONCE: ``forest_predict`` keeps
a small id-keyed cache mapping a live Forest to its tables on each device —
(a) the raw SoA (the "single" and "ref" impls) and (b) the depth-packed
layout (the "cuda" impl), each with the kernels' node layout
(``layout.build``: 16-byte records, a mask side table and, for a forest
with sparse-oblique nodes, the oblique (column, weight) side table,
validated when built) — so repeat predictions do no host-to-device table
transfers, no re-packing and no table checks. Entries are validated against a weakref (id
reuse after GC cannot alias), evicted the moment the forest is collected,
and LRU-capped.

impls:
  * "cuda" — the tiled traversal kernel over the depth-packed layout
    (``forest_infer.run_tiled``), storing each output in tree order itself.
    On a CUDA device it launches the kernel or raises; on the CPU it runs
    the kernel's plain version.
  * "single" — the single-tree traversal kernel over the raw SoA at the
    forest's global depth (``forest_infer.run_single``, the port of the
    reference's ``impl="pallas_single"``). On a CUDA device it launches
    the kernel or raises; on the CPU it runs the kernel's plain version.
  * "ref"  — the plain PyTorch gather traversal over the raw SoA tables
    (``ref.forest_predict_ref``), on either device.

``forest_predict_bucketed`` runs the depth-bucketed layout
(``bucketed.py``, PyTorch tensor code, no kernel of its own) from the same
cache, one runner per (forest, strategy, device).
"""
from __future__ import annotations

import weakref
from collections import OrderedDict
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.api import EngineFailure, YdfError
from repro_torch.core.tree import Forest, pack_by_depth, pack_depth_buckets
from repro_torch.kernels.forest_infer import layout as node_layout
from repro_torch.kernels.forest_infer.bucketed import build_bucketed_runner
from repro_torch.kernels.forest_infer.forest_infer import run_single, run_tiled
from repro_torch.kernels.forest_infer.ref import forest_predict_ref

IMPLS = ("cuda", "single", "ref")
_CACHE: "OrderedDict[int, tuple]" = OrderedDict()
_CACHE_CAP = 8
# Whether a bucket's predicate matmul beats its scan rounds, per device
# type (``select_block_strategy``'s ``matmul_cheap``, which also keeps the
# scan for buckets deeper than 6 or over the table budget). On the CPU the
# scan wins at every depth (the reference's measurement, DESIGN.md §10.3).
# On an H100 (chip_smoke.time_buckets, the serving GBT's buckets of depth
# 3-6) the leaf-path block took less device time than the scan at every
# depth at 32 and 1,024 rows, the sizes of the serving ladder, where each
# scan round's eager launches set the time; at 4,096 rows the winner
# changed between runs, and at 65,536 the scan won at every depth
# (PERF.md).
MATMUL_CHEAP = {"cpu": False, "cuda": True}


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


class DeviceSoA(NamedTuple):
    feature: torch.Tensor      # (T, M) int32
    threshold: torch.Tensor    # (T, M) float32
    cat_mask: torch.Tensor     # (T, M, 8) int32 words
    left_child: torch.Tensor   # (T, M) int32
    leaf_value: torch.Tensor   # (T, M, O) float32
    layout: node_layout.NodeLayout  # the single-tree kernel's records
    obl_features: torch.Tensor | None = None  # (T, M, P) int32
    obl_weights: torch.Tensor | None = None   # (T, M, P) float32

    @property
    def min_features(self) -> int:
        return self.layout.min_features

    @property
    def obl(self) -> dict:
        """The oblique tables as the wrappers' keywords (None when the
        forest has no oblique node)."""
        return {"obl_features": self.obl_features,
                "obl_weights": self.obl_weights}


class DevicePacked(NamedTuple):
    feature: torch.Tensor      # (B, TB, M) int32
    threshold: torch.Tensor    # (B, TB, M) float32
    cat_mask: torch.Tensor     # (B, TB, M, 8) int32 words
    left_child: torch.Tensor   # (B, TB, M) int32
    leaf_value: torch.Tensor   # (B, TB, M, O) float32
    block_depth: torch.Tensor  # (B,) int32
    inv_order: torch.Tensor    # (T,) int64: original tree t at packed slot
    layout: node_layout.NodeLayout  # the tiled kernel's records
    obl_features: torch.Tensor | None = None  # (B, TB, M, P) int32
    obl_weights: torch.Tensor | None = None   # (B, TB, M, P) float32

    @property
    def min_features(self) -> int:
        return self.layout.min_features

    @property
    def tables(self) -> tuple:
        """The kernel's table arguments, in ``forest_predict_tiled`` order
        (the oblique tables, keywords of the wrappers, are ``obl``)."""
        return (self.feature, self.threshold, self.cat_mask, self.left_child,
                self.leaf_value, self.block_depth)

    @property
    def obl(self) -> dict:
        """The oblique tables as the wrappers' keywords (None when the
        forest has no oblique node)."""
        return {"obl_features": self.obl_features,
                "obl_weights": self.obl_weights}


def _check_device(device: torch.device) -> None:
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"forest tables were asked for on {device}, but torch sees no "
            "CUDA device; pass device='cpu' to run on the CPU.")


def device_soa(forest: Forest, device) -> DeviceSoA:
    """Raw Forest SoA on ``device`` with its node layout, uploaded, built
    and validated once per (forest, device); a child outside the node
    capacity raises YdfError before anything is uploaded."""
    device = torch.device(device)
    c = _forest_cache(forest)
    key = ("soa", str(device))
    if key not in c:
        _check_device(device)
        node_layout.check_children(forest.left_child, forest.max_nodes)
        up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
        tabs = (up(forest.feature.astype(np.int32)),
                up(forest.threshold.astype(np.float32)),
                up(_mask_words(forest.cat_mask)),
                up(forest.left_child.astype(np.int32)),
                up(forest.leaf_value.astype(np.float32)))
        obl = ((up(forest.obl_features.astype(np.int32)),
                up(forest.obl_weights.astype(np.float32)))
               if forest.has_oblique() else (None, None))
        c[key] = DeviceSoA(*tabs, node_layout.build(
            *tabs, depth=int(forest.depth), obl_features=obl[0],
            obl_weights=obl[1]), *obl)
    return c[key]


def device_packed(forest: Forest, device) -> DevicePacked:
    """Depth-packed tables (``pack_by_depth``) on ``device`` with their node
    layout, packed, uploaded, built and validated once per (forest,
    device); a child outside the node capacity raises YdfError before
    anything is uploaded."""
    device = torch.device(device)
    c = _forest_cache(forest)
    key = ("packed", str(device))
    if key not in c:
        _check_device(device)
        p = pack_by_depth(forest)
        node_layout.check_children(p.left_child, p.max_nodes)
        up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
        tabs = (up(p.feature), up(p.threshold), up(_mask_words(p.cat_mask)),
                up(p.left_child), up(p.leaf_value),
                up(p.block_depth.reshape(-1)))
        obl = ((up(p.obl_features), up(p.obl_weights))
               if p.obl_features is not None else (None, None))
        inv_order = up(p.inv_order.astype(np.int64))
        c[key] = DevicePacked(*tabs, inv_order, node_layout.build(
            *tabs[:5], block_depth=tabs[5], inv_order=inv_order,
            obl_features=obl[0], obl_weights=obl[1]), *obl)
    return c[key]


def forest_predict(forest: Forest, X, impl: str = "cuda",
                   device="cuda") -> torch.Tensor:
    """forest: ``core.tree.Forest``; X: (N, F) raw-value matrix (numpy or
    tensor). -> (N, T, O) per-tree outputs on ``device``, original tree
    order. Unknown impls and too-narrow X raise ``ValueError``/``YdfError``
    (caller errors); kernel faults propagate as they are, and the compiled
    predictor lets them propagate too (no chain serves around them)."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; expected one of "
                         f"{', '.join(map(repr, IMPLS))}")
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
        return forest_predict_ref(Xd, *tabs[:5], depth=int(forest.depth),
                                  **tabs.obl)
    if impl == "single":
        return run_single(Xd, tabs.layout)
    return run_tiled(Xd, tabs.layout, tree_order=True)


def bucketed_runner(forest: Forest, strategy: str | None = None,
                    device="cuda"):
    """The depth-bucketed runner (``bucketed.build_bucketed_runner``),
    packed and uploaded once per (forest, strategy, device). ``strategy``
    None lets the per-bucket cost model choose with the device's
    ``MATMUL_CHEAP``; "scan"/"leaf_path" force one strategy for every
    bucket."""
    device = torch.device(device)
    c = _forest_cache(forest)
    key = ("bucketed", strategy or "auto", str(device))
    if key not in c:
        _check_device(device)
        bf = pack_depth_buckets(forest, strategy=strategy,
                                matmul_cheap=MATMUL_CHEAP[device.type])
        c[key] = build_bucketed_runner(bf, device)
    return c[key]


def forest_predict_bucketed(forest: Forest, X, strategy: str | None = None,
                            device="cuda") -> np.ndarray:
    """Depth-bucketed prediction: (N, F) raw-value matrix -> (N, T, O)
    numpy, original tree order. Caller errors (too-narrow X) stay
    ``YdfError`` and a CUDA device without a card ``RuntimeError``; any
    other failure is an ``EngineFailure`` naming the engine ("leaf_path"
    when forced, else "bucketed")."""
    _check_device(torch.device(device))
    try:
        return bucketed_runner(forest, strategy, device)(X)
    except (YdfError, KeyboardInterrupt):   # EngineFailure is a YdfError
        raise
    except Exception as e:
        name = "leaf_path" if strategy == "leaf_path" else "bucketed"
        raise EngineFailure(
            f"forest_infer impl {name!r} failed on a "
            f"({np.shape(X)[0] if np.ndim(X) else '?'}, ...) batch: "
            f"{type(e).__name__}: {e}", engine=name) from e
