"""Tree growth dispatch for the port's learners (the ``GrowthParams``,
``resolve_engine``, ``grow_tree`` and ``grow_trees`` of
``repro.core.grower``).

The port has one engine, "device" (core/grower_device.py): the level-wise
loop on the card, with the fused split-search kernel. The host engines
"batched" and "oracle" are not ported yet (ROADMAP A9) and raise. Where the
reference falls back from "device" to "batched" for a configuration the
device engine cannot run, the port raises ``YdfError`` with the same
reason: nothing moves training to the host on the caller's behalf.

The grower owns node allocation in the Forest SoA and the per-example
``node_of`` routing; leaf values come from a caller-provided ``leaf_fn``
over aggregated node stats.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from repro_torch.core.api import YdfError
from repro_torch.core.binning import BinnedFeatures
from repro_torch.core.grower_device import (
    device_unsupported_reason,
    grow_trees_device,
)
from repro_torch.core.splitters import SplitterParams
from repro_torch.core.tree import Forest

ENGINES = ("batched", "oracle", "device")


@dataclass
class GrowthParams:
    max_depth: int = 6
    max_nodes: int = 2048            # total node budget per tree
    growing_strategy: str = "LOCAL"  # LOCAL | BEST_FIRST_GLOBAL
    splitter: SplitterParams = field(default_factory=SplitterParams)
    engine: str = "batched"          # batched | oracle | device; the port
                                     # runs "device" only
    # per-node feature sampling policy: "stream" draws from the host rng
    # (not on the device engine), "keyed" hashes (sampling_key, tree, node)
    # — sampling.py — so every engine derives identical subsets
    feature_sampling: str = "stream"
    sampling_key: int = 0
    device_impl: str = "auto"        # auto | torch | cuda
    device: str | None = None        # None: cuda


def resolve_engine(params: GrowthParams, binned: BinnedFeatures | None = None,
                   oblique_active: bool = False) -> tuple[str, None]:
    """The engine that will run, and no fallback reason: the port runs the
    device engine or raises ``YdfError``."""
    if params.engine not in ENGINES:
        raise YdfError(f"Unknown growth engine {params.engine!r}. "
                       f"Expected one of: {', '.join(map(repr, ENGINES))}.")
    if params.engine != "device":
        raise YdfError(
            f"growth_engine={params.engine!r} is a host engine that the "
            "PyTorch port does not have yet (ROADMAP A9). Solution: use "
            "growth_engine='device'.")
    reason = device_unsupported_reason(params, binned, oblique_active)
    if reason:
        raise YdfError(
            f"The device growth engine cannot run this configuration: "
            f"{reason}. The reference falls back to the host 'batched' "
            "engine, which the port does not have yet (ROADMAP A9).")
    return "device", None


def grow_tree(forest: Forest, t: int, binned: BinnedFeatures,
              stats: np.ndarray, active: np.ndarray,
              leaf_fn: Callable[[np.ndarray], np.ndarray],
              params: GrowthParams) -> np.ndarray:
    """Grow tree ``t`` in place. ``active``: (N,) bool mask; ``stats`` must
    already include bagging weights. Returns the final ``node_of`` ((N,)
    int32, -1 for inactive examples), so boosting reads leaf assignments
    without a traversal."""
    resolve_engine(params, binned)
    forest.leaf_value[t, 0] = leaf_fn(stats[active].sum(0))
    forest.n_nodes[t] = 1
    return grow_trees_device(forest, [t], binned, [stats], [active],
                             leaf_fn, params)[0]


def grow_trees(forest: Forest, ts, binned: BinnedFeatures, stats_list,
               actives, leaf_fn, params: GrowthParams,
               block: int | None = None) -> np.ndarray:
    """Grow a block of independent trees (Random Forest §3.6) one level at a
    time. ``block`` is the nominal block width: a short final block is padded
    to it. Returns per-tree final routing, (len(ts), N) int32."""
    resolve_engine(params, binned)
    for b, t in enumerate(ts):
        forest.leaf_value[t, 0] = leaf_fn(stats_list[b][actives[b]].sum(0))
        forest.n_nodes[t] = 1
    return grow_trees_device(forest, ts, binned, stats_list, actives,
                             leaf_fn, params, block=block or len(ts))
