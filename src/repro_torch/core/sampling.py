"""Keyed (counter-based) per-node feature sampling, the port's copy of
``repro.core.sampling``.

The candidate features of node ``n`` of tree ``t`` are a pure function
``hash(key, t, n)`` (murmur3's 32-bit finalizer): the k features with the
smallest hashes, stable-argsorted, then sorted ascending so argmax ties keep
the lowest feature index. The numpy functions are verbatim copies; the torch
mirror gives bit-identical subsets on any device, which is what lets the
device growth engine reproduce the host engines' feature subsets.

torch's uint32 has no shifts or multiplies on the CPU, so the torch mirror
runs the finalizer in int64 and keeps the low 32 bits after every multiply
and xor-shift.
"""
from __future__ import annotations

import numpy as np
import torch

_GOLD = 0x9E3779B9
_M32 = 0xFFFFFFFF


def _mix_np(x: np.ndarray) -> np.ndarray:
    """murmur3 fmix32 finalizer on uint32 arrays (wrapping arithmetic)."""
    with np.errstate(over="ignore"):
        x = x.astype(np.uint32, copy=True)
        x ^= x >> np.uint32(16)
        x *= np.uint32(0x85EBCA6B)
        x ^= x >> np.uint32(13)
        x *= np.uint32(0xC2B2AE35)
        x ^= x >> np.uint32(16)
    return x


def feature_hash(key: int, tree: int, nodes: np.ndarray, F: int) -> np.ndarray:
    """(len(nodes), F) uint32 hash lattice for (key, tree, node, feature)."""
    h1 = _mix_np(np.uint32(key & 0xFFFFFFFF) ^ np.uint32(_GOLD))
    h2 = _mix_np(h1 ^ np.uint32(tree & 0xFFFFFFFF))
    hn = _mix_np(h2 ^ np.asarray(nodes, np.uint32))          # (n,)
    with np.errstate(over="ignore"):
        hf = np.arange(F, dtype=np.uint32) * np.uint32(_GOLD)
    return _mix_np(hn[:, None] ^ hf[None, :])                # (n, F)


def keyed_feature_select(key: int, tree: int, nodes: np.ndarray, F: int,
                         k: int) -> np.ndarray:
    """Per-node sampled feature indices: (len(nodes), k) int32, ascending."""
    h = feature_hash(key, tree, nodes, F)
    sel = np.argsort(h, axis=1, kind="stable")[:, :k]
    return np.sort(sel, axis=1).astype(np.int32)


def sample_size(ratio: float, F: int) -> int:
    """Subset size for a sampling ratio (the host engines' stream mode
    samples equally many)."""
    return max(1, int(round(ratio * F)))


# ---------------------------------------------------------------- torch mirror

def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for 0 <= x < 2^32, in int64 without overflow: the
    product is split at the constant's 16-bit halves."""
    lo = x * (c & 0xFFFF)                          # < 2^48
    hi = ((x * (c >> 16)) & 0xFFFF) << 16          # < 2^32
    return (lo + hi) & _M32


def _mix_t(x: torch.Tensor) -> torch.Tensor:
    """fmix32 on int64 tensors holding uint32 values: every product and
    xor-shift is cut back to its low 32 bits."""
    x = x & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def keyed_feature_select_torch(key: int, tree, nodes, F: int,
                               k: int) -> torch.Tensor:
    """torch mirror of ``keyed_feature_select``. ``tree`` and ``nodes`` are
    int tensors (any integer type, broadcastable; uint32 values taken mod
    2^32) -> (..., k) int64 feature indices, ascending, on their device."""
    nodes = torch.as_tensor(nodes)
    dev = nodes.device
    h1 = _mix_t(torch.tensor((key & _M32) ^ _GOLD, dtype=torch.int64,
                             device=dev))
    h2 = _mix_t(h1 ^ (torch.as_tensor(tree, device=dev).to(torch.int64) & _M32))
    hn = _mix_t(h2 ^ (nodes.to(torch.int64) & _M32))         # (...,)
    hf = _mul32(torch.arange(F, dtype=torch.int64, device=dev), _GOLD)
    h = _mix_t(hn[..., None] ^ hf)                           # (..., F)
    sel = torch.argsort(h, dim=-1, stable=True)[..., :k]
    return torch.sort(sel, dim=-1).values
