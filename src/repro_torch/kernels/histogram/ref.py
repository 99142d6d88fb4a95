"""Plain PyTorch histograms and fused split search: the oracles for the CUDA
kernels (``histogram.py``, ``fused.py``), and what their wrappers run on CPU
tensors.

hist[n, f, b, s] = sum over rows i with node_of[i] == n and codes[i, f] == b
of stats[i, s], accumulated in the stats' dtype with ``index_add_`` over
flat ``(node * F + f) * B + code`` ids (rows with node -1, and codes >= B,
add nothing). ``histogram_f32_ref`` sums in float64 and returns float32, the
dtype of the reference op, as the histogram kernel rounds its exact sums.
``fused_split_ref`` sums in float64 and scores in float32,
as the kernel scores float32 values of exact sums; it follows the TPU
kernel's rules, not the jnp oracle's, where the two differ: the best bin is taken per column (a NaN gain
ranks highest, as ``argmax`` ranks it, and makes the column's best NaN),
then a strict ``>`` fold over columns that a NaN never wins; a slot with
nothing scoreable gives (-1e30, -1, 0).
"""
from __future__ import annotations

import torch


def histogram_ref(codes: torch.Tensor, stats: torch.Tensor,
                  node_of: torch.Tensor, n_nodes: int,
                  n_bins: int) -> torch.Tensor:
    """codes: (N, F) uint8/int; stats: (N, S) f32; node_of: (N,) int with
    -1 = inactive. -> (n_nodes, F, B, S) f32."""
    N, F = codes.shape
    S = stats.shape[1]
    B = n_bins
    dev = stats.device
    code = codes.to(torch.int64)
    node = node_of.to(torch.int64)
    keep = (node >= 0)[:, None] & (code < B)
    seg = (node.clamp(min=0)[:, None] * F
           + torch.arange(F, device=dev)[None, :]) * B + code
    sink = n_nodes * F * B
    seg = torch.where(keep, seg, sink)
    flat = torch.zeros((sink + 1, S), dtype=stats.dtype, device=dev)
    flat.index_add_(0, seg.reshape(-1),
                    stats[:, None, :].expand(N, F, S).reshape(N * F, S))
    return flat[:sink].reshape(n_nodes, F, B, S)


def histogram_f32_ref(codes: torch.Tensor, stats: torch.Tensor,
                      node_of: torch.Tensor, n_nodes: int,
                      n_bins: int = 256) -> torch.Tensor:
    """The histogram kernel's plain version: (n_nodes, F, n_bins, S) float32,
    the rounding of float64 sums of the stats' values."""
    return histogram_ref(codes, stats.to(torch.float64), node_of, n_nodes,
                         n_bins).to(torch.float32)


def fused_split_ref(codes: torch.Tensor, stats: torch.Tensor,
                    slot_of: torch.Tensor, n_slots: int, n_bins: int = 256, *,
                    kind: str = "gh", l2: float = 0.0, min_examples: int = 5):
    """The full histogram, the ordered-bin gain scan, and the per-slot best
    (gain f32, column i32, split_bin i32); column -1 and split_bin 0 where
    no position was scoreable."""
    from repro_torch.kernels.histogram.fused import NEG_INF, _numerical_gains

    # float64 sums, float32 scores: the kernel's function up to the float64
    # rounding of its exact fixed-point sums
    hist = histogram_ref(codes, stats.to(torch.float64), slot_of, n_slots,
                         n_bins)                               # (W, kf, B, S)
    parent = hist.sum(dim=2)                                   # (W, kf, S)
    g = _numerical_gains(hist, parent, kind, float(l2),
                         int(min_examples))                    # (W, kf, B)
    nan = torch.isnan(g)
    gz = torch.where(nan, float("-inf"), g)
    col_best = gz.amax(dim=2)                                  # (W, kf)
    col_bin = gz.argmax(dim=2)                                 # first max
    # a NaN ranks highest within its column, so the column's best is NaN
    first_nan = nan.to(torch.int8).argmax(dim=2)
    has_nan = nan.any(dim=2)
    col_bin = torch.where(has_nan, first_nan, col_bin)
    cand = torch.where(has_nan | (col_best <= NEG_INF), float("-inf"),
                       col_best)
    best = cand.amax(dim=1)                                    # (W,)
    col = cand.argmax(dim=1)                                   # lowest column
    found = best > float("-inf")
    gain = torch.where(found, best, torch.full_like(best, NEG_INF))
    column = torch.where(found, col, -1).to(torch.int32)
    sbin = col_bin.gather(1, col[:, None])[:, 0] + 1
    split_bin = torch.where(found, sbin, 0).to(torch.int32)
    return gain, column, split_bin
