"""Dispatch for the histogram kernels (mirrors
``repro.kernels.histogram.ops``).

impl:
  * None   — follow the tensors' device: the CUDA kernel for CUDA tensors,
             its plain version for CPU tensors;
  * "cuda" — the CUDA kernel; the tensors must be on a CUDA device;
  * "ref"  — the plain PyTorch version, on any device.

Nothing picks the CPU or the plain version for a caller whose tensors are
on the card.
"""
from __future__ import annotations

from repro_torch.kernels.histogram import histogram as _histogram
from repro_torch.kernels.histogram.fused import fused_split
from repro_torch.kernels.histogram.ref import fused_split_ref, histogram_f32_ref

IMPLS = (None, "cuda", "ref")


def _check_impl(impl, codes) -> None:
    if impl == "cuda" and codes.device.type != "cuda":
        raise ValueError(f"impl='cuda' needs CUDA tensors, got codes on "
                         f"{codes.device}; use impl=None or 'ref' on the CPU")
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; expected one of {IMPLS}")


def histogram(codes, stats, node_of, n_nodes: int, n_bins: int = 256,
              impl: str | None = None):
    """codes (N, F) uint8; stats (N, S) f32; node_of (N,) int32 in
    [-1, n_nodes) -> the (n_nodes, F, n_bins, S) f32 histogram."""
    if impl == "ref":
        return histogram_f32_ref(codes, stats, node_of, n_nodes, n_bins)
    _check_impl(impl, codes)
    return _histogram.histogram(codes, stats, node_of, n_nodes, n_bins)


def fused_best_split(codes, stats, slot_of, n_slots: int, n_bins: int = 256,
                     *, kind: str = "gh", l2: float = 0.0,
                     min_examples: int = 5, impl: str | None = None):
    """Fused histogram + ordered-bin gain scan + per-slot argmax. codes
    (N, kf) uint8; stats (N, S) f32; slot_of (N,) int32 -> per-slot (gain,
    column, split_bin), the small output that replaces the full
    (slots, kf, B, S) histogram on the training path."""
    kw = dict(kind=kind, l2=l2, min_examples=min_examples)
    if impl == "ref":
        return fused_split_ref(codes, stats, slot_of, n_slots, n_bins, **kw)
    _check_impl(impl, codes)
    return fused_split(codes, stats, slot_of, n_slots, n_bins, **kw)
