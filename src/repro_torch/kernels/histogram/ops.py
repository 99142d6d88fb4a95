"""Dispatch for the fused split search (mirrors
``repro.kernels.histogram.ops.fused_best_split``).

impl:
  * None   — follow the tensors' device: the CUDA kernel for CUDA tensors,
             its plain version for CPU tensors (``fused.fused_split``);
  * "cuda" — the CUDA kernel; the tensors must be on a CUDA device;
  * "ref"  — the plain PyTorch version, on any device.

Nothing picks the CPU or the plain version for a caller whose tensors are
on the card. The full-histogram op (``histogram``) comes with its kernel
(ROADMAP B3).
"""
from __future__ import annotations

from repro_torch.kernels.histogram.fused import fused_split
from repro_torch.kernels.histogram.ref import fused_split_ref

IMPLS = (None, "cuda", "ref")


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
    if impl == "cuda" and codes.device.type != "cuda":
        raise ValueError(f"impl='cuda' needs CUDA tensors, got codes on "
                         f"{codes.device}; use impl=None or 'ref' on the CPU")
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; expected one of {IMPLS}")
    return fused_split(codes, stats, slot_of, n_slots, n_bins, **kw)
