"""The fused split-search kernel's wrapper (``csrc/fused_split.cu``) and the
gain math it shares with its plain version.

``fused_split`` is the port of the TPU kernel
``repro.kernels.histogram.fused.fused_split_pallas``: per frontier slot,
the 256-bin histogram of each candidate column, the ordered-bin gain scan
and the argmax, down to one (gain, column, split_bin) per slot; the
``(slots, columns, bins, stats)`` histogram never reaches the caller.

On CUDA tensors it launches the kernel on the current stream, or raises: it
never falls back. On CPU tensors it runs the plain version
(``ref.fused_split_ref``), which is how the tests reach it without a card.
``LAUNCHES`` counts kernel launches, and nothing else, so a run can show
that its level steps went through the kernel.

The kernel sums in 64-bit fixed point (exact and order-free, so repeated
calls give the same bits) and the plain version in float64; both score in
float32 from the float32 values of those sums. The reference's kernel sums
in float32, whose rounding over ~10^5 rows moves a gain by more than the
validity floor ``REL_GAIN_EPS * |score(parent)|``; with sums this exact the
kernel and its plain version agree to that floor, and at a near-tie either
may pick a different (column, split_bin) pair than the reference.

Limits on the card: any S >= 2, kf >= 1, N and n_slots below 2^31; the
launch plan is ``plan.fused_plan``. A call is three launches (prep, the
accumulate-and-scan, the fold over columns).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.histogram.plan import fused_plan
from repro_torch.kernels.histogram.ref import fused_split_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "fused_split.cu"
NEG_INF = -1e30  # matches splitters.NEG_INF
KINDS = {"gh": 0, "class": 1, "moment": 2}
INT32_MAX = 2 ** 31 - 1

#: kernel launches since the last reset (plain-version calls not counted)
LAUNCHES = 0


def score_stats(stats: torch.Tensor, kind: str, l2: float) -> torch.Tensor:
    """Score of (..., S) stat vectors; the gain of a split is
    score(L) + score(R) - score(P)."""
    if kind == "gh":
        g, h = stats[..., 0], stats[..., 1]
        return 0.5 * torch.square(g) / (h + l2 + 1e-12)
    if kind == "class":
        counts = stats[..., :-1]
        n = stats[..., -1]
        tot = torch.clamp_min(n, 1e-12)[..., None]
        p = counts / tot
        ent = -(p * torch.log(torch.clamp_min(p, 1e-12))).sum(-1)
        return -n * ent
    if kind == "moment":
        sy, n = stats[..., 0], stats[..., -1]
        return torch.square(sy) / torch.clamp_min(n, 1e-12)
    raise ValueError(kind)


def _numerical_gains(hist: torch.Tensor, parent: torch.Tensor, kind: str,
                     l2: float, min_examples: int) -> torch.Tensor:
    """Split-position gains for ordered bins. hist: (..., B, S); parent:
    (..., S). Position b means "bins <= b go left", i.e. split_bin = b + 1;
    the last position (nothing right) is masked. Returns (..., B) float32
    gains. The prefix sums run in the histogram's dtype and the scores in
    float32, so a float64 histogram gives float32 gains of float64 sums."""
    B = hist.shape[-2]
    cum = torch.cumsum(hist, dim=-2)                        # (..., B, S)
    left = cum.to(torch.float32)
    right = (parent[..., None, :] - cum).to(torch.float32)
    parent = parent.to(torch.float32)
    g = (score_stats(left, kind, l2) + score_stats(right, kind, l2)
         - score_stats(parent, kind, l2)[..., None])
    pos = torch.arange(B, device=hist.device)
    ok = ((left[..., -1] >= min_examples)
          & (right[..., -1] >= min_examples)
          & (pos < B - 1))
    return torch.where(ok, g, NEG_INF)


@functools.cache
def library() -> ctypes.CDLL:
    """Build (on first use) and load the kernel library, with its C
    signatures declared; once per process. Raises RuntimeError when the
    build fails."""
    lib = ctypes.CDLL(str(_build.build(SOURCE).library))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.fused_split.argtypes = ([p, p, p, i, i, i, i, i, i, f, f] + [i] * 8
                                + [p] * 7)
    lib.fused_split.restype = ctypes.c_int
    lib.fused_split_scratch_bytes.argtypes = [i, i, i]
    lib.fused_split_scratch_bytes.restype = ctypes.c_longlong
    lib.fused_split_kernel_launches.argtypes = []
    lib.fused_split_kernel_launches.restype = ctypes.c_longlong
    return lib


def _check(name: str, t, dtype: torch.dtype, ndim: int,
           device: torch.device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, codes are on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def fused_split(codes, stats, slot_of, n_slots: int, n_bins: int = 256, *,
                kind: str = "gh", l2: float = 0.0, min_examples: int = 5):
    """codes (N, kf) uint8 (numerical bin codes, one column per candidate
    feature); stats (N, S) f32, finite, the last stat the count; slot_of
    (N,) int32 in [-1, n_slots). -> (gain (n_slots,) f32, column
    (n_slots,) i32, split_bin (n_slots,) i32); column -1 and split_bin 0
    where no position was scoreable."""
    if not isinstance(codes, torch.Tensor):
        raise TypeError(f"codes must be a torch.Tensor, got {type(codes).__name__}")
    dev = codes.device
    _check("codes", codes, torch.uint8, 2, dev)
    _check("stats", stats, torch.float32, 2, dev)
    _check("slot_of", slot_of, torch.int32, 1, dev)
    N, kf = codes.shape
    S = stats.shape[1]
    if stats.shape[0] != N or slot_of.shape[0] != N:
        raise ValueError(f"codes, stats and slot_of must share N: "
                         f"{tuple(codes.shape)}, {tuple(stats.shape)}, "
                         f"{tuple(slot_of.shape)}")
    if kind not in KINDS:
        raise ValueError(f"unknown stat kind {kind!r}; expected one of "
                         f"{sorted(KINDS)}")
    if S < 2:
        raise ValueError(f"stats need at least 2 columns (the last is the "
                         f"count), got {S}")
    if not 1 <= n_bins <= 256:
        raise ValueError(f"n_bins must be in [1, 256], got {n_bins}")
    if not 1 <= n_slots < INT32_MAX:
        raise ValueError(f"n_slots must be in [1, {INT32_MAX}), got {n_slots}")
    if dev.type == "cpu":
        return fused_split_ref(codes, stats, slot_of, n_slots, n_bins,
                               kind=kind, l2=l2, min_examples=min_examples)
    if dev.type != "cuda":
        raise ValueError(f"fused_split runs on CUDA or CPU tensors, got "
                         f"device {dev}")
    if kf < 1 or N >= INT32_MAX:
        raise ValueError(f"unsupported shape N={N}, kf={kf}: the kernel takes "
                         f"kf >= 1 and N < {INT32_MAX}")
    plan = fused_plan(N, kf, S, n_slots, kind)
    lib = library()
    scratch = torch.empty(lib.fused_split_scratch_bytes(N, S, n_slots),
                          dtype=torch.uint8, device=dev)
    col_gain = torch.empty((n_slots, kf), dtype=torch.float32, device=dev)
    col_bin = torch.empty((n_slots, kf), dtype=torch.int32, device=dev)
    gain = torch.empty(n_slots, dtype=torch.float32, device=dev)
    column = torch.empty(n_slots, dtype=torch.int32, device=dev)
    split_bin = torch.empty(n_slots, dtype=torch.int32, device=dev)
    # the kernels run on the current stream after this returns; the caching
    # allocator reuses the scratch only for later work on that same stream
    stream = torch.cuda.current_stream(dev).cuda_stream
    global LAUNCHES
    err = lib.fused_split(
        codes.data_ptr(), stats.data_ptr(), slot_of.data_ptr(), N, kf, S,
        n_slots, n_bins, KINDS[kind], float(l2), float(min_examples),
        *plan.kernel_args(), scratch.data_ptr(), col_gain.data_ptr(),
        col_bin.data_ptr(), gain.data_ptr(), column.data_ptr(),
        split_bin.data_ptr(), stream)
    if err:
        raise RuntimeError(f"fused_split launch failed: CUDA error {err} "
                           f"(N={N}, kf={kf}, S={S}, W={n_slots})")
    LAUNCHES += 1
    return gain, column, split_bin
