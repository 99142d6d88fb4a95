"""The histogram kernel's wrapper (``csrc/histogram.cu``).

``histogram`` is the port of the TPU kernel
``repro.kernels.histogram.histogram.histogram_pallas``: the full
(n_nodes, F, n_bins, S) float32 histogram of per-row stats per (node,
feature, bin), rows with node -1 dropped. The batched growth engine builds
every level's histograms with it on the card (core/hist_backend.py).

On CUDA tensors it launches the kernel on the current stream, or raises: it
never falls back. On CPU tensors it runs the plain version
(``ref.histogram_f32_ref``), which is how the tests reach it without a card.
``LAUNCHES`` counts kernel launches, and nothing else; a call with no rows
or no nodes returns zeros without a launch.

The kernel sums in 64-bit fixed point (exact and order-free, so repeated
calls give the same bits and the count channel is exact) and returns the
float32 rounding of each sum; the plain version rounds a float64 sum. The
reference's kernel sums in float32.

Limits on the card: any S >= 1, N and n_nodes below 2^31; the stats in
groups of at most 16 and the nodes in chunks, as ``plan.histogram_plan``
lays them out. A call is two launches (prep, accumulate) and allocates
scratch that grows with N * S, not with the histogram.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.histogram.fused import INT32_MAX, _check
from repro_torch.kernels.histogram.plan import histogram_plan
from repro_torch.kernels.histogram.ref import histogram_f32_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "histogram.cu"

#: kernel launches since the last reset (plain-version calls not counted)
LAUNCHES = 0


@functools.cache
def library() -> ctypes.CDLL:
    """Build (on first use) and load the kernel library, with its C
    signatures declared; once per process. Raises RuntimeError when the
    build fails."""
    lib = ctypes.CDLL(str(_build.build(SOURCE).library))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.histogram.argtypes = [p, p, p] + [i] * 13 + [p, p, p]
    lib.histogram.restype = ctypes.c_int
    lib.histogram_scratch_bytes.argtypes = [i, i, i]
    lib.histogram_scratch_bytes.restype = ctypes.c_longlong
    lib.histogram_kernel_launches.argtypes = []
    lib.histogram_kernel_launches.restype = ctypes.c_longlong
    return lib


def histogram(codes, stats, node_of, n_nodes: int,
              n_bins: int = 256) -> torch.Tensor:
    """codes (N, F) uint8; stats (N, S) f32, finite; node_of (N,) int32 in
    [-1, n_nodes). -> (n_nodes, F, n_bins, S) f32 with
    ``out[n, f, b, s] = sum(stats[i, s] for i with node_of[i] == n and
    codes[i, f] == b)``."""
    if not isinstance(codes, torch.Tensor):
        raise TypeError(f"codes must be a torch.Tensor, got {type(codes).__name__}")
    dev = codes.device
    _check("codes", codes, torch.uint8, 2, dev)
    _check("stats", stats, torch.float32, 2, dev)
    _check("node_of", node_of, torch.int32, 1, dev)
    N, F = codes.shape
    S = stats.shape[1]
    if stats.shape[0] != N or node_of.shape[0] != N:
        raise ValueError(f"codes, stats and node_of must share N: "
                         f"{tuple(codes.shape)}, {tuple(stats.shape)}, "
                         f"{tuple(node_of.shape)}")
    if not 1 <= n_bins <= 256:
        raise ValueError(f"n_bins must be in [1, 256], got {n_bins}")
    if not 0 <= n_nodes < INT32_MAX:
        raise ValueError(f"n_nodes must be in [0, {INT32_MAX}), got {n_nodes}")
    if dev.type == "cpu":
        return histogram_f32_ref(codes, stats, node_of, n_nodes, n_bins)
    if dev.type != "cuda":
        raise ValueError(f"histogram runs on CUDA or CPU tensors, got "
                         f"device {dev}")
    if S < 1 or N >= INT32_MAX:
        raise ValueError(f"unsupported shape N={N}, S={S}: the kernel takes "
                         f"S >= 1 and N < {INT32_MAX}")
    if N == 0 or F == 0 or n_nodes == 0:
        return torch.zeros((n_nodes, F, n_bins, S), dtype=torch.float32,
                           device=dev)
    plan = histogram_plan(N, F, S, n_nodes)
    lib = library()
    scratch = torch.empty(lib.histogram_scratch_bytes(N, S, n_nodes),
                          dtype=torch.uint8, device=dev)
    out = torch.empty((n_nodes, F, n_bins, S), dtype=torch.float32, device=dev)
    # the kernels run on the current stream after this returns; the caching
    # allocator reuses the scratch only for later work on that same stream
    stream = torch.cuda.current_stream(dev).cuda_stream
    global LAUNCHES
    err = lib.histogram(codes.data_ptr(), stats.data_ptr(), node_of.data_ptr(),
                        N, F, S, n_nodes, n_bins, *plan.kernel_args(),
                        scratch.data_ptr(), out.data_ptr(), stream)
    if err:
        raise RuntimeError(f"histogram launch failed: CUDA error {err} "
                           f"(N={N}, F={F}, S={S}, n_nodes={n_nodes})")
    LAUNCHES += 1
    return out
