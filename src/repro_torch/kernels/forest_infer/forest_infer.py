"""The CUDA traversal kernel's wrapper (``csrc/forest_infer.cu``).

``forest_predict_tiled`` is the port of the TPU kernel
``repro.kernels.forest_infer.forest_infer.forest_predict_pallas_tiled``:
the same inputs (a depth-packed forest from ``core.tree.pack_by_depth``) and
the same output, (N, B*TB, O) float32 in packed tree order.

On CUDA tensors it launches the kernel on the current stream, or raises: it
never falls back. On CPU tensors it runs the kernel's plain PyTorch version
(``ref.forest_predict_packed_ref``), which is how the tests reach it without
a card. ``LAUNCHES`` counts kernel launches, and nothing else, so a run can
show that its traffic went through the kernel.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.forest_infer.ref import (
    MASK_WORDS,
    forest_predict_packed_ref,
)

SOURCE = Path(__file__).resolve().parent / "csrc" / "forest_infer.cu"

#: kernel launches since the last reset (plain-version calls not counted)
LAUNCHES = 0


@functools.cache
def library() -> ctypes.CDLL:
    """Build (on first use) and load the kernel library, with its C
    signature declared; once per process, so a dispatch does no file-system
    work. Raises RuntimeError when the build fails."""
    lib = ctypes.CDLL(str(_build.build(SOURCE).library))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.forest_infer_tiled.argtypes = [p, i, i, p, p, p, p, p, p, i, i, i, i,
                                       p, p]
    lib.forest_infer_tiled.restype = ctypes.c_int
    return lib


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, X is on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def forest_predict_tiled(X, feature, threshold, cat_mask, left_child,
                         leaf_value, block_depth) -> torch.Tensor:
    """X (N, F) f32; feature/left_child (B, TB, M) i32; threshold
    (B, TB, M) f32; cat_mask (B, TB, M, 8) i32 holding the uint32 mask
    words bit for bit; leaf_value (B, TB, M, O) f32; block_depth (B,) i32
    -> (N, B*TB, O) f32 in packed tree order.

    Preconditions the caller guarantees (``ops.device_packed`` checks them
    once per forest): every internal node's feature is < F and every
    left_child is < M - 1."""
    if not isinstance(X, torch.Tensor) or X.dim() != 2:
        raise ValueError("X must be a 2-D torch.Tensor of shape (N, F)")
    N, F = X.shape
    if feature.dim() != 3:
        raise ValueError(f"feature must be (B, TB, M), got {tuple(feature.shape)}")
    B, TB, M = feature.shape
    O = leaf_value.shape[-1]
    dev = X.device
    _check("X", X, torch.float32, (N, F), dev)
    _check("feature", feature, torch.int32, (B, TB, M), dev)
    _check("threshold", threshold, torch.float32, (B, TB, M), dev)
    _check("cat_mask", cat_mask, torch.int32, (B, TB, M, MASK_WORDS), dev)
    _check("left_child", left_child, torch.int32, (B, TB, M), dev)
    _check("leaf_value", leaf_value, torch.float32, (B, TB, M, O), dev)
    _check("block_depth", block_depth, torch.int32, (B,), dev)
    if dev.type == "cpu":
        return forest_predict_packed_ref(X, feature, threshold, cat_mask,
                                         left_child, leaf_value, block_depth)
    if dev.type != "cuda":
        raise ValueError(f"forest_predict_tiled runs on CUDA or CPU tensors, "
                         f"got device {dev}")
    if not 1 <= TB <= 256 or not 1 <= B <= 65535 or O < 1:
        raise ValueError(f"unsupported packed shape B={B}, TB={TB}, O={O}: "
                         "the kernel takes 1 <= TB <= 256, 1 <= B <= 65535")
    if cat_mask.data_ptr() % 16:
        raise ValueError("cat_mask must be 16-byte aligned")
    lib = library()
    out = torch.empty((N, B * TB, O), dtype=torch.float32, device=dev)
    if N == 0:
        return out
    # the kernel runs on the current stream after this returns; the caching
    # allocator only reuses X's or the tables' memory for later work on
    # that same stream, so no buffer here can be recycled under the kernel
    stream = torch.cuda.current_stream(dev).cuda_stream
    global LAUNCHES
    err = lib.forest_infer_tiled(
        X.data_ptr(), N, F, feature.data_ptr(), threshold.data_ptr(),
        cat_mask.data_ptr(), left_child.data_ptr(), leaf_value.data_ptr(),
        block_depth.data_ptr(), B, TB, M, O, out.data_ptr(), stream)
    if err:
        raise RuntimeError(f"forest_infer_tiled launch failed: CUDA error "
                           f"{err} (grid {-(-N // (256 // TB))} x {B}, block "
                           f"{TB} x {256 // TB})")
    LAUNCHES += 1
    return out
