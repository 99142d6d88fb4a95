"""The CUDA traversal kernels' wrappers (``csrc/forest_infer.cu`` and
``csrc/forest_single.cu``).

  * ``forest_predict_tiled`` is the port of the TPU kernel
    ``repro.kernels.forest_infer.forest_infer.forest_predict_pallas_tiled``:
    the same inputs (a depth-packed forest from ``core.tree.pack_by_depth``)
    and the same output, (N, B*TB, O) float32 in packed tree order.
  * ``forest_predict_single`` is the port of ``forest_predict_pallas``: one
    walk per (example, tree) over the raw (T, M) SoA at the forest's global
    depth, (N, T, O) float32 in tree order.

Both also take sparse-oblique nodes (``obl_features`` / ``obl_weights``),
which the TPU kernels refuse: their projections follow numpy's pairwise
order (``ref.pairwise_sum``), so the kernels equal the reference's
vectorized ``predict_raw`` bit for bit.

Both table-level functions check every table, build the node layout
(``layout.build``) and call the layout-level wrappers, ``run_tiled`` and
``run_single``, which the serving path calls with the layout that
``ops.device_packed`` / ``ops.device_soa`` built and validated once per
forest: per call they check X alone. On CUDA tensors a wrapper launches its
kernel on the current stream, or raises: none falls back. On CPU tensors
it runs the plain version, ``layout.walk``, which is how the tests reach
them without a card. ``LAUNCHES`` and ``SINGLE_LAUNCHES`` count kernel
launches, and nothing else, so a run can show that its traffic went
through the kernels.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.forest_infer import layout as node_layout
from repro_torch.kernels.forest_infer import plan as launch_plan
from repro_torch.kernels.forest_infer.layout import NodeLayout
from repro_torch.obs import trace

SOURCE = Path(__file__).resolve().parent / "csrc" / "forest_infer.cu"
SINGLE_SOURCE = SOURCE.with_name("forest_single.cu")

#: tiled-kernel launches since the last reset (plain-version calls not counted)
LAUNCHES = 0
#: single-tree-kernel launches since the last reset (the same rule)
SINGLE_LAUNCHES = 0


@functools.cache
def library() -> ctypes.CDLL:
    """Build (on first use) and load the kernel library, with its C
    signature declared; once per process, so a dispatch does no file-system
    work. Raises RuntimeError when the build fails."""
    lib = ctypes.CDLL(str(_build.build(SOURCE).library))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.forest_infer_tiled.argtypes = [p, i, i, p, p, p, p, p, i, p, p, p, i,
                                       i, i, i, i, i, i, i, i, i, i, p, p]
    lib.forest_infer_tiled.restype = ctypes.c_int
    return lib


@functools.cache
def single_library() -> ctypes.CDLL:
    """The single-tree kernel's library, built and loaded as ``library``."""
    lib = ctypes.CDLL(str(_build.build(SINGLE_SOURCE).library))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.forest_predict_single.argtypes = [p, i, i, p, p, p, p, p, i, p, i, i,
                                          i, i, i, i, i, i, i, i, i, p, p]
    lib.forest_predict_single.restype = ctypes.c_int
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


def _check_x(X, lay: NodeLayout, what: str) -> torch.device:
    """The per-call check of a layout-level wrapper: X alone."""
    if not isinstance(X, torch.Tensor) or X.dim() != 2:
        raise ValueError("X must be a 2-D torch.Tensor of shape (N, F)")
    if X.dtype != torch.float32:
        raise TypeError(f"X must be torch.float32, got {X.dtype}")
    if not X.is_contiguous():
        raise ValueError("X must be contiguous")
    dev = X.device
    if dev != lay.device:
        raise ValueError(f"X is on {dev}, the layout on {lay.device}")
    if X.shape[1] < lay.min_features:
        raise ValueError(f"X has {X.shape[1]} columns; the forest splits on "
                         f"column {lay.min_features - 1}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on CUDA or CPU tensors, got device "
                         f"{dev}")
    return dev


def _stream(dev: torch.device) -> int:
    # the kernel runs on the current stream after this returns; the caching
    # allocator only reuses X's or the tables' memory for later work on
    # that same stream, so no buffer here can be recycled under the kernel
    return torch.cuda.current_stream(dev).cuda_stream


def plan_of(lay: NodeLayout, N: int,
            variant: str | None = None) -> launch_plan.Plan:
    """The launch plan of N rows over ``lay``: B2's for a packed layout,
    B4's for an unpacked one (side tables counted)."""
    if lay.packed:
        return launch_plan.tiled_plan(N, lay.slots // lay.group, lay.group,
                                      lay.max_nodes, lay.group_masks[0],
                                      variant, lay.group_obl[0])
    return launch_plan.single_plan(N, max(1, lay.slots), lay.max_nodes,
                                   lay.out_dim, lay.group_masks, variant,
                                   lay.group_obl)


def run_tiled(X: torch.Tensor, lay: NodeLayout, *, tree_order: bool = False,
              variant: str | None = None) -> torch.Tensor:
    """X (N, F) f32 over a packed layout -> (N, S, O) f32 in packed slot
    order, or (N, T, O) in tree order with ``tree_order``. ``variant``
    forces the plan's "staged" or "global" way (see ``plan.py``). The
    caller's open span, while tracing, gets the plan's ``variant`` and the
    oblique pairs a node holds (``obl_width``)."""
    if not lay.packed:
        raise ValueError("run_tiled takes a packed layout")
    dev = _check_x(X, lay, "forest_predict_tiled")
    if tree_order and lay.slot_tree is None:
        raise ValueError("tree order needs a layout built with inv_order")
    N, F = X.shape
    S, M, O = lay.slots, lay.max_nodes, lay.out_dim
    pl = plan_of(lay, N, variant)
    trace.annotate(variant=pl.variant, obl_width=lay.obl_dims)
    if dev.type == "cpu":
        return node_layout.walk(X, lay, tree_order=tree_order)
    cols = lay.n_trees if tree_order else S
    lib = library()
    out = torch.empty((N, cols, O), dtype=torch.float32, device=dev)
    if N == 0:
        return out
    global LAUNCHES
    err = lib.forest_infer_tiled(
        X.data_ptr(), N, F, lay.records.data_ptr(), lay.masks.data_ptr(),
        lay.mask_start.data_ptr(), lay.obl.data_ptr(),
        lay.obl_start.data_ptr(), lay.obl_dims, lay.leaf.data_ptr(),
        lay.block_depth.data_ptr(),
        lay.slot_tree.data_ptr() if tree_order else None, S, M, O, cols,
        *pl.kernel_args(), out.data_ptr(), _stream(dev))
    if err:
        raise RuntimeError(f"forest_infer_tiled launch failed: CUDA error "
                           f"{err} ({pl})")
    LAUNCHES += 1
    return out


def run_single(X: torch.Tensor, lay: NodeLayout, *,
               variant: str | None = None) -> torch.Tensor:
    """X (N, F) f32 over an unpacked layout -> (N, T, O) f32 in tree order,
    every tree walked for the layout's ``depth`` rounds. ``variant`` as for
    ``run_tiled``."""
    if lay.packed:
        raise ValueError("run_single takes an unpacked layout")
    dev = _check_x(X, lay, "forest_predict_single")
    N, F = X.shape
    T, M, O = lay.slots, lay.max_nodes, lay.out_dim
    if dev.type == "cpu":
        return node_layout.walk(X, lay)
    out = torch.empty((N, T, O), dtype=torch.float32, device=dev)
    if N == 0 or T == 0:
        return out
    lib = single_library()
    pl = plan_of(lay, N, variant)
    global SINGLE_LAUNCHES
    err = lib.forest_predict_single(
        X.data_ptr(), N, F, lay.records.data_ptr(), lay.masks.data_ptr(),
        lay.mask_start.data_ptr(), lay.obl.data_ptr(),
        lay.obl_start.data_ptr(), lay.obl_dims, lay.leaf.data_ptr(), T, M, O,
        lay.depth, *pl.kernel_args(), out.data_ptr(), _stream(dev))
    if err:
        raise RuntimeError(f"forest_predict_single launch failed: CUDA error "
                           f"{err} ({pl})")
    SINGLE_LAUNCHES += 1
    return out


def forest_predict_tiled(X, feature, threshold, cat_mask, left_child,
                         leaf_value, block_depth, obl_features=None,
                         obl_weights=None) -> torch.Tensor:
    """X (N, F) f32; feature/left_child (B, TB, M) i32; threshold
    (B, TB, M) f32; cat_mask (B, TB, M, 8) i32 holding the uint32 mask
    words bit for bit; leaf_value (B, TB, M, O) f32; block_depth (B,) i32;
    obl_features (B, TB, M, P) i32 and obl_weights (B, TB, M, P) f32 for a
    forest with sparse-oblique nodes, else None
    -> (N, B*TB, O) f32 in packed tree order.

    Checks every table, builds their layout (which checks that every
    child is < M - 1) and runs ``run_tiled``; X must be as wide as the
    largest column an internal node reads."""
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
    _check("cat_mask", cat_mask, torch.int32, (B, TB, M, 8), dev)
    _check("left_child", left_child, torch.int32, (B, TB, M), dev)
    _check("leaf_value", leaf_value, torch.float32, (B, TB, M, O), dev)
    _check("block_depth", block_depth, torch.int32, (B,), dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"forest_predict_tiled runs on CUDA or CPU tensors, "
                         f"got device {dev}")
    lay = node_layout.build(feature, threshold, cat_mask, left_child,
                            leaf_value, block_depth=block_depth,
                            obl_features=obl_features,
                            obl_weights=obl_weights)
    return run_tiled(X, lay)


def forest_predict_single(X, feature, threshold, cat_mask, left_child,
                          leaf_value, depth: int, obl_features=None,
                          obl_weights=None) -> torch.Tensor:
    """X (N, F) f32; feature/left_child (T, M) i32; threshold (T, M) f32;
    cat_mask (T, M, 8) i32 holding the uint32 mask words bit for bit;
    leaf_value (T, M, O) f32; depth: the forest's global depth;
    obl_features (T, M, P) i32 and obl_weights (T, M, P) f32, or None
    -> (N, T, O) f32 in tree order, every tree walked for
    ``max(1, depth)`` rounds.

    Checks every table, builds their layout and runs ``run_single``."""
    if not isinstance(X, torch.Tensor) or X.dim() != 2:
        raise ValueError("X must be a 2-D torch.Tensor of shape (N, F)")
    N, F = X.shape
    if feature.dim() != 2:
        raise ValueError(f"feature must be (T, M), got {tuple(feature.shape)}")
    T, M = feature.shape
    O = leaf_value.shape[-1]
    dev = X.device
    _check("X", X, torch.float32, (N, F), dev)
    _check("feature", feature, torch.int32, (T, M), dev)
    _check("threshold", threshold, torch.float32, (T, M), dev)
    _check("cat_mask", cat_mask, torch.int32, (T, M, 8), dev)
    _check("left_child", left_child, torch.int32, (T, M), dev)
    _check("leaf_value", leaf_value, torch.float32, (T, M, O), dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"forest_predict_single runs on CUDA or CPU tensors, "
                         f"got device {dev}")
    lay = node_layout.build(feature, threshold, cat_mask, left_child,
                            leaf_value, depth=depth,
                            obl_features=obl_features,
                            obl_weights=obl_weights)
    return run_single(X, lay)
