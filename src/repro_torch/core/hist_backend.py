"""Pluggable histogram-building backends, the port of
``repro.core.hist_backend`` (DESIGN.md §4).

Training spends most of its time accumulating per-node gradient histograms
(paper §3.8). Implementations of the same contract:

  * "numpy"  — host path: one flattened ``np.bincount`` per (feature, unique
               stat) over (node, bin) buckets; the reference's, copied.
  * "simple" — the historical example-major pass, the ground truth the
               oracle engine uses; the reference's, copied.
  * "cuda"   — the hand-written CUDA histogram kernel
               (``kernels/histogram/csrc/histogram.cu``) on the training
               device; it stands in for the reference's "pallas" backend.
  * "torch"  — the kernel's plain PyTorch version, asked for explicitly; it
               takes the role of the reference's "pallas_interpret".

``resolve_backend("auto", device)`` is "cuda" when training runs on a CUDA
device and "numpy" on the CPU (the reference's rule on a host without its
accelerator, which keeps CPU training bit-identical to the reference).

Backends return float64 arrays; callers cast to float32 for the gain scan.
Only backends that accumulate in float64 (numpy, simple) advertise
``exact_subtraction``: the grower derives a sibling as parent minus child
only under it, and builds both children directly on the cuda and torch
backends, whose float32 outputs would leave f32-rounding residuals.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.api import YdfError

NAMES = ("auto", "numpy", "simple", "cuda", "torch")


class HistogramBackend:
    """Contract: ``build(codes, stats, node_of, n_nodes, max_bins)``.

    codes: (N, F) uint8; stats: (N, S) float; node_of: (N,) int32 in
    [-1, n_nodes) (-1 = inactive example). Returns (n_nodes, F, B, S) float64
    with ``out[n, f, b, s] = sum(stats[i, s] for active i in node n with
    codes[i, f] == b)``.
    """

    name = "?"
    # True when build() accumulates in float64, making parent-minus-sibling
    # subtraction (grower.py) safe: the f64 residual vanishes under the f32
    # cast of the gain scan. Backends whose output is float32 must not be
    # used for subtraction — residuals of f32-rounding scale can leave
    # derived buckets (e.g. hessians) slightly negative.
    exact_subtraction = False

    def build(self, codes: np.ndarray, stats: np.ndarray, node_of: np.ndarray,
              n_nodes: int, max_bins: int = 256) -> np.ndarray:
        raise NotImplementedError


class NumpyHistogramBackend(HistogramBackend):
    """Feature-major flattened bincount: one (examples,)-length scatter per
    (feature, unique stat) pair. Weight vectors are plain column views — no
    (N, F) broadcast copies — and each scatter touches a single
    (n_nodes * B) strip, so the working set stays cache-resident. Per-bucket
    accumulation order remains example-ascending, which keeps results
    bit-identical to the historical example-major per-stat pass."""

    name = "numpy"
    exact_subtraction = True

    def build(self, codes, stats, node_of, n_nodes, max_bins=256):
        F = codes.shape[1]
        S = stats.shape[1]
        B = max_bins
        act = node_of >= 0
        if not act.all():
            codes, stats, node_of = codes[act], stats[act], node_of[act]
        stats = np.ascontiguousarray(stats, np.float64)
        node = node_of.astype(np.int64) * B
        # Duplicate stat columns (e.g. GBT's hessian-gain-off layout repeats
        # the weight column) are accumulated once and copied to each alias.
        uniq, inv = _unique_stat_columns(stats)
        out = np.empty((n_nodes, F, B, S), np.float64)
        for f in range(F):
            flat = node + codes[:, f]
            strips = [np.bincount(flat, weights=stats[:, s],
                                  minlength=n_nodes * B).reshape(n_nodes, B)
                      for s in uniq]
            for s in range(S):
                out[:, f, :, s] = strips[inv[s]]
        return out


class SimpleHistogramBackend(HistogramBackend):
    """The historical example-major formulation: one bincount per stat over an
    (N, F)-shaped flat index, with per-stat broadcast weight copies. Kept as
    the readable ground-truth module (paper §2.3) — the oracle growth engine
    uses it, and the optimized backends are tested against it bit-for-bit."""

    name = "simple"
    exact_subtraction = True

    def build(self, codes, stats, node_of, n_nodes, max_bins=256):
        F = codes.shape[1]
        S = stats.shape[1]
        B = max_bins
        act = node_of >= 0
        codes_a = codes[act]
        stats_a = stats[act]
        node_a = node_of[act].astype(np.int64)
        out = np.zeros((n_nodes * F * B, S), np.float64)
        base = node_a[:, None] * (F * B) + np.arange(F)[None, :] * B  # (n, F)
        flat = (base + codes_a).ravel()
        for s in range(S):
            w = np.broadcast_to(stats_a[:, s:s + 1], (len(node_a), F)).ravel()
            out[:, s] = np.bincount(flat, weights=w, minlength=n_nodes * F * B)
        return out.reshape(n_nodes, F, B, S)


def _unique_stat_columns(stats: np.ndarray) -> tuple[list[int], np.ndarray]:
    """Indices of the first occurrence of each distinct stat column, plus the
    inverse map expanding unique columns back to the full layout."""
    S = stats.shape[1]
    uniq: list[int] = []
    inv = np.zeros(S, np.int64)
    for s in range(S):
        for k, u in enumerate(uniq):
            if np.array_equal(stats[:, s], stats[:, u]):
                inv[s] = k
                break
        else:
            inv[s] = len(uniq)
            uniq.append(s)
    return uniq, inv


class CudaHistogramBackend(HistogramBackend):
    """The histogram kernel behind the host-side contract, on ``device``.

    Each build copies codes, float32 stats and node ids to the device, runs
    ``ops.histogram`` (the CUDA kernel, or with ``plain=True`` its plain
    PyTorch version, the "torch" backend) and copies the float32 histogram
    back. Unlike the reference's jit, nothing here needs ``n_nodes`` padded:
    the output has exactly ``n_nodes`` rows. ``builds`` counts calls of
    ``build``.
    """

    def __init__(self, device, plain: bool = False):
        self.device = torch.device(device)
        self.plain = plain
        self.name = "torch" if plain else "cuda"
        self.builds = 0

    def build(self, codes, stats, node_of, n_nodes, max_bins=256):
        from repro_torch.kernels.histogram.ops import histogram
        self.builds += 1
        dev = self.device
        # stats as float32 before the kernel, as the reference backend does
        out = histogram(
            torch.from_numpy(np.ascontiguousarray(codes, np.uint8)).to(dev),
            torch.from_numpy(np.ascontiguousarray(stats, np.float32)).to(dev),
            torch.from_numpy(np.ascontiguousarray(node_of, np.int32)).to(dev),
            int(n_nodes), max_bins, impl="ref" if self.plain else "cuda")
        return out.cpu().numpy().astype(np.float64)


_CACHE: dict[tuple[str, str], HistogramBackend] = {}


def resolve_backend(name: str | HistogramBackend | None = "auto",
                    device=None) -> HistogramBackend:
    """Map a ``histogram_backend`` hparam value to a backend instance for
    training on ``device`` (None: cuda, as every entry point of the port).

    "auto" is "cuda" on a CUDA device and "numpy" on the CPU. "cuda" on a
    CPU device raises: nothing runs a kernel's plain version on the
    training hot path silently; tests and kernel debugging opt in with
    "torch". The reference's names "pallas" and "pallas_interpret" raise,
    naming their counterparts here.
    """
    if isinstance(name, HistogramBackend):
        return name
    if name is None:
        name = "auto"
    dev = None
    if name in ("auto", "cuda", "torch"):
        from repro_torch.core.engines import resolve_device
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    if name == "auto":
        name = "cuda" if dev.type == "cuda" else "numpy"
    if name in ("pallas", "pallas_interpret"):
        raise YdfError(
            f"histogram_backend={name!r} is the JAX package's TPU kernel. "
            "The PyTorch port's counterparts are 'cuda' (the CUDA histogram "
            "kernel) and 'torch' (its plain PyTorch version).")
    if name not in NAMES:
        raise YdfError(
            f"Unknown histogram_backend {name!r}. Expected one of: "
            f"{', '.join(map(repr, NAMES))}.")
    if name == "cuda" and dev.type != "cuda":
        raise YdfError(
            f"histogram_backend='cuda' launches the CUDA histogram kernel and "
            f"needs a CUDA device, but training runs on {dev}. Solutions: "
            "(1) use histogram_backend='auto' (numpy on the CPU), (2) use "
            "'numpy', (3) opt into the kernel's plain PyTorch version "
            "explicitly with 'torch' (tests/debugging only).")
    key = (name, str(dev) if name in ("cuda", "torch") else "")
    if key not in _CACHE:
        _CACHE[key] = {
            "numpy": NumpyHistogramBackend,
            "simple": SimpleHistogramBackend,
            "cuda": lambda: CudaHistogramBackend(dev),
            "torch": lambda: CudaHistogramBackend(dev, plain=True)}[name]()
    return _CACHE[key]
