"""Inference engines and the compiled serving stack (paper §3.7;
DESIGN.md §5, §10): a model compiles to an engine, and ``compile_predictor``
bundles that engine with the request encoder and the model's output head.

Engines (all produce bit-identical per-tree leaf outputs; "naive" projects
sparse-oblique nodes with ``np.dot``, as the reference's does, and may differ
from the others at a near-tie with a threshold):
  * "cuda"       — the hand-written traversal kernel over the depth-packed
                   layout (kernels/forest_infer), on a CUDA device, for
                   numerical, categorical and sparse-oblique nodes alike
                   (the reference's Pallas engines refuse oblique forests
                   and serve them on the host; here they stay on the
                   card). Compiling it builds and loads the kernel library
                   and uploads the packed forest, so a build error
                   (RuntimeError) surfaces at compile time. Its dispatch errors (a failed launch)
                   propagate as they are, never as EngineFailure: no
                   degradation chain serves around a dead kernel.
  * "ref"        — the plain PyTorch gather traversal over the raw SoA, on
                   any device; the head of the chain when the caller runs
                   on the CPU.
  * "bucketed"   — the depth-bucketed traversal (§10,
                   kernels/forest_infer/bucketed.py, PyTorch tensor code on
                   any device): trees grouped by actual depth, each bucket
                   pays its own round count and picks its scoring strategy
                   by the cost model of its device (``ops.MATMUL_CHEAP``).
                   Axis-aligned forests only.
  * "leaf_path"  — the bucketed engine with leaf-path scoring (a predicate
                   matrix and one batched matmul, §10.2) forced on every
                   bucket; offered only when every tree's path table fits
                   ``LEAF_PATH_BUDGET``.
  * "vectorized" — specialized numpy lockstep traversal on the host
                   (tree.compile_predict_raw).
  * "naive"      — Algorithm 1 of the paper: per-example while-loop. The
                   readable oracle; always compatible.

"bucketed" and "leaf_path" run only when asked for by name: the default
stays "cuda" on the card and "ref" on the CPU. Asking for an engine the
forest's structure does not allow raises ``YdfError`` naming the reason
and the compatible engines.

Devices: ``device=None`` means "cuda". Without a CUDA device every entry
point raises ``YdfError`` and asks for ``device="cpu"``; nothing picks the
CPU on the caller's behalf.

A ``CompiledPredictor`` pickles: its engine travels as (name, forest,
device type) and rebuilds through ``_compile_forest_engine`` on load, so
the chosen engine survives and no device buffer or cache is serialized.
Loading one compiled for "cuda" where there is no card raises YdfError.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from repro_torch.core.api import EngineFailure, YdfError
from repro_torch.core.dataspec import BatchEncoder
from repro_torch.core.tree import (
    LEAF_PATH_BUDGET,
    Forest,
    compile_predict_raw,
    leaf_path_sizes,
    predict_naive,
    tree_depths,
)
from repro_torch.kernels.forest_infer import forest_infer, ops
from repro_torch.obs import clock, trace

# in order of preference; "cuda" only on a CUDA device, "bucketed" and
# "leaf_path" only for a forest whose structure they take
ENGINES = ("cuda", "ref", "bucketed", "leaf_path", "vectorized", "naive")

# Minimum n_trees * depth for the reference's size rule to prefer the
# bucketed engine over the numpy engine on a host (select_cpu_engine).
BUCKETED_MIN_WORK = 256

# engines whose first call at a new batch shape pays a one-off cost (the
# reference's jit trace; here the kernel plan, the first launch and the
# caching allocator's growth): the layer that knows its dispatch shapes
# (serving's warm_ladder, benchmark_inference) warms these
JIT_ENGINES = ("cuda", "bucketed", "leaf_path")


def resolve_device(device=None) -> torch.device:
    """``None`` -> cuda. A CUDA device without a card raises YdfError."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        how = " (the default)" if device is None else ""
        raise YdfError(
            f"Device {dev} was requested{how}, but torch sees no CUDA device. "
            "The port runs on the GPU; pass device='cpu' to run the plain "
            "PyTorch and numpy engines on the CPU instead.")
    if dev.type not in ("cuda", "cpu"):
        raise YdfError(f"Unsupported device {dev}; use 'cuda' or 'cpu'.")
    return dev


@dataclass
class Engine:
    name: str
    per_tree: Callable[[np.ndarray], np.ndarray]  # X (N,F) -> (N,T,leaf_dim)
    note: str = ""
    # errors propagate as they are instead of becoming EngineFailure
    fatal_errors: bool = False
    # what the engine pickles as: its closure, device tables and caches do
    # not serialize, so it rebuilds from (name, forest, device type)
    forest: Forest | None = None
    device: torch.device | None = None

    def __getstate__(self):
        return {"name": self.name, "forest": self.forest,
                "device": self.device.type}

    def __setstate__(self, state):
        rebuilt = _compile_forest_engine(state["forest"], state["name"],
                                         resolve_device(state["device"]))
        self.__dict__.update(rebuilt.__dict__)


def _compat_bucketed(forest: Forest) -> str | None:
    if forest.has_oblique():
        return "oblique conditions are not supported by the bucketed engine"
    return None


def _compat_leaf_path(forest: Forest) -> str | None:
    if forest.has_oblique():
        return "oblique conditions are not supported by the leaf_path engine"
    n_internal, n_leaves = leaf_path_sizes(forest)
    if n_internal * n_leaves > LEAF_PATH_BUDGET:
        return (f"leaf-path flattening needs a {n_internal}x{n_leaves} "
                f"predicate matrix per tree (> {LEAF_PATH_BUDGET} budget); "
                f"the transform targets shallow trees")
    return None


_COMPAT = {"bucketed": _compat_bucketed, "leaf_path": _compat_leaf_path}


def _device_engines(device: torch.device) -> list[str]:
    return [e for e in ENGINES if e != "cuda" or device.type == "cuda"]


def available_engines(device=None, forest: Forest | None = None) -> list[str]:
    """Engines that run on ``device``, in order of preference. The
    forest-gated engines ("bucketed", "leaf_path") are listed only for a
    ``forest`` whose structure they take."""
    return [e for e in _device_engines(resolve_device(device))
            if e not in _COMPAT
            or (forest is not None and _COMPAT[e](forest) is None)]


def select_cpu_engine(forest: Forest) -> str:
    """The reference's size rule between the two host traversals: the
    bucketed engine for a forest of at least BUCKETED_MIN_WORK
    ``n_trees * depth``, else the trace-free numpy engine (and for any
    forest the bucketed engine does not take). The port's default on the
    CPU stays "ref"; this rule is for callers choosing a host engine."""
    if _compat_bucketed(forest) is not None or forest.n_trees == 0:
        return "vectorized"
    depth = int(tree_depths(forest).max())
    if forest.n_trees * max(1, depth) >= BUCKETED_MIN_WORK:
        return "bucketed"
    return "vectorized"


def compile_model(model, engine: str | None = None, device=None) -> Engine:
    return _compile_forest_engine(model.forest, engine, resolve_device(device))


def _compile_forest_engine(forest: Forest, engine: str | None,
                           device: torch.device) -> Engine:
    known = _device_engines(device)
    if engine is None:
        engine = known[0]
    if engine not in known:
        raise YdfError(f"Unknown engine {engine!r} on device {device}. "
                       f"Available: {available_engines(device, forest)}.")
    reason = _COMPAT[engine](forest) if engine in _COMPAT else None
    if reason:
        raise YdfError(
            f"Model is not compatible with the {engine!r} engine: {reason}. "
            f"Compatible engines: {available_engines(device, forest)}.")
    kw = {"forest": forest, "device": device}
    if engine == "naive":
        return Engine("naive", lambda X: predict_naive(forest, X), **kw)
    if engine == "vectorized":
        return Engine("vectorized", compile_predict_raw(forest),
                      note="specialized flat-table numpy traversal (§5.1)",
                      **kw)
    if engine in _COMPAT:
        strategy = "leaf_path" if engine == "leaf_path" else None
        ops.bucketed_runner(forest, strategy, device)   # pack + upload now
        note = ("predicate-matrix (leaf-path) scoring forced on every "
                "bucket (§10.2)" if engine == "leaf_path" else
                "depth-bucketed traversal, per-bucket round count and "
                "strategy (§10)")
        return Engine(engine, lambda X: ops.forest_predict_bucketed(
            forest, X, strategy, device), note=f"{note} on {device}", **kw)
    if engine == "ref":
        ops.device_soa(forest, device)   # upload once, now
        return Engine(
            "ref", lambda X: _traverse(forest, X, "ref", device),
            note=f"plain PyTorch gather traversal on {device}", **kw)
    forest_infer.library()               # build + load now: RuntimeError here
    ops.device_packed(forest, device)    # pack + upload once, now
    return Engine(
        "cuda", lambda X: _traverse(forest, X, "cuda", device),
        note="hand-written CUDA traversal over depth-packed blocks (sm_90a)",
        fatal_errors=True, **kw)


def _traverse(forest: Forest, X: np.ndarray, impl: str,
              device: torch.device) -> np.ndarray:
    """The ``ref`` and ``cuda`` engines' call: upload and launch
    (``engines/traverse``, where B2's launch adds its plan's ``variant``
    and ``obl_width`` while tracing), then the (N, T, O) scores back to the host
    (``engines/copy_back``, which waits for the device), with the bytes
    each way counted."""
    with trace.span("engines/traverse", rows=len(X)):
        out = ops.forest_predict(forest, X, impl, device)
    with trace.span("engines/copy_back", rows=len(X)):
        host = out.cpu().numpy()
    trace.count("engines/h2d_bytes", X.nbytes)
    trace.count("engines/d2h_bytes", host.nbytes)
    return host


# ------------------------------------------------- compiled predictor (§5.1)

@dataclass
class CompiledPredictor:
    """The reusable end-to-end serving artifact (DESIGN.md §5.1).

    Built once per model: ``encoder`` holds the vectorized raw->code tables,
    ``engine`` the traversal closure (device-resident forest for cuda/ref),
    ``finalize`` the model's aggregation + activation head. ``encode`` /
    ``predict_encoded`` split the two halves so a micro-batcher can encode
    per request but dispatch per padded batch.
    """
    engine: Engine
    encoder: BatchEncoder
    # a picklable head: models.py's _GbtFinalize, _RfFinalize, ... in a
    # _TracedHead
    finalize: Callable[[np.ndarray], np.ndarray]
    compile_s: float = 0.0
    # trailing shape of one prediction: () for regression, (n_classes,) for
    # classification, so a zero-row dispatch returns a correctly-shaped
    # empty array without running the engine
    out_shape: tuple = ()

    @property
    def name(self) -> str:
        return self.engine.name

    def encode(self, dataset) -> np.ndarray:
        with trace.span("engines/encode") as sp:
            X = self.encoder.encode(dataset)
            if sp is not None:
                sp.args["rows"] = len(X)
        return X

    def per_tree(self, X: np.ndarray) -> np.ndarray:
        # engine failures surface TYPED: the serving front-end routes
        # EngineFailure into retry / circuit-breaker logic, while schema
        # errors (encode) stay YdfError and reach the caller. The kernel
        # engine's errors stay untyped, so nothing degrades around them.
        try:
            with trace.span("engines/dispatch", engine=self.name,
                            rows=len(X)):
                return self.engine.per_tree(X)
        except (EngineFailure, KeyboardInterrupt):
            raise
        except Exception as e:
            if self.engine.fatal_errors:
                raise
            raise EngineFailure(
                f"engine {self.name!r} failed on a batch of "
                f"{len(X)} rows: {type(e).__name__}: {e}",
                engine=self.name) from e

    def predict_encoded(self, X: np.ndarray) -> np.ndarray:
        if len(X) == 0:
            return np.zeros((0,) + self.out_shape, np.float32)
        return self.finalize(self.per_tree(X))

    def predict(self, dataset) -> np.ndarray:
        return self.predict_encoded(self.encode(dataset))


@dataclass
class _TracedHead:
    """The model's aggregation and activation head in an
    ``engines/finalize`` span; picklable as the head is."""
    head: Callable[[np.ndarray], np.ndarray]

    def __call__(self, per_tree: np.ndarray) -> np.ndarray:
        with trace.span("engines/finalize", rows=len(per_tree)):
            return self.head(per_tree)


def compile_predictor(model, engine: str | None = None,
                      device=None) -> CompiledPredictor:
    """Compile ``model`` into a CompiledPredictor on ``device`` (None ->
    cuda; raises YdfError without a card). Raises RuntimeError when the
    cuda engine's kernel does not build."""
    dev = resolve_device(device)
    t0 = clock.perf()
    with trace.span("engines/compile", engine=engine or "auto",
                    device=str(dev)):
        eng = compile_model(model, engine, dev)
    finalize = model._compile_finalize()
    # probe the output head on a zero per-tree stack to learn the trailing
    # prediction shape, without an engine call
    probe = finalize(np.zeros(
        (1, model.forest.n_trees, model.forest.leaf_value.shape[-1]),
        np.float32))
    return CompiledPredictor(engine=eng,
                             encoder=BatchEncoder(model.spec, model.features),
                             finalize=_TracedHead(finalize),
                             compile_s=clock.perf() - t0,
                             out_shape=tuple(np.asarray(probe).shape[1:]))


def benchmark_inference(model, dataset, *, repetitions: int = 5,
                        device=None) -> str:
    """App. B.4 analogue: time every engine available for the model on
    ``device`` (None -> cuda) over the encoded dataset, host clock around
    each call (each returns host numpy, so the device work is inside).

    JIT_ENGINES warm up AT THE TIMED SHAPE, and that warm-up is reported
    separately as compile time (with the compile itself: kernel build and
    table upload). The other engines have nothing to warm: their compile
    time is the closure's specialization alone, and a 64-row call just
    touches the code path."""
    dev = resolve_device(device)
    X = BatchEncoder(model.spec, model.features).encode(dataset)
    lines = ["benchmark_inference on %s (avg over %d reps, batch=%d):"
             % (dev, repetitions, X.shape[0])]
    for name in available_engines(dev, model.forest):
        t0 = clock.perf()
        eng = compile_model(model, name, dev)
        if name in JIT_ENGINES:
            eng.per_tree(X)          # warm-up at the timed shape
            compile_s = clock.perf() - t0
        else:
            compile_s = clock.perf() - t0
            eng.per_tree(X[:min(64, len(X))])  # untimed code-path touch
        t0 = clock.perf()
        for _ in range(repetitions):
            eng.per_tree(X)
        dt = (clock.perf() - t0) / repetitions
        us = dt / max(1, X.shape[0]) * 1e6
        lines.append(f"  {name:<12s} {us:10.3f} us/example  "
                     f"({dt * 1e3:.2f} ms/batch, compile {compile_s * 1e3:.1f} ms)")
    return "\n".join(lines)
