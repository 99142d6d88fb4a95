"""Inference engines and the compiled serving stack (paper §3.7;
DESIGN.md §5): a model compiles to an engine, and ``compile_predictor``
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
  * "vectorized" — specialized numpy lockstep traversal on the host
                   (tree.compile_predict_raw).
  * "naive"      — Algorithm 1 of the paper: per-example while-loop. The
                   readable oracle; always compatible.

Devices: ``device=None`` means "cuda". Without a CUDA device every entry
point raises ``YdfError`` and asks for ``device="cpu"``; nothing picks the
CPU on the caller's behalf.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from repro_torch.core.api import EngineFailure, YdfError
from repro_torch.core.dataspec import BatchEncoder
from repro_torch.core.tree import Forest, compile_predict_raw, predict_naive
from repro_torch.kernels.forest_infer import forest_infer, ops
from repro_torch.obs import clock, trace

ENGINES = ("cuda", "ref", "vectorized", "naive")


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


def available_engines(device=None) -> list[str]:
    """Engines that run on ``device``, in order of preference."""
    dev = resolve_device(device)
    return list(ENGINES) if dev.type == "cuda" else list(ENGINES[1:])


def compile_model(model, engine: str | None = None, device=None) -> Engine:
    return _compile_forest_engine(model.forest, engine, resolve_device(device))


def _compile_forest_engine(forest: Forest, engine: str | None,
                           device: torch.device) -> Engine:
    avail = available_engines(device)
    if engine is None:
        engine = avail[0]
    if engine not in avail:
        raise YdfError(f"Unknown engine {engine!r} on device {device}. "
                       f"Available: {avail}.")
    if engine == "naive":
        return Engine("naive", lambda X: predict_naive(forest, X))
    if engine == "vectorized":
        return Engine("vectorized", compile_predict_raw(forest),
                      note="specialized flat-table numpy traversal (§5.1)")
    if engine == "ref":
        ops.device_soa(forest, device)   # upload once, now
        return Engine(
            "ref",
            lambda X: ops.forest_predict(forest, X, "ref", device).cpu().numpy(),
            note=f"plain PyTorch gather traversal on {device}")
    forest_infer.library()               # build + load now: RuntimeError here
    ops.device_packed(forest, device)    # pack + upload once, now
    return Engine(
        "cuda",
        lambda X: ops.forest_predict(forest, X, "cuda", device).cpu().numpy(),
        note="hand-written CUDA traversal over depth-packed blocks (sm_90a)",
        fatal_errors=True)


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
        return self.encoder.encode(dataset)

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
                             finalize=finalize,
                             compile_s=clock.perf() - t0,
                             out_shape=tuple(np.asarray(probe).shape[1:]))
