"""GPipe-style pipeline parallelism over a mesh axis, the port of
``repro.train.pipeline``.

Schedule: classic GPipe fill-drain over M microbatches and S stages:
T = M + S - 1 slots; stage s works on microbatch (t - s) at slot t; stage 0
takes microbatch clip(t) and the last stage emits microbatch t - S + 1;
activations move stage -> stage + 1 each slot by a point-to-point send and
receive over the stage axis (the reference's ``ppermute``). Bubble fraction
= (S-1)/T, reported by ``pipeline_efficiency``.

Each rank passes the whole (S, ...) stack of stage params and uses its own
stage's row (the reference's ``in_specs=P(stage_axis)``); the other mesh
axes replicate, as under ``shard_map``. The result is broadcast over the
stage axis by a masked sum. Point-to-point operations carry no gradient,
so an input that requires one is refused.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.api import YdfError


def pipeline_efficiency(n_micro: int, n_stages: int) -> float:
    return n_micro / (n_micro + n_stages - 1)


def _rows(tree, i: int):
    if isinstance(tree, dict):
        return {k: _rows(v, i) for k, v in tree.items()}
    return tree[i]


def _needs_grad(tree) -> bool:
    if isinstance(tree, dict):
        return any(_needs_grad(v) for v in tree.values())
    return isinstance(tree, torch.Tensor) and tree.requires_grad


def make_pipeline_fn(block_fn: Callable, mesh, *, stage_axis: str = "stage",
                     n_micro: int):
    """block_fn(params_stage, x) -> x, applied per stage.

    Returns fn(stage_params, x_micro) where stage_params leaves have a
    leading dim S (this rank uses its stage's row) and x_micro is
    (M, mb, ...) (the same on every rank). Output: (M, mb, ...) activations
    after all S stages, on every rank.
    """
    S = mesh.shape[stage_axis]

    def pipelined(params, xs):
        if torch.is_grad_enabled() and (_needs_grad(params) or _needs_grad(xs)):
            raise YdfError("the pipeline's point-to-point sends carry no "
                           "gradient; run it on tensors that require none")
        sid = mesh.coords[stage_axis]
        params = _rows(params, sid)
        M = xs.shape[0]
        if M != n_micro:
            raise YdfError(f"{M} microbatches passed to a pipeline of {n_micro}")
        buf = torch.zeros_like(xs[0])       # activation currently held
        outs = torch.zeros_like(xs)
        for t in range(M + S - 1):
            if sid == 0:                    # stage 0 ingests microbatch t
                buf = xs[min(max(t, 0), M - 1)]
            y = block_fn(params, buf)
            if sid == S - 1 and t - S + 1 >= 0:   # last stage emits
                outs[t - S + 1] = y
            buf = mesh.shift(y, stage_axis)  # shift activations forward
        # only the last stage holds real outputs; broadcast them
        mask = outs if sid == S - 1 else torch.zeros_like(outs)
        return mesh.all_reduce(mask, (stage_axis,))

    return pipelined
