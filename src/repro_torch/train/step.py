"""Train-step factory for the LM stack, on one device.

``make_train_step`` builds ``train_step(state, batch) -> (state, metrics)``
for any registered architecture, with:
  * loss and gradients by autograd (``cfg.remat`` applied per layer),
  * gradient accumulation (``cfg.grad_accum`` microbatches, gradients
    summed in float32),
  * global-norm clipping and the AdamW / Adafactor update, which writes the
    params and slots in place (the counterpart of the reference's donated
    state; there is no jit, so ``TrainStepBundle.jitted()`` is the step).

State is a plain dict: {"params", "slots", "step"}. It must not be made
under ``torch.inference_mode()``: such tensors cannot enter autograd.

With a mesh (``launch.mesh.make_mesh``) and sharding rules, each rank holds
its block of every state leaf under the leaf's resolved spec
(``state_shardings``) and its block of the global batch
(``batch_shardings``: rows split over the "batch" axes). A step gathers
every param in full, runs the one-device forward and backward on the
rank's rows, sums the gradients over the batch axes, gathers the slots,
clips and updates the full tensors exactly as one device does, and keeps
this rank's blocks. The CE is divided by the GLOBAL weight sum (an
all-reduce), the MoE aux loss is split evenly over the batch shards, and
MoE groups are formed over the global batch (``models.moe.moe_block``), so
the loss and its gradient are the one-device step's. Ranks that differ
only in the other axes compute the same rows. ``cfg.grad_accum``
microbatches split the rank's rows.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Mapping

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.api import YdfError
from repro_torch.models import lm
from repro_torch.models.layers import Ctx
from repro_torch.models.params import at, init_params, leaves, schema_axes, schema_shapes
from repro_torch.optim import clip_by_global_norm, make_optimizer, opt_slot_specs
from repro_torch.sharding import batch_split, check_mesh, tree_gather, tree_shardings


def _map_paths(fn, tree, path: tuple = ()):
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


# ----------------------------------------------------------------- state

def train_state_specs(cfg: ModelConfig):
    """(meta-tensor tree, logical-axes tree) for the full train state."""
    sch = lm.model_schema(cfg)
    p_specs = schema_shapes(sch, cfg.param_dtype)
    p_axes = schema_axes(sch)
    s_specs, s_axes = opt_slot_specs(cfg, p_specs, p_axes)
    specs = {"params": p_specs, "slots": s_specs,
             "step": torch.empty((), dtype=torch.int32, device="meta")}
    axes = {"params": p_axes, "slots": s_axes, "step": ()}
    return specs, axes


def init_train_state(generator: torch.Generator, cfg: ModelConfig, *, device=None):
    """Params drawn with ``generator`` (``init_params``), zeroed slots and
    step 0, on ``device`` (None is cuda)."""
    from repro_torch.core.engines import resolve_device
    if torch.is_inference_mode_enabled():
        raise YdfError("a train state made under torch.inference_mode() "
                       "cannot enter autograd")
    dev = resolve_device(device)
    params = init_params(lm.model_schema(cfg), cfg.param_dtype,
                         generator=generator, device=dev)
    return {"params": params, "slots": make_optimizer(cfg).init(params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


# ----------------------------------------------------------------- step

@dataclass(frozen=True)
class TrainStepBundle:
    step_fn: Callable          # (state, batch) -> (state, metrics)
    state_specs: Any
    state_axes: Any
    state_shardings: Any = None    # under a mesh: NamedSharding per leaf
    batch_shardings: Any = None

    def jitted(self) -> Callable:
        """The step itself: eager PyTorch has no jit, and the step always
        updates the state in place (the reference's donation)."""
        return self.step_fn


def _split_microbatches(batch: Mapping[str, torch.Tensor], n: int) -> list[dict]:
    b = next(iter(batch.values())).shape[0]
    if b % n:
        raise YdfError(f"batch {b} does not split into grad_accum={n} microbatches")
    return [{k: v[i * (b // n):(i + 1) * (b // n)] for k, v in batch.items()}
            for i in range(n)]


def make_train_step(cfg: ModelConfig, shape: ShapeConfig, mesh=None, rules=None,
                    *, device=None) -> TrainStepBundle:
    """The step on one device, or under ``mesh`` and ``rules`` (a process
    mesh of this rank's device): then the state and the batch are this
    rank's blocks under ``state_shardings`` and ``batch_shardings``, and
    the metrics are the global batch's."""
    from repro_torch.core.engines import resolve_device
    sharded = check_mesh(mesh, rules)
    dev = resolve_device(device)
    state_specs, state_axes = train_state_specs(cfg)
    if not sharded:
        return TrainStepBundle(_step_fn(cfg, Ctx(cfg, dev)), state_specs, state_axes)
    if mesh.device != dev:
        raise YdfError(f"the mesh's ranks hold their tensors on {mesh.device}, "
                       f"the step was asked for {dev}")
    state_sh = tree_shardings(state_axes, mesh, rules, state_specs)
    batch_sh = tree_shardings(lm.batch_axes(cfg, shape), mesh, rules,
                              lm.batch_spec(cfg, shape))
    axes = batch_split(batch_sh)
    ctx = Ctx(cfg, dev, mesh=mesh, rules=rules, batch_axes=axes)
    return TrainStepBundle(_step_fn(cfg, ctx, state_sh, batch_sh), state_specs,
                           state_axes, state_sh, batch_sh)


def _sharded_loss(params, batch, ctx: Ctx):
    """This rank's share of the global loss: its CE sum over the global
    weight sum plus its aux loss over the number of batch shards, so the
    shares sum to the one-device loss (and their gradients to its
    gradient). Metrics are this rank's shares too."""
    sum_loss, sum_w, aux = lm.loss_terms(params, batch, ctx)
    total_w = ctx.mesh.all_reduce(sum_w.detach(), ctx.batch_axes)
    ce = sum_loss / torch.clamp(total_w, min=1.0)
    aux = aux / ctx.batch_shards
    return ce + aux, {"ce": ce, "aux": aux, "tokens": sum_w}


def _step_fn(cfg: ModelConfig, ctx: Ctx, state_sh=None, batch_sh=None):
    opt = make_optimizer(cfg)
    accum = max(1, cfg.grad_accum)
    mesh, split = ctx.mesh, ctx.batch_shards > 1
    loss_fn = _sharded_loss if split else lm.loss_fn

    def value_and_grad(params, batch):
        """(loss, metrics, grads): grads in each param's dtype, zero for a
        param the loss does not reach."""
        flat = [(path, p.detach().requires_grad_()) for path, p in leaves(params)]
        live = dict(flat)
        loss, metrics = loss_fn(_map_paths(lambda path, _: live[path], params),
                                batch, ctx)
        grads = torch.autograd.grad(loss, [p for _, p in flat], allow_unused=True,
                                    materialize_grads=True)
        by_path = {path: g for (path, _), g in zip(flat, grads)}
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                _map_paths(lambda path, _: by_path[path], params))

    def reduce(t):
        """The sum over the batch shards, in float32 (``t``'s dtype back)."""
        return mesh.all_reduce(t.float(), ctx.batch_axes).to(t.dtype) if split else t

    def train_step(state, batch):
        if any(p.is_inference() for _, p in leaves(state["params"])):
            raise YdfError("the train state was made under torch.inference_mode() "
                           "and cannot enter autograd")
        if state_sh is not None:
            blocks = state
            state = tree_gather(blocks, state_sh)
            batch = {k: batch_sh[k].gather(v, dims=range(1, v.dim()))
                     for k, v in batch.items()}
        params = state["params"]
        if accum == 1:
            loss, metrics, grads = value_and_grad(params, batch)
        else:
            grads = _map_paths(lambda _, p: torch.zeros(p.shape, dtype=torch.float32,
                                                        device=p.device), params)
            loss = torch.zeros((), dtype=torch.float32, device=ctx.device)
            for mb in _split_microbatches(batch, accum):
                l, _, g = value_and_grad(params, mb)
                grads = _map_paths(lambda path, a: a + at(g, path).float(), grads)
                loss = loss + l
            grads = _map_paths(lambda _, g: g / accum, grads)
            loss = loss / accum
            metrics = {}

        if split:
            grads = _map_paths(lambda _, g: reduce(g), grads)
            loss = reduce(loss)
            metrics = {k: reduce(v) for k, v in metrics.items()}
        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
        new_params, new_slots = opt.update(grads, state["slots"], params, state["step"])
        new_state = {"params": new_params, "slots": new_slots, "step": state["step"] + 1}
        if state_sh is not None:   # this rank's blocks, written in place
            for k in ("params", "slots"):
                _keep_blocks(blocks[k], new_state[k], state_sh[k])
                new_state[k] = blocks[k]
        out_metrics = {"loss": loss.float(), "grad_norm": gnorm}
        out_metrics.update({k: v.float() for k, v in metrics.items()})
        return new_state, out_metrics

    return train_step


def _keep_blocks(blocks, full, shardings) -> None:
    """Write this rank's block of each updated full leaf into ``blocks``."""
    if isinstance(blocks, dict):
        for k in blocks:
            _keep_blocks(blocks[k], full[k], shardings[k])
    elif full is not blocks:
        with torch.no_grad():
            blocks.copy_(shardings.shard(full))

