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
Sharded training over a mesh is a later slice (ROADMAP A9.4).
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


def one_device(mesh, rules) -> None:
    if mesh is not None or rules is not None:
        raise YdfError("the port trains on one device; a mesh and sharding "
                       "rules come with sharded training (ROADMAP A9.4)")


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
    from repro_torch.core.engines import resolve_device
    one_device(mesh, rules)
    ctx = Ctx(cfg, resolve_device(device))
    opt = make_optimizer(cfg)
    accum = max(1, cfg.grad_accum)

    def value_and_grad(params, batch):
        """(loss, metrics, grads): grads in each param's dtype, zero for a
        param the loss does not reach."""
        flat = [(path, p.detach().requires_grad_()) for path, p in leaves(params)]
        live = dict(flat)
        loss, metrics = lm.loss_fn(_map_paths(lambda path, _: live[path], params),
                                   batch, ctx)
        grads = torch.autograd.grad(loss, [p for _, p in flat], allow_unused=True,
                                    materialize_grads=True)
        by_path = {path: g for (path, _), g in zip(flat, grads)}
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                _map_paths(lambda path, _: by_path[path], params))

    def train_step(state, batch):
        params = state["params"]
        if any(p.is_inference() for _, p in leaves(params)):
            raise YdfError("the train state was made under torch.inference_mode() "
                           "and cannot enter autograd")
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

        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
        new_params, new_slots = opt.update(grads, state["slots"], params, state["step"])
        new_state = {"params": new_params, "slots": new_slots, "step": state["step"] + 1}
        out_metrics = {"loss": loss.float(), "grad_norm": gnorm}
        out_metrics.update({k: v.float() for k, v in metrics.items()})
        return new_state, out_metrics

    state_specs, state_axes = train_state_specs(cfg)
    return TrainStepBundle(train_step, state_specs, state_axes)

