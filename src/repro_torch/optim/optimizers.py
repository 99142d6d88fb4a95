"""Optimizers: AdamW and Adafactor (factored second moment for >=2-D
params), global gradient-norm clipping, warmup+cosine schedule. The
reference's arithmetic written out (not ``torch.optim``), so each update
is the same sum in float32.

State layout: ``slots`` mirrors the param tree with each tensor leaf
replaced by a dict of float32 slot tensors; ``opt_slot_specs`` gives the
matching meta-device tensors and logical axes without allocating.
``update`` writes the new params and slots into the given tensors (under
``torch.no_grad()``): a param is updated in float32 and cast back to its
dtype.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.params import at, leaves

F32 = torch.float32


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]                  # params -> slots
    update: Callable[[Any, Any, Any, Any], tuple[Any, Any]]
    # update(grads, slots, params, step) -> (params, slots), written in place


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def global_norm(tree) -> torch.Tensor:
    sq = [x.float().square().sum() for _, x in leaves(tree)]
    return torch.stack(sq).sum().sqrt()


def clip_by_global_norm(tree, max_norm: float):
    """(tree scaled to ``max_norm`` if its norm is larger, the norm); each
    leaf is scaled in float32 and cast back to its dtype."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return _tree_map(lambda x: (x.float() * scale).to(x.dtype), tree), norm


def lr_schedule(cfg: ModelConfig, warmup: int = 100, total: int = 10_000):
    base = cfg.learning_rate

    def sched(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = base * (step + 1.0) / warmup
        frac = torch.clamp((step - warmup) / max(1, total - warmup), 0.0, 1.0)
        cos = base * 0.5 * (1.0 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, cos)

    return sched


def _apply_leafwise(leaf_fn, params, grads, slots):
    """leaf_fn(g, s, p) -> (new p, new slot dict) over the param tree, each
    result written into ``p`` and ``s``'s tensors."""
    with torch.no_grad():
        for path, p in leaves(params):
            s = at(slots, path)
            newp, new_s = leaf_fn(at(grads, path), s, p)
            p.copy_(newp)
            for k, v in new_s.items():
                s[k].copy_(v)
    return params, slots


# --------------------------------------------------------------- AdamW

def _adamw(cfg: ModelConfig, b1=0.9, b2=0.95, eps=1e-8) -> Optimizer:
    sched = lr_schedule(cfg)
    wd = cfg.weight_decay

    def init(params):
        return _tree_map(lambda p: {"m": torch.zeros(p.shape, dtype=F32, device=p.device),
                                    "v": torch.zeros(p.shape, dtype=F32, device=p.device)},
                         params)

    def update(grads, slots, params, step):
        lr = sched(step)
        t = step.float() + 1.0
        c1 = 1.0 - b1 ** t
        c2 = 1.0 - b2 ** t

        def leaf(g, s, p):
            g = g.float()
            m = b1 * s["m"] + (1 - b1) * g
            v = b2 * s["v"] + (1 - b2) * g.square()
            upd = (m / c1) / (torch.sqrt(v / c2) + eps)
            if p.ndim >= 2:
                upd = upd + wd * p.float()
            newp = (p.float() - lr * upd).to(p.dtype)
            return newp, {"m": m, "v": v}

        return _apply_leafwise(leaf, params, grads, slots)

    return Optimizer(init, update)


# --------------------------------------------------------------- Adafactor

def _adafactor(cfg: ModelConfig, eps=1e-30, clip_thresh=1.0) -> Optimizer:
    """Factored second moment over the trailing two dims; leading dims
    (stacked layers, experts) are kept, so slot size ~ O(rows + cols)."""
    sched = lr_schedule(cfg)
    wd = cfg.weight_decay

    def init(params):
        def leaf(p):
            if p.ndim >= 2:
                return {"vr": torch.zeros(p.shape[:-1], dtype=F32, device=p.device),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=F32,
                                          device=p.device)}
            return {"v": torch.zeros(p.shape, dtype=F32, device=p.device)}
        return _tree_map(leaf, params)

    def update(grads, slots, params, step):
        lr = sched(step)
        t = step.float() + 1.0
        b2 = 1.0 - t ** -0.8  # Shazeer & Stern decay schedule

        def leaf(g, s, p):
            g = g.float()
            g2 = g.square() + eps
            if p.ndim >= 2:
                vr = b2 * s["vr"] + (1 - b2) * g2.mean(-1)
                vc = b2 * s["vc"] + (1 - b2) * g2.mean(-2)
                denom = torch.clamp(vr.mean(-1, keepdim=True), min=eps)
                vhat = vr[..., None] * vc[..., None, :] / denom[..., None]
                upd = g * torch.rsqrt(vhat + eps)
                new_s = {"vr": vr, "vc": vc}
            else:
                v = b2 * s["v"] + (1 - b2) * g2
                upd = g * torch.rsqrt(v + eps)
                new_s = {"v": v}
            # update clipping by RMS (Adafactor's d=1.0 rule)
            rms = torch.sqrt(upd.square().mean() + eps)
            upd = upd / torch.clamp(rms / clip_thresh, min=1.0)
            if p.ndim >= 2:
                upd = upd + wd * p.float()
            newp = (p.float() - lr * upd).to(p.dtype)
            return newp, new_s

        return _apply_leafwise(leaf, params, grads, slots)

    return Optimizer(init, update)


def make_optimizer(cfg: ModelConfig) -> Optimizer:
    if cfg.optimizer == "adamw":
        return _adamw(cfg)
    if cfg.optimizer == "adafactor":
        return _adafactor(cfg)
    raise ValueError(cfg.optimizer)


# --------------------------------------------------------------- specs

def opt_slot_specs(cfg: ModelConfig, param_specs, param_axes):
    """(meta-tensor tree, logical-axes tree) for the optimizer slots,
    mirroring what ``Optimizer.init`` would build, without allocating."""
    def meta(shape):
        return torch.empty(tuple(shape), dtype=F32, device="meta")

    def leaf(spec, axes):
        shape, axes = tuple(spec.shape), tuple(axes)
        if cfg.optimizer == "adamw":
            return {"m": meta(shape), "v": meta(shape)}, {"m": axes, "v": axes}
        if len(shape) >= 2:
            return ({"vr": meta(shape[:-1]), "vc": meta(shape[:-2] + shape[-1:])},
                    {"vr": axes[:-1], "vc": axes[:-2] + axes[-1:]})
        return {"v": meta(shape)}, {"v": axes}

    def walk(specs, axes):
        if isinstance(specs, dict):
            out = {k: walk(specs[k], axes[k]) for k in specs}
            return ({k: v[0] for k, v in out.items()}, {k: v[1] for k, v in out.items()})
        return leaf(specs, axes)

    return walk(param_specs, param_axes)
