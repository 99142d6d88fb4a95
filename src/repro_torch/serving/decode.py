"""LM serving: prefill (full-sequence, cache-building) and decode (one token
against a cache) on one device, and a greedy generation loop.

Serving runs without a backward pass, so every bundle runs under
``torch.inference_mode()``; ``remat`` (a training setting) is off, as in the
reference. Sharded serving over a mesh is a later slice (ROADMAP A9.4).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.api import YdfError
from repro_torch.models import lm
from repro_torch.models.layers import Ctx
from repro_torch.models.params import schema_axes, schema_shapes


def _serve_cfg(cfg: ModelConfig) -> ModelConfig:
    return cfg.replace(remat="none")


def serve_state_specs(cfg: ModelConfig):
    sch = lm.model_schema(cfg)
    return schema_shapes(sch, cfg.param_dtype), schema_axes(sch)


def _one_device(mesh, rules) -> None:
    if mesh is not None or rules is not None:
        raise YdfError("the port serves on one device; a mesh and sharding "
                       "rules come with sharded serving (ROADMAP A9.4)")


def _device(device) -> torch.device:
    from repro_torch.core.engines import resolve_device
    return resolve_device(device)


@dataclass(frozen=True)
class ServeBundle:
    """``fn`` with the call under ``torch.inference_mode()``: decode is
    ``(params, batch, cache) -> (logits, cache)`` and updates the cache in
    place; prefill is ``(params, batch) -> (logits, cache)``."""
    fn: Callable

    def __call__(self, *args):
        with torch.inference_mode():
            return self.fn(*args)


def make_decode_step(cfg: ModelConfig, shape: ShapeConfig, mesh=None, rules=None,
                     *, device=None) -> ServeBundle:
    _one_device(mesh, rules)
    ctx = Ctx(_serve_cfg(cfg), _device(device))

    def decode_step(params, batch, cache):
        return lm.decode_step(params, batch, cache, ctx)

    return ServeBundle(decode_step)


def make_prefill(cfg: ModelConfig, shape: ShapeConfig, mesh=None, rules=None,
                 *, device=None) -> ServeBundle:
    _one_device(mesh, rules)
    ctx = Ctx(_serve_cfg(cfg), _device(device))

    def prefill(params, batch):
        return lm.prefill(params, batch, ctx)

    return ServeBundle(prefill)


def greedy_generate(params, prompt_batch, cfg: ModelConfig, n_steps: int,
                    mesh=None, rules=None, *, device=None):
    """Prefill a prompt, then greedy-decode: returns the (B, n_steps) int32
    tokens, the first from the prefill's logits. Runs ``n_steps`` decode
    steps, as the reference does (the last step's token is not returned)."""
    _one_device(mesh, rules)
    dev = _device(device)
    ctx = Ctx(_serve_cfg(cfg), dev)
    batch = {k: v.to(dev) for k, v in prompt_batch.items()}
    B = next(iter(batch.values())).shape[0]
    S = batch["tokens"].shape[1] + (cfg.n_patches if cfg.family == "vlm" else 0)
    with torch.inference_mode():
        logits, cache = lm.prefill(params, batch, ctx)
        # grow the cache to fit generated tokens
        full = lm.init_cache(cfg, B, S + n_steps, device=dev)
        cache = {k: _embed_cache(full[k], cache[k]) for k in full}
        tokens = []
        tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
        for _ in range(n_steps):
            tokens.append(tok)
            logits, cache = lm.decode_step(params, {"token": tok}, cache, ctx)
            tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
        return torch.cat(tokens, dim=1)


def _embed_cache(full, part):
    """Write a prefill cache into a (larger) zeroed decode cache."""
    if full.shape == part.shape:
        return part
    full[tuple(slice(0, n) for n in part.shape)] = lm.to_cache_dtype(part, full.dtype)
    return full
