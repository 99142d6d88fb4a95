"""LM serving: prefill (full-sequence, cache-building) and decode (one token
against a cache), on one device or over a mesh, and a greedy generation
loop.

Serving runs without a backward pass, so every bundle runs under
``torch.inference_mode()``; ``remat`` (a training setting) is off, as in the
reference.

Under a mesh (``launch.mesh.make_mesh``) and sharding rules every rank calls
the bundle with its blocks: the params under ``param_shardings``, the
batch under ``batch_shardings`` (rows split over the "batch" axes) and the
cache under ``cache_shardings``. A call gathers the params in full, runs
the one-device code on the rank's rows and returns the GLOBAL logits (an
all-gather over the batch axes) with this rank's cache blocks. A decode
step gathers each layer's cache over its length and head shards just
before the layer uses it and writes back only this rank's block
(``ShardedCache``); the positions check reads the largest position over
the batch shards.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.api import YdfError
from repro_torch.models import lm
from repro_torch.models.layers import Ctx
from repro_torch.models.params import schema_axes, schema_shapes
from repro_torch.sharding import (
    NamedSharding, PartitionSpec, batch_split, check_mesh, tree_gather, tree_shardings)


def _serve_cfg(cfg: ModelConfig) -> ModelConfig:
    return cfg.replace(remat="none")


def serve_state_specs(cfg: ModelConfig):
    sch = lm.model_schema(cfg)
    return schema_shapes(sch, cfg.param_dtype), schema_axes(sch)


def _device(device) -> torch.device:
    from repro_torch.core.engines import resolve_device
    return resolve_device(device)


class ShardedCache:
    """A decode cache held in blocks under ``shardings`` (one
    NamedSharding per cache key, for the cache's global shape): the
    ``Ctx.cache_io`` of a decode step under a mesh. The blocks' batch rows
    are this rank's; ``load`` gathers a layer over its other cut
    dimensions and ``store`` writes this rank's block of it back."""

    def __init__(self, shardings: dict, max_len: int, batch_axes):
        self.shardings = shardings
        self.max_len = max_len
        self.batch_axes = tuple(batch_axes)

    def _layer(self, key: str, idx) -> NamedSharding:
        n = len(idx) if isinstance(idx, tuple) else 1
        sh = self.shardings[key]
        return NamedSharding(sh.mesh, PartitionSpec(*sh.spec[n:]))

    def load(self, cache, key: str, idx):
        layer = cache[key][idx]
        return self._layer(key, idx).gather(layer, dims=range(1, layer.dim()))

    def store(self, cache, key: str, idx, full) -> None:
        block = cache[key][idx]
        if full is not block:
            block.copy_(self._layer(key, idx).shard(full, dims=range(1, full.dim())))

    def positions(self, cache) -> tuple[int, int]:
        """(the cache's global length, the largest position of any row)."""
        mesh = self.shardings["pos"].mesh
        last = mesh.all_reduce(cache["pos"].max().reshape(1), self.batch_axes, "max")
        return self.max_len, int(last.item())


@dataclass(frozen=True)
class ServeBundle:
    """``fn`` with the call under ``torch.inference_mode()``: decode is
    ``(params, batch, cache) -> (logits, cache)`` and updates the cache in
    place; prefill is ``(params, batch) -> (logits, cache)``. Under a mesh
    the shardings say which block of each argument a rank passes (the
    prefill's ``cache_shardings``: of the cache it returns)."""
    fn: Callable
    param_shardings: Any = None
    batch_shardings: Any = None
    cache_shardings: Any = None

    def __call__(self, *args):
        with torch.inference_mode():
            return self.fn(*args)


class _Mesh:
    """A serving bundle's placement under a mesh."""

    def __init__(self, cfg: ModelConfig, batch: int, length: int, mesh, rules):
        p_specs, p_axes = serve_state_specs(cfg)
        self.mesh = mesh
        self.params = tree_shardings(p_axes, mesh, rules, p_specs)
        self.cache = tree_shardings(lm.cache_axes(cfg), mesh, rules,
                                    lm.cache_spec(cfg, batch, length))
        self.length = length
        self.rules = rules

    def batch_of(self, cfg: ModelConfig, shape: ShapeConfig):
        return tree_shardings(lm.batch_axes(cfg, shape), self.mesh, self.rules,
                              lm.batch_spec(cfg, shape))

    def ctx(self, cfg: ModelConfig, device, batch_sh, cache_io=None) -> Ctx:
        return Ctx(cfg, device, mesh=self.mesh, rules=self.rules,
                   batch_axes=batch_split(batch_sh), cache_io=cache_io)

    def rows(self, batch: dict, batch_sh) -> dict:
        """This rank's rows of the batch, whole along every other dim."""
        return {k: batch_sh[k].gather(v, dims=range(1, v.dim())) for k, v in batch.items()}

    def logits(self, local, ctx: Ctx):
        return self.mesh.all_gather(local, ctx.batch_axes, dim=0)

    def cache_blocks(self, cache: dict) -> dict:
        """This rank's blocks of a cache of its rows (every dim but the
        batch's is cut)."""
        out = {}
        for k, v in cache.items():
            rows = lm.CACHE_AXES[k].index("batch")
            out[k] = self.cache[k].shard(v, dims=[d for d in range(v.dim()) if d != rows])
        return out


def _placement(cfg, shape, mesh, rules, device, length: int):
    if not check_mesh(mesh, rules):
        return None
    if mesh.device != device:
        raise YdfError(f"the mesh's ranks hold their tensors on {mesh.device}, "
                       f"the bundle was asked for {device}")
    return _Mesh(cfg, shape.global_batch, length, mesh, rules)


def make_decode_step(cfg: ModelConfig, shape: ShapeConfig, mesh=None, rules=None,
                     *, device=None) -> ServeBundle:
    """One token against a cache of ``shape.seq_len`` positions for
    ``shape.global_batch`` rows."""
    cfg = _serve_cfg(cfg)
    dev = _device(device)
    place = _placement(cfg, shape, mesh, rules, dev, shape.seq_len)
    if place is None:
        ctx = Ctx(cfg, dev)

        def decode_step(params, batch, cache):
            return lm.decode_step(params, batch, cache, ctx)

        return ServeBundle(decode_step)

    b_sh = place.batch_of(cfg, shape)
    ctx = place.ctx(cfg, dev, b_sh, ShardedCache(place.cache, place.length,
                                                 batch_split(b_sh)))

    def sharded_decode_step(params, batch, cache):
        logits, cache = lm.decode_step(tree_gather(params, place.params),
                                       place.rows(batch, b_sh), cache, ctx)
        return place.logits(logits, ctx), cache

    return ServeBundle(sharded_decode_step, place.params, b_sh, place.cache)


def make_prefill(cfg: ModelConfig, shape: ShapeConfig, mesh=None, rules=None,
                 *, device=None) -> ServeBundle:
    cfg = _serve_cfg(cfg)
    dev = _device(device)
    length = shape.seq_len
    place = _placement(cfg, shape, mesh, rules, dev, length)
    if place is None:
        ctx = Ctx(cfg, dev)

        def prefill(params, batch):
            return lm.prefill(params, batch, ctx)

        return ServeBundle(prefill)

    b_sh = place.batch_of(cfg, shape)
    ctx = place.ctx(cfg, dev, b_sh)

    def sharded_prefill(params, batch):
        logits, cache = lm.prefill(tree_gather(params, place.params),
                                   place.rows(batch, b_sh), ctx)
        return place.logits(logits, ctx), place.cache_blocks(cache)

    return ServeBundle(sharded_prefill, place.params, b_sh, place.cache)


def greedy_generate(params, prompt_batch, cfg: ModelConfig, n_steps: int,
                    mesh=None, rules=None, *, device=None):
    """Prefill a prompt, then greedy-decode: returns the (B, n_steps) int32
    tokens, the first from the prefill's logits. Runs ``n_steps`` decode
    steps, as the reference does (the last step's token is not returned).

    Under a mesh every rank passes its param blocks under the serving
    shardings (``make_prefill(...).param_shardings``) and the GLOBAL
    prompt; the params are gathered once, and the tokens returned are the
    global batch's."""
    dev = _device(device)
    cfg_s = _serve_cfg(cfg)
    batch = {k: v.to(dev) for k, v in prompt_batch.items()}
    B = next(iter(batch.values())).shape[0]
    S = batch["tokens"].shape[1] + (cfg.n_patches if cfg.family == "vlm" else 0)
    shape = ShapeConfig("generate", "prefill", S, B)
    place = _placement(cfg_s, shape, mesh, rules, dev, S + n_steps)
    if place is None:
        ctx = step_ctx = Ctx(cfg_s, dev)
    else:
        b_sh = place.batch_of(cfg_s, shape)
        ctx = place.ctx(cfg_s, dev, b_sh)
        step_ctx = place.ctx(cfg_s, dev, b_sh, ShardedCache(place.cache, S + n_steps,
                                                            ctx.batch_axes))
        batch = {k: b_sh[k].shard(v, dims=(0,)) for k, v in batch.items()}
    with torch.inference_mode():
        if place is not None:
            params = tree_gather(params, place.params)
        logits, cache = lm.prefill(params, batch, ctx)
        # grow the cache to fit generated tokens
        full = lm.init_cache(cfg, batch["tokens"].shape[0], S + n_steps, device=dev)
        cache = {k: _embed_cache(full[k], cache[k]) for k in full}
        if place is not None:
            cache = place.cache_blocks(cache)
        tokens = []
        tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
        for _ in range(n_steps):
            tokens.append(tok)
            logits, cache = lm.decode_step(params, {"token": tok}, cache, step_ctx)
            tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
        out = torch.cat(tokens, dim=1)
        return out if place is None else place.logits(out, ctx)


def _embed_cache(full, part):
    """Write a prefill cache into a (larger) zeroed decode cache."""
    if full.shape == part.shape:
        return part
    full[tuple(slice(0, n) for n in part.shape)] = lm.to_cache_dtype(part, full.dtype)
    return full
