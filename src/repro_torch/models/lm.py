"""Model assembly for every family (dense / moe / vlm / audio / hybrid / ssm).

The same interface as the reference's ``repro.models.lm``:

  * ``model_schema(cfg)``     — nested ParamSpec tree (init + meta shapes + axes)
  * ``forward(params, batch, ctx)``            — final hidden states (train/prefill)
  * ``loss_fn(params, batch, ctx)``            — chunked CE loss (+ MoE aux)
  * ``init_cache / cache_spec / cache_axes``  — decode caches per family
  * ``prefill(params, batch, ctx)``            — forward + cache population
  * ``decode_step(params, batch, cache, ctx)`` — one-token serving step

Params are plain nested dicts of tensors; layers are stacked on a leading
'layers' dim and applied by a Python loop over it. While autograd records,
each layer body runs under ``cfg.remat`` (``torch.utils.checkpoint``);
serving runs without it. The decode cache is updated in place.
"""
from __future__ import annotations

import functools
from typing import Any

import torch
from torch import nn
from torch.utils import checkpoint as torch_checkpoint

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.api import YdfError
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.attention import (
    attention_schema,
    decode_attention,
    flash_attention,
    out_project,
    qkv_project,
)
from repro_torch.models.layers import (
    Ctx,
    chunked_softmax_xent,
    embed,
    embed_schema,
    layernorm,
    layernorm_schema,
    logits_last,
    mlp,
    mlp_schema,
    rmsnorm,
    rmsnorm_schema,
    unembed_matrix,
)
from repro_torch.models.moe import moe_block, moe_schema
from repro_torch.models.params import (
    Schema,
    init_params,
    leaves,
    stack_layers,
    torch_dtype,
)

FAMILIES = ("dense", "moe", "vlm", "audio", "hybrid", "ssm")


def _check_family(cfg: ModelConfig) -> str:
    if cfg.family not in FAMILIES:
        raise ValueError(cfg.family)
    return cfg.family


# =====================================================================
# Schemas
# =====================================================================

def _attn_mlp_block_schema(cfg: ModelConfig) -> Schema:
    """One decoder block: [ln1 -> attn] + [ln2 -> mlp/moe] (or parallel)."""
    sch: Schema = {
        "ln1": rmsnorm_schema(cfg.d_model),
        "attn": attention_schema(cfg),
    }
    if not cfg.parallel_block:
        sch["ln2"] = rmsnorm_schema(cfg.d_model)
    if cfg.n_experts:
        sch["moe"] = moe_schema(cfg)
    else:
        sch["mlp"] = mlp_schema(cfg)
    return sch


def _whisper_enc_block_schema(cfg: ModelConfig) -> Schema:
    return {
        "ln1": layernorm_schema(cfg.d_model),
        "attn": attention_schema(cfg),
        "ln2": layernorm_schema(cfg.d_model),
        "mlp": mlp_schema(cfg),
    }


def _whisper_dec_block_schema(cfg: ModelConfig) -> Schema:
    return {
        "ln1": layernorm_schema(cfg.d_model),
        "self_attn": attention_schema(cfg),
        "ln2": layernorm_schema(cfg.d_model),
        "cross_attn": attention_schema(cfg),
        "ln3": layernorm_schema(cfg.d_model),
        "mlp": mlp_schema(cfg),
    }


def _zamba_groups(cfg: ModelConfig) -> tuple[int, int]:
    per = cfg.attn_every
    if not per or cfg.n_layers % per:
        raise YdfError(f"{cfg.name}: n_layers {cfg.n_layers} is not a multiple "
                       f"of attn_every {per}")
    return cfg.n_layers // per, per


def model_schema(cfg: ModelConfig) -> Schema:
    fam = _check_family(cfg)
    sch: Schema = {"embed": embed_schema(cfg)}
    if fam in ("dense", "moe", "vlm"):
        sch["layers"] = stack_layers(cfg.n_layers, _attn_mlp_block_schema(cfg))
        sch["final_norm"] = rmsnorm_schema(cfg.d_model)
    elif fam == "audio":
        sch["enc_layers"] = stack_layers(cfg.n_enc_layers, _whisper_enc_block_schema(cfg))
        sch["enc_norm"] = layernorm_schema(cfg.d_model)
        sch["dec_layers"] = stack_layers(cfg.n_layers, _whisper_dec_block_schema(cfg))
        sch["final_norm"] = layernorm_schema(cfg.d_model)
    elif fam == "hybrid":
        G, per = _zamba_groups(cfg)
        mamba = {"ln": rmsnorm_schema(cfg.d_model), "m": ssm_mod.mamba2_schema(cfg)}
        sch["mamba"] = stack_layers(G, stack_layers(per, mamba))
        sch["shared"] = {  # ONE weight set, invoked G times
            "ln1": rmsnorm_schema(cfg.d_model),
            "attn": attention_schema(cfg),
            "ln2": rmsnorm_schema(cfg.d_model),
            "mlp": mlp_schema(cfg),
        }
        sch["final_norm"] = rmsnorm_schema(cfg.d_model)
    else:  # ssm
        rwkv = ssm_mod.rwkv6_schema(cfg)
        block = {
            "ln1": layernorm_schema(cfg.d_model),
            "time": rwkv["time"],
            "ln2": layernorm_schema(cfg.d_model),
            "channel": rwkv["channel"],
        }
        sch["ln0"] = layernorm_schema(cfg.d_model)
        sch["layers"] = stack_layers(cfg.n_layers, block)
        sch["final_norm"] = layernorm_schema(cfg.d_model)
    return sch


# =====================================================================
# Block applications
# =====================================================================

def _attn_mlp_block(p, x, ctx: Ctx, positions, *, causal=True, prefix_len=None):
    """Standard decoder block over full sequences (train / prefill)."""
    cfg = ctx.cfg
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    q, k, v = qkv_project(p["attn"], h, h, ctx, positions, positions)
    a = flash_attention(q, k, v, positions, positions, ctx, causal=causal,
                        prefix_len=prefix_len)
    a = out_project(p["attn"], a, ctx)
    if cfg.parallel_block:
        if "moe" in p:
            m, aux = moe_block(p["moe"], h, ctx)
        else:
            m = mlp(p["mlp"], h, ctx)
        x = x + a + m
    else:
        x = x + a
        h2 = rmsnorm(p["ln2"], x, cfg.norm_eps)
        if "moe" in p:
            m, aux = moe_block(p["moe"], h2, ctx)
        else:
            m = mlp(p["mlp"], h2, ctx)
        x = x + m
    return x, (a, k, v, aux)


def _layer(stacked, i: int):
    """Layer ``i`` of a stacked param tree (views, no copies)."""
    if isinstance(stacked, dict):
        return {k: _layer(v, i) for k, v in stacked.items()}
    return stacked[i]


def _n_layers(stacked) -> int:
    return leaves(stacked)[0][1].shape[0]


_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_matmuls(ctx, op, *args, **kwargs):
    """The selective-checkpoint policy of ``remat="dots"``: keep the outputs
    of matmuls without batch dims (jax's
    ``dots_with_no_batch_dims_saveable``), recompute everything else."""
    pol = torch_checkpoint.CheckpointPolicy
    return pol.MUST_SAVE if op in _MATMULS else pol.PREFER_RECOMPUTE


def _remat(body, remat: str):
    """``body`` under the config's rematerialization while autograd records:
    "full" saves only each call's inputs, "dots" also the matmul outputs,
    "none" everything."""
    if remat == "none" or not torch.is_grad_enabled():
        return body
    if remat == "full":
        return functools.partial(torch_checkpoint.checkpoint, body,
                                 use_reentrant=False)
    if remat == "dots":
        return functools.partial(
            torch_checkpoint.checkpoint, body, use_reentrant=False,
            context_fn=functools.partial(
                torch_checkpoint.create_selective_checkpoint_contexts,
                _save_matmuls))
    raise ValueError(remat)


def _unstack(stacked) -> list:
    """The per-layer param trees of ``stacked``, one ``unbind`` per leaf (a
    view each; under autograd the layers' gradients stack into the leaf's
    in one pass, where indexing layer by layer would add a full-size zero
    tensor per layer)."""
    if isinstance(stacked, dict):
        per_key = {k: _unstack(v) for k, v in stacked.items()}
        n = len(next(iter(per_key.values())))
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    return list(stacked.unbind(0))


def _scan(body, carry, stacked, remat: str = "none"):
    """Apply ``body(carry, layer_params) -> (carry, y)`` over the leading
    'layers' dim of ``stacked`` (under ``remat``, see ``_remat``); returns
    (carry, [y per layer])."""
    body = _remat(body, remat)
    ys = []
    for p in _unstack(stacked):
        carry, y = body(carry, p)
        ys.append(y)
    return carry, ys


# =====================================================================
# Forward (train / prefill) per family
# =====================================================================

def _positions(B: int, S: int, device, offset: int = 0):
    return (torch.arange(S, dtype=torch.int32, device=device)[None, :]
            + offset).expand(B, S)


def _embed_inputs(params, batch, ctx: Ctx):
    """Returns (x, positions, prefix_len). Handles vlm patch prefix and
    audio(decoder) token embedding."""
    cfg = ctx.cfg
    if cfg.family == "vlm":
        patches = batch["patches"].to(ctx.dtype)  # (B, P, D)
        toks = embed(params["embed"], batch["tokens"], ctx)  # (B, S-P, D)
        x = torch.cat([patches, toks], dim=1)
        B, S = x.shape[0], x.shape[1]
        return x, _positions(B, S, x.device), cfg.n_patches
    x = embed(params["embed"], batch["tokens"], ctx)
    B, S = x.shape[0], x.shape[1]
    if cfg.family == "audio":
        x = x + _sinusoid(S, cfg.d_model, x.device).to(x.dtype)[None]
    if cfg.family == "ssm":
        x = layernorm(params["ln0"], x, cfg.norm_eps)
    return x, _positions(B, S, x.device), None


def _sinusoid(S: int, D: int, device):
    pos = torch.arange(S, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(D // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(torch.tensor(10_000.0, device=device), 2.0 * dim / D)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _whisper_encode(params, frames, ctx: Ctx):
    """frames: (B, T, D) stub frame embeddings -> encoder states (B, T, D)."""
    cfg = ctx.cfg
    x = frames.to(ctx.dtype) + _sinusoid(frames.shape[1], cfg.d_model,
                                         frames.device).to(ctx.dtype)[None]
    pos = _positions(x.shape[0], x.shape[1], x.device)

    def body(x, p):
        h = layernorm(p["ln1"], x, cfg.norm_eps)
        q, k, v = qkv_project(p["attn"], h, h, ctx, pos, pos, use_rope=False)
        a = out_project(p["attn"], flash_attention(q, k, v, pos, pos, ctx, causal=False), ctx)
        x = x + a
        x = x + mlp(p["mlp"], layernorm(p["ln2"], x, cfg.norm_eps), ctx)
        return x, None

    x, _ = _scan(body, x, params["enc_layers"], cfg.remat)
    return layernorm(params["enc_norm"], x, cfg.norm_eps)


def forward(params, batch, ctx: Ctx, *, return_cache: bool = False):
    """Full-sequence forward. Returns (h_final, cache_or_None, aux_loss).

    cache (when return_cache) is the same structure ``decode_step`` consumes,
    with entries valid for positions [0, S).
    """
    fam = _check_family(ctx.cfg)
    if fam == "audio":
        return _forward_whisper(params, batch, ctx, return_cache)
    if fam == "hybrid":
        return _forward_zamba(params, batch, ctx, return_cache)
    if fam == "ssm":
        return _forward_rwkv(params, batch, ctx, return_cache)
    return _forward_attn(params, batch, ctx, return_cache)


def _forward_attn(params, batch, ctx: Ctx, return_cache: bool):
    cfg = ctx.cfg
    x, pos, prefix = _embed_inputs(params, batch, ctx)

    def body(x, p):
        x, (_, k, v, aux) = _attn_mlp_block(p, x, ctx, pos, prefix_len=prefix)
        return x, ((k, v) if return_cache else None, aux)

    x, ys = _scan(body, x, params["layers"], cfg.remat)
    h = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    aux = (torch.stack([y[1] for y in ys]).sum() if cfg.n_experts
           else torch.zeros((), dtype=torch.float32, device=x.device))
    cache = None
    if return_cache:
        cache = {"k": torch.stack([y[0][0] for y in ys]),
                 "v": torch.stack([y[0][1] for y in ys]),
                 "pos": _full_pos(x)}
    return h, cache, aux


def _full_pos(x):
    return torch.full((x.shape[0],), x.shape[1], dtype=torch.int32, device=x.device)


def _forward_whisper(params, batch, ctx: Ctx, return_cache: bool):
    cfg = ctx.cfg
    enc = _whisper_encode(params, batch["frames"], ctx)  # (B, T, D)
    x, pos, _ = _embed_inputs(params, batch, ctx)
    enc_pos = _positions(enc.shape[0], enc.shape[1], enc.device)

    def body(x, p):
        h = layernorm(p["ln1"], x, cfg.norm_eps)
        q, k, v = qkv_project(p["self_attn"], h, h, ctx, pos, pos, use_rope=False)
        x = x + out_project(p["self_attn"],
                            flash_attention(q, k, v, pos, pos, ctx, causal=True), ctx)
        h = layernorm(p["ln2"], x, cfg.norm_eps)
        cq, ck, cv = qkv_project(p["cross_attn"], h, enc, ctx, use_rope=False)
        x = x + out_project(p["cross_attn"],
                            flash_attention(cq, ck, cv, pos, enc_pos, ctx, causal=False), ctx)
        x = x + mlp(p["mlp"], layernorm(p["ln3"], x, cfg.norm_eps), ctx)
        return x, ((k, v, ck, cv) if return_cache else None)

    x, ys = _scan(body, x, params["dec_layers"], cfg.remat)
    h = layernorm(params["final_norm"], x, cfg.norm_eps)
    cache = None
    if return_cache:
        cache = {name: torch.stack([y[j] for y in ys])
                 for j, name in enumerate(("k", "v", "xk", "xv"))}
        cache["pos"] = _full_pos(x)
    return h, cache, torch.zeros((), dtype=torch.float32, device=x.device)


def _shared_attn_block(p, x, ctx: Ctx, pos):
    cfg = ctx.cfg
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    q, k, v = qkv_project(p["attn"], h, h, ctx, pos, pos)
    x = x + out_project(p["attn"], flash_attention(q, k, v, pos, pos, ctx, causal=True), ctx)
    x = x + mlp(p["mlp"], rmsnorm(p["ln2"], x, cfg.norm_eps), ctx)
    return x, (k, v)


def _forward_zamba(params, batch, ctx: Ctx, return_cache: bool):
    cfg = ctx.cfg
    x, pos, _ = _embed_inputs(params, batch, ctx)
    shared = params["shared"]

    def mamba_layer(x, p_l):
        y, (conv, ssm) = ssm_mod.mamba2_chunked(
            p_l["m"], rmsnorm(p_l["ln"], x, cfg.norm_eps), ctx)
        return x + y, ((conv, ssm) if return_cache else None)

    def group(x, p_g):
        x, states = _scan(mamba_layer, x, p_g, cfg.remat)
        x, (k, v) = _shared_attn_block(shared, x, ctx, pos)
        if not return_cache:
            return x, None
        return x, (torch.stack([s[0] for s in states]),
                   torch.stack([s[1] for s in states]), k, v)

    x, ys = _scan(group, x, params["mamba"], cfg.remat)
    h = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    cache = None
    if return_cache:
        cache = {name: torch.stack([y[j] for y in ys])
                 for j, name in enumerate(("conv", "ssm", "k", "v"))}
        cache["pos"] = _full_pos(x)
    return h, cache, torch.zeros((), dtype=torch.float32, device=x.device)


def _forward_rwkv(params, batch, ctx: Ctx, return_cache: bool):
    cfg = ctx.cfg
    x, _, _ = _embed_inputs(params, batch, ctx)

    def body(x, p):
        t, (tshift, wkv) = ssm_mod.rwkv6_time_mix(
            p["time"], layernorm(p["ln1"], x, cfg.norm_eps), ctx)
        x = x + t
        c, cshift = ssm_mod.rwkv6_channel_mix(
            p["channel"], layernorm(p["ln2"], x, cfg.norm_eps), ctx)
        x = x + c
        return x, ((tshift, wkv, cshift) if return_cache else None)

    x, ys = _scan(body, x, params["layers"], cfg.remat)
    h = layernorm(params["final_norm"], x, cfg.norm_eps)
    cache = None
    if return_cache:
        cache = {name: torch.stack([y[j] for y in ys])
                 for j, name in enumerate(("tshift", "wkv", "cshift"))}
        cache["pos"] = _full_pos(x)
    return h, cache, torch.zeros((), dtype=torch.float32, device=x.device)


# =====================================================================
# Loss
# =====================================================================

def loss_terms(params, batch, ctx: Ctx):
    """(sum of the weighted CE over label positions, the sum of the weights,
    the MoE aux loss): ``loss_fn``'s parts, which a sharded step combines
    over the batch shards."""
    cfg = ctx.cfg
    h, _, aux = forward(params, batch, ctx)
    if cfg.family == "vlm":  # loss on text positions only
        h = h[:, cfg.n_patches:, :]
    labels = batch["labels"]
    weights = batch.get("weights")
    if weights is None:
        weights = torch.ones(labels.shape, dtype=torch.float32, device=labels.device)
    un = unembed_matrix(params["embed"], ctx)
    sum_loss, sum_w = chunked_softmax_xent(h, un, labels, weights, ctx)
    return sum_loss, sum_w, aux


def loss_fn(params, batch, ctx: Ctx):
    """Mean CE over label positions (+ MoE aux). Returns (loss, metrics)."""
    sum_loss, sum_w, aux = loss_terms(params, batch, ctx)
    ce = sum_loss / torch.clamp(sum_w, min=1.0)
    return ce + aux, {"ce": ce, "aux": aux, "tokens": sum_w}


# =====================================================================
# Decode caches
# =====================================================================

def cache_spec(cfg: ModelConfig, batch_size: int, max_len: int) -> dict[str, Any]:
    """Meta-device tensors for the decode cache (also defines the structure)."""
    fam = _check_family(cfg)
    dt = torch_dtype(cfg.kv_cache_dtype or cfg.dtype)
    B, L = batch_size, cfg.n_layers
    KV, Dh = cfg.n_kv_heads, cfg.resolved_head_dim()

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    out: dict[str, Any] = {"pos": meta((B,), torch.int32)}
    if fam in ("dense", "moe", "vlm", "audio"):
        out["k"] = meta((L, B, max_len, KV, Dh), dt)
        out["v"] = meta((L, B, max_len, KV, Dh), dt)
    if fam == "audio":
        out["xk"] = meta((L, B, cfg.enc_seq, KV, Dh), dt)
        out["xv"] = meta((L, B, cfg.enc_seq, KV, Dh), dt)
    elif fam == "hybrid":
        G, per = _zamba_groups(cfg)
        H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
        conv_dim = H * P + 2 * N
        out["conv"] = meta((G, per, B, cfg.d_conv - 1, conv_dim), dt)
        out["ssm"] = meta((G, per, B, H, P, N), torch.float32)
        out["k"] = meta((G, B, max_len, KV, Dh), dt)
        out["v"] = meta((G, B, max_len, KV, Dh), dt)
    elif fam == "ssm":
        D = cfg.d_model
        H, C = D // cfg.rwkv_head_dim, cfg.rwkv_head_dim
        out["tshift"] = meta((L, B, D), dt)
        out["cshift"] = meta((L, B, D), dt)
        out["wkv"] = meta((L, B, H, C, C), torch.float32)
    return out


CACHE_AXES = {
    "pos": ("batch",),
    "k": ("layers", "batch", "kv_len", "kv_heads", "qkv"),
    "v": ("layers", "batch", "kv_len", "kv_heads", "qkv"),
    "xk": ("layers", "batch", "kv_len", "kv_heads", "qkv"),
    "xv": ("layers", "batch", "kv_len", "kv_heads", "qkv"),
    "conv": ("layers", None, "batch", None, "heads"),
    "ssm": ("layers", None, "batch", "heads", None, None),
    "tshift": ("layers", "batch", "embed_act"),
    "cshift": ("layers", "batch", "embed_act"),
    "wkv": ("layers", "batch", "heads", None, None),
}


def cache_axes(cfg: ModelConfig) -> dict[str, tuple]:
    return {k: CACHE_AXES[k] for k in cache_spec(cfg, 1, 8)}


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int, *, device=None):
    from repro_torch.core.engines import resolve_device
    dev = resolve_device(device)
    return {k: torch.zeros(s.shape, dtype=s.dtype, device=dev)
            for k, s in cache_spec(cfg, batch_size, max_len).items()}


# float8_e4m3fn's largest finite value is 448; values above 464 (the half
# way to the next step) are NaN in ml_dtypes' cast, which the reference uses
_E4M3_NAN_ABOVE = 464.0


def to_cache_dtype(x, dtype: torch.dtype):
    """``x.to(dtype)``, except that a float8_e4m3fn cast gives NaN (sign
    kept) beyond the format's range, as the reference's cast does, where
    torch's saturates to +-448."""
    y = x.to(dtype)
    if dtype != torch.float8_e4m3fn:
        return y
    nan = torch.where(x < 0, 0xFF, 0x7F).to(torch.uint8)
    bits = torch.where(x.abs() > _E4M3_NAN_ABOVE, nan, y.view(torch.uint8))
    return bits.view(dtype)


def _cache_insert(cache_l, new, pos):
    """Writes new (B, 1, KV, Dh) into cache_l (B, Smax, KV, Dh) at pos (B,),
    in place. The positions were checked by ``decode_step``."""
    B = cache_l.shape[0]
    rows = torch.arange(B, device=cache_l.device)
    cache_l[rows, pos.long()] = to_cache_dtype(new[:, 0], cache_l.dtype)


def _check_positions(cache, ctx: Ctx):
    """The reference clamps an out-of-range write to the cache's last slot;
    the port refuses it (one host read of the positions a step; under a
    mesh, the largest over the batch shards, so every rank refuses alike).
    The ssm family's states have no sequence axis: any position fits."""
    if "k" not in cache:
        return
    if ctx.cache_io is None:
        max_len, last = cache["k"].shape[2], int(cache["pos"].max())
    else:
        max_len, last = ctx.cache_io.positions(cache)
    if last >= max_len:
        raise YdfError(f"decode position {last} is past the cache's "
                       f"{max_len} slots; grow the cache (init_cache) first")


# =====================================================================
# Decode step (one new token) per family
# =====================================================================

def decode_step(params, batch, cache, ctx: Ctx):
    """batch: {'token': (B,1) int32}. Returns (logits (B,V) fp32, cache);
    the cache's tensors are updated in place and ``pos`` advanced."""
    fam = _check_family(ctx.cfg)
    _check_positions(cache, ctx)
    if fam == "audio":
        h, cache = _decode_whisper(params, batch, cache, ctx)
    elif fam == "hybrid":
        h, cache = _decode_zamba(params, batch, cache, ctx)
    elif fam == "ssm":
        h, cache = _decode_rwkv(params, batch, cache, ctx)
    else:
        h, cache = _decode_attn(params, batch, cache, ctx)
    logits = logits_last(h[:, -1, :], unembed_matrix(params["embed"], ctx), ctx)
    return logits, cache


def _cache_at(cache, key: str, idx, ctx: Ctx):
    """``cache[key][idx]``, the layer's tensor a decode step reads and
    updates in place: a view on one device; under a mesh (``ctx.cache_io``)
    the layer gathered over its length and head shards, this rank's batch
    rows, which ``_cache_done`` writes back."""
    if ctx.cache_io is None:
        return cache[key][idx]
    return ctx.cache_io.load(cache, key, idx)


def _cache_done(cache, key: str, idx, layer, ctx: Ctx) -> None:
    if ctx.cache_io is not None:
        ctx.cache_io.store(cache, key, idx, layer)


def _decode_embed(params, batch, cache, ctx: Ctx):
    x = embed(params["embed"], batch["token"], ctx)  # (B, 1, D)
    pos = cache["pos"]  # (B,) index where this token is written
    if ctx.cfg.family == "audio":
        x = x + _sinusoid_at(pos, ctx.cfg.d_model)[:, None, :].to(x.dtype)
    if ctx.cfg.family == "ssm":
        x = layernorm(params["ln0"], x, ctx.cfg.norm_eps)
    return x, pos


def _sinusoid_at(p, D: int):
    """p: (B,) positions -> (B, D)."""
    dim = torch.arange(D // 2, dtype=torch.float32, device=p.device)
    ang = p.float()[:, None] / torch.pow(torch.tensor(10_000.0, device=p.device),
                                         2.0 * dim / D)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _decode_attn(params, batch, cache, ctx: Ctx):
    cfg = ctx.cfg
    x, pos = _decode_embed(params, batch, cache, ctx)
    pos2 = pos[:, None]  # (B, 1)
    layers = params["layers"]
    for i in range(_n_layers(layers)):
        p = _layer(layers, i)
        k_c, v_c = _cache_at(cache, "k", i, ctx), _cache_at(cache, "v", i, ctx)
        h = rmsnorm(p["ln1"], x, cfg.norm_eps)
        q, k, v = qkv_project(p["attn"], h, h, ctx, pos2, pos2)
        _cache_insert(k_c, k, pos)
        _cache_insert(v_c, v, pos)
        _cache_done(cache, "k", i, k_c, ctx)
        _cache_done(cache, "v", i, v_c, ctx)
        a = decode_attention(q, k_c, v_c, pos, ctx)
        a = out_project(p["attn"], a, ctx)
        if cfg.parallel_block:
            m = moe_block(p["moe"], h, ctx)[0] if "moe" in p else mlp(p["mlp"], h, ctx)
            x = x + a + m
        else:
            x = x + a
            h2 = rmsnorm(p["ln2"], x, cfg.norm_eps)
            m = moe_block(p["moe"], h2, ctx)[0] if "moe" in p else mlp(p["mlp"], h2, ctx)
            x = x + m
    h = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    cache["pos"] = pos + 1
    return h, cache


def _decode_whisper(params, batch, cache, ctx: Ctx):
    cfg = ctx.cfg
    x, pos = _decode_embed(params, batch, cache, ctx)
    pos2 = pos[:, None]
    layers = params["dec_layers"]
    for i in range(_n_layers(layers)):
        p = _layer(layers, i)
        k_c, v_c = _cache_at(cache, "k", i, ctx), _cache_at(cache, "v", i, ctx)
        h = layernorm(p["ln1"], x, cfg.norm_eps)
        q, k, v = qkv_project(p["self_attn"], h, h, ctx, pos2, pos2, use_rope=False)
        _cache_insert(k_c, k, pos)
        _cache_insert(v_c, v, pos)
        _cache_done(cache, "k", i, k_c, ctx)
        _cache_done(cache, "v", i, v_c, ctx)
        x = x + out_project(p["self_attn"], decode_attention(q, k_c, v_c, pos, ctx), ctx)
        h = layernorm(p["ln2"], x, cfg.norm_eps)
        cq, _, _ = qkv_project(p["cross_attn"], h, h[:, :0], ctx, use_rope=False)
        ca = decode_attention(cq, _cache_at(cache, "xk", i, ctx),
                              _cache_at(cache, "xv", i, ctx), pos, ctx,
                              valid_len=cfg.enc_seq)
        x = x + out_project(p["cross_attn"], ca, ctx)
        x = x + mlp(p["mlp"], layernorm(p["ln3"], x, cfg.norm_eps), ctx)
    h = layernorm(params["final_norm"], x, cfg.norm_eps)
    cache["pos"] = pos + 1
    return h, cache


def _decode_zamba(params, batch, cache, ctx: Ctx):
    cfg = ctx.cfg
    x, pos = _decode_embed(params, batch, cache, ctx)
    pos2 = pos[:, None]
    shared = params["shared"]
    groups = params["mamba"]
    for g in range(_n_layers(groups)):
        p_g = _layer(groups, g)
        for i in range(_n_layers(p_g)):
            p_l = _layer(p_g, i)
            conv = _cache_at(cache, "conv", (g, i), ctx)
            ssm = _cache_at(cache, "ssm", (g, i), ctx)
            y, (conv2, ssm2) = ssm_mod.mamba2_step(
                p_l["m"], rmsnorm(p_l["ln"], x, cfg.norm_eps), ctx, conv, ssm)
            conv.copy_(conv2)
            ssm.copy_(ssm2)
            _cache_done(cache, "conv", (g, i), conv, ctx)
            _cache_done(cache, "ssm", (g, i), ssm, ctx)
            x = x + y
        k_c, v_c = _cache_at(cache, "k", g, ctx), _cache_at(cache, "v", g, ctx)
        h = rmsnorm(shared["ln1"], x, cfg.norm_eps)
        q, k, v = qkv_project(shared["attn"], h, h, ctx, pos2, pos2)
        _cache_insert(k_c, k, pos)
        _cache_insert(v_c, v, pos)
        _cache_done(cache, "k", g, k_c, ctx)
        _cache_done(cache, "v", g, v_c, ctx)
        x = x + out_project(shared["attn"], decode_attention(q, k_c, v_c, pos, ctx), ctx)
        x = x + mlp(shared["mlp"], rmsnorm(shared["ln2"], x, cfg.norm_eps), ctx)
    h = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    cache["pos"] = pos + 1
    return h, cache


def _decode_rwkv(params, batch, cache, ctx: Ctx):
    cfg = ctx.cfg
    x, pos = _decode_embed(params, batch, cache, ctx)
    layers = params["layers"]
    for i in range(_n_layers(layers)):
        p = _layer(layers, i)
        tsh, wkv, csh = (_cache_at(cache, key, i, ctx)
                         for key in ("tshift", "wkv", "cshift"))
        t, (tsh2, wkv2) = ssm_mod.rwkv6_time_step(
            p["time"], layernorm(p["ln1"], x, cfg.norm_eps), ctx, tsh, wkv)
        x = x + t
        c, csh2 = ssm_mod.rwkv6_channel_mix(
            p["channel"], layernorm(p["ln2"], x, cfg.norm_eps), ctx, csh)
        x = x + c
        tsh.copy_(tsh2)
        wkv.copy_(wkv2)
        csh.copy_(csh2)
        for key, layer in (("tshift", tsh), ("wkv", wkv), ("cshift", csh)):
            _cache_done(cache, key, i, layer, ctx)
    h = layernorm(params["final_norm"], x, cfg.norm_eps)
    cache["pos"] = pos + 1
    return h, cache


def prefill(params, batch, ctx: Ctx):
    """Full-sequence prefill: returns (last-token logits (B,V), cache)."""
    h, cache, _ = forward(params, batch, ctx, return_cache=True)
    logits = logits_last(h[:, -1, :], unembed_matrix(params["embed"], ctx), ctx)
    return logits, cache


# =====================================================================
# Batch specs (meta tensors) + logical axes
# =====================================================================

BATCH_AXES = {
    "tokens": ("batch", "seq"),
    "labels": ("batch", "seq"),
    "weights": ("batch", "seq"),
    "patches": ("batch", "seq", "embed_act"),
    "frames": ("batch", "kv_len", "embed_act"),
    "token": ("batch", None),
}


def batch_spec(cfg: ModelConfig, shape: ShapeConfig) -> dict[str, Any]:
    """Model inputs for a given assigned shape, as meta-device tensors."""
    B, S = shape.global_batch, shape.seq_len
    i32, dt = torch.int32, torch_dtype(cfg.dtype)

    def meta(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device="meta")

    if shape.kind == "decode":
        return {"token": meta((B, 1), i32)}
    out: dict[str, Any] = {}
    if cfg.family == "vlm":
        S_text = S - cfg.n_patches
        out["patches"] = meta((B, cfg.n_patches, cfg.d_model), dt)
        out["tokens"] = meta((B, S_text), i32)
        if shape.kind == "train":
            out["labels"] = meta((B, S_text), i32)
        return out
    if cfg.family == "audio":
        out["frames"] = meta((B, cfg.enc_seq, cfg.d_model), dt)
    out["tokens"] = meta((B, S), i32)
    if shape.kind == "train":
        out["labels"] = meta((B, S), i32)
    return out


def batch_axes(cfg: ModelConfig, shape: ShapeConfig) -> dict[str, tuple]:
    return {k: BATCH_AXES[k] for k in batch_spec(cfg, shape)}


def make_batch(generator: torch.Generator, cfg: ModelConfig, shape: ShapeConfig,
               *, device=None):
    """Random concrete batch matching batch_spec (for smoke tests/examples),
    drawn with ``generator`` (on ``device``)."""
    from repro_torch.core.engines import resolve_device
    dev = resolve_device(device)
    out = {}
    for name, s in batch_spec(cfg, shape).items():
        if s.dtype == torch.int32:
            out[name] = torch.randint(0, cfg.vocab_size, s.shape, generator=generator,
                                      dtype=torch.int32, device=dev)
        else:
            v = torch.randn(s.shape, generator=generator, dtype=torch.float32,
                            device=dev)
            out[name] = v.to(s.dtype) * torch.tensor(0.02, dtype=s.dtype, device=dev)
    return out


# =====================================================================
# nn.Module wrapper
# =====================================================================

class _Params(nn.Module):
    """One level of a nested param dict: dicts become submodules, tensors
    parameters (frozen: this is the serving path)."""

    def __init__(self, tree: dict):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, _Params(v))
            else:
                self.register_parameter(k, nn.Parameter(v, requires_grad=False))

    def tree(self) -> dict:
        out = {k: p for k, p in self._parameters.items()}
        out.update({k: m.tree() for k, m in self._modules.items()})
        return out


class LanguageModel(_Params):
    """A model of ``cfg`` holding its nested param dict as registered
    parameters (``state_dict()`` keys are the dotted paths, e.g.
    ``layers.attn.wq``). Without ``params``, draws them with ``generator``
    (``init_params``) on ``device`` (None is cuda)."""

    def __init__(self, cfg: ModelConfig, params: dict | None = None, *,
                 device=None, generator: torch.Generator | None = None):
        from repro_torch.core.engines import resolve_device
        dev = resolve_device(device)
        if params is None:
            if generator is None:
                generator = torch.Generator(device=dev).manual_seed(0)
            params = init_params(model_schema(cfg), cfg.param_dtype,
                                 generator=generator, device=dev)
        super().__init__(params)
        self.cfg = cfg
        self.ctx = Ctx(cfg, dev)

    def forward(self, batch, *, return_cache: bool = False):
        return forward(self.tree(), batch, self.ctx, return_cache=return_cache)

    def prefill(self, batch):
        return prefill(self.tree(), batch, self.ctx)

    def decode_step(self, batch, cache):
        return decode_step(self.tree(), batch, cache, self.ctx)
