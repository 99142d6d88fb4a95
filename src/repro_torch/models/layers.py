"""Shared transformer building blocks (pure functions over param dicts)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Mapping

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.params import ParamSpec, torch_dtype


@dataclass(frozen=True)
class Ctx:
    """Runtime context threaded through apply functions.

    ``moe_stats``, when a dict, sums each MoE block's (token, choice) pairs
    under ``"routed"`` (an int) and those that found a capacity slot under
    ``"kept"`` (a device tensor).

    Under a mesh (``core.mesh.ProcessMesh``, with the sharding ``rules``)
    each rank runs the one-device code on its rows of the batch, split over
    ``batch_axes``; the steps gather what they need around it
    (``train.step``, ``serving.decode``). An MoE block forms its groups over
    the global batch, and ``cache_io`` (serving under a mesh) gathers a
    decode cache's layer before a step uses it and writes this rank's block
    back. ``constrain`` is the identity: the port places tensors by
    ``sharding.NamedSharding`` where a step needs them, with no compiler to
    constrain.
    """
    cfg: ModelConfig
    device: torch.device
    moe_stats: dict | None = None
    mesh: Any = None
    rules: Mapping[str, tuple[str, ...]] | None = None
    batch_axes: tuple[str, ...] = ()
    cache_io: Any = None

    @property
    def dtype(self) -> torch.dtype:
        return torch_dtype(self.cfg.dtype)

    @property
    def batch_shards(self) -> int:
        """How many blocks the global batch is split into."""
        return self.mesh.group_size(self.batch_axes) if self.batch_axes else 1

    def constrain(self, x, logical):
        return x


# ---------------------------------------------------------------- norms

def rmsnorm_schema(dim: int, axes=("embed_act",)) -> ParamSpec:
    return ParamSpec((dim,), axes, init="ones")


def rmsnorm(scale, x, eps: float):
    dt = x.dtype
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale.float()).to(dt)


def layernorm_schema(dim: int):
    return {"scale": ParamSpec((dim,), ("embed_act",), init="ones"),
            "bias": ParamSpec((dim,), ("embed_act",), init="zeros")}


def layernorm(p, x, eps: float):
    dt = x.dtype
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = (x32 - mu).square().mean(-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(dt)


def largest_divisor_leq(n: int, cap: int) -> int:
    """Largest divisor of n that is <= cap (>=1). Used to pick chunk sizes."""
    c = max(1, min(cap, n))
    while n % c:
        c -= 1
    return c


# ---------------------------------------------------------------- rope

def rope(x, positions, theta: float):
    """x: (..., S, H, D); positions: (..., S) int32."""
    if theta <= 0:
        return x
    d = x.shape[-1]
    half = d // 2
    exponent = torch.arange(half, dtype=torch.float32, device=x.device) / half
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                         device=x.device), exponent)
    ang = positions[..., None].float() * freqs  # (..., S, half)
    cos = torch.cos(ang)[..., None, :]  # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------- mlp

def mlp_schema(cfg: ModelConfig, d_ff: int | None = None,
               mlp_axis: str = "mlp") -> dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    gated = cfg.act in ("swiglu", "geglu")
    sch = {
        "w_in": ParamSpec((d, f), ("embed", mlp_axis)),
        "w_out": ParamSpec((f, d), (mlp_axis, "embed")),
    }
    if gated:
        sch["w_gate"] = ParamSpec((d, f), ("embed", mlp_axis))
    return sch


def _act(name: str, x):
    if name == "swiglu":
        return F.silu(x)
    if name == "geglu" or name == "gelu":
        return F.gelu(x, approximate="tanh")
    if name == "relu_sq":
        return torch.relu(x).square()
    raise ValueError(name)


def mlp(p, x, ctx: Ctx, act: str | None = None):
    """x: (B, S, D) -> (B, S, D)."""
    act = act or ctx.cfg.act
    h = x @ p["w_in"].to(x.dtype)
    if "w_gate" in p:
        g = x @ p["w_gate"].to(x.dtype)
        h = _act(act, g) * h
    else:
        h = _act(act, h)
    return h @ p["w_out"].to(x.dtype)


# ---------------------------------------------------------------- embedding / unembed

def embed_schema(cfg: ModelConfig) -> dict:
    sch = {"tokens": ParamSpec((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                               init="embed", scale=0.02)}
    if not cfg.tie_embeddings:
        sch["unembed"] = ParamSpec((cfg.d_model, cfg.vocab_size), ("embed", "vocab"))
    return sch


def embed(p, tokens, ctx: Ctx):
    x = F.embedding(tokens, p["tokens"]).to(ctx.dtype)
    if ctx.cfg.embed_scale:
        # the scale is rounded to the compute dtype first, as the reference's
        x = x * torch.tensor(ctx.cfg.d_model ** 0.5, dtype=ctx.dtype,
                             device=x.device)
    return x


def unembed_matrix(p, ctx: Ctx):
    if "unembed" in p:
        return p["unembed"].to(ctx.dtype)  # (D, V)
    return p["tokens"].t().to(ctx.dtype)


def chunked_softmax_xent(h, unembed_dv, labels, weights, ctx: Ctx):
    """Cross-entropy without materializing (B, S, V) logits.

    h: (B, S, D) final hidden states; unembed_dv: (D, V);
    labels: (B, S) int; weights: (B, S) float (0 for padding).
    Returns (sum_loss, sum_weight), float32 scalars.
    """
    B, S, D = h.shape
    C = largest_divisor_leq(S, ctx.cfg.loss_chunk)
    sum_loss = torch.zeros((), dtype=torch.float32, device=h.device)
    sum_w = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, S, C):
        hs, ls, ws = h[:, i:i + C], labels[:, i:i + C], weights[:, i:i + C]
        logits = (hs @ unembed_dv).float()
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, ls[..., None].long())[..., 0]
        sum_loss = sum_loss + ((lse - gold) * ws).sum()
        sum_w = sum_w + ws.sum()
    return sum_loss, sum_w


def logits_last(h_last, unembed_dv, ctx: Ctx):
    """h_last: (B, D) -> (B, V) logits (for serving)."""
    return (h_last @ unembed_dv).float()
