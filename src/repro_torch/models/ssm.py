"""Sub-quadratic sequence mixers: Mamba2 (SSD) and RWKV6 (Finch).

Both ship two forms sharing weights, as the reference's:
  * chunked-parallel (train / prefill): a Python loop over sequence chunks
    carrying the recurrent state; within-chunk terms are dense products;
  * single-step recurrence (decode): O(1) state update.

Two departures from the reference's arithmetic, neither of which moves a
forward value:
  * The intra-chunk decay matrices take the exp of the masked log-decay
    differences (``-inf`` above the diagonal), where the reference takes
    the exp of every difference and zeroes the masked ones afterwards.
    Above the diagonal a difference is a positive sum of up to a chunk's
    log-decays, whose exp overflows at the configs' chunk lengths; the
    forward pass drops it either way, but the backward pass then multiplies
    a zero cotangent by inf (NaN gradients in the reference, ROADMAP C).
  * The reference's three-operand einsums are written as elementwise
    products followed by one batched matmul, so no (B, Q, K, H, P) tensor
    is built whatever the contraction order.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import Ctx, largest_divisor_leq, rmsnorm
from repro_torch.models.params import ParamSpec

F32 = torch.float32


def _masked_exp(d, mask):
    """exp(d) where ``mask``, 0 elsewhere, with finite gradients (the exp of
    a masked entry is never taken)."""
    return torch.exp(torch.where(mask, d, float("-inf")))


# =====================================================================
# Mamba2 / SSD
# =====================================================================

def mamba2_schema(cfg: ModelConfig) -> dict:
    D = cfg.d_model
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    inner = H * P
    conv_dim = inner + 2 * N
    return {
        "in_proj": ParamSpec((D, 2 * inner + 2 * N + H), ("embed", "heads")),
        "conv_w": ParamSpec((cfg.d_conv, conv_dim), ("conv", "heads")),
        "conv_b": ParamSpec((conv_dim,), ("heads",), init="zeros"),
        "A_log": ParamSpec((H,), ("heads",), init="zeros"),
        "D": ParamSpec((H,), ("heads",), init="ones"),
        "dt_bias": ParamSpec((H,), ("heads",), init="zeros"),
        "norm": ParamSpec((inner,), ("heads",), init="ones"),
        "out_proj": ParamSpec((inner, D), ("heads", "embed")),
    }


def _mamba2_project(p, x, ctx: Ctx):
    cfg = ctx.cfg
    inner, N = cfg.ssm_heads * cfg.ssm_head_dim, cfg.ssm_state
    zxbcdt = x @ p["in_proj"].to(x.dtype)
    return torch.split(zxbcdt, [inner, inner, N, N, cfg.ssm_heads], dim=-1)


def _causal_conv(xbc, conv_w, conv_b, conv_state=None):
    """xbc: (B, S, C); conv_w: (K, C) depthwise causal conv.

    conv_state: (B, K-1, C) trailing inputs from the previous segment (decode).
    Returns (y, new_conv_state).
    """
    K = conv_w.shape[0]
    if conv_state is None:
        pad = xbc.new_zeros((xbc.shape[0], K - 1, xbc.shape[2]))
    else:
        pad = conv_state.to(xbc.dtype)
    xp = torch.cat([pad, xbc], dim=1)  # (B, S+K-1, C)
    S = xbc.shape[1]
    y = sum(xp[:, i:i + S, :] * conv_w[i].to(xbc.dtype) for i in range(K))
    y = F.silu(y + conv_b.to(xbc.dtype))
    new_state = xp[:, -(K - 1):, :] if K > 1 else pad
    return y, new_state


def _ssd_chunk(h, xb, Bk, Ck, la):
    """One SSD chunk. h: (B,H,P,N) carried state; xb: (B,Q,H,P) input
    scaled by dt; Bk, Ck: (B,Q,N); la: (B,Q,H) log decays (<= 0).
    Returns (h_new, y (B,Q,H,P))."""
    Q = xb.shape[1]
    cum = torch.cumsum(la, dim=1)                            # (B,Q,H) inclusive
    # inter-chunk: contribution of the carried state
    y_inter = torch.einsum("bqn,bhpn->bqhp", Ck, h) * torch.exp(cum)[..., None]
    # intra-chunk: masked pairwise decays, (B,Q,K,H) = cum_q - cum_k
    mask = torch.ones((Q, Q), dtype=torch.bool, device=xb.device).tril()
    dmat = _masked_exp(cum[:, :, None, :] - cum[:, None, :, :],
                       mask[None, :, :, None])
    sc = Ck @ Bk.transpose(1, 2)                             # (B,Q,K)
    w = (sc[..., None] * dmat).permute(0, 3, 1, 2)           # (B,H,Q,K)
    y_intra = (w @ xb.permute(0, 2, 1, 3)).permute(0, 2, 1, 3)
    # state update: h' = decay_total * h + sum_k exp(cum_last - cum_k) B_k xb_k
    dk = torch.exp(cum[:, -1:, :] - cum)                     # (B,Q,H)
    xs = (xb * dk[..., None]).permute(0, 2, 3, 1)            # (B,H,P,K)
    h_new = torch.exp(cum[:, -1])[:, :, None, None] * h + xs @ Bk[:, None]
    return h_new, y_inter + y_intra


def mamba2_chunked(p, x, ctx: Ctx, conv_state=None, ssm_state=None):
    """x: (B, S, D) -> (y (B, S, D), (conv_state, ssm_state))."""
    cfg = ctx.cfg
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    B, S, D = x.shape
    inner = H * P
    Q = largest_divisor_leq(S, cfg.ssm_chunk)

    z, xin, Bc, Cc, dt = _mamba2_project(p, x, ctx)
    xbc = torch.cat([xin, Bc, Cc], dim=-1)
    xbc, new_conv = _causal_conv(xbc, p["conv_w"], p["conv_b"], conv_state)
    xin, Bc, Cc = torch.split(xbc, [inner, N, N], dim=-1)

    dt = F.softplus(dt.float() + p["dt_bias"].float())      # (B,S,H)
    loga = -dt * torch.exp(p["A_log"].float())               # log decay per step, <= 0
    xh = xin.reshape(B, S, H, P)
    xdt = xh.float() * dt[..., None]                         # input scaled by dt
    Bf, Cf = Bc.float(), Cc.float()

    h = (torch.zeros((B, H, P, N), dtype=F32, device=x.device)
         if ssm_state is None else ssm_state)
    ys = []
    for i in range(0, S, Q):
        h, y = _ssd_chunk(h, xdt[:, i:i + Q], Bf[:, i:i + Q], Cf[:, i:i + Q],
                          loga[:, i:i + Q])
        ys.append(y)
    y = torch.cat(ys, dim=1)                                 # (B,S,H,P)
    y = y + xh.float() * p["D"].float()[None, None, :, None]
    y = y.reshape(B, S, inner).to(x.dtype)
    y = y * F.silu(z)
    y = rmsnorm(p["norm"], y, cfg.norm_eps)
    out = y @ p["out_proj"].to(x.dtype)
    return out, (new_conv, h)


def mamba2_step(p, x, ctx: Ctx, conv_state, ssm_state):
    """Single-token decode. x: (B, 1, D). States as in mamba2_chunked."""
    cfg = ctx.cfg
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    B = x.shape[0]
    inner = H * P
    z, xin, Bc, Cc, dt = _mamba2_project(p, x, ctx)
    xbc = torch.cat([xin, Bc, Cc], dim=-1)
    xbc, new_conv = _causal_conv(xbc, p["conv_w"], p["conv_b"], conv_state)
    xin, Bc, Cc = torch.split(xbc, [inner, N, N], dim=-1)

    dt = F.softplus(dt[:, 0].float() + p["dt_bias"].float())            # (B,H)
    a = torch.exp(-dt * torch.exp(p["A_log"].float()))                   # (B,H)
    xh = xin[:, 0].reshape(B, H, P).float()
    xdt = xh * dt[..., None]
    Bk = Bc[:, 0].float()  # (B,N)
    Ck = Cc[:, 0].float()
    h_new = a[:, :, None, None] * ssm_state + xdt[..., None] * Bk[:, None, None, :]
    y = (h_new @ Ck[:, None, :, None])[..., 0]                           # (B,H,P)
    y = y + xh * p["D"].float()[None, :, None]
    y = y.reshape(B, 1, inner).to(x.dtype)
    y = y * F.silu(z)
    y = rmsnorm(p["norm"], y, cfg.norm_eps)
    out = y @ p["out_proj"].to(x.dtype)
    return out, (new_conv, h_new)


# =====================================================================
# RWKV6 (Finch)
# =====================================================================

def rwkv6_schema(cfg: ModelConfig) -> dict:
    D = cfg.d_model
    H = D // cfg.rwkv_head_dim
    C = cfg.rwkv_head_dim
    lora = max(32, D // 16)
    return {
        "time": {
            "mu_r": ParamSpec((D,), ("embed_act",), init="zeros"),
            "mu_k": ParamSpec((D,), ("embed_act",), init="zeros"),
            "mu_v": ParamSpec((D,), ("embed_act",), init="zeros"),
            "mu_w": ParamSpec((D,), ("embed_act",), init="zeros"),
            "mu_g": ParamSpec((D,), ("embed_act",), init="zeros"),
            "wr": ParamSpec((D, D), ("embed", "heads")),
            "wk": ParamSpec((D, D), ("embed", "heads")),
            "wv": ParamSpec((D, D), ("embed", "heads")),
            "wg": ParamSpec((D, D), ("embed", "heads")),
            "wo": ParamSpec((D, D), ("heads", "embed")),
            "w0": ParamSpec((D,), ("embed_act",), init="zeros"),
            "w_lora_a": ParamSpec((D, lora), ("embed", None)),
            "w_lora_b": ParamSpec((lora, D), (None, "heads")),
            "u": ParamSpec((H, C), ("heads", None), init="zeros"),
            "ln_scale": ParamSpec((D,), ("embed_act",), init="ones"),
            "ln_bias": ParamSpec((D,), ("embed_act",), init="zeros"),
        },
        "channel": {
            "mu_k": ParamSpec((D,), ("embed_act",), init="zeros"),
            "mu_r": ParamSpec((D,), ("embed_act",), init="zeros"),
            "wk": ParamSpec((D, cfg.d_ff), ("embed", "mlp")),
            "wv": ParamSpec((cfg.d_ff, D), ("mlp", "embed")),
            "wr": ParamSpec((D, D), ("embed", "heads")),
        },
    }


def _token_shift(x, shift_state):
    """x: (B, S, D); shift_state: (B, D) last token of previous segment."""
    return torch.cat([shift_state[:, None, :].to(x.dtype), x[:, :-1, :]], dim=1)


def _rwkv_time_inputs(p, x, prev, ctx: Ctx):
    cfg = ctx.cfg
    H, C = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    dt = x.dtype

    def mix(mu):
        return x + (prev - x) * mu.to(dt)

    r = mix(p["mu_r"]) @ p["wr"].to(dt)
    k = mix(p["mu_k"]) @ p["wk"].to(dt)
    v = mix(p["mu_v"]) @ p["wv"].to(dt)
    g = F.silu(mix(p["mu_g"]) @ p["wg"].to(dt))
    w_dd = mix(p["mu_w"]) @ p["w_lora_a"].to(dt)
    w_dd = torch.tanh(w_dd) @ p["w_lora_b"].to(dt)
    logw = -torch.exp(torch.clamp(p["w0"].float() + w_dd.float(),
                                  -8.0, 4.0))  # (B,S,D), in (-inf, 0)
    B_, S, _ = x.shape
    shp = (B_, S, H, C)
    return (r.reshape(shp), k.reshape(shp), v.reshape(shp), g, logw.reshape(shp))


def _wkv_chunk(state, rq, kq, vq, lw, u):
    """One wkv chunk. state: (B,H,C,C); rq, kq, vq, lw: (B,Q,H,C) float32
    (lw the log decays); u: (H, C). Returns (state_new, y (B,Q,H,C))."""
    Q = rq.shape[1]
    cum = torch.cumsum(lw, dim=1)   # inclusive cumulative log-decay
    # the state seen by token q is decayed by steps 1..q-1 (RWKV applies w
    # before adding token q's kv): the exclusive cumsum
    cum_ex = cum - lw
    y_inter = ((rq * torch.exp(cum_ex)).permute(0, 2, 1, 3) @ state).permute(0, 2, 1, 3)
    # intra-chunk: token k < q contributes decay prod_{i=k+1}^{q-1} w_i
    mask = torch.ones((Q, Q), dtype=torch.bool, device=rq.device).tril(-1)
    A = _masked_exp(cum_ex[:, :, None] - cum[:, None, :],
                    mask[None, :, :, None, None])           # (B,Q,K,H,C)
    sc = (rq[:, :, None] * A * kq[:, None]).sum(-1)          # (B,Q,K,H)
    y_intra = (sc.permute(0, 3, 1, 2) @ vq.permute(0, 2, 1, 3)).permute(0, 2, 1, 3)
    # current token bonus: u
    y_diag = (rq * (u[None, None] * kq)).sum(-1)[..., None] * vq
    # state update to end of chunk
    dk = torch.exp(cum[:, -1:] - cum)  # decay from step k(+1) to chunk end
    kv = (kq * dk).permute(0, 2, 3, 1) @ vq.permute(0, 2, 1, 3)   # (B,H,C,C)
    s_new = torch.exp(cum[:, -1])[..., None] * state + kv
    return s_new, y_inter + y_intra + y_diag


def _group_norm(p, y, H: int, C: int):
    """RWKV's ln_x: normalize each head of (B, S, D), then scale and shift
    (float32 in, float32 out)."""
    B, S, D = y.shape
    yh = y.reshape(B, S, H, C)
    mu = yh.mean(-1, keepdim=True)
    var = yh.var(-1, keepdim=True, correction=0)
    yh = (yh - mu) * torch.rsqrt(var + 64e-5)
    return yh.reshape(B, S, D) * p["ln_scale"].float() + p["ln_bias"].float()


def rwkv6_time_mix(p, x, ctx: Ctx, shift_state=None, wkv_state=None):
    """x: (B, S, D) -> (out, (shift_state, wkv_state)). Chunked-parallel form."""
    cfg = ctx.cfg
    B, S, D = x.shape
    H, C = D // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    Q = largest_divisor_leq(S, cfg.rwkv_chunk)
    if shift_state is None:
        shift_state = x.new_zeros((B, D))
    state = (torch.zeros((B, H, C, C), dtype=F32, device=x.device)
             if wkv_state is None else wkv_state)

    prev = _token_shift(x, shift_state)
    r, k, v, g, logw = _rwkv_time_inputs(p, x, prev, ctx)
    u = p["u"].float()
    r, k, v = r.float(), k.float(), v.float()
    ys = []
    for i in range(0, S, Q):
        state, y = _wkv_chunk(state, r[:, i:i + Q], k[:, i:i + Q],
                              v[:, i:i + Q], logw[:, i:i + Q], u)
        ys.append(y)
    y = torch.cat(ys, dim=1).reshape(B, S, D).to(x.dtype)
    y = _group_norm(p, y.float(), H, C).to(x.dtype)
    y = y * g
    out = y @ p["wo"].to(x.dtype)
    return out, (x[:, -1, :], state)


def rwkv6_time_step(p, x, ctx: Ctx, shift_state, wkv_state):
    """Single-token decode. x: (B, 1, D)."""
    cfg = ctx.cfg
    B, _, D = x.shape
    H, C = D // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    prev = shift_state[:, None, :].to(x.dtype)
    r, k, v, g, logw = _rwkv_time_inputs(p, x, prev, ctx)
    r1, k1, v1 = (a[:, 0].float() for a in (r, k, v))
    w1 = torch.exp(logw[:, 0])  # (B,H,C)
    u = p["u"].float()
    kv = k1[..., None] * v1[..., None, :]                    # (B,H,C,C)
    y = (r1[:, :, None, :] @ (wkv_state + u[None, ..., None] * kv))[:, :, 0]
    s_new = w1[..., None] * wkv_state + kv
    y = _group_norm(p, y.reshape(B, 1, D), H, C).to(x.dtype)
    y = y * g
    out = y @ p["wo"].to(x.dtype)
    return out, (x[:, -1, :], s_new)


def rwkv6_channel_mix(p, x, ctx: Ctx, shift_state=None):
    """RWKV channel-mix FFN with token shift. x: (B,S,D)."""
    if shift_state is None:
        shift_state = x.new_zeros((x.shape[0], x.shape[2]))
    prev = _token_shift(x, shift_state)
    dt = x.dtype

    def mix(mu):
        return x + (prev - x) * mu.to(dt)

    k = torch.relu(mix(p["mu_k"]) @ p["wk"].to(dt)).square()
    vv = k @ p["wv"].to(dt)
    rr = torch.sigmoid(mix(p["mu_r"]) @ p["wr"].to(dt))
    return rr * vv, x[:, -1, :]
