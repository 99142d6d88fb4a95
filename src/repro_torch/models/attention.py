"""GQA attention: flash-style chunked softmax attention (PyTorch tensor code,
never materializes the full score matrix), causal/bidirectional/prefix-LM
masks, KV-cache decode, and an optional causal-block-skip variant.

The reference asks XLA for float32 products of bf16 operands (the scores and
P·V, ``preferred_element_type``). Here the bf16 operands are upcast to
float32 before the product: a bf16 product is exact in float32 and a bf16
value is exact in TF32, so the result does not depend on whether TF32 is on.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import Ctx, largest_divisor_leq, rmsnorm, rope
from repro_torch.models.params import ParamSpec

NEG = -1.0e30


def attention_schema(cfg: ModelConfig) -> dict:
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim()
    sch = {
        "wq": ParamSpec((d, h, dh), ("embed", "heads", "qkv")),
        "wk": ParamSpec((d, kv, dh), ("embed", "kv_heads", "qkv")),
        "wv": ParamSpec((d, kv, dh), ("embed", "kv_heads", "qkv")),
        "wo": ParamSpec((h, dh, d), ("heads", "qkv", "embed")),
    }
    if cfg.qkv_bias:
        sch["bq"] = ParamSpec((h, dh), ("heads", "qkv"), init="zeros")
        sch["bk"] = ParamSpec((kv, dh), ("kv_heads", "qkv"), init="zeros")
        sch["bv"] = ParamSpec((kv, dh), ("kv_heads", "qkv"), init="zeros")
    if cfg.qk_norm:
        sch["q_norm"] = ParamSpec((dh,), (None,), init="ones")
        sch["k_norm"] = ParamSpec((dh,), (None,), init="ones")
    return sch


def _project(x, w):
    """x: (B, S, D); w: (D, H, Dh) -> (B, S, H, Dh)."""
    B, S, _ = x.shape
    D, H, Dh = w.shape
    return (x @ w.to(x.dtype).reshape(D, H * Dh)).reshape(B, S, H, Dh)


def _scaled(x, scale: float):
    """x * scale, the scale rounded to x's dtype first (as XLA does)."""
    return x * torch.tensor(scale, dtype=x.dtype, device=x.device)


def qkv_project(p, xq, xkv, ctx: Ctx, q_positions=None, kv_positions=None,
                use_rope: bool = True):
    """xq: (B, Sq, D); xkv: (B, Skv, D). Returns q (B,Sq,H,Dh), k/v (B,Skv,KV,Dh)."""
    cfg = ctx.cfg
    dt = xq.dtype
    q = _project(xq, p["wq"])
    k = _project(xkv, p["wk"])
    v = _project(xkv, p["wv"])
    if "bq" in p:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    if "q_norm" in p:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    if use_rope and cfg.rope_theta > 0:
        q = rope(q, q_positions, cfg.rope_theta)
        k = rope(k, kv_positions, cfg.rope_theta)
    return q, k, v


def out_project(p, attn_out, ctx: Ctx):
    """attn_out: (B, S, H, Dh) -> (B, S, D)."""
    B, S, H, Dh = attn_out.shape
    wo = p["wo"].to(attn_out.dtype)
    return attn_out.reshape(B, S, H * Dh) @ wo.reshape(H * Dh, wo.shape[-1])


def _mask(qp, kp, causal: bool, prefix_len):
    """qp: (B, cq), kp: (B, ck) -> bool (B, cq, ck). True = attend."""
    if causal:
        m = kp[:, None, :] <= qp[:, :, None]
        if prefix_len is not None:
            m = m | (kp[:, None, :] < prefix_len)
        return m
    return torch.ones((qp.shape[0], qp.shape[1], kp.shape[1]), dtype=torch.bool,
                      device=qp.device)


def flash_attention(q, k, v, q_pos, k_pos, ctx: Ctx, *, causal=True,
                    prefix_len=None):
    """Chunked-softmax attention.

    q: (B, Sq, H, Dh); k, v: (B, Skv, KV, Dh); *_pos: (B, S) int32.
    Loops over (q-chunk x kv-chunk) tiles keeping a running max/denominator
    in fp32, so peak memory is O(cq * ck) per head instead of O(Sq * Skv).
    ``attn_impl='chunked_causal_skip'`` only visits the lower-triangular
    tiles; the dense tiling visits every tile, in the same kv order.
    """
    cfg = ctx.cfg
    B, Sq, H, Dh = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    cq = largest_divisor_leq(Sq, cfg.attn_chunk_q)
    ck = largest_divisor_leq(Skv, cfg.attn_chunk_kv)
    nq, nk = Sq // cq, Skv // ck
    qg = _scaled(q, Dh ** -0.5).reshape(B, nq, cq, KV, G, Dh)
    qp = q_pos.reshape(B, nq, cq)
    kc = k.reshape(B, nk, ck, KV, Dh)
    vc = v.reshape(B, nk, ck, KV, Dh)
    kp = k_pos.reshape(B, nk, ck)
    skip = (cfg.attn_impl == "chunked_causal_skip" and causal
            and prefix_len is None and Sq == Skv and cq == ck)

    outs = []
    for qi in range(nq):
        qcb = qg[:, qi].float()                              # (B, cq, KV, G, Dh)
        qpb = qp[:, qi]
        m = torch.full((B, cq, KV, G), NEG, dtype=torch.float32, device=q.device)
        l = torch.zeros((B, cq, KV, G), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, cq, KV, G, Dh), dtype=torch.float32, device=q.device)
        for ki in range(qi + 1 if skip else nk):
            vcb = vc[:, ki]
            s = torch.einsum("bqvgd,bkvd->bqvgk", qcb, kc[:, ki].float())
            msk = _mask(qpb, kp[:, ki], causal, prefix_len)[:, :, None, None, :]
            s = torch.where(msk, s, NEG)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None]) * msk
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bqvgk,bkvd->bqvgd", p.to(vcb.dtype).float(), vcb.float())
            m = m_new
        l = torch.where(l == 0.0, 1.0, l)
        outs.append((acc / l[..., None]).reshape(B, cq, H, Dh))
    return torch.cat(outs, dim=1).to(q.dtype)


def decode_attention(q, k_cache, v_cache, pos, ctx: Ctx, *, valid_len=None):
    """Single-token attention over a cache.

    q: (B, 1, H, Dh); k_cache/v_cache: (B, Smax, KV, Dh); pos: (B,) int32 —
    index of the current token inside the cache (inclusive upper bound of the
    causal mask). valid_len: optional static bound (cross-attn: no mask).
    A low-precision cache (float8_e4m3fn) is upcast on read: its values are
    exact in q's dtype and in float32.
    """
    B, _, H, Dh = q.shape
    Smax, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    qg = _scaled(q, Dh ** -0.5).reshape(B, KV, G, Dh)
    s = torch.einsum("bvgd,bkvd->bvgk", qg.float(), k_cache.float())  # (B, KV, G, Smax)
    kpos = torch.arange(Smax, dtype=torch.int32, device=q.device)
    if valid_len is None:
        msk = kpos[None, :] <= pos[:, None]  # (B, Smax)
    else:
        msk = (kpos < valid_len)[None, :].expand(B, Smax)
    s = torch.where(msk[:, None, None, :], s, NEG)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bvgk,bkvd->bvgd", p.to(q.dtype).float(), v_cache.float())
    return out.reshape(B, 1, H, Dh).to(q.dtype)


def reference_attention(q, k, v, q_pos, k_pos, *, causal=True, prefix_len=None):
    """O(S^2)-memory oracle used by tests."""
    B, Sq, H, Dh = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, Dh).float() * Dh ** -0.5
    s = torch.einsum("bqvgd,bkvd->bqvgk", qg, k.float())
    msk = _mask(q_pos, k_pos, causal, prefix_len)[:, :, None, None, :]
    s = torch.where(msk, s, NEG)
    p = torch.softmax(s, dim=-1) * msk
    out = torch.einsum("bqvgk,bkvd->bqvgd", p, v.float())
    return out.reshape(B, Sq, H, Dh).to(q.dtype)
