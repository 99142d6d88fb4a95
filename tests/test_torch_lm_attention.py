"""The port's attention (``repro_torch.models.attention``) against the
reference's ``flash_attention`` and ``decode_attention`` on the same seeded
numpy inputs, at atol 2e-6 (float32): the cases of ``test_attention.py``
(GQA (4, 4), (4, 2), (8, 1), causal and bidirectional, the prefix-LM mask,
the causal-skip tiling against the dense one, chunking that does not
divide, decode against full attention), decode with ``valid_len``, a
float8 cache upcast on read, the projections, and bf16 operands upcast
before the product."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as RefConfig
from repro.models import attention as RA
from repro.models.layers import Ctx as RefCtx
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models.layers import Ctx

CPU = torch.device("cpu")
ATOL = 2e-6


def _ctxs(**kw):
    return RefCtx(RefConfig(**kw)), Ctx(ModelConfig(**kw), CPU)


def _qkv(seed, B, S, H, KV, D, Skv=None):
    r = np.random.default_rng(seed)
    Skv = Skv or S
    return (r.standard_normal((B, S, H, D)).astype(np.float32),
            r.standard_normal((B, Skv, KV, D)).astype(np.float32),
            r.standard_normal((B, Skv, KV, D)).astype(np.float32))


def _pos(B, S):
    return np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S)).copy()


def _flash(q, k, v, qp, kp, ctxs, **kw):
    rctx, tctx = ctxs
    ref = RA.flash_attention(*map(jnp.asarray, (q, k, v, qp, kp)), rctx, **kw)
    ours = A.flash_attention(*map(torch.from_numpy, (q, k, v, qp, kp)), tctx, **kw)
    return np.asarray(ref), ours.numpy()


@pytest.mark.parametrize("H,KV", [(4, 4), (4, 2), (8, 1)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_matches_the_reference(H, KV, causal):
    B, S, D = 2, 64, 16
    q, k, v = _qkv(0, B, S, H, KV, D)
    ref, ours = _flash(q, k, v, _pos(B, S), _pos(B, S),
                       _ctxs(attn_chunk_q=16, attn_chunk_kv=16), causal=causal)
    np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=0)
    oracle = A.reference_attention(*map(torch.from_numpy, (q, k, v, _pos(B, S), _pos(B, S))),
                                   causal=causal).numpy()
    np.testing.assert_allclose(ours, oracle, atol=2e-5, rtol=2e-5)


def test_reference_attention_matches_the_reference():
    B, S, H, KV, D = 2, 24, 4, 2, 8
    q, k, v = _qkv(5, B, S, H, KV, D)
    for causal, prefix in [(True, None), (True, 6), (False, None)]:
        ref = RA.reference_attention(*map(jnp.asarray, (q, k, v, _pos(B, S), _pos(B, S))),
                                     causal=causal, prefix_len=prefix)
        ours = A.reference_attention(*map(torch.from_numpy, (q, k, v, _pos(B, S), _pos(B, S))),
                                     causal=causal, prefix_len=prefix)
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_prefix_lm_mask():
    B, S, H, KV, D = 1, 32, 2, 2, 8
    q, k, v = _qkv(1, B, S, H, KV, D)
    ref, ours = _flash(q, k, v, _pos(B, S), _pos(B, S),
                       _ctxs(attn_chunk_q=8, attn_chunk_kv=8), causal=True, prefix_len=8)
    np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=0)


def test_causal_skip_matches_the_reference_and_the_dense_tiling():
    B, S, H, KV, D = 2, 64, 4, 2, 16
    q, k, v = _qkv(2, B, S, H, KV, D)
    pos = _pos(B, S)
    skip_ref, skip = _flash(q, k, v, pos, pos, _ctxs(attn_chunk_q=16, attn_chunk_kv=16,
                                                     attn_impl="chunked_causal_skip"))
    _, dense = _flash(q, k, v, pos, pos, _ctxs(attn_chunk_q=16, attn_chunk_kv=16))
    np.testing.assert_allclose(skip, skip_ref, atol=ATOL, rtol=0)
    np.testing.assert_allclose(skip, dense, atol=ATOL, rtol=0)


def test_non_divisible_chunking():
    """S=50 with chunk 16 -> the divisor fallback (10)."""
    B, S, H, KV, D = 1, 50, 2, 1, 8
    q, k, v = _qkv(3, B, S, H, KV, D)
    ref, ours = _flash(q, k, v, _pos(B, S), _pos(B, S),
                       _ctxs(attn_chunk_q=16, attn_chunk_kv=16), causal=True)
    np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=0)


def test_cross_attention_over_a_longer_kv():
    B, S, Skv, H, KV, D = 2, 12, 40, 4, 4, 8
    q, k, v = _qkv(6, B, S, H, KV, D, Skv=Skv)
    ref, ours = _flash(q, k, v, _pos(B, S), _pos(B, Skv),
                       _ctxs(attn_chunk_q=16, attn_chunk_kv=16), causal=False)
    np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=0)


def _decode(q, kc, vc, pos, ctxs, **kw):
    rctx, tctx = ctxs
    ref = RA.decode_attention(*map(jnp.asarray, (q, kc, vc, pos)), rctx, **kw)
    ours = A.decode_attention(*map(torch.from_numpy, (q, kc, vc, pos)), tctx, **kw)
    return np.asarray(ref), ours.numpy()


def test_decode_matches_the_reference_and_full_attention():
    B, S, H, KV, D, Smax = 2, 24, 4, 2, 8, 32
    q, k, v = _qkv(4, B, S, H, KV, D)
    kc = np.pad(k, ((0, 0), (0, Smax - S), (0, 0), (0, 0)))
    vc = np.pad(v, ((0, 0), (0, Smax - S), (0, 0), (0, 0)))
    pos = np.full((B,), S - 1, np.int32)
    ref, ours = _decode(q[:, -1:], kc, vc, pos, _ctxs())
    np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=0)
    full = A.reference_attention(*map(torch.from_numpy, (q, k, v, _pos(B, S), _pos(B, S))))
    np.testing.assert_allclose(ours[:, 0], full[:, -1].numpy(), atol=2e-5, rtol=2e-5)


def test_decode_with_valid_len_and_ragged_positions():
    B, Smax, H, KV, D = 3, 20, 6, 3, 8
    q, kc, vc = _qkv(7, B, 1, H, KV, D, Skv=Smax)
    for kw, pos in [({}, np.array([0, 7, 19], np.int32)),
                    ({"valid_len": 13}, np.array([2, 2, 2], np.int32))]:
        ref, ours = _decode(q, kc, vc, pos, _ctxs(), **kw)
        np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=0)


def test_float8_cache_is_upcast_on_read():
    B, Smax, H, KV, D = 2, 16, 4, 2, 8
    q, kc, vc = _qkv(8, B, 1, H, KV, D, Skv=Smax)
    kc8 = jnp.asarray(kc).astype(jnp.float8_e4m3fn)
    vc8 = jnp.asarray(vc).astype(jnp.float8_e4m3fn)
    pos = jnp.asarray([9, 15], jnp.int32)
    ref = RA.decode_attention(jnp.asarray(q), kc8, vc8, pos, RefCtx(RefConfig()))
    tk8 = torch.from_numpy(np.array(kc8).view(np.uint8)).view(torch.float8_e4m3fn)
    tv8 = torch.from_numpy(np.array(vc8).view(np.uint8)).view(torch.float8_e4m3fn)
    ours = A.decode_attention(torch.from_numpy(q), tk8, tv8, torch.tensor(np.asarray(pos)),
                              Ctx(ModelConfig(), CPU))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_bf16_operands_are_upcast_before_the_product():
    """bf16 q/k/v: the scores and P.V are float32 products of bf16 values in
    both packages (XLA's preferred_element_type, the port's upcast), so the
    outputs agree to bf16 rounding."""
    B, S, H, KV, D = 2, 32, 4, 2, 16
    q, k, v = _qkv(9, B, S, H, KV, D)
    rctx, tctx = _ctxs(attn_chunk_q=8, attn_chunk_kv=16, dtype="bfloat16")
    ref = RA.flash_attention(*[jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)],
                             jnp.asarray(_pos(B, S)), jnp.asarray(_pos(B, S)), rctx)
    ours = A.flash_attention(*[torch.from_numpy(a).bfloat16() for a in (q, k, v)],
                             torch.from_numpy(_pos(B, S)), torch.from_numpy(_pos(B, S)), tctx)
    assert ours.dtype == torch.bfloat16
    ref32 = np.asarray(ref.astype(jnp.float32))
    diff = np.abs(ours.float().numpy() - ref32)
    assert (diff <= 2 ** -7 * np.abs(ref32) + 1e-6).all(), diff.max()


def test_projections():
    r = np.random.default_rng(10)
    cfg = dict(d_model=32, n_heads=4, n_kv_heads=2, head_dim=8, qkv_bias=True, qk_norm=True,
               rope_theta=1e4)
    rctx, tctx = _ctxs(**cfg)
    p = {"wq": (32, 4, 8), "wk": (32, 2, 8), "wv": (32, 2, 8), "wo": (4, 8, 32),
         "bq": (4, 8), "bk": (2, 8), "bv": (2, 8), "q_norm": (8,), "k_norm": (8,)}
    p = {k: r.standard_normal(s).astype(np.float32) / 4 for k, s in p.items()}
    x = r.standard_normal((2, 10, 32)).astype(np.float32)
    xkv = r.standard_normal((2, 6, 32)).astype(np.float32)
    qp, kp = _pos(2, 10), _pos(2, 6) + 3
    ref = RA.qkv_project({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                         jnp.asarray(xkv), rctx, jnp.asarray(qp), jnp.asarray(kp))
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    ours = A.qkv_project(tp, torch.from_numpy(x), torch.from_numpy(xkv), tctx,
                         torch.from_numpy(qp), torch.from_numpy(kp))
    for a, b in zip(ref, ours):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=ATOL, rtol=1e-5)
    o_ref = RA.out_project({"wo": jnp.asarray(p["wo"])}, ref[0], rctx)
    o = A.out_project({"wo": tp["wo"]}, ours[0], tctx)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=ATOL, rtol=1e-5)
