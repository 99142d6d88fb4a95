"""The port's transformer building blocks (``repro_torch.models.layers``)
against the reference's on the same seeded numpy inputs, in float32, at
rtol 1e-5 and atol 1e-6: the norms, rope, each activation, the MLP, the
embedding (with and without gemma's scale), the unembedding, serving
logits and the chunked cross-entropy."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as RefConfig
from repro.models import layers as R
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

CPU = torch.device("cpu")
TOL = dict(rtol=1e-5, atol=1e-6)


def _ctx(**kw):
    return R.Ctx(RefConfig(dtype="float32", **kw)), L.Ctx(ModelConfig(dtype="float32", **kw), CPU)


def _rng(seed):
    return np.random.default_rng(seed)


def _close(ref, ours, **tol):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(ref), **(tol or TOL))


def test_configs_construct_alike():
    assert dataclasses.asdict(ModelConfig()) == dataclasses.asdict(RefConfig())


def test_rmsnorm():
    r = _rng(0)
    x = r.standard_normal((3, 5, 48)).astype(np.float32) * 3
    scale = r.standard_normal(48).astype(np.float32)
    _close(R.rmsnorm(jnp.asarray(scale), jnp.asarray(x), 1e-6),
           L.rmsnorm(torch.from_numpy(scale), torch.from_numpy(x), 1e-6))


def test_layernorm():
    r = _rng(1)
    x = (r.standard_normal((3, 5, 48)) * 2 + 0.5).astype(np.float32)
    p = {"scale": r.standard_normal(48).astype(np.float32),
         "bias": r.standard_normal(48).astype(np.float32)}
    _close(R.layernorm(jax.tree.map(jnp.asarray, p), jnp.asarray(x), 1e-6),
           L.layernorm({k: torch.from_numpy(v) for k, v in p.items()},
                       torch.from_numpy(x), 1e-6))


def test_largest_divisor_leq():
    for n, cap in [(64, 16), (50, 16), (7, 16), (1, 4), (12, 5), (2048, 512)]:
        assert L.largest_divisor_leq(n, cap) == R.largest_divisor_leq(n, cap)


@pytest.mark.parametrize("theta", [1e4, 1e6, 0.0])
def test_rope(theta):
    r = _rng(2)
    x = r.standard_normal((2, 40, 3, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(40, dtype=np.int32) + 5, (2, 40)).copy()
    _close(R.rope(jnp.asarray(x), jnp.asarray(pos), theta),
           L.rope(torch.from_numpy(x), torch.from_numpy(pos), theta))


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu", "relu_sq"])
def test_activation(act):
    x = np.linspace(-6, 6, 4001, dtype=np.float32)
    _close(R._act(act, jnp.asarray(x)), L._act(act, torch.from_numpy(x)))


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_mlp(act):
    r = _rng(3)
    rc, tc = _ctx(d_model=32, d_ff=80, act=act)
    p = {"w_in": r.standard_normal((32, 80)).astype(np.float32) / 6,
         "w_out": r.standard_normal((80, 32)).astype(np.float32) / 9}
    if act == "swiglu":
        p["w_gate"] = r.standard_normal((32, 80)).astype(np.float32) / 6
    x = r.standard_normal((2, 7, 32)).astype(np.float32)
    _close(R.mlp(jax.tree.map(jnp.asarray, p), jnp.asarray(x), rc),
           L.mlp({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x), tc))


@pytest.mark.parametrize("scale", [False, True])
def test_embed_and_unembed(scale):
    r = _rng(4)
    rc, tc = _ctx(d_model=24, vocab_size=50, embed_scale=scale, tie_embeddings=True)
    table = (r.standard_normal((50, 24)) * 0.02).astype(np.float32)
    toks = r.integers(0, 50, (3, 9)).astype(np.int32)
    _close(R.embed({"tokens": jnp.asarray(table)}, jnp.asarray(toks), rc),
           L.embed({"tokens": torch.from_numpy(table)}, torch.from_numpy(toks), tc))
    _close(R.unembed_matrix({"tokens": jnp.asarray(table)}, rc),
           L.unembed_matrix({"tokens": torch.from_numpy(table)}, tc))
    un = r.standard_normal((24, 50)).astype(np.float32)
    _close(R.unembed_matrix({"tokens": jnp.asarray(table), "unembed": jnp.asarray(un)}, rc),
           L.unembed_matrix({"tokens": torch.from_numpy(table), "unembed": torch.from_numpy(un)}, tc))


def test_embed_scale_is_rounded_to_the_compute_dtype():
    """gemma's sqrt(d_model) multiplies in the compute dtype, as in the
    reference: bf16 embeddings scale by bf16(sqrt(2048))."""
    table = np.linspace(-0.05, 0.05, 64 * 2048, dtype=np.float32).reshape(64, 2048)
    toks = np.arange(64, dtype=np.int32)[None]
    rc = R.Ctx(RefConfig(d_model=2048, embed_scale=True, dtype="bfloat16"))
    tc = L.Ctx(ModelConfig(d_model=2048, embed_scale=True, dtype="bfloat16"), CPU)
    ref = np.asarray(R.embed({"tokens": jnp.asarray(table)}, jnp.asarray(toks), rc).astype(jnp.float32))
    ours = L.embed({"tokens": torch.from_numpy(table)}, torch.from_numpy(toks), tc)
    assert ours.dtype == torch.bfloat16
    np.testing.assert_array_equal(ours.float().numpy(), ref)


def test_logits_last():
    r = _rng(5)
    rc, tc = _ctx()
    h = r.standard_normal((3, 40)).astype(np.float32)
    un = r.standard_normal((40, 70)).astype(np.float32)
    _close(R.logits_last(jnp.asarray(h), jnp.asarray(un), rc),
           L.logits_last(torch.from_numpy(h), torch.from_numpy(un), tc))


@pytest.mark.parametrize("S,chunk", [(32, 8), (30, 8), (16, 512)])
def test_chunked_softmax_xent(S, chunk):
    r = _rng(6)
    rc, tc = _ctx(loss_chunk=chunk)
    h = r.standard_normal((2, S, 24)).astype(np.float32)
    un = r.standard_normal((24, 90)).astype(np.float32) / 5
    labels = r.integers(0, 90, (2, S)).astype(np.int32)
    w = (r.random((2, S)) > 0.2).astype(np.float32)
    ref = R.chunked_softmax_xent(jnp.asarray(h), jnp.asarray(un), jnp.asarray(labels),
                                 jnp.asarray(w), rc)
    ours = L.chunked_softmax_xent(torch.from_numpy(h), torch.from_numpy(un),
                                  torch.from_numpy(labels), torch.from_numpy(w), tc)
    for a, b in zip(ref, ours):
        assert b.dtype == torch.float32
        _close(a, b)
