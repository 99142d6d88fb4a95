"""The port's sequence mixers (``repro_torch.models.ssm``: Mamba2/SSD and
RWKV6) against the reference's, function by function, in float32 at small
widths: the same weights (the reference's ``init_params``, carried as
numpy), inputs and carried states (from a numpy seed). Every output and
every returned state within 1e-5 of its largest entry (float32 sums in
another order). Also the reference's own checks of ``tests/test_ssm.py``
on the port (chunked against the step recurrence, chunk invariance, state
carry), and the reference's non-finite gradients at the configs' chunk
lengths, which the port does not have (ROADMAP C)."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.configs import smoke_config as ref_smoke_config
from repro.configs.base import ModelConfig as RefConfig
from repro.configs.base import ShapeConfig as RefShape
from repro.models import lm as ref_lm
from repro.models import ssm as ref_ssm
from repro.models.layers import Ctx as RefCtx
from repro.models.params import init_params as ref_init_params
from repro_torch.configs import get_arch, smoke_config
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import lm_params_from_arrays
from repro_torch.models import lm, ssm
from repro_torch.models.layers import Ctx
from repro_torch.models.params import init_params, leaves

CPU = torch.device("cpu")
REL = 1e-5
B = 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small torch ops on one thread: test workers share the host, and a
    thread pool per worker oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mamba_cfgs(chunk=8):
    kw = dict(d_model=32, ssm_heads=4, ssm_head_dim=8, ssm_state=8, ssm_chunk=chunk,
              d_conv=4, dtype="float32", param_dtype="float32")
    return RefConfig(**kw), ModelConfig(**kw)


def _rwkv_cfgs(chunk=8):
    kw = dict(d_model=32, rwkv_head_dim=8, rwkv_chunk=chunk, d_ff=64,
              dtype="float32", param_dtype="float32")
    return RefConfig(**kw), ModelConfig(**kw)


def _weights(schema, seed=0):
    """The reference's init, with the zero/one-initialised vectors drawn
    too (so every term of the mixers is exercised): (jax tree, torch tree)."""
    p = ref_init_params(jax.random.key(seed), schema, "float32")
    rng = np.random.default_rng(seed + 100)
    arrays = jax.tree.map(lambda a: np.asarray(a, np.float32)
                          + (0.3 * rng.standard_normal(a.shape).astype(np.float32)
                             if a.ndim == 1 or a.shape == (4, 8) else 0), p)
    return (jax.tree.map(jnp.asarray, arrays),
            jax.tree.map(lambda a: torch.tensor(a), arrays))


def _np(t):
    return t.detach().numpy()


def _close(ours, ref, what=""):
    ref = np.asarray(ref)
    assert _np(ours).shape == ref.shape, what
    np.testing.assert_allclose(_np(ours), ref, rtol=0,
                               atol=REL * np.abs(ref).max(), err_msg=what)


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32) * 0.5


def test_schemas_equal_the_reference():
    for (rc, c), fn, ref_fn in ((_mamba_cfgs(), ssm.mamba2_schema, ref_ssm.mamba2_schema),
                                (_rwkv_cfgs(), ssm.rwkv6_schema, ref_ssm.rwkv6_schema)):
        ours, ref = dict(leaves(fn(c))), dict(leaves(ref_fn(rc)))
        assert set(ours) == set(ref)
        for k in ref:
            assert (ours[k].shape, ours[k].axes, ours[k].init) == \
                (ref[k].shape, ref[k].axes, ref[k].init), k


@pytest.mark.parametrize("carried", [False, True])
def test_causal_conv_and_project_equal_the_reference(carried):
    rc, c = _mamba_cfgs()
    jp, tp = _weights(ref_ssm.mamba2_schema(rc))
    x = _x((B, 12, 32), 1)
    for r, o in zip(ref_ssm._mamba2_project(jp, jnp.asarray(x), RefCtx(rc)),
                    ssm._mamba2_project(tp, torch.tensor(x), Ctx(c, CPU))):
        _close(o, r, "project")
    xbc = _x((B, 12, 48), 2)
    state = _x((B, 3, 48), 3) if carried else None
    y, st = ref_ssm._causal_conv(jnp.asarray(xbc), jp["conv_w"], jp["conv_b"],
                                 None if state is None else jnp.asarray(state))
    ty, tst = ssm._causal_conv(torch.tensor(xbc), tp["conv_w"], tp["conv_b"],
                               None if state is None else torch.tensor(state))
    _close(ty, y, "conv")
    _close(tst, st, "conv state")


@pytest.mark.parametrize("chunk,S", [(8, 24), (16, 16), (5, 20)])
@pytest.mark.parametrize("carried", [False, True])
def test_mamba2_chunked_and_step_equal_the_reference(chunk, S, carried):
    rc, c = _mamba_cfgs(chunk)
    jp, tp = _weights(ref_ssm.mamba2_schema(rc))
    x = _x((B, S, 32), 4)
    conv = _x((B, 3, 48), 5) if carried else None
    h = _x((B, 4, 8, 8), 6) if carried else None
    j = (lambda a: None if a is None else jnp.asarray(a))
    t = (lambda a: None if a is None else torch.tensor(a))
    y, (conv2, h2) = ref_ssm.mamba2_chunked(jp, jnp.asarray(x), RefCtx(rc), j(conv), j(h))
    ty, (tconv2, th2) = ssm.mamba2_chunked(tp, torch.tensor(x), Ctx(c, CPU), t(conv), t(h))
    _close(ty, y, "y")
    _close(tconv2, conv2, "conv state")
    _close(th2, h2, "ssm state")
    conv = conv if carried else np.zeros((B, 3, 48), np.float32)
    h = h if carried else np.zeros((B, 4, 8, 8), np.float32)
    y, (conv2, h2) = ref_ssm.mamba2_step(jp, jnp.asarray(x[:, :1]), RefCtx(rc),
                                         jnp.asarray(conv), jnp.asarray(h))
    ty, (tconv2, th2) = ssm.mamba2_step(tp, torch.tensor(x[:, :1]), Ctx(c, CPU),
                                        torch.tensor(conv), torch.tensor(h))
    _close(ty, y, "step y")
    _close(tconv2, conv2, "step conv")
    _close(th2, h2, "step ssm")


@pytest.mark.parametrize("chunk,S", [(8, 24), (16, 16), (5, 20)])
@pytest.mark.parametrize("carried", [False, True])
def test_rwkv6_time_mix_and_step_equal_the_reference(chunk, S, carried):
    rc, c = _rwkv_cfgs(chunk)
    jp, tp = _weights(ref_ssm.rwkv6_schema(rc)["time"])
    x = _x((B, S, 32), 7)
    shift = _x((B, 32), 8) if carried else None
    wkv = _x((B, 4, 8, 8), 9) if carried else None
    j = (lambda a: None if a is None else jnp.asarray(a))
    t = (lambda a: None if a is None else torch.tensor(a))
    prev = ref_ssm._token_shift(jnp.asarray(x), jnp.asarray(
        shift if carried else np.zeros((B, 32), np.float32)))
    tprev = ssm._token_shift(torch.tensor(x), torch.tensor(
        shift if carried else np.zeros((B, 32), np.float32)))
    _close(tprev, prev, "token shift")
    for name, r, o in zip("rkvgw", ref_ssm._rwkv_time_inputs(jp, jnp.asarray(x), prev, RefCtx(rc)),
                          ssm._rwkv_time_inputs(tp, torch.tensor(x), tprev, Ctx(c, CPU))):
        _close(o, r, f"time input {name}")
    y, (sh2, s2) = ref_ssm.rwkv6_time_mix(jp, jnp.asarray(x), RefCtx(rc), j(shift), j(wkv))
    ty, (tsh2, ts2) = ssm.rwkv6_time_mix(tp, torch.tensor(x), Ctx(c, CPU), t(shift), t(wkv))
    _close(ty, y, "y")
    _close(tsh2, sh2, "shift state")
    _close(ts2, s2, "wkv state")
    shift = shift if carried else np.zeros((B, 32), np.float32)
    wkv = wkv if carried else np.zeros((B, 4, 8, 8), np.float32)
    y, (sh2, s2) = ref_ssm.rwkv6_time_step(jp, jnp.asarray(x[:, :1]), RefCtx(rc),
                                           jnp.asarray(shift), jnp.asarray(wkv))
    ty, (tsh2, ts2) = ssm.rwkv6_time_step(tp, torch.tensor(x[:, :1]), Ctx(c, CPU),
                                          torch.tensor(shift), torch.tensor(wkv))
    _close(ty, y, "step y")
    _close(tsh2, sh2, "step shift")
    _close(ts2, s2, "step wkv")


@pytest.mark.parametrize("carried", [False, True])
def test_rwkv6_channel_mix_equals_the_reference(carried):
    rc, c = _rwkv_cfgs()
    jp, tp = _weights(ref_ssm.rwkv6_schema(rc)["channel"])
    x = _x((B, 10, 32), 10)
    shift = _x((B, 32), 11) if carried else None
    y, sh = ref_ssm.rwkv6_channel_mix(jp, jnp.asarray(x), RefCtx(rc),
                                      None if shift is None else jnp.asarray(shift))
    ty, tsh = ssm.rwkv6_channel_mix(tp, torch.tensor(x), Ctx(c, CPU),
                                    None if shift is None else torch.tensor(shift))
    _close(ty, y, "y")
    _close(tsh, sh, "shift")


# ---------------------------------------------- the reference's checks, ported

def _port_weights(schema, seed=0):
    return init_params(schema, "float32", generator=torch.Generator().manual_seed(seed),
                       device=CPU)


@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_mamba2_chunked_matches_recurrence(chunk):
    _, c = _mamba_cfgs(chunk)
    p = _port_weights(ssm.mamba2_schema(c))
    x = torch.tensor(_x((2, 16, 32), 12))
    y_chunk, (_, h_chunk) = ssm.mamba2_chunked(p, x, Ctx(c, CPU))
    conv = torch.zeros((2, 3, 48))
    h = torch.zeros((2, 4, 8, 8))
    ys = []
    for s in range(16):
        y, (conv, h) = ssm.mamba2_step(p, x[:, s:s + 1], Ctx(c, CPU), conv, h)
        ys.append(y)
    np.testing.assert_allclose(_np(y_chunk), _np(torch.cat(ys, 1)), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(_np(h_chunk), _np(h), atol=1e-4, rtol=1e-4)


def test_mamba2_chunk_invariance_and_state_carry():
    x = torch.tensor(_x((1, 24, 32), 13))
    outs = []
    for chunk in (4, 12, 24):
        _, c = _mamba_cfgs(chunk)
        p = _port_weights(ssm.mamba2_schema(c))
        outs.append(_np(ssm.mamba2_chunked(p, x, Ctx(c, CPU))[0]))
    np.testing.assert_allclose(outs[0], outs[1], atol=1e-4)
    np.testing.assert_allclose(outs[0], outs[2], atol=1e-4)
    full = outs[1]
    y1, (conv, h) = ssm.mamba2_chunked(p, x[:, :16], Ctx(c, CPU))
    y2, _ = ssm.mamba2_chunked(p, x[:, 16:], Ctx(c, CPU), conv_state=conv, ssm_state=h)
    np.testing.assert_allclose(_np(torch.cat([y1, y2], 1)), full, atol=1e-4)


def test_rwkv6_chunked_matches_step_recurrence_and_chunk_invariance():
    _, c = _rwkv_cfgs(8)
    p = _port_weights(ssm.rwkv6_schema(c)["time"])
    x = torch.tensor(_x((2, 16, 32), 14))
    y_chunk, (shift_c, s_chunk) = ssm.rwkv6_time_mix(p, x, Ctx(c, CPU))
    shift, state = torch.zeros((2, 32)), torch.zeros((2, 4, 8, 8))
    ys = []
    for s in range(16):
        y, (shift, state) = ssm.rwkv6_time_step(p, x[:, s:s + 1], Ctx(c, CPU), shift, state)
        ys.append(y)
    np.testing.assert_allclose(_np(y_chunk), _np(torch.cat(ys, 1)), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(_np(s_chunk), _np(state), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(_np(shift_c), _np(shift), atol=1e-6)
    x = torch.tensor(_x((1, 24, 32), 15))
    outs = [_np(ssm.rwkv6_time_mix(p, x, Ctx(c.replace(rwkv_chunk=k), CPU))[0])
            for k in (4, 8, 24)]
    np.testing.assert_allclose(outs[0], outs[1], atol=1e-4)
    np.testing.assert_allclose(outs[0], outs[2], atol=1e-4)


def test_rwkv6_channel_mix_shift():
    _, c = _rwkv_cfgs(8)
    p = _port_weights(ssm.rwkv6_schema(c)["channel"])
    x = torch.tensor(_x((2, 8, 32), 16))
    full, last = ssm.rwkv6_channel_mix(p, x, Ctx(c, CPU))
    assert torch.equal(last, x[:, -1, :])
    shift = torch.zeros((2, 32))
    ys = []
    for s in range(8):
        y, shift = ssm.rwkv6_channel_mix(p, x[:, s:s + 1], Ctx(c, CPU), shift)
        ys.append(y)
    np.testing.assert_allclose(_np(torch.cat(ys, 1)), _np(full), atol=1e-5)


# ---------------------------------------------- gradients at the real chunks

def _non_finite_leaves(tree) -> list[str]:
    return [".".join(p) for p, g in leaves(tree) if not np.isfinite(np.asarray(g)).all()]


@pytest.mark.parametrize("name,field,chunk,ref_bad", [
    ("rwkv6-3b", "rwkv_chunk", 128, 28), ("zamba2-2.7b", "ssm_chunk", 256, 18)])
def test_gradients_are_finite_at_the_real_chunk_where_the_reference_gives_nan(
        name, field, chunk, ref_bad):
    """The reference takes exp of every intra-chunk log-decay difference and
    zeroes the masked ones after; above the diagonal the difference passes
    88.7 at these chunks, exp overflows, and the backward pass gives
    0 * inf = NaN. The port takes the exp of the masked differences. Same
    weights and batch (S = 256, B = 2); the loss agrees."""
    ref_cfg = ref_smoke_config(ref_get_arch(name)).replace(**{field: chunk})
    cfg = smoke_config(get_arch(name)).replace(**{field: chunk})
    params = ref_init_params(jax.random.key(0), ref_lm.model_schema(ref_cfg),
                             ref_cfg.param_dtype)
    batch = ref_lm.make_batch(jax.random.key(1), ref_cfg, RefShape("t", "train", 256, B))
    (ref_loss, _), ref_grads = jax.value_and_grad(ref_lm.loss_fn, has_aux=True)(
        params, batch, RefCtx(ref_cfg))
    ref_grads = jax.tree.map(np.asarray, ref_grads)
    assert np.isfinite(float(ref_loss))
    bad = _non_finite_leaves(ref_grads)
    assert len(bad) == ref_bad and "embed.tokens" in bad      # the pinned fault

    tp = lm_params_from_arrays(cfg, jax.tree.map(lambda a: np.asarray(a, np.float32), params),
                               device="cpu")
    flat = [(p, t.requires_grad_()) for p, t in leaves(tp)]
    loss, _ = lm.loss_fn(tp, {k: torch.tensor(np.asarray(v)) for k, v in batch.items()},
                         Ctx(cfg, CPU))
    grads = torch.autograd.grad(loss, [t for _, t in flat])
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    # where the reference's gradient is finite, it is the port's
    for (path, _), g in zip(flat, grads):
        ref = np.asarray(dict(leaves(ref_grads))[path])
        if np.isfinite(ref).all():
            np.testing.assert_allclose(g.numpy(), ref, rtol=0,
                                       atol=1e-4 * np.abs(ref).max(), err_msg=str(path))
