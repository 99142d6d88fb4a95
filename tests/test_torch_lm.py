"""The port's LM serving path (``repro_torch.models.lm``,
``repro_torch.serving.decode``, ``repro_torch.launch.serve``) against the
reference, for the smoke config of every arch, in float32: the
reference's ``init_params`` weights carried across with
``convert.lm_params_from_arrays`` (zamba2's with its shared attention
block's projections at their full fan-in, ``chip_smoke.full_fan_in``: the
reference's draw makes that block's softmax near argmax at the smoke
width, scores of std ~16, and, applied twice, it moves both packages'
hidden states 1.4e-4 from a float64 forward), the reference's
``make_batch`` inputs.
``forward``'s hidden states and the logits of ``prefill`` and one
``decode_step`` within atol 1e-4; the caches within 1e-5 of their largest
value (entries reach ~20, and float32 sums in another order move them by a
few ulps of that); ``greedy_generate``'s tokens equal. Also: the float8
cache's bytes equal the reference's (NaN beyond the format's range, as
ml_dtypes casts), and the refusals (a decode position past the cache, a
mesh, no card)."""
from __future__ import annotations

import contextlib
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.configs import list_archs as ref_list_archs
from repro.configs import smoke_config as ref_smoke_config
from repro.configs.base import ShapeConfig as RefShape
from repro.models import lm as ref_lm
from repro.models.layers import Ctx as RefCtx
from repro.models.params import init_params as ref_init_params
from repro.serving.decode import _embed_cache as ref_embed_cache
from repro.serving.decode import greedy_generate as ref_greedy_generate
from repro_torch.configs import SHAPES, get_arch, smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import lm_params_from_arrays
from repro_torch.core.api import YdfError
from repro_torch.launch import serve as launch_serve
from repro_torch.models import lm
from repro_torch.models.layers import Ctx, logits_last, unembed_matrix
from repro_torch.models.params import init_params
from repro_torch.serving import decode

CPU = torch.device("cpu")
ARCHS = ref_list_archs()
B, S = 2, 32
LOGITS_ATOL = 1e-4
CACHE_REL = 1e-5

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small torch ops on one thread: test workers share the host, and a
    thread pool per worker oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



@pytest.fixture(scope="module")
def built():
    """arch -> (cfg, ref params, port params, ref batch, port batch)."""
    out = {}

    def get(name):
        if name not in out:
            ref_cfg = ref_smoke_config(ref_get_arch(name))
            cfg = smoke_config(get_arch(name))
            params = ref_init_params(jax.random.key(0), ref_lm.model_schema(ref_cfg),
                                     ref_cfg.param_dtype)
            arrays = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
            tp = lm_params_from_arrays(cfg, arrays, device="cpu")
            if cfg.family == "hybrid":
                import chip_smoke
                chip_smoke.full_fan_in(tp, cfg)
                params = jax.tree.map(lambda t: jnp.array(t.numpy(), copy=True), tp)
            batch = ref_lm.make_batch(jax.random.key(2), ref_cfg, RefShape("p", "prefill", S, B))
            tb = {k: torch.tensor(np.asarray(v)) for k, v in batch.items()}
            out[name] = (ref_cfg, cfg, params, tp, batch, tb)
        return out[name]
    return get


def _np(t):
    return t.detach().cpu().numpy()


def _close_cache(ref_cache, cache):
    assert set(ref_cache) == set(cache)
    for k in ref_cache:
        a, b = np.asarray(ref_cache[k]), _np(cache[k])
        assert a.shape == b.shape, k
        if k == "pos":
            np.testing.assert_array_equal(b, a)
        else:
            np.testing.assert_allclose(b, a, rtol=0, atol=CACHE_REL * np.abs(a).max())


@pytest.mark.parametrize("name", ARCHS)
def test_forward_and_prefill_equal_the_reference(name, built):
    ref_cfg, cfg, params, tp, batch, tb = built(name)
    ctx = Ctx(cfg, CPU)
    h, _, aux = ref_lm.forward(params, batch, RefCtx(ref_cfg))
    th, none, taux = lm.forward(tp, tb, ctx)
    assert none is None
    np.testing.assert_allclose(_np(th), np.asarray(h), rtol=0, atol=LOGITS_ATOL)
    np.testing.assert_allclose(taux.item(), float(aux), rtol=1e-5, atol=1e-7)
    logits, cache = ref_lm.prefill(params, batch, RefCtx(ref_cfg))
    tlogits, tcache = lm.prefill(tp, tb, ctx)
    assert tlogits.dtype == torch.float32 and tlogits.shape == (B, cfg.vocab_size)
    np.testing.assert_allclose(_np(tlogits), np.asarray(logits), rtol=0, atol=LOGITS_ATOL)
    _close_cache(cache, tcache)


def _grown(ref_cfg, cfg, cache, tcache, extra=8):
    total = S + (cfg.n_patches if cfg.family == "vlm" else 0)
    cache = jax.tree.map(ref_embed_cache, ref_lm.init_cache(ref_cfg, B, total + extra), cache)
    full = lm.init_cache(cfg, B, total + extra, device="cpu")
    return cache, {k: decode._embed_cache(full[k], tcache[k]) for k in full}


@pytest.mark.parametrize("name", ARCHS)
def test_decode_step_and_greedy_generate_equal_the_reference(name, built):
    ref_cfg, cfg, params, tp, batch, tb = built(name)
    logits, cache = ref_lm.prefill(params, batch, RefCtx(ref_cfg))
    _, tcache = lm.prefill(tp, tb, Ctx(cfg, CPU))
    cache, tcache = _grown(ref_cfg, cfg, cache, tcache)
    tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
    ref_d, ref_next = ref_lm.decode_step(params, {"token": tok}, cache, RefCtx(ref_cfg))
    d, tnext = lm.decode_step(tp, {"token": torch.tensor(np.asarray(tok))}, tcache,
                              Ctx(cfg, CPU))
    np.testing.assert_allclose(_np(d), np.asarray(ref_d), rtol=0, atol=LOGITS_ATOL)
    assert tnext is tcache                  # updated in place
    _close_cache(ref_next, tnext)
    ref_toks = np.asarray(ref_greedy_generate(params, batch, ref_cfg, 8))
    toks = decode.greedy_generate(tp, tb, cfg, 8, device="cpu")
    assert toks.dtype == torch.int32
    np.testing.assert_array_equal(_np(toks), ref_toks)


@pytest.mark.parametrize("name", ARCHS)
def test_decode_consistent_with_forward(name, built):
    """The reference's own check on the port: prefill(S) then decode_step
    == forward(S+1) last-token logits (MoE with ample capacity)."""
    _, cfg, _, tp, _, tb = built(name)
    if cfg.n_experts:
        cfg = cfg.replace(capacity_factor=16.0)
    ctx = Ctx(cfg, CPU)
    logits, cache = lm.prefill(tp, tb, ctx)
    nxt = torch.argmax(logits, -1).to(torch.int32)[:, None]
    total = S + (cfg.n_patches if cfg.family == "vlm" else 0)
    full = lm.init_cache(cfg, B, total + 8, device="cpu")
    cache = {k: decode._embed_cache(full[k], cache[k]) for k in full}
    d, _ = lm.decode_step(tp, {"token": nxt}, cache, ctx)
    h, _, _ = lm.forward(tp, dict(tb, tokens=torch.cat([tb["tokens"], nxt], 1)), ctx)
    ref = logits_last(h[:, -1, :], unembed_matrix(tp["embed"], ctx), ctx)
    np.testing.assert_allclose(_np(d), _np(ref), atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("name", ["qwen2-1.5b", "qwen2-moe-a2.7b", "paligemma-3b"])
def test_loss_fn_equals_the_reference(name, built):
    ref_cfg, cfg, params, tp, _, _ = built(name)
    shape = RefShape("t", "train", S, B)
    batch = ref_lm.make_batch(jax.random.key(5), ref_cfg, shape)
    loss, m = ref_lm.loss_fn(params, batch, RefCtx(ref_cfg))
    tloss, tm = lm.loss_fn(tp, {k: torch.tensor(np.asarray(v)) for k, v in batch.items()},
                           Ctx(cfg, CPU))
    np.testing.assert_allclose(tloss.item(), float(loss), rtol=1e-5)
    for k in ("ce", "aux", "tokens"):
        np.testing.assert_allclose(tm[k].item(), float(m[k]), rtol=1e-5, atol=1e-7)


def test_float8_cast_matches_ml_dtypes_around_448():
    """torch saturates beyond 448; the reference (ml_dtypes) gives NaN above
    464, the half way to the next step. The port follows the reference."""
    v = np.array([448, 449, 456, 460, 463.9, 464, 464.01, 465, 470, 480, 500, 1e4,
                  np.inf, np.nan, 0.1, 1e-3, 1e-9, 0.0, 300.0], np.float32)
    v = np.concatenate([v, -v])
    for dt_name, jdt, tdt in [("float32", jnp.float32, torch.float32),
                              ("bfloat16", jnp.bfloat16, torch.bfloat16)]:
        x = jnp.asarray(v).astype(jdt)
        ref = np.asarray(x.astype(jnp.float8_e4m3fn)).view(np.uint8)
        ours = lm.to_cache_dtype(torch.from_numpy(v).to(tdt), torch.float8_e4m3fn)
        assert ours.dtype == torch.float8_e4m3fn
        # a NaN input keeps its NaN; the sign bit of a NaN is not compared
        nan_in = np.isnan(v)
        np.testing.assert_array_equal(ours.view(torch.uint8).numpy()[~nan_in], ref[~nan_in], dt_name)
        assert np.isnan(ours.float().numpy()[nan_in]).all()
        rounded = torch.from_numpy(v).to(tdt).float().numpy()
        assert np.isnan(ours.float().numpy()[np.abs(rounded) > 464]).all()
    assert torch.equal(lm.to_cache_dtype(torch.ones(3), torch.bfloat16), torch.ones(3).bfloat16())


def test_float8_cache_bytes_equal_the_reference(built):
    ref_cfg, cfg, params, tp, batch, tb = built("qwen2-1.5b")
    ref_cfg8 = ref_cfg.replace(kv_cache_dtype="float8_e4m3fn")
    cfg8 = cfg.replace(kv_cache_dtype="float8_e4m3fn")
    _, cache = ref_lm.prefill(params, batch, RefCtx(ref_cfg8))
    _, tcache = lm.prefill(tp, tb, Ctx(cfg8, CPU))
    cache, tcache = _grown(ref_cfg8, cfg8, cache, tcache, extra=4)
    for k in ("k", "v"):
        assert tcache[k].dtype == torch.float8_e4m3fn
        np.testing.assert_array_equal(tcache[k].view(torch.uint8).numpy(),
                                      np.asarray(cache[k]).view(np.uint8))
    one = jnp.ones((B, 1), jnp.int32)
    ref_d, ref_next = ref_lm.decode_step(params, {"token": one}, cache, RefCtx(ref_cfg8))
    d, tnext = lm.decode_step(tp, {"token": torch.ones((B, 1), dtype=torch.int32)}, tcache,
                              Ctx(cfg8, CPU))
    np.testing.assert_allclose(_np(d), np.asarray(ref_d), rtol=0, atol=LOGITS_ATOL)
    for k in ("k", "v"):
        np.testing.assert_array_equal(tnext[k].view(torch.uint8).numpy(),
                                      np.asarray(ref_next[k]).view(np.uint8))


def test_float8_decode_close_to_bf16_under_the_reference_rule(built):
    """test_models_smoke.py's fp8 check, on its own inputs, in both
    packages: the same argmax and max |delta| < 0.25 against the
    compute-dtype cache. The rule is a property of those inputs: on the
    first 16 tokens of this module's batch both packages' fp8 caches move
    the second row's argmax (75 -> 76, max |delta| ~0.3); the port follows
    the reference there too."""
    ref_cfg, cfg, params, tp, _, _ = built("qwen2-1.5b")
    own = ref_lm.make_batch(jax.random.key(2), ref_cfg, RefShape("p", "prefill", 16, B))
    sliced = {"tokens": ref_lm.make_batch(jax.random.key(2), ref_cfg,
                                          RefShape("p", "prefill", S, B))["tokens"][:, :16]}
    for label, batch in (("own", own), ("sliced", sliced)):
        tb = {k: torch.tensor(np.asarray(v)) for k, v in batch.items()}
        outs = {}
        for kvd in ("", "float8_e4m3fn"):
            rc, c = ref_cfg.replace(kv_cache_dtype=kvd), cfg.replace(kv_cache_dtype=kvd)
            _, cache = ref_lm.prefill(params, batch, RefCtx(rc))
            _, tcache = lm.prefill(tp, tb, Ctx(c, CPU))
            cache = jax.tree.map(ref_embed_cache, ref_lm.init_cache(rc, B, 20), cache)
            full = lm.init_cache(c, B, 20, device="cpu")
            tcache = {k: decode._embed_cache(full[k], tcache[k]) for k in full}
            ref, _ = ref_lm.decode_step(params, {"token": jnp.ones((B, 1), jnp.int32)},
                                        cache, RefCtx(rc))
            ours, _ = lm.decode_step(tp, {"token": torch.ones((B, 1), dtype=torch.int32)},
                                     tcache, Ctx(c, CPU))
            np.testing.assert_allclose(_np(ours), np.asarray(ref), rtol=0, atol=LOGITS_ATOL)
            assert (_np(ours).argmax(-1) == np.asarray(ref).argmax(-1)).all()
            outs[kvd] = _np(ours)
        same = (outs[""].argmax(-1) == outs["float8_e4m3fn"].argmax(-1)).all()
        delta = np.abs(outs[""] - outs["float8_e4m3fn"]).max()
        if label == "own":
            assert same and delta < 0.25
        else:
            assert not same and delta > 0.25


def test_decode_past_the_cache_is_refused(built):
    _, cfg, _, tp, _, tb = built("qwen2-1.5b")
    _, cache = lm.prefill(tp, tb, Ctx(cfg, CPU))
    full = lm.init_cache(cfg, B, S + 1, device="cpu")
    cache = {k: decode._embed_cache(full[k], cache[k]) for k in full}
    tok = {"token": torch.ones((B, 1), dtype=torch.int32)}
    lm.decode_step(tp, tok, cache, Ctx(cfg, CPU))      # writes the last slot
    assert cache["pos"].tolist() == [S + 1] * B
    k_before = cache["k"].clone()
    with pytest.raises(YdfError, match="past the cache"):
        lm.decode_step(tp, tok, cache, Ctx(cfg, CPU))
    assert torch.equal(cache["k"], k_before)           # nothing was written


def test_mesh_and_rules_are_refused(built):
    """A mesh must be a process mesh, and rules come with one (serving on a
    mesh: tests/test_torch_lm_mesh.py)."""
    _, cfg, _, tp, _, tb = built("qwen2-1.5b")
    shape = ShapeConfig("p", "prefill", S, B)
    for call, match in (
            (lambda: decode.make_decode_step(cfg, shape, mesh=object(), rules={},
                                             device="cpu"), "not a process mesh"),
            (lambda: decode.make_prefill(cfg, shape, rules={}, device="cpu"),
             "rules need a mesh"),
            (lambda: decode.greedy_generate(tp, tb, cfg, 2, mesh=object(), device="cpu"),
             "not a process mesh")):
        with pytest.raises(YdfError, match=match):
            call()


def test_entry_points_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    cfg = smoke_config(get_arch("qwen2-1.5b"))
    shape = ShapeConfig("p", "prefill", 8, 1)
    for call in (lambda: lm.init_cache(cfg, 1, 8),
                 lambda: lm.make_batch(torch.Generator(), cfg, shape),
                 lambda: decode.make_prefill(cfg, shape),
                 lambda: decode.make_decode_step(cfg, shape),
                 lambda: decode.greedy_generate({}, {"tokens": torch.zeros(1, 8)}, cfg, 1),
                 lambda: lm.LanguageModel(cfg),
                 lambda: lm_params_from_arrays(cfg, {})):
        with pytest.raises(YdfError, match="no CUDA device"):
            call()


def test_serve_bundles_run_prefill_and_decode_in_inference_mode(built):
    _, cfg, _, tp, _, tb = built("qwen3-8b")
    shape = ShapeConfig("p", "prefill", S, B)
    prefill = decode.make_prefill(cfg, shape, device="cpu")
    step = decode.make_decode_step(cfg, ShapeConfig("d", "decode", S + 4, B), device="cpu")
    logits, cache = prefill(tp, tb)
    assert logits.is_inference()
    ref_logits, ref_cache = lm.prefill(tp, tb, Ctx(cfg, CPU))
    assert torch.equal(logits, ref_logits)
    with torch.inference_mode():
        full = lm.init_cache(cfg, B, S + 4, device="cpu")
        cache = {k: decode._embed_cache(full[k], cache[k]) for k in full}
    nxt = {"token": torch.argmax(logits, -1).to(torch.int32)[:, None]}
    d, cache = step(tp, nxt, cache)
    full = lm.init_cache(cfg, B, S + 4, device="cpu")
    ref_cache = {k: decode._embed_cache(full[k], ref_cache[k]) for k in full}
    ref_d, _ = lm.decode_step(tp, nxt, ref_cache, Ctx(cfg, CPU))
    assert torch.equal(d, ref_d) and cache["pos"].tolist() == [S + 1] * B


def test_language_model_holds_the_params_and_round_trips(built):
    _, cfg, _, tp, _, tb = built("whisper-large-v3")
    model = lm.LanguageModel(cfg, tp, device="cpu")
    sd = model.state_dict()
    assert "dec_layers.cross_attn.wq" in sd and "embed.tokens" in sd
    assert all(not p.requires_grad for p in model.parameters())
    assert sum(p.numel() for p in model.parameters()) == sum(
        v.numel() for v in sd.values())
    fresh = lm.LanguageModel(cfg, device="cpu", generator=torch.Generator().manual_seed(7))
    assert not torch.equal(fresh.state_dict()["embed.tokens"], sd["embed.tokens"])
    fresh.load_state_dict(sd)
    with torch.inference_mode():
        a, _ = model.prefill(tb)
        b, _ = fresh.prefill(tb)
        c, _ = lm.prefill(tp, tb, Ctx(cfg, CPU))
    assert torch.equal(a, b) and torch.equal(a, c)


def test_lm_params_from_arrays_checks_the_tree(built):
    ref_cfg, cfg, params, _, _, _ = built("qwen2-moe-a2.7b")
    arrays = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    bf16 = lm_params_from_arrays(cfg, arrays, device="cpu", dtype="bfloat16")
    assert bf16["layers"]["attn"]["wq"].dtype == torch.bfloat16
    assert bf16["layers"]["moe"]["router"].dtype == torch.float32   # the spec's own
    missing = {k: v for k, v in arrays.items() if k != "final_norm"}
    with pytest.raises(YdfError, match="missing.*final_norm"):
        lm_params_from_arrays(cfg, missing, device="cpu")
    with pytest.raises(YdfError, match="extra.*bogus"):
        lm_params_from_arrays(cfg, dict(arrays, bogus=np.zeros(3, np.float32)), device="cpu")
    bad = jax.tree.map(lambda a: a, arrays)
    bad["final_norm"] = np.ones(cfg.d_model + 1, np.float32)
    with pytest.raises(YdfError, match="final_norm has shape"):
        lm_params_from_arrays(cfg, bad, device="cpu")


def test_specs_equal_the_reference():
    for name in ARCHS:
        ref_cfg, cfg = ref_get_arch(name), get_arch(name)
        for shape_name, shape in SHAPES.items():
            ref = ref_lm.batch_spec(ref_cfg, RefShape(**dataclasses.asdict(shape)))
            ours = lm.batch_spec(cfg, shape)
            assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                    for k, v in ours.items()} == \
                {k: (tuple(v.shape), str(v.dtype)) for k, v in ref.items()}, (name, shape_name)
            assert lm.batch_axes(cfg, shape) == ref_lm.batch_axes(
                ref_cfg, RefShape(**dataclasses.asdict(shape)))
        for kvd in ("", "float8_e4m3fn"):
            ref = ref_lm.cache_spec(ref_cfg.replace(kv_cache_dtype=kvd), 3, 40)
            ours = lm.cache_spec(cfg.replace(kv_cache_dtype=kvd), 3, 40)
            assert all(v.device.type == "meta" for v in ours.values())
            assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                    for k, v in ours.items()} == \
                {k: (tuple(v.shape), str(v.dtype)) for k, v in ref.items()}, name
        assert lm.cache_axes(cfg) == ref_lm.cache_axes(ref_cfg)


def test_make_batch_draws_from_the_generator():
    cfg = smoke_config(get_arch("paligemma-3b"))
    shape = ShapeConfig("p", "prefill", 20, 3)
    a = lm.make_batch(torch.Generator().manual_seed(1), cfg, shape, device="cpu")
    b = lm.make_batch(torch.Generator().manual_seed(1), cfg, shape, device="cpu")
    assert a["tokens"].shape == (3, 12) and a["patches"].shape == (3, 8, cfg.d_model)
    assert a["tokens"].dtype == torch.int32 and 0 <= a["tokens"].min() <= a["tokens"].max() < 128
    assert torch.equal(a["tokens"], b["tokens"]) and torch.equal(a["patches"], b["patches"])
    assert abs(a["patches"].std().item() - 0.02) < 0.005
    p = init_params(lm.model_schema(cfg), cfg.param_dtype, device="cpu",
                    generator=torch.Generator().manual_seed(0))
    toks = decode.greedy_generate(p, a, cfg, 3, device="cpu")
    assert toks.shape == (3, 3)


def test_launch_serve_main_on_the_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        launch_serve.main(["--arch", "qwen2-1.5b", "--smoke", "--device", "cpu",
                           "--batch", "2", "--prompt-len", "16", "--gen", "4"])
    first, second = out.getvalue().splitlines()
    assert first.startswith("qwen2-1.5b: generated 8 tokens in ") and first.endswith(" on cpu")
    assert second.startswith("sample token ids: [") and len(eval(second.split(": ")[1])) == 4
