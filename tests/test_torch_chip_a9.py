"""chip_smoke's ROADMAP A9 phases (35-37: lm_parity, lm_serve, lm_families):
CPU rehearsals at a small size, and card checks at a small size.

On the CPU each phase runs every check, the card's side on the CPU too
(the parity phase then compares the CPU with itself); the timings come
from the host clock and the peak memory and decode trace are absent. The
tests marked ``cuda`` need a card and skip without one:

    python -m pytest -q -m cuda tests/test_torch_chip_a9.py
"""
from __future__ import annotations

import pytest
import torch

import chip_smoke as cs
from repro_torch.configs import get_arch, smoke_config

CPU = "cpu"

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small torch ops on one thread: test workers share the host, and a
    thread pool per worker oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _small(cfg):
    """A width that runs in seconds on the CPU: the smoke config's, the
    family's own layout kept (MoE top-k and shared experts, vlm patches,
    whisper's encoder)."""
    s = smoke_config(cfg)
    return s.replace(n_layers=cfg.n_layers, n_enc_layers=min(cfg.n_enc_layers, 2),
                     attn_chunk_q=32, attn_chunk_kv=32, moe_group_size=64)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def test_lm_parity_phase_on_the_cpu():
    out = cs.lm_parity(CPU, archs=("qwen2-1.5b", "qwen2-moe-a2.7b", "whisper-large-v3"),
                       steps=3)
    assert sorted(out) == ["qwen2-1.5b", "qwen2-moe-a2.7b", "whisper-large-v3"]
    for row in out.values():
        assert row["tokens_equal"] and set(row["max_abs_diff"]) >= {
            "h", "logits", "decode", "cache_k", "cache_v"}
        assert all(d == 0.0 for d in row["max_abs_diff"].values())
        assert row["init_params"]["tokens_equal"] and not row["past_tolerance"]
    assert "cache_xk" in out["whisper-large-v3"]["max_abs_diff"]


def test_lm_serve_phase_on_the_cpu():
    cfg = _small(get_arch("qwen2-1.5b")).replace(n_layers=3, dtype="bfloat16",
                                                 param_dtype="bfloat16")
    out = cs.lm_serve(CPU, cfg=cfg, batch=2, prompt=48, gen=4)
    b = out["b_bfloat16_served"]
    assert b["generated"] == 4 and len(b["sample_tokens"]) == 4
    assert b["peak_memory_bytes"] is None and b["decode_step_trace"] == {}
    assert b["bounds"]["decode_ms"] > 0 and b["bounds"]["prefill_flops"] > 0
    assert out["a_float32_decode_vs_forward"]["max_abs_diff"] <= cs.LM_DECODE_TOL
    assert out["c_bfloat16_vs_float32"]["max_over_std"] <= cs.LM_BF16_REL
    assert out["d_float8_cache"]["gated"]["argmax_equal"] == cs.LM_FP8["batch"]


def test_lm_families_phase_on_the_cpu():
    out = cs.lm_families(CPU, batch=2, prompt=40, gen=3, width=_small)
    assert sorted(out) == sorted(cs.LM_FAMILIES)
    moe = out["qwen2-moe-a2.7b"]["moe"]
    assert moe["capacity_factor"] == 1.25 and 0.0 <= moe["dropped_share"] < 1.0
    assert out["paligemma-3b"]["patches"] == 8
    assert out["whisper-large-v3"]["encoder_frames"] == 24
    assert all(r["float32_decode_vs_forward"] <= cs.LM_DECODE_TOL for r in out.values())


def test_full_fan_in_rescales_only_the_attention_projections():
    cfg = smoke_config(get_arch("whisper-large-v3")).replace(dtype="float32")
    raw = cs.lm_weights(cfg, CPU, fan_in=False)
    scaled = cs.lm_weights(cfg, CPU)
    D, H, Dh = cfg.d_model, cfg.n_heads, cfg.resolved_head_dim()
    for key, name in (("enc_layers", "attn"), ("dec_layers", "self_attn"),
                      ("dec_layers", "cross_attn")):
        a, b = raw[key][name], scaled[key][name]
        assert torch.allclose(b["wq"], a["wq"] * (H / D) ** 0.5)
        assert torch.allclose(b["wo"], a["wo"] / H ** 0.5)
        assert torch.equal(b["bq"], a["bq"])
    assert torch.equal(raw["dec_layers"]["mlp"]["w_in"], scaled["dec_layers"]["mlp"]["w_in"])
    assert torch.equal(raw["embed"]["tokens"], scaled["embed"]["tokens"])
    assert Dh == 16


@pytest.mark.cuda
def test_lm_parity_on_the_card(cuda):
    out = cs.lm_parity(cuda, archs=("qwen2-1.5b", "grok-1-314b", "paligemma-3b"), steps=4)
    assert all(r["tokens_equal"] for r in out.values())


@pytest.mark.cuda
def test_lm_serve_on_the_card_at_a_small_size(cuda):
    cfg = get_arch("qwen2-1.5b").replace(n_layers=2)
    out = cs.lm_serve(cuda, cfg=cfg, batch=2, prompt=256, gen=4)
    b = out["b_bfloat16_served"]
    assert b["peak_memory_bytes"] > 0 and b["decode_step_trace"]["kernel_launches"] > 0


@pytest.mark.cuda
def test_lm_families_on_the_card_at_a_small_size(cuda):
    out = cs.lm_families(cuda, layers=1, batch=2, prompt=300, gen=2)
    assert out["qwen2-moe-a2.7b"]["moe"]["experts"] == 60
