"""chip_smoke's phases 38-40 (ROADMAP A9, second part: lm_ssm_parity,
lm_ssm_serve, lm_train): CPU rehearsals at a small size, the bounds from
the full shapes, and card checks at a small size.

On the CPU each phase runs every check (the parity phases compare the CPU
with itself); timings come from the host clock and the peak memory and
decode trace are absent. The tests marked ``cuda`` need a card and skip
without one:

    python -m pytest -q -m cuda tests/test_torch_chip_a9_train.py
"""
from __future__ import annotations

import pytest
import torch

import chip_smoke as cs
from repro_torch.configs import get_arch, smoke_config

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _small_bf16(cfg):
    """The smoke width in the full config's bf16 (zamba2: 4 groups of 2, so
    its bf16 gate runs at LM_SSM_BF16_DEPTH's 6 layers)."""
    s = smoke_config(cfg).replace(dtype="bfloat16", param_dtype="bfloat16")
    return s.replace(n_layers=8) if cfg.family == "hybrid" else s


def _small_real_chunks(cfg):
    """The smoke width with the config's own chunk lengths."""
    return smoke_config(cfg).replace(ssm_chunk=cfg.ssm_chunk, rwkv_chunk=cfg.rwkv_chunk)


def test_lm_ssm_parity_phase_on_the_cpu():
    out = cs.lm_parity(CPU, archs=cs.LM_SSM_ARCHS, steps=3)
    assert sorted(out) == ["rwkv6-3b", "zamba2-2.7b"]
    assert {"cache_conv", "cache_ssm", "cache_k", "cache_v"} <= set(
        out["zamba2-2.7b"]["max_abs_diff"])
    assert {"cache_tshift", "cache_wkv", "cache_cshift"} <= set(
        out["rwkv6-3b"]["max_abs_diff"])
    for row in out.values():
        assert row["tokens_equal"] and not row["past_tolerance"]
        assert all(d == 0.0 for d in row["max_abs_diff"].values())


def test_lm_ssm_serve_phase_on_the_cpu():
    out = cs.lm_ssm_serve(CPU, width=_small_bf16, batch=2, prompt=40, gen=4,
                          check=dict(batch=2, prompt=31))
    assert sorted(out) == ["rwkv6-3b", "zamba2-2.7b"]
    for row in out.values():
        b = row["b_bfloat16_served"]
        assert b["generated"] == 4 and b["peak_memory_bytes"] is None
        assert b["bounds"]["decode_ms"] > 0 and b["bounds"]["prefill_f32_flops"] > 0
        assert row["a_float32_decode_vs_forward"]["max_abs_diff"] <= cs.LM_DECODE_TOL
        assert row["c_bfloat16_vs_float32"]["max_over_std"] <= cs.LM_BF16_REL
        assert row["a_init_params"]["max_abs_diff"] >= 0
    z = out["zamba2-2.7b"]
    assert z["layers"] == 8 and z["c_bfloat16_vs_float32"]["layers"] == 6
    assert "max_over_std" in z["c_bfloat16_vs_float32_full_depth"]
    assert "c_bfloat16_vs_float32_full_depth" not in out["rwkv6-3b"]


def test_ssm_recipes_touch_only_what_they_name():
    cfg = get_arch("zamba2-2.7b").replace(n_layers=12)
    small = smoke_config(cfg).replace(n_layers=12, attn_every=6)
    raw = cs.lm_weights(small, CPU)
    served = cs.lm_ssm_weights(small, CPU)
    s = (2 * 12) ** -0.5
    assert torch.allclose(served["mamba"]["m"]["out_proj"], raw["mamba"]["m"]["out_proj"] * s)
    assert torch.allclose(served["shared"]["mlp"]["w_out"], raw["shared"]["mlp"]["w_out"] * s)
    assert torch.equal(served["mamba"]["m"]["in_proj"], raw["mamba"]["m"]["in_proj"])
    dt = torch.nn.functional.softplus(served["mamba"]["m"]["dt_bias"])
    assert 1e-3 <= dt.min() and dt.max() <= 0.1 + 1e-6
    A = served["mamba"]["m"]["A_log"].exp()
    assert 1 <= A.min() and A.max() <= 16
    rw = cs.lm_ssm_weights(smoke_config(get_arch("rwkv6-3b")), CPU)["layers"]["time"]["w0"]
    assert rw.min() >= -6 and rw.max() <= -1 and torch.allclose(rw[:, 0], torch.full((2,), -6.0))


def test_ssm_serve_bounds_from_the_full_shapes():
    """The decode step's bytes: the bf16 weights (rwkv6's untied token
    table: the batch's rows only), the recurrent states read and written,
    zamba2's 9 KV caches read to the mean position."""
    z = cs.lm_ssm_serve_bounds(get_arch("zamba2-2.7b"), 4, 2048, 32)
    r = cs.lm_ssm_serve_bounds(get_arch("rwkv6-3b"), 4, 2048, 32)
    assert z["weight_bytes"] == 2 * 2_314_535_840
    assert r["weight_bytes"] == 2 * (3_089_295_360 - 65_536 * 2560 + 4 * 2560)
    # ssm states: 54 layers x 4 x 80 heads x 64 x 64 float32, conv 3 x 5248 bf16
    assert z["state_bytes_read_and_written"] == 2 * 54 * 4 * (80 * 64 * 64 * 4 + 3 * 5248 * 2)
    assert z["kv_bytes_read"] == 2 * 9 * 4 * (2048 + 16) * 32 * 80 * 2
    assert r["state_bytes_read_and_written"] == 2 * 32 * 4 * (40 * 64 * 64 * 4 + 2 * 2560 * 2)
    for b in (z, r):
        assert 1.7 < b["decode_ms"] < 1.9 and b["decode_by"] == "bytes"
        assert b["prefill_by"] == "operations"


def test_train_bound_from_the_full_shapes():
    b = cs.lm_train_bound(get_arch("qwen2-1.5b"), 4, 2048)
    assert b["params"] == 1_543_714_304 and b["tokens"] == 8192
    assert b["bf16_flops"] == 8 * 1_543_714_304 * 8192          # tied: the table unembeds
    assert b["by"] == "operations" and 0.15 < b["step_s"] < 0.25


def test_lm_train_phase_on_the_cpu(tmp_path):
    cfg = smoke_config(get_arch("qwen2-1.5b"))
    a = cs.lm_train(CPU, cfg=cfg.replace(dtype="bfloat16", param_dtype="bfloat16"),
                    batch=2, seq=32, steps=3)
    assert a["steps"] == 3 and len(a["losses"]) == 3 and a["peak_memory_bytes"] is None
    assert a["remat"] == "full" and a["bound"]["step_s"] > 0
    b = cs.lm_train_resume(CPU, str(tmp_path), cfg=cfg, batch=2, seq=32)
    assert b["bit_equal"] and b["step_repeats"] and b["checkpoint_bytes"] > 0
    assert b["losses"]["straight"][-1] == b["losses"]["resumed"][-1]
    c = cs.lm_train_ssm(CPU, batch=2, seq=256, width=_small_real_chunks)
    assert c["zamba2-2.7b"]["chunk"] == 256 and c["rwkv6-3b"]["chunk"] == 128
    d = cs.lm_train_parity(CPU, archs=("grok-1-314b", "zamba2-2.7b", "rwkv6-3b"))
    assert all(r["loss_rel"] == 0 and r["params_max_abs_diff"] == 0 for r in d.values())


def test_full_fan_in_rescales_the_shared_block():
    cfg = smoke_config(get_arch("zamba2-2.7b"))
    raw = cs.lm_weights(cfg, CPU, fan_in=False)
    scaled = cs.lm_weights(cfg, CPU)
    D, H = cfg.d_model, cfg.n_heads
    a, b = raw["shared"]["attn"], scaled["shared"]["attn"]
    assert torch.allclose(b["wq"], a["wq"] * (H / D) ** 0.5)
    assert torch.allclose(b["wo"], a["wo"] / H ** 0.5)
    assert torch.equal(raw["mamba"]["m"]["in_proj"], scaled["mamba"]["m"]["in_proj"])


@pytest.mark.cuda
def test_lm_ssm_parity_and_serve_on_the_card(cuda):
    out = cs.lm_parity(cuda, archs=cs.LM_SSM_ARCHS, steps=4)
    assert all(r["tokens_equal"] for r in out.values())
    served = cs.lm_ssm_serve(cuda, width=lambda c: c.replace(
        n_layers=6 if c.family == "hybrid" else 2), batch=2, prompt=256, gen=4,
        check=dict(batch=2, prompt=255))
    assert all(r["b_bfloat16_served"]["decode_step_trace"]["kernel_launches"] > 0
               for r in served.values())


@pytest.mark.cuda
def test_lm_train_on_the_card_at_a_small_size(cuda, tmp_path):
    cfg = get_arch("qwen2-1.5b").replace(n_layers=2)
    a = cs.lm_train(cuda, cfg=cfg, batch=2, seq=256, steps=3)
    assert a["peak_memory_bytes"] > 0
    b = cs.lm_train_resume(cuda, str(tmp_path), cfg=cfg, batch=1, seq=128)
    assert b["bit_equal"]
    d = cs.lm_train_parity(cuda, archs=("qwen2-1.5b", "zamba2-2.7b", "rwkv6-3b"))
    assert len(d) == 3
