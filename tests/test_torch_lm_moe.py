"""The port's MoE (``repro_torch.models.moe``) against the reference's on
the same seeded numpy inputs: the routing's ``disp`` exactly equal and
``comb`` within rtol 1e-6 (drops at capacity, ties between gates broken
toward the lower expert as ``lax.top_k`` does), and ``moe_block``'s output
and aux loss within rtol 1e-6 (the output's elements near zero within 1e-6
of its largest: the expert matmuls sum in another order) with and without
shared experts."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.configs import smoke_config as ref_smoke_config
from repro.models import moe as RM
from repro.models.layers import Ctx as RefCtx
from repro.models.params import init_params as ref_init_params
from repro_torch.configs import get_arch, smoke_config
from repro_torch.models import moe as M
from repro_torch.models.layers import Ctx

CPU = torch.device("cpu")


def _routing(gates: np.ndarray, k: int, cap: int):
    ref_disp, ref_comb = RM._top_k_dispatch(jnp.asarray(gates), k, cap)
    routing = M._top_k_dispatch(torch.tensor(gates), k, cap)
    disp, comb = M.dispatch_tensors(*routing, gates.shape[-1], cap)
    return (np.asarray(ref_disp), np.asarray(ref_comb)), (disp.numpy(), comb.numpy()), routing


def _gates(seed, G, T, E):
    r = np.random.default_rng(seed)
    logits = r.standard_normal((G, T, E)).astype(np.float32) * 2
    return np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))


@pytest.mark.parametrize("G,T,E,k,cap", [(2, 16, 4, 2, 4), (3, 24, 8, 2, 5),
                                         (1, 32, 6, 3, 40)])
def test_dispatch_equals_the_reference(G, T, E, k, cap):
    gates = _gates(G * T + E, G, T, E)
    (rd, rc), (d, c), (expert, slot, keep, _) = _routing(gates, k, cap)
    np.testing.assert_array_equal(d, rd)
    np.testing.assert_allclose(c, rc, rtol=1e-6, atol=0)
    dropped = int((keep == 0).sum())
    if cap < T * k / E:       # capacity below the mean load: some drop
        assert dropped > 0
    else:
        assert dropped == 0
    assert int(d.sum()) == keep.numel() - dropped


def test_first_choices_take_capacity_slots_before_second_choices():
    # every token's first choice is expert 0 and its second expert 1, except
    # token 0's, which are swapped. Every first choice takes its slot before
    # any second choice: expert 0 gives slots 0-2 to tokens 1-3 and slot 3
    # to token 0's second choice; expert 1 gives slot 0 to token 0 and slots
    # 1-3 to the second choices of tokens 1-3. Capacity 2 keeps slots 0-1.
    g = np.full((1, 4, 3), 0.1, np.float32)
    g[0, :, 0], g[0, :, 1] = 0.6, 0.3
    g[0, 0] = [0.3, 0.6, 0.1]
    (rd, rc), (d, c), (expert, slot, keep, _) = _routing(g, 2, 2)
    np.testing.assert_array_equal(d, rd)
    np.testing.assert_allclose(c, rc, rtol=1e-6, atol=0)
    assert slot[0, :, 0].tolist() == [0, 0, 1, 2] and keep[0, :, 0].tolist() == [1, 1, 1, 0]
    assert slot[0, :, 1].tolist() == [3, 1, 2, 3] and keep[0, :, 1].tolist() == [0, 1, 0, 0]


def test_tied_gates_break_toward_the_lower_expert_as_lax_top_k():
    r = np.random.default_rng(11)
    vals = np.array([0.3, 0.2, 0.1, 0.05], np.float32)
    # each token draws its gates from four values, so ties are everywhere
    g = vals[r.integers(0, 4, (2, 16, 6))]
    g = (g / g.sum(-1, keepdims=True)).astype(np.float32)
    _, ref_idx = jax.lax.top_k(jnp.asarray(g), 3)
    _, idx = M.top_k(torch.from_numpy(g), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    (rd, rc), (d, c), _ = _routing(g, 3, 4)
    np.testing.assert_array_equal(d, rd)
    np.testing.assert_allclose(c, rc, rtol=1e-6, atol=0)
    # a tie torch.topk breaks the other way: [.3, .3, .2, .2] picks 0 then 1
    assert M.top_k(torch.tensor([[0.3, 0.3, 0.2, 0.2]]), 2)[1].tolist() == [[0, 1]]


@pytest.mark.parametrize("name,cf", [("qwen2-moe-a2.7b", 1.25), ("grok-1-314b", 1.25),
                                     ("qwen2-moe-a2.7b", 16.0)])
def test_moe_block_equals_the_reference(name, cf):
    ref_cfg = ref_smoke_config(ref_get_arch(name)).replace(capacity_factor=cf)
    cfg = smoke_config(get_arch(name)).replace(capacity_factor=cf)
    schema = RM.moe_schema(ref_cfg)
    p = ref_init_params(jax.random.key(3), schema, "float32")
    x = np.random.default_rng(4).standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    ref_out, ref_aux = RM.moe_block(p, jnp.asarray(x), RefCtx(ref_cfg))
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a, np.float32)), p)
    stats = {}
    out, aux = M.moe_block(tp, torch.from_numpy(x), Ctx(cfg, CPU, moe_stats=stats))
    ref_out = np.asarray(ref_out)      # elements near 0: 1e-6 of the largest
    np.testing.assert_allclose(out.numpy(), ref_out, rtol=1e-6,
                               atol=1e-6 * np.abs(ref_out).max())
    np.testing.assert_allclose(aux.item(), float(ref_aux), rtol=1e-6)
    assert ("shared" in tp) == (name == "qwen2-moe-a2.7b")
    assert stats["routed"] == 2 * 32 * cfg.top_k
    kept = int(stats["kept"].item())
    assert (kept < stats["routed"]) == (cf < 2)
