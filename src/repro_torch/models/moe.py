"""GShard/Switch-style MoE: top-k routing with per-group expert capacity.

The routing is the reference's: groups of ``T`` tokens, capacity slots
given first to first choices (k-major), drops at capacity, renormalized
top-k weights and the Switch load-balancing loss. The reference dispatches
with dense (group, token, expert, capacity) one-hot einsums, which stand in
for the scatter a TPU lacks; here tokens are scattered into their expert
slots and gathered back by index. ``dispatch_tensors`` builds the
reference's ``disp``/``comb`` from the same routing, for the tests.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.mesh import gather_rows
from repro_torch.models.layers import Ctx, _act, largest_divisor_leq, mlp
from repro_torch.models.params import ParamSpec


def moe_schema(cfg: ModelConfig) -> dict:
    E, D, F_ = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    gated = cfg.act in ("swiglu", "geglu")
    sch = {
        "router": ParamSpec((D, E), ("embed", None), dtype="float32"),
        "w_in": ParamSpec((E, D, F_), ("expert", "embed", "expert_mlp")),
        "w_out": ParamSpec((E, F_, D), ("expert", "expert_mlp", "embed")),
    }
    if gated:
        sch["w_gate"] = ParamSpec((E, D, F_), ("expert", "embed", "expert_mlp"))
    if cfg.n_shared_experts:
        Fs = cfg.n_shared_experts * cfg.moe_d_ff
        sch["shared"] = {
            "w_in": ParamSpec((D, Fs), ("embed", "mlp")),
            "w_out": ParamSpec((Fs, D), ("mlp", "embed")),
        }
        if gated:
            sch["shared"]["w_gate"] = ParamSpec((D, Fs), ("embed", "mlp"))
        sch["shared_gate"] = ParamSpec((D, 1), ("embed", None))
    return sch


def top_k(gates, k: int):
    """The k largest gates and their experts, ties toward the lower expert
    index (as ``lax.top_k``; ``torch.topk`` does not promise it)."""
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _top_k_dispatch(gates, k: int, capacity: int):
    """gates: (G, T, E) fp32 -> (expert, slot, keep, weight), each (G, T, k).

    ``slot`` is the choice's capacity slot at its expert (slots go first to
    first choices, then by token index); ``keep`` is 1.0 where the slot is
    below ``capacity`` and the gate is positive; ``weight`` = keep * the
    renormalized gate.
    """
    G, T, E = gates.shape
    topv, topi = top_k(gates, k)                             # (G, T, k)
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    # k-major order: (T, k) -> (k, T), so first choices beat second choices
    idx_flat = topi.transpose(1, 2).reshape(G, k * T)
    oh_flat = F.one_hot(idx_flat, E)                         # (G, kT, E) int64
    before = torch.cumsum(oh_flat, dim=1) - oh_flat          # slots before me
    slot = before.gather(-1, idx_flat[..., None])[..., 0]    # (G, kT)
    slot = slot.reshape(G, k, T).transpose(1, 2)             # (G, T, k)
    keep = (slot < capacity).float() * (topv > 0)
    return topi, slot, keep, keep * topv


def dispatch_tensors(expert, slot, keep, weight, n_experts: int, capacity: int):
    """The reference's one-hot ``disp`` and ``comb`` (G, T, E, C) from the
    routing of ``_top_k_dispatch``."""
    onehot = F.one_hot(expert, n_experts).float()                 # (G, T, k, E)
    in_range = (slot < capacity).float()
    slot_oh = F.one_hot(slot.clamp(max=capacity - 1), capacity).float() \
        * in_range[..., None]                                     # (G, T, k, C)
    disp = torch.einsum("gtke,gtkc,gtk->gtec", onehot, slot_oh, keep)
    comb = torch.einsum("gtke,gtkc,gtk->gtec", onehot, slot_oh, weight)
    return disp, comb


def moe_block(p, x, ctx: Ctx):
    """x: (B, S, D) -> (out (B, S, D), aux_loss scalar).

    The groups are formed over the global batch: under a mesh whose batch
    shards each hold a whole number of groups, every rank routes its own
    (the aux loss is then the mean over its groups); where a group spans
    shards, the rank gathers the global batch's tokens over the batch axes
    (differentiably), routes all of them as one device would, and keeps its
    rows (the aux loss is the global one)."""
    n = ctx.batch_shards
    if n > 1:
        B, S, D = x.shape
        if (B * S) % largest_divisor_leq(n * B * S, ctx.cfg.moe_group_size):
            xg = gather_rows(x.reshape(B * S, D), ctx.mesh, ctx.batch_axes)
            out, aux = _moe_block(p, xg.reshape(1, n * B * S, D), ctx)
            i = ctx.mesh.block_index(ctx.batch_axes)
            return out[0, i * B * S:(i + 1) * B * S].reshape(B, S, D), aux
    return _moe_block(p, x, ctx)


def _moe_block(p, x, ctx: Ctx):
    cfg = ctx.cfg
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = largest_divisor_leq(B * S, cfg.moe_group_size)
    G = (B * S) // T
    cap = max(4, int(cfg.capacity_factor * T * k / E))
    xt = x.reshape(G, T, D)

    logits = xt.float() @ p["router"]
    gates = torch.softmax(logits, dim=-1)
    expert, slot, keep, weight = _top_k_dispatch(gates, k, cap)

    # load-balancing aux loss (Switch): E * sum_e f_e * p_e
    kept = torch.zeros((G, E), dtype=torch.float32, device=x.device)
    kept.scatter_add_(1, expert.reshape(G, T * k), keep.reshape(G, T * k))
    f_e = kept / T                                           # (G, E) dispatched frac
    p_e = gates.mean(dim=1)                                  # (G, E)
    aux = (E * (f_e * p_e).sum(-1)).mean() * cfg.router_aux_weight
    if ctx.moe_stats is not None:
        st = ctx.moe_stats                   # (token, choice) pairs
        st["routed"] = st.get("routed", 0) + keep.numel()
        st["kept"] = st.get("kept", 0) + keep.sum()

    # scatter each kept choice's token into its (expert, group, slot); a
    # dropped choice goes to slot ``cap``, which is cut off before the MLP
    dt = x.dtype
    g_idx = torch.arange(G, device=x.device)[:, None, None].expand(G, T, k)
    t_idx = torch.arange(T, device=x.device)[None, :, None].expand(G, T, k)
    to_slot = torch.where(keep > 0, slot, cap)
    expert_in = x.new_zeros((E, G, cap + 1, D))
    expert_in[expert, g_idx, to_slot] = xt[g_idx, t_idx]
    expert_in = expert_in[:, :, :cap].reshape(E, G * cap, D)
    h = torch.bmm(expert_in, p["w_in"].to(dt))
    if "w_gate" in p:
        g = torch.bmm(expert_in, p["w_gate"].to(dt))
        h = _act(cfg.act, g) * h
    else:
        h = _act(cfg.act, h)
    eo = torch.bmm(h, p["w_out"].to(dt)).reshape(E, G, cap, D)
    eo = F.pad(eo, (0, 0, 0, 1))                             # slot cap reads 0
    picked = eo[expert, g_idx, to_slot]                      # (G, T, k, D)
    w = weight.to(dt).float()[..., None]
    out = (picked.float() * w).sum(dim=2).to(dt).reshape(B, S, D)

    if "shared" in p:
        shared = mlp(p["shared"], x, ctx)
        sg = torch.sigmoid(x.float() @ p["shared_gate"].float())
        out = out + shared * sg.to(dt)
    return out, aux
