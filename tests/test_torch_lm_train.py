"""The port's LM training (``repro_torch.optim``, ``train.step``,
``train.loop``, ``data.lm_data``, ``launch.train``) against the reference,
in float32 at smoke widths.

* Optimizers on identical inputs (params, gradients, slots, step): AdamW
  and Adafactor within 1e-6 relative; ``clip_by_global_norm`` and
  ``lr_schedule`` too.
* One whole train step from a state carried across
  (``convert.lm_train_state_from_arrays``): ``loss`` within 1e-5 and
  ``grad_norm`` within 1e-4 (relative); the params within 2 lr(0) of the
  reference's everywhere (a first AdamW step is ~lr sign(g), and float
  noise can flip the sign of a gradient near zero) and within 1e-6
  relative wherever |g| exceeds 1e-3 of its leaf's largest entry (plus
  1e-5 lr(0) absolute, for params near zero: a small gradient entry's
  float error, ~1e-5 of it, moves its first step by as much through
  AdamW's eps); the slots within 1e-4 of their largest entry.
* The reference's ``tests/test_train.py`` on the port: grad-accum
  equivalence, chunked xent, resume (3 + 3 steps equal 6, bit for bit on
  the CPU), deadline preemption, Adafactor's factored slots, data
  determinism with the successor tables equal to the reference's.
* The launcher on the CPU, its refusals, and the card default."""
from __future__ import annotations

import contextlib
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import chip_smoke
from repro.configs import get_arch as ref_get_arch
from repro.configs import smoke_config as ref_smoke_config
from repro.configs.base import ShapeConfig as RefShape
from repro.data import lm_data as ref_lm_data
from repro.models import lm as ref_lm
from repro.models.layers import Ctx as RefCtx
from repro.optim import make_optimizer as ref_make_optimizer
from repro.optim import opt_slot_specs as ref_opt_slot_specs
from repro.optim.optimizers import clip_by_global_norm as ref_clip
from repro.optim.optimizers import lr_schedule as ref_lr_schedule
from repro.models.params import schema_axes as ref_schema_axes
from repro.models.params import schema_shapes as ref_schema_shapes
from repro.train import init_train_state as ref_init_train_state
from repro.train import make_train_step as ref_make_train_step
from repro_torch.configs import get_arch, smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import lm_train_state_from_arrays
from repro_torch.core.api import YdfError
from repro_torch.data import lm_data
from repro_torch.distributed.checkpoint import CheckpointManager
from repro_torch.launch import train as launch_train
from repro_torch.models import lm
from repro_torch.models.layers import Ctx, chunked_softmax_xent, unembed_matrix
from repro_torch.models.params import init_params, leaves, schema_axes, schema_shapes
from repro_torch.optim import (
    clip_by_global_norm,
    global_norm,
    lr_schedule,
    make_optimizer,
    opt_slot_specs,
)
from repro_torch.train import init_train_state, make_train_step, train_state_specs
from repro_torch.train.loop import LoopConfig, train_loop

CPU = torch.device("cpu")
SHAPE = ShapeConfig("t", "train", 64, 4)
CFG = smoke_config(get_arch("qwen2-1.5b"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return {k: _np_tree(v) for k, v in tree.items()} if isinstance(tree, dict) \
        else np.asarray(tree.detach().numpy() if isinstance(tree, torch.Tensor) else tree)


def _torch_tree(tree):
    return {k: _torch_tree(v) for k, v in tree.items()} if isinstance(tree, dict) \
        else torch.tensor(np.asarray(tree))


def _random_like(tree, rng, positive=False, scale=1.0):
    def draw(a):
        a = np.asarray(a)
        x = rng.standard_normal(a.shape).astype(np.float32) * scale
        return np.abs(x) if positive else x
    return jax.tree.map(draw, tree)


# ----------------------------------------------------------------- optimizers

@pytest.mark.parametrize("name,step", [("qwen2-1.5b", 0), ("qwen2-1.5b", 250),
                                       ("grok-1-314b", 0), ("grok-1-314b", 250)])
def test_optimizer_update_equals_the_reference(name, step):
    ref_cfg = ref_smoke_config(ref_get_arch(name))
    cfg = smoke_config(get_arch(name))
    rng = np.random.default_rng(3)
    params = _random_like(ref_schema_shapes(ref_lm.model_schema(ref_cfg), "float32"), rng,
                          scale=0.1)
    grads = _random_like(params, rng, scale=0.01)
    ref_opt = ref_make_optimizer(ref_cfg)
    slots = jax.tree.map(lambda s: np.asarray(s), ref_opt.init(params))
    slots = _random_like(slots, rng, positive=True, scale=1e-4)
    new_p, new_s = ref_opt.update(jax.tree.map(jnp.asarray, grads),
                                  jax.tree.map(jnp.asarray, slots),
                                  jax.tree.map(jnp.asarray, params),
                                  jnp.asarray(step, jnp.int32))
    tparams, tslots = _torch_tree(params), _torch_tree(slots)
    out_p, out_s = make_optimizer(cfg).update(_torch_tree(grads), tslots, tparams,
                                              torch.tensor(step, dtype=torch.int32))
    assert out_p is tparams and out_s is tslots        # written in place
    for (path, ours), (_, ref) in zip(leaves(out_p), leaves(jax.tree.map(np.asarray, new_p))):
        np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-6, atol=0, err_msg=str(path))
    for (path, ours), (_, ref) in zip(leaves(out_s), leaves(jax.tree.map(np.asarray, new_s))):
        np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-6, atol=0, err_msg=str(path))


def test_clip_and_lr_schedule_equal_the_reference():
    rng = np.random.default_rng(4)
    tree = {"a": rng.standard_normal((3, 5)).astype(np.float32),
            "b": {"c": rng.standard_normal(7).astype(np.float32)}}
    for max_norm in (0.5, 100.0):                      # clipped, and not
        ref, ref_n = ref_clip(jax.tree.map(jnp.asarray, tree), max_norm)
        ours, n = clip_by_global_norm(_torch_tree(tree), max_norm)
        np.testing.assert_allclose(n.item(), float(ref_n), rtol=1e-6)
        for (_, o), (_, r) in zip(leaves(ours), leaves(jax.tree.map(np.asarray, ref))):
            np.testing.assert_allclose(o.numpy(), r, rtol=1e-6)
    np.testing.assert_allclose(global_norm(_torch_tree(tree)).item(),
                               np.sqrt(sum(np.square(a).sum() for _, a in leaves(tree))),
                               rtol=1e-6)
    ref_sched, sched = ref_lr_schedule(ref_smoke_config(ref_get_arch("qwen2-1.5b"))), \
        lr_schedule(CFG)
    for step in (0, 1, 50, 99, 100, 101, 5000, 9999, 10_000, 20_000):
        np.testing.assert_allclose(sched(torch.tensor(step, dtype=torch.int32)).item(),
                                   float(ref_sched(jnp.asarray(step, jnp.int32))),
                                   rtol=1e-6)


def test_slot_specs_equal_the_reference_and_adafactor_is_factored():
    for name in ("qwen2-1.5b", "grok-1-314b"):
        ref_cfg, cfg = ref_smoke_config(ref_get_arch(name)), smoke_config(get_arch(name))
        sch, ref_sch = lm.model_schema(cfg), ref_lm.model_schema(ref_cfg)
        specs, axes = opt_slot_specs(cfg, schema_shapes(sch, "float32"), schema_axes(sch))
        ref_specs, ref_axes = ref_opt_slot_specs(ref_cfg, ref_schema_shapes(ref_sch, "float32"),
                                                 ref_schema_axes(ref_sch))
        assert [(p, tuple(s.shape), s.dtype, s.device.type) for p, s in leaves(specs)] == \
            [(p, tuple(s.shape), torch.float32, "meta") for p, s in leaves(ref_specs)]
        assert axes == ref_axes
    slot_elems = sum(int(np.prod(s.shape)) for _, s in leaves(specs))
    param_elems = sum(int(np.prod(s.shape)) for _, s in leaves(schema_shapes(sch, "float32")))
    assert cfg.optimizer == "adafactor" and slot_elems < 0.35 * param_elems
    state_specs, state_axes = train_state_specs(cfg)
    assert state_axes["step"] == () and state_specs["step"].dtype == torch.int32


# ----------------------------------------------------------------- whole step

@pytest.mark.parametrize("name", ["qwen2-1.5b", "grok-1-314b", "rwkv6-3b"])
def test_one_train_step_equals_the_reference(name):
    ref_cfg = ref_smoke_config(ref_get_arch(name))
    cfg = smoke_config(get_arch(name))
    shape = ShapeConfig("t", "train", 32, 2)
    ref_state = ref_init_train_state(jax.random.key(0), ref_cfg)
    # the attention projections at full fan-in (see test_torch_lm_grads.py)
    state = lm_train_state_from_arrays(cfg, _np_tree(ref_state), device="cpu")
    chip_smoke.full_fan_in(state["params"], cfg)
    ref_state = dict(ref_state, params=jax.tree.map(lambda t: jnp.array(t.numpy(), copy=True),
                                                    state["params"]))
    # the gradient test's batch: on others the reference's rwkv6 gradient can
    # be past 1e-4 of a leaf from the port's, the reference's own float32
    # error (test_torch_lm_grads.py pins it)
    batch = ref_lm.make_batch(jax.random.key(5), ref_cfg, RefShape("t", "train", 32, 2))
    (_, _), ref_grads = jax.value_and_grad(ref_lm.loss_fn, has_aux=True)(
        ref_state["params"], batch, RefCtx(ref_cfg))
    ref_new, ref_m = jax.jit(ref_make_train_step(ref_cfg, RefShape("t", "train", 32, 2)).step_fn)(
        ref_state, batch)
    new, m = make_train_step(cfg, shape, device="cpu").jitted()(
        state, {k: torch.tensor(np.asarray(v)) for k, v in batch.items()})
    assert int(new["step"]) == int(ref_new["step"]) == 1
    np.testing.assert_allclose(m["loss"].item(), float(ref_m["loss"]), rtol=1e-5)
    np.testing.assert_allclose(m["grad_norm"].item(), float(ref_m["grad_norm"]), rtol=1e-4)
    assert {"loss", "grad_norm", "ce", "aux", "tokens"} <= set(m)
    lr0 = float(ref_lr_schedule(ref_cfg)(jnp.asarray(0, jnp.int32)))
    ref_p = dict(leaves(jax.tree.map(np.asarray, ref_new["params"])))
    g = dict(leaves(jax.tree.map(np.asarray, ref_grads)))
    for path, ours in leaves(new["params"]):
        ours, ref = ours.numpy(), ref_p[path]
        np.testing.assert_allclose(ours, ref, rtol=0, atol=2 * lr0, err_msg=str(path))
        big = np.abs(g[path]) > 1e-3 * np.abs(g[path]).max()
        np.testing.assert_allclose(ours[big], ref[big], rtol=1e-6, atol=1e-5 * lr0,
                                   err_msg=str(path))
    for path, ours in leaves(new["slots"]):
        ref = np.asarray(dict(leaves(jax.tree.map(np.asarray, ref_new["slots"])))[path])
        np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-4 * np.abs(ref).max(),
                                   err_msg=str(path))


# ----------------------------------------------------------------- remat

@pytest.mark.parametrize("name", ["qwen2-1.5b", "zamba2-2.7b"])
def test_remat_modes_recompute_and_give_the_same_gradients(name, monkeypatch):
    """"none" runs each layer body once; "full" and "dots" run it again in
    the backward pass (zamba2's Mamba2 layers twice more: their scan nests
    in the group's, as the reference's jax.checkpoint calls do), and all
    three give the same gradients bit for bit (the recomputation is the
    same arithmetic)."""
    from repro_torch.models import ssm
    cfg = smoke_config(get_arch(name))
    shape = ShapeConfig("t", "train", 32, 2)
    batch = lm.make_batch(torch.Generator().manual_seed(1), cfg, shape, device="cpu")
    calls = {"attn": 0, "mamba": 0}

    def spy(module, fn, key):
        real = getattr(module, fn)

        def counted(*a, **k):
            calls[key] += 1
            return real(*a, **k)
        monkeypatch.setattr(module, fn, counted)

    spy(lm, "_shared_attn_block" if cfg.family == "hybrid" else "_attn_mlp_block", "attn")
    spy(ssm, "mamba2_chunked", "mamba")
    uses = {"attn": cfg.n_layers // (cfg.attn_every or 1),
            "mamba": cfg.n_layers if cfg.family == "hybrid" else 0}
    runs = {"none": {"attn": 1, "mamba": 1}, "full": {"attn": 2, "mamba": 3},
            "dots": {"attn": 2, "mamba": 3}}
    grads, mms = {}, {}
    for remat in ("none", "full", "dots"):
        c = cfg.replace(remat=remat)
        params = init_params(lm.model_schema(c), "float32", device=CPU,
                             generator=torch.Generator().manual_seed(0))
        flat = [(p, t.requires_grad_()) for p, t in leaves(params)]
        calls.update(attn=0, mamba=0)
        loss, _ = lm.loss_fn(params, batch, Ctx(c, CPU))
        assert calls == uses
        with _CountMatmuls() as counted:
            grads[remat] = torch.autograd.grad(loss, [t for _, t in flat])
        mms[remat] = counted.n
        assert calls == {k: n * runs[remat][k] for k, n in uses.items()}, remat
    for remat in ("full", "dots"):
        assert all(torch.equal(a, b) for a, b in zip(grads["none"], grads[remat]))
    # the backward pass's matmuls: "dots" recomputes none of them (it saved
    # every matmul without batch dims), "full" all of the forward's again
    assert mms["none"] == mms["dots"] < mms["full"]


class _CountMatmuls(TorchDispatchMode):
    """Counts the mm/addmm ops run inside the block."""

    def __enter__(self):
        self.n = 0
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


# ----------------------------------------------------------------- test_train.py, ported

def test_grad_accum_equivalence():
    """accum=2 gives (numerically) the same update as accum=1."""
    s1 = init_train_state(torch.Generator().manual_seed(0), CFG, device="cpu")
    s2 = init_train_state(torch.Generator().manual_seed(0), CFG, device="cpu")
    batch = lm.make_batch(torch.Generator().manual_seed(1), CFG, SHAPE, device="cpu")
    s1, m1 = make_train_step(CFG.replace(grad_accum=1), SHAPE, device="cpu").step_fn(s1, batch)
    s2, m2 = make_train_step(CFG.replace(grad_accum=2), SHAPE, device="cpu").step_fn(s2, batch)
    np.testing.assert_allclose(m1["loss"].item(), m2["loss"].item(), rtol=1e-5)
    for (_, a), (_, b) in zip(leaves(s1["params"]), leaves(s2["params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=3e-5)


def test_chunked_xent_matches_dense():
    cfg = CFG.replace(loss_chunk=16)
    ctx = Ctx(cfg, CPU)
    params = init_params(lm.model_schema(cfg), "float32", device=CPU,
                         generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    Bz, Sz, D, V = 2, 48, cfg.d_model, cfg.vocab_size
    h = torch.randn((Bz, Sz, D), generator=g)
    labels = torch.randint(0, V, (Bz, Sz), generator=g)
    w = torch.ones((Bz, Sz))
    un = unembed_matrix(params["embed"], ctx)
    sl, sw = chunked_softmax_xent(h, un, labels, w, ctx)
    logits = (h @ un).float()
    dense = torch.logsumexp(logits, -1) - torch.gather(logits, -1, labels[..., None])[..., 0]
    np.testing.assert_allclose(sl.item(), dense.sum().item(), rtol=1e-5)
    assert sw.item() == Bz * Sz


def test_train_loop_resume_determinism(tmp_path):
    """3 + 3 steps with a restart == 6 straight steps, bit for bit."""
    quiet = dict(log=lambda *a: None, device="cpu")
    loop6 = LoopConfig(total_steps=6, ckpt_every=3, log_every=100, seed=7)
    out_a = train_loop(CFG, SHAPE, os.path.join(tmp_path, "a"), loop6, **quiet)
    loop3 = LoopConfig(total_steps=3, ckpt_every=3, log_every=100, seed=7)
    train_loop(CFG, SHAPE, os.path.join(tmp_path, "b"), loop3, **quiet)
    logged = []
    out_b = train_loop(CFG, SHAPE, os.path.join(tmp_path, "b"), loop6,
                       log=logged.append, device="cpu")           # resumes at 3
    assert logged == ["resumed from step 3", logged[1]] and logged[1].startswith("step 6:")
    assert out_a["final_step"] == out_b["final_step"] == 6
    assert out_a["losses"][-1] == out_b["losses"][-1]
    sa, _ = CheckpointManager(os.path.join(tmp_path, "a")).restore(6, device="cpu")
    sb, _ = CheckpointManager(os.path.join(tmp_path, "b")).restore(6, device="cpu")
    assert [p for p, _ in leaves(sa)] == [p for p, _ in leaves(sb)]
    for (path, a), (_, b) in zip(leaves(sa), leaves(sb)):
        assert torch.equal(a, b), path
    assert int(sa["step"]) == 6
    # nothing left to run: the state is saved again at its own step
    again = train_loop(CFG, SHAPE, os.path.join(tmp_path, "b"), loop6, **quiet)
    assert again["final_step"] == 6 and CheckpointManager(
        os.path.join(tmp_path, "b")).latest_step() == 6


def test_deadline_preemption(tmp_path):
    loop = LoopConfig(total_steps=10_000, ckpt_every=5, log_every=10_000,
                      deadline_s=1e-3)  # deadline hits right after step 1
    out = train_loop(CFG, SHAPE, str(tmp_path), loop, log=lambda *a: None, device="cpu")
    assert out["preempted"] and out["final_step"] >= 1
    assert CheckpointManager(str(tmp_path)).latest_step() == out["final_step"]


def test_data_pipeline_determinism_and_the_reference_tables():
    b1 = lm_data.batch_at(CFG, SHAPE, 5, seed=3, device="cpu")
    b2 = lm_data.batch_at(CFG, SHAPE, 5, seed=3, device="cpu")
    b3 = lm_data.batch_at(CFG, SHAPE, 6, seed=3, device="cpu")
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert not torch.equal(b1["tokens"], b3["tokens"])
    assert b1["tokens"].dtype == torch.int32 and b1["tokens"].shape == (4, 64)
    assert torch.equal(b1["tokens"][:, 1:], b1["labels"][:, :-1])   # next-token shift
    for vocab, seed in ((128, 3), (151_936, 0)):
        succ, p = lm_data._chain(vocab, seed)
        ref_succ, ref_p = ref_lm_data._chain(vocab, seed)
        np.testing.assert_array_equal(succ, np.asarray(ref_succ))
        np.testing.assert_array_equal(p, np.asarray(ref_p))
        assert succ.dtype == np.int32 and p.dtype == np.float32
    # every transition follows the chain
    succ, _ = lm_data._chain(CFG.vocab_size, 3)
    toks = b1["tokens"].numpy()
    nxt = np.concatenate([toks[:, 1:], b1["labels"][:, -1:].numpy()], 1)
    assert all(nxt[b, t] in succ[toks[b, t]] for b in range(4) for t in range(64))
    for arch, key, shape in (("paligemma-3b", "patches", (4, 8, 64)),
                             ("whisper-large-v3", "frames", (4, 24, 64))):
        cfg = smoke_config(get_arch(arch))
        b = lm_data.batch_at(cfg, SHAPE, 0, device="cpu")
        assert b[key].shape == shape and b[key].dtype == torch.float32
        assert abs(b[key].std().item() - 0.02) < 0.003
        text = SHAPE.seq_len - (cfg.n_patches if cfg.family == "vlm" else 0)
        assert b["tokens"].shape == b["labels"].shape == (4, text)


# ----------------------------------------------------------------- launcher, refusals

def test_launch_train_main_on_the_cpu(tmp_path):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = launch_train.main(["--arch", "rwkv6-3b", "--smoke", "--device", "cpu",
                                 "--steps", "3", "--batch", "2", "--seq", "32",
                                 "--ckpt", str(tmp_path)])
    assert res["final_step"] == 3 and not res["preempted"]
    assert out.getvalue().splitlines()[-1].startswith("done: 3 steps on cpu; last losses: [(")
    assert CheckpointManager(os.path.join(tmp_path, "rwkv6-3b")).all_steps() == [3]


def test_launch_train_refusals(tmp_path):
    base = ["--arch", "qwen2-1.5b", "--smoke", "--device", "cpu", "--ckpt", str(tmp_path)]
    for extra, match in ((["--mesh", "single"], "needs a world of 256 ranks; this one has 1"),
                         (["--mesh", "multi"], "needs a world of 512 ranks; this one has 1"),
                         (["--overlap-flags"], "no counterpart")):
        with pytest.raises(YdfError, match=match):
            launch_train.main(base + extra)
    assert not os.listdir(tmp_path)


def test_mesh_and_rules_are_refused(tmp_path):
    """A mesh must be a process mesh, and rules come with one (training on a
    mesh: tests/test_torch_lm_mesh.py)."""
    for call, match in (
            (lambda: make_train_step(CFG, SHAPE, mesh=object(), rules={}, device="cpu"),
             "not a process mesh"),
            (lambda: make_train_step(CFG, SHAPE, rules={}, device="cpu"), "rules need a mesh"),
            (lambda: train_loop(CFG, SHAPE, str(tmp_path), LoopConfig(total_steps=1),
                                mesh=object(), device="cpu"), "not a process mesh")):
        with pytest.raises(YdfError, match=match):
            call()


def test_a_state_made_in_inference_mode_is_refused():
    with torch.inference_mode():
        with pytest.raises(YdfError, match="inference_mode"):
            init_train_state(torch.Generator(), CFG, device="cpu")
        params = init_params(lm.model_schema(CFG), "float32", device=CPU,
                             generator=torch.Generator().manual_seed(0))
    state = {"params": params, "slots": make_optimizer(CFG).init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    batch = lm.make_batch(torch.Generator().manual_seed(1), CFG, SHAPE, device="cpu")
    with pytest.raises(YdfError, match="inference_mode"):
        make_train_step(CFG, SHAPE, device="cpu").step_fn(state, batch)


def test_entry_points_need_a_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    CheckpointManager(str(tmp_path)).save(1, {"w": torch.ones(2)})
    for call in (lambda: init_train_state(torch.Generator(), CFG),
                 lambda: make_train_step(CFG, SHAPE),
                 lambda: lm_data.batch_at(CFG, SHAPE, 0),
                 lambda: CheckpointManager(str(tmp_path)).restore(1),
                 lambda: train_loop(CFG, SHAPE, str(tmp_path / "x"), LoopConfig()),
                 lambda: lm_train_state_from_arrays(CFG, {}),
                 lambda: launch_train.main(["--arch", "qwen2-1.5b", "--smoke",
                                            "--ckpt", str(tmp_path)])):
        with pytest.raises(YdfError, match="no CUDA device"):
            call()
