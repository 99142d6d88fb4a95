"""The LM stack on a mesh (ROADMAP A9.4), on the CPU with gloo.

ONE spawned world of 8 gloo ranks (``chip_smoke.lm_mesh_rank``, which chip
phase 42 runs on the card; its own ``run_world`` deadline, so a hang fails
the test instead of the suite) runs every part of the reference's
``tests/test_distributed_lm.py`` script, with the meshes built over the
same ranks:

* the blocks of ``sharding.NamedSharding`` against the row-major rule of
  ``jax.sharding.NamedSharding``;
* part 1: the train step on (pod, data, model) = (2, 2, 2) against the
  reference's UNSHARDED step (the script's |dloss| < 1e-3: the reference's
  own sharded step fails under jax 0.9.0, ROADMAP C) and the port's
  one-device step (loss and grad norm within 1e-5 relative, params within
  1e-5), for qwen2's and qwen2-moe's smoke configs from the reference's
  state and batch, and qwen2-moe at 6 positions, where an MoE group of 16
  tokens spans the batch shards of 12;
* a planted fault (the gradient of one small param, the q bias, left
  unreduced over the batch axes): the slot gate names that leaf, where
  the loss, grad-norm and params gates alone pass it;
* part 2: a save on (2, 2, 2) restored on (data, model) = (4, 2), every
  leaf equal (a hash of the global tensor from each layout's blocks), and
  a step from it;
* part 3: the int8 hierarchical psum on (pod, data) = (2, 4): within 1.2
  times the quantum, 1e-4 uncompressed;
* part 4: the GPipe pipeline on (rep, stage) = (2, 4) within 1e-5 of the
  sequential stages, 0 < efficiency < 1;
* prefill, decode and ``greedy_generate`` on (2, 2, 2) under SERVE_RULES and
  LONG_DECODE_RULES for five families: within 1e-5 of one device, tokens
  equal (qwen2-moe's decode routes 8 tokens as one group over four batch
  shards of 2);
* ``train_loop`` on (2, 2, 2) stopped, then resumed on (4, 2), equal to a
  straight run.

A world of 1 in process: the (1, 1, 1) step and serving bit for bit against
one device (chip phase 41). And the refusals.
"""
from __future__ import annotations

import functools

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from repro.configs import get_arch as ref_get_arch
from repro.configs import smoke_config as ref_smoke_config
from repro.configs.base import ShapeConfig as RefShape
from repro.models import lm as ref_lm
from repro.train import init_train_state as ref_init_train_state
from repro.train import make_train_step as ref_make_train_step
from repro_torch.configs import get_arch, smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import lm_train_state_from_arrays
from repro_torch.core.api import YdfError
from repro_torch.core.distributed import run_world
from repro_torch.launch.mesh import AbstractMesh, make_mesh
from repro_torch.serving import decode
from repro_torch.sharding import NamedSharding, PartitionSpec, rules_for
from repro_torch.train import make_train_step
from repro_torch.train.loop import LoopConfig, train_loop
from repro_torch.train.pipeline import make_pipeline_fn

CPU = torch.device("cpu")
WORLD = 8
MESH = ((2, 2, 2), ("pod", "data", "model"))
RESTORE = ((4, 2), ("data", "model"))
TRAIN = [("qwen2-1.5b", 8, 64), ("qwen2-moe-a2.7b", 8, 64),
         ("qwen2-moe-a2.7b", 8, 6)]
SERVE = ("qwen2-1.5b", "qwen2-moe-a2.7b", "whisper-large-v3", "zamba2-2.7b",
         "rwkv6-3b")
SERVE_SHAPE = dict(batch=8, prompt=16, gen=8)
LOOP = dict(batch=8, seq=32, steps=4, split=2)
FAULT_LEAF = ("layers", "attn", "bq")
LAYOUT_SPECS = {"rows over (pod, data), cols over model": ((8, 6), (("pod", "data"), "model")),
                "rows over (data, pod)": ((8, 3), (("data", "pod"), None)),
                "cols over (model, data)": ((2, 8), (None, ("model", "data")))}


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.asarray(tree.detach().cpu().numpy() if isinstance(tree, torch.Tensor) else tree)


def _train_case(arch: str, batch: int, seq: int) -> tuple:
    """(the world's case: the reference's initial state and batch as the
    port's arrays, the reference's unsharded loss)."""
    ref_cfg = ref_smoke_config(ref_get_arch(arch))
    cfg = smoke_config(get_arch(arch))
    shape = RefShape("t", "train", seq, batch)
    ref_state = ref_init_train_state(jax.random.key(0), ref_cfg)
    ref_batch = ref_lm.make_batch(jax.random.key(1), ref_cfg, shape)
    ref_next = ref_lm.make_batch(jax.random.key(2), ref_cfg, shape)
    _, m = jax.jit(ref_make_train_step(ref_cfg, shape).step_fn)(ref_state, ref_batch)
    state = lm_train_state_from_arrays(cfg, jax.tree.map(np.asarray, ref_state),
                                       device="cpu")
    case = {"name": f"{arch} S={seq}", "cfg": cfg, "batch": batch, "seq": seq,
            "state": _np(state),
            "batches": [jax.tree.map(np.asarray, b) for b in (ref_batch, ref_next)]}
    return case, float(m["loss"])


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh")
    cases, ref_losses = [], {}
    for arch, b, s in TRAIN:
        case, loss = _train_case(arch, b, s)
        cases.append(case)
        ref_losses[case["name"]] = loss
    serve = [{"name": arch, "cfg": smoke_config(get_arch(arch)),
              "rules": ("serve", "long_decode"), **SERVE_SHAPE} for arch in SERVE]
    loop_cfg = smoke_config(get_arch("qwen2-1.5b"))
    job = {"device": "cpu", "layout": {"mesh": MESH, "specs": LAYOUT_SPECS},
           "train": {"mesh": MESH, "restore_mesh": RESTORE, "dir": str(tmp / "reshard"),
                     "cases": cases},
           "fault": {"mesh": MESH, "case": cases[0], "leaf": FAULT_LEAF},
           "serve": {"mesh": MESH, "cases": serve},
           "psum": {"mesh": ((2, 4), ("pod", "data"))},
           "pipeline": {"mesh": ((2, 4), ("rep", "stage")), "n_micro": 6,
                        "micro_batch": 8, "width": 16, "scale": 0.3},
           "loop": {"mesh": MESH, "resume_mesh": RESTORE, "cfg": loop_cfg,
                    "dir": str(tmp / "loop"), **LOOP}}
    out = run_world(chip_smoke.lm_mesh_rank, WORLD, job, device=CPU, timeout_s=300)
    return out, ref_losses


def _blocks_by_rule(shape, spec) -> np.ndarray:
    """Each rank's block (rank order), by jax's rule: a dimension over
    several mesh axes is cut row-major over them in the spec's order."""
    sizes = dict(zip(MESH[1], MESH[0]))
    x = np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape)
    rows = []
    for r in range(WORLD):
        coords = dict(zip(MESH[1], np.unravel_index(r, MESH[0])))
        block = x
        for d, part in enumerate(spec):
            axes = () if part is None else (part if isinstance(part, tuple) else (part,))
            n, i = 1, 0
            for a in axes:
                n, i = n * sizes[a], i * sizes[a] + coords[a]
            size = shape[d] // n
            block = np.take(block, range(i * size, (i + 1) * size), axis=d)
        rows.append(block.reshape(-1))
    return np.stack(rows)


@pytest.mark.parametrize("name", list(LAYOUT_SPECS))
def test_blocks_follow_the_named_sharding_rule(world, name):
    got = world[0]["layout"][name]
    assert got["rebuilt_on"] == WORLD
    np.testing.assert_array_equal(got["blocks"], _blocks_by_rule(*LAYOUT_SPECS[name]))


@pytest.mark.parametrize("case", [f"{a} S={s}" for a, _, s in TRAIN])
def test_sharded_train_step_equals_the_reference_and_one_device(world, case):
    out, ref_losses = world
    row = out["train"][case]
    assert row["mesh"] == {"pod": 2, "data": 2, "model": 2}
    assert abs(row["loss"] - ref_losses[case]) < 1e-3, (row["loss"], ref_losses[case])
    assert row["loss_rel"] <= 1e-5 and row["grad_norm_rel"] <= 1e-5, row
    assert row["params_max_abs_diff"] <= 1e-5, row
    assert row["slots_leaf_rel"] <= 1e-5, row
    assert row["collective_calls"] > 0 and row["collective_bytes"] > 0


def test_a_leaf_left_unreduced_fails_the_slot_gate(world):
    row = world[0]["fault"]
    for key in ("loss_rel", "grad_norm_rel", "params_max_abs_diff"):
        assert row[key] <= 1e-5, (key, row)
    assert row["slots_leaf_rel"] > 1e-2, row
    assert row["slots_worst_leaf"] in {"/".join(FAULT_LEAF + (s,)) for s in ("m", "v")}
    bad = chip_smoke.mesh_failures({"train": {"fault": row}})
    assert [b[1] for b in bad if b[1] == "slots_leaf_rel"] == ["slots_leaf_rel"], bad


def test_a_state_saved_on_one_mesh_restores_on_another(world):
    re = world[0]["train"][f"{TRAIN[0][0]} S={TRAIN[0][2]}"]["reshard"]
    assert re["saved_on"] == {"pod": 2, "data": 2, "model": 2}
    assert re["restored_on"] == {"data": 4, "model": 2}
    assert re["restored_leaves_differing"] == []
    assert re["loss_rel"] <= 1e-5 and re["grad_norm_rel"] <= 1e-5, re
    assert re["params_max_abs_diff"] <= 1e-5, re
    assert re["slots_leaf_rel"] <= 1e-5, re


def test_the_restore_hash_sees_a_changed_or_moved_entry():
    def hashes():
        mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
        sh = NamedSharding(mesh, PartitionSpec("data", None))
        x = torch.arange(12, dtype=torch.float32).reshape(3, 4)
        changed = x.clone()
        changed[1, 2] = torch.nextafter(changed[1, 2], torch.tensor(100.0))
        return [chip_smoke._tree_hashes({"w": t}, {"w": sh})["w"]
                for t in (x, x.clone(), changed, x.flip(1))]
    same, again, changed, moved = run_world(hashes, 1, device=CPU)
    assert same == again and len({same, changed, moved}) == 3


def test_int8_hierarchical_psum(world):
    ps = world[0]["psum"]
    assert ps["mesh"] == {"pod": 2, "data": 4}
    assert ps["exact"] <= 1e-4
    assert 0 < ps["compressed"] <= 1.2 * ps["quantum"], ps


def test_gpipe_pipeline_equals_the_sequential_stages(world):
    pl = world[0]["pipeline"]
    assert pl["mesh"] == {"rep": 2, "stage": 4}
    assert pl["max_abs_diff"] <= 1e-5
    assert 0 < pl["efficiency"] < 1


@pytest.mark.parametrize("rules", ["serve", "long_decode"])
@pytest.mark.parametrize("arch", SERVE)
def test_serving_on_the_mesh_equals_one_device(world, arch, rules):
    r = world[0]["serve"][arch][rules]
    for key in ("prefill_logits_max_abs_diff", "prefill_cache_max_abs_diff",
                "decode_logits_max_abs_diff"):
        assert r[key] <= 1e-5, (key, r)
    assert r["tokens_equal"]


def test_serving_rules_shard_the_cache_length(world):
    specs = world[0]["serve"]["qwen2-1.5b"]
    assert specs["serve"]["cache_specs"]["k"] == [None, ("pod", "data"), "model", None, None]
    assert specs["long_decode"]["cache_specs"]["k"] == [None, None, ("pod", "data"),
                                                        "model", None]


def test_train_loop_resumes_on_another_mesh(world):
    lp = world[0]["loop"]
    assert [s for s, _ in lp["losses_straight"]] == [1, 2, 3, 4]
    assert lp["losses_resumed"] == lp["losses_straight"][LOOP["split"]:]
    assert lp["max_abs_diff"] <= 1e-6


def test_the_gates_of_phase_42_pass_on_the_rehearsal(world):
    assert chip_smoke.mesh_failures(world[0]) == []


# ------------------------------------------------------- a world of one

@pytest.mark.parametrize("arch", ["qwen2-1.5b", "qwen2-moe-a2.7b"])
def test_a_one_rank_mesh_equals_one_device_bit_for_bit(arch):
    cfg = smoke_config(get_arch(arch))
    row = run_world(chip_smoke.lm_mesh_one_rank, 1, "cpu", cfg, (4, 32), (2, 16),
                    device=CPU)
    assert row["metrics_equal"] and not row["leaves_differing"], row
    assert row["collective_calls"] == 0
    s = row["serve"]
    assert s["prefill_logits_equal"] and s["prefill_cache_equal"] and s["tokens_equal"]


# ------------------------------------------------------- refusals

def test_a_non_mesh_object_is_refused(tmp_path):
    cfg = smoke_config(get_arch("qwen2-1.5b"))
    tshape = ShapeConfig("t", "train", 16, 2)
    pshape = ShapeConfig("p", "prefill", 16, 2)
    calls = {
        "train step": lambda: make_train_step(cfg, tshape, mesh=object(),
                                              rules=rules_for("train"), device="cpu"),
        "abstract mesh": lambda: make_train_step(
            cfg, tshape, AbstractMesh((2, 2), ("data", "model")), rules_for("train"),
            device="cpu"),
        "loop": lambda: train_loop(cfg, tshape, str(tmp_path), LoopConfig(total_steps=1),
                                   mesh=object(), rules=rules_for("train"), device="cpu"),
        "decode": lambda: decode.make_decode_step(cfg, pshape, mesh=object(),
                                                  rules=rules_for("serve"), device="cpu"),
        "prefill": lambda: decode.make_prefill(cfg, pshape, mesh="mesh",
                                               rules=rules_for("serve"), device="cpu"),
        "generate": lambda: decode.greedy_generate({}, {"tokens": torch.zeros(1, 4)}, cfg,
                                                   2, mesh=object(), device="cpu")}
    for name, call in calls.items():
        with pytest.raises(YdfError, match="not a process mesh"):
            call()
    for call in (lambda: make_train_step(cfg, tshape, rules=rules_for("train"), device="cpu"),
                 lambda: decode.make_prefill(cfg, pshape, rules=rules_for("serve"),
                                             device="cpu")):
        with pytest.raises(YdfError, match="rules need a mesh"):
            call()


def test_a_mesh_needs_a_process_group_of_its_size():
    with pytest.raises(YdfError, match="initialized default process group"):
        make_mesh((2, 2), ("data", "model"), device="cpu")
    with pytest.raises(YdfError, match="needs a world of 4 ranks, this one has 1"):
        run_world(functools.partial(make_mesh, device="cpu"), 1, (2, 2), ("data", "model"),
                  device=CPU)


def test_the_pipeline_refuses_gradients():
    pipe = make_pipeline_fn(lambda w, x: x @ w, AbstractMesh((4,), ("stage",)), n_micro=2)
    w = torch.zeros(4, 3, 3, requires_grad=True)
    with pytest.raises(YdfError, match="carry no gradient"):
        pipe(w, torch.zeros(2, 1, 3))
