"""Distributed training in the port (``repro_torch.core.distributed``)
against the JAX package's ``repro.core.distributed``, on the CPU.

Tolerances, as the reference states its own:
  * the gain machinery: ``split_gain_tensor`` and ``best_split_gh`` equal
    the reference's bit for bit (the port's fixed scan orders are XLA's CPU
    orders); ``_pack_bits`` words, viewed as uint32, equal the reference's;
  * the level step on a world of 1 against ``make_level_step`` on a (1, 1)
    mesh, level by level: feature, bin and partition equal, gain and the
    histogram within rtol 1e-5 (B3's plain version rounds exact sums, the
    reference sums float32);
  * the whole fit against a test-side driver of the reference's level step
    (the reference's own ``fit`` fails at ``distributed.py:168`` under this
    jax, ROADMAP C): feature and bin equal, leaves within rtol 1e-5;
    ``predict_scores_complete`` and ``complete_trees_to_forest`` bit for
    bit;
  * spawned gloo worlds (2, 2), (4, 1), (1, 4) in one world of four ranks
    (one spawn): scores within atol 1e-4 of the world of 1, the reference's
    own rule (``tests/test_distributed_df.py:30-31``), a stop on (2, 2)
    resumed on (4, 1) within 1e-4, the forest served through the CPU
    engine within 1e-4;
  * ``SimulatedCluster``: a faulted run equals the clean run bit for bit,
    ``traffic_bytes`` equals the reference's byte for byte, and the trees
    equal the reference's (feature and bin exactly, gain and leaf within
    rtol 1e-6).
"""
from __future__ import annotations

import functools
import json
import operator
import os
import sys
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import distributed as R
from repro_torch.core import distributed as P
from repro_torch.core.api import YdfError
from repro_torch.train.checkpoint import (
    CheckpointPolicy,
    checkpoint_name,
    latest_checkpoint,
    resume_training,
)

CPU = "cpu"


def _mesh_data(N=2048, F=8, seed=0):
    """The reference script's data (tests/test_distributed_df.py:18-23)."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 64, (N, F)).astype(np.uint8)
    logit = (0.8 * (codes[:, 0] > 30) - 1.2 * (codes[:, 3] > 45)
             + 0.5 * (codes[:, 5] > 10))
    y = (rng.random(N) < 1 / (1 + np.exp(-logit))).astype(np.float64)
    return codes, y


def _hist(rng, nodes, F, B):
    n = rng.integers(0, 20, (nodes, F, B)).astype(np.float32)
    g = (rng.normal(size=(nodes, F, B)) * n).astype(np.float32)
    h = (rng.uniform(0.1, 0.25, size=(nodes, F, B)) * n).astype(np.float32)
    return np.stack([g, h, n], -1)


# ------------------------------------------------------------ gain machinery

@pytest.mark.parametrize("B", [2, 16, 32, 64, 256])
@pytest.mark.parametrize("l2,min_examples", [(0.0, 2), (0.5, 5)])
def test_gain_machinery_equals_the_reference(B, l2, min_examples):
    rng = np.random.default_rng(B)
    hist = _hist(rng, 4, 5, B)
    want = np.asarray(R.split_gain_tensor(jnp.asarray(hist), min_examples, l2))
    got = P.split_gain_tensor(torch.from_numpy(hist), min_examples, l2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    np.testing.assert_array_equal(got.numpy(), want)      # the XLA orders
    rg, rf, rb = (np.asarray(x) for x in
                  R.best_split_gh(jnp.asarray(hist), min_examples, l2))
    pg, pf, pb = (x.numpy() for x in
                  P.best_split_gh(torch.from_numpy(hist), min_examples, l2))
    np.testing.assert_array_equal(pf, rf)
    np.testing.assert_array_equal(pb, rb)
    np.testing.assert_allclose(pg, rg, rtol=1e-6)
    assert pf.dtype == pb.dtype == np.int32


def test_gains_of_a_column_do_not_depend_on_the_batch():
    """The fault-recovery merge's premise: the gains of a column subset are
    the same bits as those columns' slice of the full batch."""
    hist = torch.from_numpy(_hist(np.random.default_rng(3), 3, 9, 64))
    full = P.split_gain_tensor(hist, 2, 0.0)
    for cols in ([4], [0, 8], [1, 2, 5, 7]):
        part = P.split_gain_tensor(hist[:, cols].contiguous(), 2, 0.0)
        assert torch.equal(part, full[:, cols])


def test_ties_go_to_the_smallest_feature_then_bin():
    hist = np.zeros((1, 3, 8, 3), np.float32)
    for f in (1, 2):                   # two equal columns, one empty column
        hist[0, f, :, 2] = 4.0
        hist[0, f, :, 1] = 1.0
        hist[0, f, :4, 0], hist[0, f, 4:, 0] = -1.0, 1.0
    gain, feat, bin_ = P.best_split_gh(torch.from_numpy(hist), 2, 0.0)
    rg, rf, rb = R.best_split_gh(jnp.asarray(hist), 2, 0.0)
    assert (int(feat[0]), int(bin_[0])) == (int(rf[0]), int(rb[0])) == (1, 4)
    assert float(gain[0]) == float(rg[0])


def test_pack_bits_words_equal_the_reference_and_round_trip():
    rng = np.random.default_rng(0)
    for bits in (rng.integers(0, 2, 256).astype(np.int32),
                 np.ones(64, np.int32), np.zeros(32, np.int32),
                 np.eye(32, dtype=np.int32)[31]):     # bit 31 alone
        want = np.asarray(R._pack_bits(jnp.asarray(bits)))
        words = P._pack_bits(torch.from_numpy(bits))
        assert words.dtype == torch.int32
        np.testing.assert_array_equal(words.numpy().view(np.uint32), want)
        np.testing.assert_array_equal(P._unpack_bits(words).numpy(), bits)


def test_summing_words_of_disjoint_owners_is_their_or():
    """The model-axis psum: each row's bit is set on one rank at most."""
    rng = np.random.default_rng(1)
    owner = rng.integers(0, 4, 512)
    bits = rng.integers(0, 2, 512)
    words = [P._pack_bits(torch.from_numpy(((owner == r) & (bits == 1))
                                           .astype(np.int32)))
             for r in range(4)]
    total = torch.stack(words).sum(0, dtype=torch.int32)
    np.testing.assert_array_equal(P._unpack_bits(total).numpy(), bits)


# ------------------------------------------------------------ the level step

def _port_levels(codes, stats, cfg, F):
    mesh = P.Mesh(1, 1, CPU)
    node = torch.zeros(codes.shape[0], dtype=torch.int32)
    out = []
    for d in range(cfg.max_depth):
        step = P.make_level_step(mesh, cfg, 2 ** d, F)
        f, b, g, go, hist = step(torch.from_numpy(codes),
                                 torch.from_numpy(stats), node)
        out.append([x.numpy() for x in (f, b, g, go, hist)])
        go = torch.where(torch.isfinite(g)[node.clamp(min=0).long()], go, 0)
        node = node * 2 + go
    return out


def test_level_step_equals_the_reference_level_by_level():
    codes, y = _mesh_data()
    N, F = codes.shape
    g, h = R._grad_hess(np.full(N, R._init_pred(y, "binary")), y, "binary")
    stats = np.stack([g, h, np.ones(N)], 1).astype(np.float32)
    cfg_r = R.DistGBTConfig(max_depth=4, n_bins=64)
    cfg_p = P.DistGBTConfig(max_depth=4, n_bins=64)
    hook = sys.excepthook
    got = P.run_world(_port_levels, 1, codes, stats, cfg_p, F, device=CPU)
    assert sys.excepthook is hook       # the in-process world left no trace
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    node = np.zeros(N, np.int32)
    for d in range(cfg_r.max_depth):
        f, b, gain, go, hist = (np.asarray(x) for x in R.make_level_step(
            mesh, cfg_r, 2 ** d, F)(jnp.asarray(codes), jnp.asarray(stats),
                                    jnp.asarray(node)))
        pf, pb, pg, pgo, ph = got[d]
        np.testing.assert_array_equal(pf, f)
        np.testing.assert_array_equal(pb, b)
        np.testing.assert_array_equal(pgo, go)
        np.testing.assert_allclose(pg, gain, rtol=1e-5)
        np.testing.assert_allclose(ph, hist, rtol=1e-5)
        go = np.where(np.isfinite(gain)[node.clip(0)], go, 0)
        node = np.where(node >= 0, node * 2 + go, node).astype(np.int32)


# ------------------------------------------------------------ the whole fit

def _reference_fit(codes, y, cfg, task="binary"):
    """The reference's boosting loop (distributed.py:155-176, :322-337)
    around its own ``make_level_step`` on a (1, 1) mesh, with ``node_of``
    brought to numpy before the ``where`` that fails at :168."""
    N, F = codes.shape
    D = cfg.max_depth
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    fns = [R.make_level_step(mesh, cfg, 2 ** d, F) for d in range(D + 1)]
    init = R._init_pred(y, task)
    pred = np.full(N, init, np.float64)
    trees = []
    for _ in range(cfg.num_trees):
        g, h = R._grad_hess(pred, y, task)
        stats = jnp.asarray(np.stack([g, h, np.ones(N)], 1).astype(np.float32))
        node_of = np.zeros(N, np.int32)
        feats, bins, gains = [], [], []
        for d in range(D):
            f, b, gn, go, _ = fns[d](jnp.asarray(codes), stats,
                                     jnp.asarray(node_of))
            feats.append(np.asarray(f))
            bins.append(np.asarray(b))
            gains.append(np.asarray(gn))
            go = np.where(np.isfinite(gains[-1])[node_of.clip(0)],
                          np.asarray(go), 0)
            node_of = np.where(node_of >= 0, node_of * 2 + go,
                               node_of).astype(np.int32)
        hist = fns[D](jnp.asarray(codes), stats, jnp.asarray(node_of))[4]
        leaf_stats = np.asarray(hist[:, 0].sum(axis=1))
        leaf = -cfg.shrinkage * leaf_stats[:, 0] / (leaf_stats[:, 1]
                                                    + cfg.l2 + 1e-12)
        trees.append({"feat": np.concatenate(feats),
                      "bin": np.concatenate(bins),
                      "gain": np.concatenate(gains),
                      "leaf": leaf.astype(np.float32)})
        pred += trees[-1]["leaf"][node_of]
    return trees, init


@pytest.mark.parametrize("task", ["binary", "regression"])
def test_whole_fit_equals_the_reference_driver(task):
    codes, y = _mesh_data()
    if task == "regression":
        y = y * 2.5 + codes[:, 2] / 64.0
    cfg_r = R.DistGBTConfig(max_depth=4, n_bins=64, num_trees=4)
    cfg_p = P.DistGBTConfig(max_depth=4, n_bins=64, num_trees=4)
    want, init = _reference_fit(codes, y, cfg_r, task)
    (got,) = P.fit_on_world(cfg_p, codes, y, [(1, 1)], task=task, device=CPU)
    assert got.init_pred == init and len(got.trees) == len(want)
    for a, b in zip(got.trees, want):
        np.testing.assert_array_equal(a["feat"], b["feat"])
        np.testing.assert_array_equal(a["bin"], b["bin"])
        np.testing.assert_allclose(a["gain"], b["gain"], rtol=1e-5)
        np.testing.assert_allclose(a["leaf"], b["leaf"], rtol=1e-5)
        assert {k: v.dtype for k, v in a.items()} == \
            {k: v.dtype for k, v in b.items()}
    # the host helpers are the reference's, bit for bit, on the same trees
    s = got.predict_scores(codes)
    assert s.tobytes() == R.predict_scores_complete(
        got.trees, got.init_pred, 4, codes).tobytes()
    names = [f"f{i}" for i in range(codes.shape[1])]
    mine, ref = got.to_forest(names), R.complete_trees_to_forest(
        got.trees, got.init_pred, 4, names)
    for k in ("feature", "threshold", "split_bin", "cat_mask", "left_child",
              "leaf_value", "n_nodes", "split_gain", "tree_class",
              "init_pred"):
        np.testing.assert_array_equal(getattr(mine, k), getattr(ref, k))
    assert (mine.depth, mine.out_dim) == (ref.depth, ref.out_dim)
    assert got.training_logs["histogram_launches"] == [0]
    assert got.training_logs["learner"] == "distributed_gbt"


def test_spawned_gloo_meshes_agree_stop_and_resume(tmp_path):
    """One spawned world of four gloo ranks: (2, 2), (4, 1) and (1, 4)
    straight runs, then a stop on (2, 2) resumed on (4, 1)."""
    from repro_torch.core.engines import _compile_forest_engine
    from repro_torch.core.tree import aggregate_gbt
    codes, y = _mesh_data()
    cfg = P.DistGBTConfig(max_depth=4, n_bins=64, num_trees=4)
    (m11,) = P.fit_on_world(cfg, codes, y, [(1, 1)], device=CPU)
    s = m11.predict_scores(codes)
    assert ((s > 0) == y).mean() > 0.62
    ck = str(tmp_path / "ck")
    runs = P.fit_on_world(
        cfg, codes, y, [(2, 2), (4, 1), (1, 4), (2, 2), (4, 1)],
        checkpoints=[None, None, None,
                     CheckpointPolicy(ck, every_n_trees=2,
                                      cancel=P.CancelAfter(3)),
                     CheckpointPolicy(ck)], device=CPU)
    for m in runs[:3]:
        np.testing.assert_allclose(m.predict_scores(codes), s, atol=1e-4,
                                   err_msg=str(m.training_logs["mesh"]))
        assert not m.training_logs["interrupted"]
        assert m.training_logs["histogram_launches"] == [0, 0, 0, 0]
    half, resumed = runs[3:]
    assert half.training_logs["interrupted"] and len(half.trees) == 3
    assert not resumed.training_logs["interrupted"]
    assert [e["event"] for e in resumed.training_logs["resilience"]][0] == \
        "resume"
    assert len(resumed.trees) == cfg.num_trees
    np.testing.assert_allclose(resumed.predict_scores(codes), s, atol=1e-4)
    # the (2, 2) forest through the port's CPU engine
    forest = runs[0].to_forest([f"f{i}" for i in range(codes.shape[1])])
    engine = _compile_forest_engine(forest, None, torch.device(CPU))
    served = aggregate_gbt(np.asarray(engine.per_tree(
        codes.astype(np.float32))), forest)[:, 0]
    np.testing.assert_allclose(served, runs[0].predict_scores(codes),
                               atol=1e-4)


@pytest.mark.parametrize("fn,args,match", [
    # a (3, 1) mesh over a world of 2 raises YdfError on every rank
    pytest.param(P.Mesh, (3, 1, CPU), "YdfError", id="raises"),
    # a rank that dies without a word
    pytest.param(os._exit, (3,), "exited with code 3", id="dies")])
def test_a_failing_rank_fails_the_world(fn, args, match):
    with pytest.raises(RuntimeError, match=match):
        P.run_world(fn, 2, *args, device=CPU)


@pytest.mark.parametrize("cancel,num_trees,timeout_s,match", [
    # rank 0's cancel probe raises at the first tree
    pytest.param(functools.partial(operator.truediv, 1, 0), 3,
                 P.WORLD_TIMEOUT_S, "failed", id="raises"),
    # the fit outlasts the world's deadline
    pytest.param(None, 10 ** 6, 8.0, "did not finish in 8.0 s",
                 id="deadline")])
def test_a_checkpointed_world_fails_in_time(tmp_path, cancel, num_trees,
                                            timeout_s, match):
    """A rank inside a checkpoint session captures SIGTERM as a stop at its
    next tree, so a failed world's ranks are killed: the call fails within
    seconds, not after the fit or the collective timeout."""
    codes, y = _mesh_data(N=256)
    cfg = P.DistGBTConfig(max_depth=2, n_bins=64, num_trees=num_trees)
    policy = CheckpointPolicy(str(tmp_path / "ck"), every_n_trees=10 ** 9,
                              cancel=cancel)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=match):
        P.run_world(P._fit_meshes_rank, 2, cfg, codes, y, [(2, 1)], [policy],
                    "binary", CPU, device=CPU, timeout_s=timeout_s)
    assert time.monotonic() - t0 < min(timeout_s, 8.0) + 60


def test_mesh_and_fit_guards():
    codes, y = _mesh_data(N=64)
    codes = np.ascontiguousarray(codes[:, :3])
    cfg = P.DistGBTConfig(max_depth=2, n_bins=64, num_trees=1)
    with pytest.raises(YdfError, match="must divide model axis"):
        P.fit_on_world(cfg, codes, y, [(1, 2)], device=CPU)
    with pytest.raises(YdfError, match="one world"):
        P.fit_on_world(cfg, codes, y, [(1, 1), (2, 1)], device=CPU)
    with pytest.raises(YdfError, match="initialized default process group"):
        P.Mesh(1, 1, CPU)
    with pytest.raises(YdfError, match="no mesh"):
        P.DistributedGBT(cfg, None).fit(codes, y)
    assert P.default_backend(CPU, 1) == P.default_backend(CPU, 4) == "gloo"


# ------------------------------------------------------------ SimulatedCluster

def _sim_setup(num_trees=8):
    rng = np.random.default_rng(1)
    N, F = 512, 6
    codes = rng.integers(0, 32, (N, F)).astype(np.uint8)
    y = (codes[:, 1] > 15).astype(np.float64)
    return codes, y, num_trees


def _cfgs(**kw):
    return R.DistGBTConfig(**kw), P.DistGBTConfig(**kw)


def _cancel_after(n):
    calls = {"n": 0}

    def cancel():
        calls["n"] += 1
        return calls["n"] >= n
    return cancel


def _trees_equal(a, b):
    return len(a) == len(b) and all(
        np.array_equal(ta[k], tb[k]) for ta, tb in zip(a, b) for k in ta)


def test_simulated_cluster_fault_tolerance():
    """The counterpart of tests/test_distributed_df.py's: worker deaths
    reassign features and the grown tree keeps its gains and leaves."""
    rng = np.random.default_rng(1)
    N, F = 512, 6
    codes = rng.integers(0, 32, (N, F)).astype(np.uint8)
    y = (codes[:, 1] > 15).astype(np.float64)
    stats = np.stack([0.5 - y, np.full(N, 0.25), np.ones(N)], 1)
    cfg_r, cfg_p = _cfgs(max_depth=3, n_bins=32)
    sim = P.SimulatedCluster(codes, 4, cfg_p, seed=0, device=CPU)
    ref = R.SimulatedCluster(codes, 4, cfg_r, seed=0)
    t0, r0 = sim.grow_tree(stats), ref.grow_tree(stats)
    traffic_before = sim.traffic_bytes
    assert traffic_before == ref.traffic_bytes
    sim.kill_worker(0)
    sim.kill_worker(2)
    t1 = sim.grow_tree(stats)
    np.testing.assert_allclose(t0["leaf"], t1["leaf"])
    np.testing.assert_allclose(t0["gain"], t1["gain"], rtol=1e-6)
    assert sim.traffic_bytes > traffic_before
    for k in ("feat", "bin", "gain", "leaf", "node_of"):
        np.testing.assert_array_equal(t0[k], r0[k])
    with pytest.raises(RuntimeError):
        sim.kill_worker(1), sim.kill_worker(3)
    assert sim.resilience[0]["event"] == "worker_death"
    # one histogram per live worker per level: 4 + 2 workers x 3 levels
    assert sim.hist_builds == 4 * 3 + 2 * 3


@pytest.mark.parametrize("N", [256, 1024])
def test_traffic_is_independent_of_examples_and_equals_the_reference(N):
    cfg_r, cfg_p = _cfgs(max_depth=2, n_bins=16)
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 16, (N, 4)).astype(np.uint8)
    stats = np.stack([rng.normal(size=N), np.ones(N), np.ones(N)], 1)
    sim = P.SimulatedCluster(codes, 2, cfg_p, seed=0, device=CPU)
    ref = R.SimulatedCluster(codes, 2, cfg_r, seed=0)
    sim.grow_tree(stats)
    ref.grow_tree(stats)
    assert sim.traffic_bytes == ref.traffic_bytes
    # per-level candidate traffic: 2 workers x nodes x 12 bytes, whatever N
    assert sim.traffic_bytes - N // 8 * cfg_p.max_depth == \
        2 * (1 + 2) * 12


def test_simulated_cluster_trees_equal_the_reference():
    codes, y, T = _sim_setup()
    cfg_r, cfg_p = _cfgs(max_depth=3, n_bins=32, num_trees=T)
    for task, yy in (("binary", y), ("regression", y * 3 + codes[:, 4] / 9)):
        mine = P.SimulatedCluster(codes, 4, cfg_p, seed=0,
                                  device=CPU).fit(yy, task=task)
        ref = R.SimulatedCluster(codes, 4, cfg_r, seed=0).fit(yy, task=task)
        assert len(mine.trees) == len(ref.trees) == T
        for a, b in zip(mine.trees, ref.trees):
            np.testing.assert_array_equal(a["feat"], b["feat"])
            np.testing.assert_array_equal(a["bin"], b["bin"])
            np.testing.assert_allclose(a["gain"], b["gain"], rtol=1e-6)
            np.testing.assert_allclose(a["leaf"], b["leaf"], rtol=1e-6)
        np.testing.assert_allclose(mine.predict_scores(codes),
                                   ref.predict_scores(codes), rtol=1e-6)


def test_simulated_cluster_multi_death_soak_bit_identical():
    """Scheduled + Bernoulli worker deaths (>= 2, some mid-level) leave
    the forest bit-identical to the clean run."""
    codes, y, T = _sim_setup()
    _, cfg = _cfgs(max_depth=3, n_bins=32, num_trees=T)
    clean = P.SimulatedCluster(codes, 6, cfg, seed=0, device=CPU).fit(y)
    plan = P.WorkerFaultPlan(seed=5, deaths=((1, 1, 0), (4, 2, 3)),
                             death_rate=0.02)
    faulted = P.SimulatedCluster(codes, 6, cfg, seed=0, fault_plan=plan,
                                 device=CPU).fit(y)
    ref = R.SimulatedCluster(codes, 6, _cfgs(max_depth=3, n_bins=32,
                                             num_trees=T)[0], seed=0,
                             fault_plan=R.WorkerFaultPlan(
                                 seed=5, deaths=((1, 1, 0), (4, 2, 3)),
                                 death_rate=0.02)).fit(y)
    log = faulted.training_logs["resilience"]
    deaths = [e for e in log if e["event"] == "worker_death"]
    assert len(deaths) >= 2 and any(e["event"] == "level_restart"
                                    for e in log)
    assert log == ref.training_logs["resilience"]
    assert _trees_equal(clean.trees, faulted.trees)
    assert clean.predict_scores(codes).tobytes() == \
        faulted.predict_scores(codes).tobytes()


def test_simulated_cluster_checkpoint_resume(tmp_path):
    codes, y, T = _sim_setup()
    _, cfg = _cfgs(max_depth=3, n_bins=32, num_trees=T)
    clean = P.SimulatedCluster(codes, 4, cfg, seed=0, device=CPU).fit(y)
    ckdir = str(tmp_path / "ck")
    part = P.SimulatedCluster(codes, 4, cfg, seed=0, device=CPU).fit(
        y, checkpoint=CheckpointPolicy(ckdir, every_n_trees=2,
                                       cancel=_cancel_after(3)))
    assert part.training_logs["interrupted"]
    assert 0 < len(part.trees) < cfg.num_trees
    resumed = P.SimulatedCluster(codes, 4, cfg, seed=0, device=CPU).fit(
        y, checkpoint=CheckpointPolicy(ckdir))
    assert _trees_equal(clean.trees, resumed.trees)
    assert {k: v.dtype for k, v in resumed.trees[0].items()} == \
        {k: v.dtype for k, v in clean.trees[-1].items()}


def test_simulated_cluster_wrong_data_rejected(tmp_path):
    codes, y, _ = _sim_setup()
    _, cfg = _cfgs(max_depth=3, n_bins=32, num_trees=8)
    ckdir = str(tmp_path / "ck")
    P.SimulatedCluster(codes, 4, cfg, seed=0, device=CPU).fit(
        y, checkpoint=CheckpointPolicy(ckdir, every_n_trees=2,
                                       cancel=_cancel_after(3)))
    with pytest.raises(YdfError, match="DIFFERENT dataset"):
        P.SimulatedCluster(codes, 4, cfg, seed=0, device=CPU).fit(
            1.0 - y, checkpoint=CheckpointPolicy(ckdir))


def test_learner_resume_refuses_trainer_checkpoint(tmp_path):
    """A SimulatedCluster checkpoint has no 'learner' key: resume_training
    refuses it with directions."""
    from repro_torch.data.tabular import adult_like
    codes, y, _ = _sim_setup()
    _, cfg = _cfgs(max_depth=3, n_bins=32, num_trees=8)
    ckdir = str(tmp_path / "ck")
    P.SimulatedCluster(codes, 4, cfg, seed=0, device=CPU).fit(
        y, checkpoint=CheckpointPolicy(ckdir, every_n_trees=2,
                                       cancel=_cancel_after(3)))
    with pytest.raises(YdfError, match="not written by a Learner"):
        resume_training(ckdir, adult_like(100, seed=1), device=CPU)


def test_a_checkpoint_resumes_only_on_its_device_type(tmp_path):
    codes, y, _ = _sim_setup()
    _, cfg = _cfgs(max_depth=3, n_bins=32, num_trees=8)
    ckdir = str(tmp_path / "ck")
    P.SimulatedCluster(codes, 4, cfg, seed=0, device=CPU).fit(
        y, checkpoint=CheckpointPolicy(ckdir, every_n_trees=2,
                                       cancel=_cancel_after(3)))
    payload, manifest, _ = latest_checkpoint(ckdir)
    assert manifest["device"] == "cpu" and payload["kind"] == "sim_gbt"
    assert payload["trees"]["feat"].shape == (3, 7)     # stacked (T, nodes)
    # the same checkpoint, as a training on the card would have written it
    path = os.path.join(ckdir, checkpoint_name(manifest["trees_done"]),
                        "manifest.json")
    with open(path, "w") as f:
        json.dump({**manifest, "device": "cuda"}, f)
    with pytest.raises(YdfError, match="training on 'cuda'"):
        P.SimulatedCluster(codes, 4, cfg, seed=0, device=CPU).fit(
            y, checkpoint=CheckpointPolicy(ckdir))


# ------------------------------------------------------------ the device rule

def test_entry_points_default_to_the_card_and_raise_without_one():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs on it")
    codes, y, _ = _sim_setup()
    cfg = P.DistGBTConfig(max_depth=2, n_bins=32, num_trees=1)
    with pytest.raises(YdfError, match="no CUDA device"):
        P.SimulatedCluster(codes, 2, cfg)
    with pytest.raises(YdfError, match="no CUDA device"):
        P.fit_on_world(cfg, codes, y, [(1, 1)])
    with pytest.raises(YdfError, match="no CUDA device"):
        P.Mesh(1, 1)
    with pytest.raises(YdfError, match="no CUDA device"):
        P.run_world(P.Mesh, 1, 1, 1)


def test_hist_impl_follows_the_kernels_dispatch():
    with pytest.raises(YdfError, match="'cuda'"):
        P.DistGBTConfig(hist_impl="pallas")
    with pytest.raises(YdfError, match="keep the defaults"):
        P.DistGBTConfig(data_axis="rows")
    codes, y, _ = _sim_setup()
    stats = np.stack([0.5 - y, np.full(len(y), 0.25), np.ones(len(y))], 1)
    # "cuda" on CPU tensors raises instead of taking the plain version
    sim = P.SimulatedCluster(codes, 2, P.DistGBTConfig(
        max_depth=2, n_bins=32, hist_impl="cuda"), device=CPU)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        sim.grow_tree(stats)
    # "ref" is the plain version, on float32 stats: the same structure
    ref_sim = P.SimulatedCluster(codes, 2, P.DistGBTConfig(
        max_depth=3, n_bins=32, hist_impl="ref"), device=CPU)
    numpy_sim = P.SimulatedCluster(codes, 2, P.DistGBTConfig(
        max_depth=3, n_bins=32), device=CPU)
    a, b = ref_sim.grow_tree(stats), numpy_sim.grow_tree(stats)
    np.testing.assert_array_equal(a["feat"], b["feat"])
    np.testing.assert_array_equal(a["bin"], b["bin"])
    np.testing.assert_allclose(a["gain"], b["gain"], rtol=1e-5)
    assert ref_sim.hist_builds == numpy_sim.hist_builds == 2 * 3


def test_benchmark_rows_equal_the_reference():
    import importlib
    ours = importlib.import_module("benchmarks.torch_distributed_df")
    ref = importlib.import_module("benchmarks.distributed_df")
    assert ours.run(verbose=False, device=CPU) == ref.run(verbose=False)
