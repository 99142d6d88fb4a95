"""Fault-tolerant LM training loop: checkpoint/resume, asynchronous saves,
deadline ('preemption') detection, deterministic data replay, on one device
or over a mesh.

A restarted run reproduces the exact state: the data is a pure function of
(seed, step) and the checkpoint restores every leaf bit for bit, so N
straight steps equal the same steps split by a restart (on the CPU, bit for
bit). Under a mesh every rank runs the loop: it takes its block of each
global batch, saves collectively (every rank gathers, rank 0 writes) and
restores its own blocks, so a run may resume on another mesh shape.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.data.lm_data import batch_at
from repro_torch.distributed.checkpoint import CheckpointManager
from repro_torch.obs import clock
from repro_torch.sharding import tree_shard
from repro_torch.train.step import init_train_state, make_train_step


@dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    log_every: int = 10
    seed: int = 0
    deadline_s: float | None = None  # stop cleanly after this wall-time
    async_ckpt: bool = True


def train_loop(cfg: ModelConfig, shape: ShapeConfig, ckpt_dir: str,
               loop: LoopConfig, *, mesh=None, rules=None,
               batch_override: int | None = None, log=print, device=None) -> dict:
    """Train ``cfg`` from step 0 (params drawn from ``loop.seed``) or from
    the latest checkpoint in ``ckpt_dir`` to ``loop.total_steps``, on
    ``device`` (None is cuda). Returns the final step, the logged
    (step, loss) pairs, the final checkpoint's directory and whether the
    deadline stopped the run. Under ``mesh`` and ``rules`` every rank calls
    this with the same arguments (the mesh's device)."""
    from repro_torch.core.engines import resolve_device
    dev = resolve_device(device)
    bundle = make_train_step(cfg, shape, mesh, rules, device=dev)
    step_fn = bundle.jitted()
    state_sh, batch_sh = bundle.state_shardings, bundle.batch_shardings
    mgr = CheckpointManager(ckpt_dir)

    start = mgr.latest_step()
    if start is None:
        state = init_train_state(torch.Generator(device=dev).manual_seed(loop.seed),
                                 cfg, device=dev)
        if state_sh is not None:
            state = tree_shard(state, state_sh)
        start = 0
    else:
        state, _ = mgr.restore(start, shardings=state_sh, device=dev)
        log(f"resumed from step {start}")

    t0 = clock.wall()
    losses = []
    done = saved = start
    preempted = False
    for step in range(start, loop.total_steps):
        batch = batch_at(cfg, shape, step, seed=loop.seed,
                         batch_override=batch_override, device=dev)
        if batch_sh is not None:
            batch = tree_shard(batch, batch_sh)
        state, metrics = step_fn(state, batch)
        done = step + 1
        if done % loop.log_every == 0 or done == loop.total_steps:
            loss = float(metrics["loss"])
            losses.append((done, loss))
            log(f"step {done}: loss={loss:.4f} "
                f"gnorm={float(metrics['grad_norm']):.3f} "
                f"({(clock.wall() - t0):.1f}s)")
        if done % loop.ckpt_every == 0:
            if loop.async_ckpt:
                mgr.save_async(done, state, shardings=state_sh)
            else:
                mgr.save(done, state, shardings=state_sh)
            saved = done
        late = bool(loop.deadline_s and clock.wall() - t0 > loop.deadline_s)
        if mesh is not None and loop.deadline_s:   # every rank stops alike
            late = bool(mesh.all_reduce(torch.tensor([int(late)], device=dev),
                                        mesh.axis_names, "max").item())
        if late:
            preempted = True
            log(f"deadline hit at step {done}; checkpoint + clean exit "
                "(restart resumes here)")
            break
    mgr.wait()
    # the final state, unless the last step's periodic save holds it already
    final = (mgr.path(done) if saved == done and done > start
             else mgr.save(done, state, shardings=state_sh))
    return {"final_step": done, "losses": losses, "ckpt": final,
            "preempted": preempted}
