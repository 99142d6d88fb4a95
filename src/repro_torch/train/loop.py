"""Fault-tolerant LM training loop on one device: checkpoint/resume,
asynchronous saves, deadline ('preemption') detection, deterministic data
replay.

A restarted run reproduces the exact state: the data is a pure function of
(seed, step) and the checkpoint restores every leaf bit for bit, so N
straight steps equal the same steps split by a restart (on the CPU, bit for
bit). A mesh or sharding rules raise ``YdfError`` (ROADMAP A9.4).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.data.lm_data import batch_at
from repro_torch.distributed.checkpoint import CheckpointManager
from repro_torch.obs import clock
from repro_torch.train.step import init_train_state, make_train_step, one_device


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
    deadline stopped the run."""
    from repro_torch.core.engines import resolve_device
    one_device(mesh, rules)
    dev = resolve_device(device)
    step_fn = make_train_step(cfg, shape, device=dev).jitted()
    mgr = CheckpointManager(ckpt_dir)

    start = mgr.latest_step()
    if start is None:
        state = init_train_state(torch.Generator(device=dev).manual_seed(loop.seed),
                                 cfg, device=dev)
        start = 0
    else:
        state, _ = mgr.restore(start, device=dev)
        log(f"resumed from step {start}")

    t0 = clock.wall()
    losses = []
    done = saved = start
    preempted = False
    for step in range(start, loop.total_steps):
        batch = batch_at(cfg, shape, step, seed=loop.seed,
                         batch_override=batch_override, device=dev)
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
                mgr.save_async(done, state)
            else:
                mgr.save(done, state)
            saved = done
        if loop.deadline_s and clock.wall() - t0 > loop.deadline_s:
            preempted = True
            log(f"deadline hit at step {done}; checkpoint + clean exit "
                "(restart resumes here)")
            break
    mgr.wait()
    # the final state, unless the last step's periodic save holds it already
    final = mgr.path(done) if saved == done and done > start else mgr.save(done, state)
    return {"final_step": done, "losses": losses, "ckpt": final,
            "preempted": preempted}
