"""Training launcher: ``train_loop`` for one architecture, with checkpoints
under ``--ckpt/<arch>``. CPU-sized with --smoke; runs on the card unless
``--device cpu``. Weights are random, drawn from ``--seed``; the data is
the synthetic stream of ``data.lm_data``.

    python -m repro_torch.launch.train --arch qwen2-1.5b --smoke --steps 50
    python -m repro_torch.launch.train --arch qwen2-1.5b --batch 4 --seq 2048
    torchrun --nproc-per-node ... -m repro_torch.launch.train --arch qwen3-8b --mesh single

``--mesh single|multi`` trains sharded over the production mesh (16x16 or
2x16x16) under the training rules, in the world ``torchrun`` starts (env://
rendezvous); outside a world of 256 (512) ranks it raises ``YdfError``
naming the size. ``--overlap-flags`` set XLA's TPU latency-hiding flags in
the reference and has no counterpart here: it raises.
"""
from __future__ import annotations

import argparse
import os


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config + tiny shape (CPU-sized)")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--ckpt", default=os.path.join("build", "lm_ckpt"))
    ap.add_argument("--mesh", default="none", choices=["none", "single", "multi"])
    ap.add_argument("--overlap-flags", action="store_true",
                    help="the reference's XLA TPU flags: refused here")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from repro_torch.core.api import YdfError
    if args.overlap_flags:
        raise YdfError("--overlap-flags sets XLA's TPU latency-hiding scheduler "
                       "flags, which have no counterpart in the PyTorch port")

    from repro_torch.configs import SHAPES, get_arch, smoke_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.engines import resolve_device
    from repro_torch.train.loop import LoopConfig, train_loop

    device = resolve_device(args.device)
    cfg = get_arch(args.arch)
    shape = SHAPES[args.shape]
    if args.smoke:
        cfg = smoke_config(cfg)
        shape = ShapeConfig("smoke", "train", args.seq or 128, args.batch or 4)
    elif args.batch or args.seq:
        shape = ShapeConfig("custom", "train", args.seq or shape.seq_len,
                            args.batch or shape.global_batch)

    mesh = rules = None
    if args.mesh != "none":
        from repro_torch.launch.mesh import production_mesh_from_env
        from repro_torch.sharding import rules_for
        mesh = production_mesh_from_env(multi_pod=args.mesh == "multi", device=device)
        rules, device = rules_for("train"), mesh.device   # this rank's card
    out = train_loop(cfg, shape, os.path.join(args.ckpt, args.arch),
                     LoopConfig(total_steps=args.steps, seed=args.seed),
                     mesh=mesh, rules=rules, device=device)
    where = "cpu" if device.type == "cpu" else _card_name(device)
    print(f"done: {out['final_step']} steps on {where}; "
          f"last losses: {out['losses'][-3:]}")
    return out


def _card_name(device) -> str:
    import torch
    return torch.cuda.get_device_name(device)


if __name__ == "__main__":
    main()
