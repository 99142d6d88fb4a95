"""Serving launcher: prefill a batch of prompts, then decode greedily,
reporting tokens/s. CPU-sized with --smoke; runs on the card unless
``--device cpu``. Weights are random, drawn from ``--seed``.

    python -m repro_torch.launch.serve --arch qwen2-1.5b

``--mesh single|multi`` serves sharded over the production mesh under the
serving rules, in the world ``torchrun`` starts (env:// rendezvous);
outside a world of 256 (512) ranks it raises ``YdfError`` naming the size.
"""
from __future__ import annotations

import argparse

from repro_torch.obs import clock


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", default="none", choices=["none", "single", "multi"])
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs import get_arch, smoke_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.engines import resolve_device
    from repro_torch.models import lm
    from repro_torch.models.params import init_params
    from repro_torch.serving.decode import greedy_generate

    device = resolve_device(args.device)
    mesh = rules = None
    if args.mesh != "none":
        from repro_torch.launch.mesh import production_mesh_from_env
        from repro_torch.sharding import rules_for
        mesh = production_mesh_from_env(multi_pod=args.mesh == "multi", device=device)
        rules, device = rules_for("serve"), mesh.device   # this rank's card
    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    shape = ShapeConfig("serve", "prefill", args.prompt_len, args.batch)
    gen = torch.Generator(device=device)
    params = init_params(lm.model_schema(cfg), cfg.param_dtype,
                         generator=gen.manual_seed(args.seed), device=device)
    batch = lm.make_batch(gen.manual_seed(args.seed + 1), cfg, shape,
                          device=device)

    t0 = clock.perf()
    if mesh is not None:
        from repro_torch.serving.decode import make_prefill
        from repro_torch.sharding import tree_shard
        params = tree_shard(params, make_prefill(cfg, shape, mesh, rules,
                                                 device=device).param_shardings)
    toks = greedy_generate(params, batch, cfg, args.gen, mesh, rules, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = clock.perf() - t0
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    n_tok = toks.shape[0] * toks.shape[1]
    print(f"{args.arch}: generated {n_tok} tokens in {dt:.2f}s "
          f"({n_tok / dt:.1f} tok/s incl. warm-up) on {where}")
    print("sample token ids:", toks[0, :16].tolist())


if __name__ == "__main__":
    main()
