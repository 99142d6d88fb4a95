#!/usr/bin/env python3
"""How sensitive the port's randomly initialised hybrid (zamba2-2.7b) and
ssm (rwkv6-3b) models are to rounding, for each recipe of random weights:
``init_params``' draw (the reference's init), then with the attention
projections at their full fan-in (``chip_smoke.full_fan_in``), the
residual branches' output projections scaled by 1 / sqrt(2 n_layers)
(``residual_rescale``), and the recurrences' published decay inits
(``ssm_init``).

    python3 benchmarks/torch_lm_ssm_conditioning.py [--device cuda] [--layers 6 54]

For each arch at full width, cut to each depth (zamba2: a multiple of 6),
it prints one JSON line per recipe (``chip_smoke.lm_ssm_conditioning``):
bf16 against float32 last-token prefill logits on the same weights (max
and rms |delta| over the logits' std, argmax agreement) and a float32
decode step against the forward pass. With ``--device cpu`` keep the
depths and ``--prompt`` small.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

RECIPES = ((), ("full_fan_in",), ("full_fan_in", "residual"),
           ("full_fan_in", "residual", "ssm_init"), ("full_fan_in", "ssm_init"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--archs", nargs="+", default=["zamba2-2.7b", "rwkv6-3b"])
    ap.add_argument("--layers", type=int, nargs="+", default=None,
                    help="depths (default: each arch's own)")
    ap.add_argument("--prompt", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=1)
    args = ap.parse_args()
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_arch
    from repro_torch.core.engines import resolve_device
    device = resolve_device(args.device)
    if device.type == "cuda":
        print(cs.nvidia_smi(), flush=True)
    for name in args.archs:
        full = get_arch(name)
        for n_layers in args.layers or [full.n_layers]:
            cfg = full.replace(n_layers=n_layers)
            # rwkv6 has no attention: full fan-in leaves its weights as drawn
            recipes = dict.fromkeys(tuple(r for r in rec if cfg.family != "ssm"
                                          or r != "full_fan_in") for rec in RECIPES)
            for recipe in recipes:
                row = cs.lm_ssm_conditioning(cfg, device, recipe, prompt=args.prompt,
                                             batch=args.batch)
                print(json.dumps({"arch": name, "layers": n_layers,
                                  "recipe": "+".join(recipe) or "init_params", **row}),
                      flush=True)
                if device.type == "cuda":
                    torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
