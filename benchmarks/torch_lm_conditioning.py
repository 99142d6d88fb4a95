#!/usr/bin/env python3
"""How sensitive a randomly initialised LM of the port is to rounding, with
the reference's init (``init_params``: fan_in = shape[-2], which is the head
count for wq/wk/wv and head_dim for wo) and with the attention projections
rescaled to their full fan-in (``chip_smoke.full_fan_in``).

    python3 benchmarks/torch_lm_conditioning.py [--device cuda] [--layers 1 2 4 28]

For qwen2-1.5b at full width, cut to each depth, it prints one JSON line per
(depth, init): the std of q and of the attention scores in layer 0, the
last-token prefill logits of bf16 against float32 on the same weights
(max |delta| and rms |delta| over the logits' std, argmax agreement), a
float32 decode step against the forward pass over the same tokens (max
|delta|), and a float8 KV cache against the bf16 one under the reference's
rule (test_models_smoke.py: argmax equal, max |delta| < 0.25). With
``--device cpu`` keep the depths small.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--layers", type=int, nargs="+", default=[1, 2, 4, 28])
    ap.add_argument("--prompt", type=int, default=128)
    args = ap.parse_args()
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_arch
    from repro_torch.core.engines import resolve_device
    device = resolve_device(args.device)
    if device.type == "cuda":
        print(cs.nvidia_smi(), flush=True)
    torch.set_grad_enabled(False)
    for n_layers in args.layers:
        cfg = get_arch("qwen2-1.5b").replace(n_layers=n_layers)
        for full in (False, True):
            row = cs.lm_conditioning(cfg, device, prompt=args.prompt, full_fan_in=full)
            print(json.dumps({"layers": n_layers, "init": "full fan-in" if full
                              else "init_params", **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
