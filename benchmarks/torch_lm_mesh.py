#!/usr/bin/env python3
"""Phases 41-42 of ``chip_smoke.py`` alone (the LM mesh), and
``compare_correctness`` on a small GBT and RF, without the rest of the
smoke run.

    python3 benchmarks/torch_lm_mesh.py [--out chiprun_out/lm_mesh.json]

Needs the card: ``lm_mesh_one`` runs a world of 1 with NCCL on a (1, 1, 1)
mesh, ``lm_mesh_world`` one spawned world of four gloo ranks sharing the
card (the gates, configurations and reported numbers are the phases',
``chip_smoke.py``'s docstring). It prints the card's name and power limit,
one line per part with its seconds or its error, and writes every result
as JSON to ``--out``. Exits 1 if a part fails.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "lm_mesh.json"))
    args = ap.parse_args()
    import torch

    import chip_smoke as cs
    from repro_torch.obs import clock
    if not torch.cuda.is_available():
        print("torch_lm_mesh: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    card = cs.nvidia_smi()
    print(card, flush=True)
    out, failed = {"card": card}, False

    def part(name, fn, *a):
        nonlocal failed
        t0 = clock.perf()
        try:
            out[name] = fn(*a)
            print(name, "ok", clock.perf() - t0, flush=True)
        except Exception:       # reported, and the next part still runs
            failed = True
            out[name + "_error"] = traceback.format_exc()[-6000:]
            print(name, "FAILED", out[name + "_error"], flush=True)
        out[name + "_s"] = clock.perf() - t0
        torch.cuda.empty_cache()

    part("lm_mesh_one", cs.lm_mesh_one, device)
    scratch = cs.scratch_dir()
    try:
        part("lm_mesh_world", cs.lm_mesh_world, device, scratch)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)

    def compare():
        data = cs.higgs_like(20_000)
        valid = cs.validation_rows(data)
        return cs.compare_models(cs.train_gbt(data, device, num_trees=10),
                                 cs.train_rf(data, device, num_trees=4), valid, device)

    part("compare_correctness", compare)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1, default=str)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
