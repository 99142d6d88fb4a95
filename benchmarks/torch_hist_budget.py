#!/usr/bin/env python3
"""Times the histogram kernels (B3, B1) of the PyTorch/CUDA port under
several shared-memory budgets per block (``kernels/histogram/plan.py``
``SMEM_BUDGET``), at the shapes ``chip_smoke.py`` times.

    python3 benchmarks/torch_hist_budget.py [--budgets-kb 64 96 200]

Needs one CUDA card. For each budget and shape it prints one JSON line:
the plan, and the device time of one call (``chip_smoke.device_only_ms``:
CUDA events with the host hidden behind a sleep kernel, median of 20).
Budgets are compared within one run, in turns. The card's name and power
limit are printed first.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--budgets-kb", type=int, nargs="+", default=[64, 96, 200])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_hist_budget: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.histogram import fused, histogram, plan
    dev = torch.device("cuda")
    print(cs.nvidia_smi(), flush=True)
    _build.build_all()
    calls = {}
    for seed, shape in enumerate(cs.HIST_TIMED, 300):
        label, a, k = cs.timed_inputs(shape, seed, dev)
        calls["hist " + label] = (
            lambda a=a, k=k: histogram.histogram(*a, k),
            lambda a=a, k=k: plan.histogram_plan(a[0].shape[0], a[0].shape[1],
                                                 a[1].shape[1], k))
    for seed, shape in enumerate(cs.FUSED_TIMED, 200):
        label, a, w = cs.timed_inputs(shape, seed, dev)
        kind = shape[3]
        calls["fused " + label] = (
            lambda a=a, w=w, kind=kind: fused.fused_split(*a, w, kind=kind),
            lambda a=a, w=w, kind=kind: plan.fused_plan(
                a[0].shape[0], a[0].shape[1], a[1].shape[1], w, kind))
    default = plan.SMEM_BUDGET
    try:
        for name, (call, plan_of) in calls.items():
            for kb in args.budgets_kb:
                plan.SMEM_BUDGET = kb * 1024
                print(json.dumps({"shape": name, "budget_kb": kb,
                                  "plan": dataclasses.asdict(plan_of()),
                                  "device_ms": cs.device_only_ms(call)}),
                      flush=True)
    finally:
        plan.SMEM_BUDGET = default
    return 0


if __name__ == "__main__":
    sys.exit(main())
