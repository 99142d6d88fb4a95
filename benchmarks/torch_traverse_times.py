#!/usr/bin/env python3
"""Times the traversal kernels (B2, B4) of the PyTorch/CUDA port on
axis-aligned forests, for comparing two checkouts on one card.

    python3 benchmarks/torch_traverse_times.py

Needs one CUDA card. Times the checkout the script lies in, so two
versions are compared by running each checkout's copy on the same card,
one after the other, in turns (A, B, B, A). Cases: the default GBT that
``chip_smoke.py`` serves (300 trees of depth 3-6, 128 nodes, categorical
columns) at N = 1,024, 4,096 and 65,536 rows, and a random Random
Forest-shaped forest (16 trees of 4,095 nodes, 28 numerical columns, two
outputs) at 10,000 rows. For each it prints one JSON line with the device
time of one call of each kernel over its cached layout
(``chip_smoke.device_only_ms``: CUDA events with the host hidden behind a
sleep kernel, median of 20) and the plan it took. The card's name and
power limit are printed first.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_traverse_times: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.forest_infer import forest_infer, ops
    dev = torch.device("cuda")
    print(cs.nvidia_smi(), flush=True)
    _build.build_all()
    gbt = cs.build_default_gbt().forest
    rf = cs.random_forest(16, 2047, 28, 2, seed=1, max_nodes=4096)
    rng = np.random.default_rng(2)
    cases = [(f"gbt N={n}", gbt, cs.encoded_inputs(n, seed=100 + n))
             for n in (1024, 4096, 65_536)]
    cases.append(("rf N=10000", rf,
                  rng.normal(size=(10_000, 28)).astype(np.float32)))
    for name, forest, X in cases:
        Xd = torch.from_numpy(np.ascontiguousarray(X, np.float32)).to(dev)
        packed = ops.device_packed(forest, dev).layout
        soa = ops.device_soa(forest, dev).layout
        row = {"case": name,
               "tiled_device_ms": cs.device_only_ms(
                   lambda: forest_infer.run_tiled(Xd, packed)),
               "single_device_ms": cs.device_only_ms(
                   lambda: forest_infer.run_single(Xd, soa)),
               "tiled_plan": cs.traversal_plan(forest, X, "tiled",
                                               dev).variant,
               "single_plan": cs.traversal_plan(forest, X, "single",
                                                dev).variant}
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
