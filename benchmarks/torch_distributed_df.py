"""Distributed DF training benchmark of the PyTorch port (paper §3.9 /
Guillame-Bert & Teytaud), the counterpart of ``benchmarks/distributed_df.py``:
per-level communication volume against N (candidate traffic is independent
of the number of examples; partitions are bit-packed), through the port's
single-process simulation backend, whose workers build their histograms with
B3 on the card (``run(device="cpu")``: the port's numpy histograms).

    python3 benchmarks/torch_distributed_df.py

Prints ``n_examples,candidate_bytes,bitmap_bytes,float_mask_bytes`` rows;
the byte counts come from the shapes and do not depend on the device.
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core.distributed import DistGBTConfig, SimulatedCluster  # noqa: E402


def run(verbose: bool = True, device=None) -> dict:
    cfg = DistGBTConfig(max_depth=4, n_bins=64)
    rows = {}
    for N in (512, 2048, 8192):
        rng = np.random.default_rng(0)
        codes = rng.integers(0, 64, (N, 16)).astype(np.uint8)
        stats = np.stack([rng.normal(size=N), np.ones(N), np.ones(N)], 1)
        sim = SimulatedCluster(codes, 8, cfg, seed=0, device=device)
        sim.grow_tree(stats)
        bitmap = N // 8 * cfg.max_depth
        candidates = sim.traffic_bytes - bitmap
        rows[N] = {"total_bytes": sim.traffic_bytes,
                   "candidate_bytes": candidates,
                   "bitmap_bytes": bitmap,
                   "float_mask_bytes": N * 4 * cfg.max_depth}
        if verbose:
            r = rows[N]
            print(f"  N={N:6d}: candidates={r['candidate_bytes']:7d}B "
                  f"(N-independent)  bitmap={r['bitmap_bytes']:7d}B "
                  f"(vs {r['float_mask_bytes']}B unpacked = "
                  f"{r['float_mask_bytes'] / r['bitmap_bytes']:.0f}x)", flush=True)
    return rows


def main():
    out = run(verbose=False)
    print("n_examples,candidate_bytes,bitmap_bytes,float_mask_bytes")
    for n, r in out.items():
        print(f"{n},{r['candidate_bytes']},{r['bitmap_bytes']},{r['float_mask_bytes']}")


if __name__ == "__main__":
    main()
