"""Host time of the request encoder, ``BatchEncoder.encode``, on raw rows
at HIGGS width: 28 NUMERICAL float64 columns with 2% NaN for missing, the
columns the benchmark's scoring and serving cells send.

    python3 benchmarks/torch_encode_times.py [--rows 1 52 300 65536]
        [--typed 1] [--out FILE]

Per row count: the median of 7 windows, each the mean of as many calls as
fill about 0.2 s, in microseconds a call; ``--out`` appends the JSON line
to FILE. ``--typed 0`` sends the same values as Python lists, which take
the per-column object path. Runs on the host alone (no device); the
package is the one on ``PYTHONPATH`` (``src`` by default), so two trees
can be timed in one process's environment each.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
F = 28


def columns(n: int, seed: int) -> dict:
    r = np.random.default_rng(seed)
    X = r.standard_normal((n, F))
    X[r.random((n, F)) < 0.02] = np.nan
    return {f"num_{j}": np.ascontiguousarray(X[:, j]) for j in range(F)}


def time_call(fn, budget_s: float = 0.2, windows: int = 7) -> float:
    fn()
    t = time.perf_counter()
    fn()
    reps = max(1, int(budget_s / max(time.perf_counter() - t, 1e-7)))
    means = []
    for _ in range(windows):
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        means.append((time.perf_counter() - t) / reps)
    return float(np.median(means))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, nargs="+", default=[1, 52, 300, 65536])
    ap.add_argument("--typed", type=int, choices=(0, 1), default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not os.environ.get("PYTHONPATH"):
        sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.dataspec import BatchEncoder, infer_dataspec
    names = [f"num_{j}" for j in range(F)]
    enc = BatchEncoder(infer_dataspec(columns(4096, 0)), names)
    out = {"package": str(Path(sys.modules["repro_torch"].__file__).parent),
           "typed": bool(args.typed), "us_per_call": {}}
    for n in args.rows:
        batch = columns(n, n + 1)
        if not args.typed:
            batch = {k: v.tolist() for k, v in batch.items()}
        out["us_per_call"][n] = 1e6 * time_call(lambda: enc.encode(batch))
    line = json.dumps(out)
    print(line)
    if args.out:
        with open(args.out, "a") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
