"""Run cells of the benchmark several times, one process after another, and
summarise them: each run's result line, and per cell and metric the
median and the spread (the distance between the first and third quartile
of ``statistics.quantiles(values, n=4)``, as a share of the median).

    python3 bench/sweep.py --out out/sets.jsonl \\
        --run gbt_higgs.train,101,45,0 --run gbt_higgs.train,102,45,0 ...

Each ``--run`` is ``cell,seed,seconds,trace``. Every result line, with
the run's exit code, wall seconds and the end of its standard error, is
appended to ``--out``. Prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        return "nvidia-smi not available"


def spread(values: list[float]) -> float | None:
    if len(values) < 2:
        return None
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med if med else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--run", action="append", default=[])
    ap.add_argument("--timeout", type=float, default=1200)
    args = ap.parse_args(argv)
    print("card:", card(), flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    by_cell: dict[str, dict[str, list]] = {}
    for spec in args.run:
        cell, seed, seconds, trace = spec.split(",")
        cmd = [sys.executable, str(ROOT / "bench" / "run.py"), "--workload",
               cell, "--seed", seed, "--seconds", seconds, "--trace", trace]
        t0 = time.perf_counter()
        try:
            p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                               timeout=args.timeout)
            rc, stdout, stderr = p.returncode, p.stdout, p.stderr
        except subprocess.TimeoutExpired as e:
            rc, stdout, stderr = 124, e.stdout or "", str(e.stderr or "")
        wall = time.perf_counter() - t0
        lines = stdout.strip().splitlines()
        try:
            res = json.loads(lines[-1]) if lines else None
        except json.JSONDecodeError:
            res = None
        rec = {"cell": cell, "seed": int(seed), "seconds": float(seconds),
               "trace": int(trace), "rc": rc, "wall_s": wall, "result": res,
               "stderr_tail": stderr[-3000:]}
        with open(out, "a") as fh:
            fh.write(json.dumps(rec) + "\n")
        short = {}
        if res:
            short = {k: v["value"] for k, v in res["metrics"].items()}
            for k, v in short.items():
                by_cell.setdefault(f"{cell} trace={trace}", {}).setdefault(
                    k, []).append(v)
            short["correct"] = res["correct"]
            short["checks"] = {k: v["value"] for k, v in res["checks"].items()}
            short["mem_GB"] = res["device"]["memory_peak_bytes"] / 1e9
            short["notes"] = res.get("notes")
            if "busy_s" in res["device"]:
                short["busy_s"] = res["device"]["busy_s"]
                short["window_s"] = res["device"]["window_s"]
        print(json.dumps({"run": spec, "rc": rc, "wall_s": round(wall, 1),
                          **short}), flush=True)
        if rc != 0 or res is None:
            print(stderr[-2500:], flush=True)
    for cell, metrics in by_cell.items():
        for name, vals in metrics.items():
            print(f"{cell} {name}: n={len(vals)} median="
                  f"{statistics.median(vals)!r} spread={spread(vals)!r} "
                  f"values={vals!r}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
