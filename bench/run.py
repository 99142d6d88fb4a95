"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The program is ``src/repro_torch``; its
kernels build into the checkout's ``build/`` on the first run and load
from there after. The last line of standard output is one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` ``breakdown``, and ``checks``: each number compared with the
plain reference beside its limit). The same numbers end standard error.
Exits 2 without a CUDA device, 3 where the program is missing, 4 where
the process loaded JAX or the JAX package.
"""
from __future__ import annotations

import os
import time


def _process_age() -> float:
    """Seconds since this process started (Linux), 0 where unknown."""
    try:
        with open("/proc/self/stat") as fh:
            start = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            up = float(fh.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


# the set-up's clock starts with the process
T_START = time.perf_counter() - _process_age()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every build and kernel cache at a fixed place inside the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / sub)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("bench: the program (src/repro_torch) is not in this "
              "checkout", file=sys.stderr)
        return 3
    import torch
    from bench import harness
    bench = harness.benchmark()
    work = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in work:
        print(f"bench: no workload {args.workload!r}; cells: {sorted(work)}",
              file=sys.stderr)
        return 2
    chips = work[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench: {args.workload} needs {chips} CUDA device(s); torch "
              f"sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    run = harness.make_run(bench, args.workload, args.seed, args.seconds,
                           bool(args.trace), "cuda")
    out = harness.run_cell(run, T_START, bench)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"bench: the process loaded {loaded}", file=sys.stderr)
        return 4
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
