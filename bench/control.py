"""The readings the limits of ``bench/limits/`` are set from, on the chip.

    python3 bench/control.py --cell gbt_higgs.score_bulk --seeds 1,2,3 \\
        --mode control --out out/control.jsonl

Modes (one process, one JSON line per seed and reading, appended to
``--out``):

  * ``program``: the cell's numbers from sound runs of the program at the
    cell's own sizes, with a window of ``--seconds`` (long enough to
    compare as many answers as a run does); the lower readings.
  * ``control``: the reference computed in bfloat16 put in the program's
    place, judged by the same numbers at the same sizes; the upper
    readings.
  * ``faults`` (training cells): the reference put in the program's place
    with each fault a training can have: a tree that leaves the boosting
    state unchanged, a tree grown on half the rows, a leaf altered where
    it is made, the state left unmoved from tree 10 on, the boosting
    stopped after 4 trees.

The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TRAIN_FAULTS = ("unchanged", "half", "altered", "stale", "early")


def readings(cell: str, seed: int, mode: str, seconds: float,
             device: str = "cuda", overrides: dict | None = None) -> list:
    """[(label, {number: value})] of one seed."""
    from bench import frozen, harness
    from bench.generators import score, serve, train
    bench = harness.benchmark()
    run = harness.make_run(bench, cell, seed, seconds, False, device,
                           overrides)
    kind = run.traffic["generator"]
    if mode == "program":
        out = harness.run_cell(run, time.perf_counter(), bench)
        return [("program", {k: v["value"] for k, v in out["checks"].items()}
                 | {"correct": out["correct"]})]
    if kind == "train":
        data = frozen.synth_rows(run.config["data"], run.config["rows"],
                                 seed, 0)
        held = frozen.synth_rows(run.config["data"],
                                 run.params["held_out_rows"], seed, 10_000)
        # a forest at the trained model's shape, for the held-out answers
        arrays = frozen.gbt_complete(run.config["forest"], run.config["data"],
                                     data, seed, run.device)
        cases = [("control", "bfloat16", None)] if mode == "control" else \
            [(f"fault_{f}", "float64", f) for f in TRAIN_FAULTS]
        return [(label, train.follow_checks(
            run, data, held, None, arrays, None, precision=precision,
            fault=fault))
            for label, precision, fault in cases]
    drv = {"score": score, "serve": serve}[kind]
    state = drv.setup(run)
    if kind == "score":
        picks = score.sample_calls(run, run.params["check_calls"]
                                   * len(state.pool))
        kept = [(i % len(state.pool), None) for i in picks]
        state.model = None
        return [("control", {"pred_gap": score.score_gap(
            run, state, kept, "bfloat16")})]
    r = frozen.rng(seed, 5)
    n = len(state.requests)
    picks = sorted(set(r.choice(n, size=min(run.params["check_requests"], n),
                                replace=False).tolist()))
    state.server = state.model = None
    return [("control", {"pred_gap": serve.request_gap(
        run, state, [(k, None) for k in picks], "bfloat16")})]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--mode", choices=("program", "control", "faults"),
                    required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        for label, nums in readings(args.cell, seed, args.mode, args.seconds):
            line = {"cell": args.cell, "seed": seed, "reading": label,
                    "seconds": round(time.perf_counter() - t0, 2), **nums}
            print(json.dumps(line), flush=True)
            with open(out, "a") as fh:
                fh.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
