"""The readings the limits of the mixed-column cell and the default-engine
training cell are set from, on the chip (``control.py``'s counterpart for
the ``score_mixed`` and ``train_engine`` generators).

    python3 bench/control_mixed.py --cell gbt_rank1_adult.score_bulk_mixed \\
        --seeds 1,2,3 --mode control --out out/control_mixed.jsonl

Modes (one process, one JSON line per seed and reading, appended to
``--out``):

  * ``program``: the cell's numbers from sound runs of the program at the
    cell's own sizes, with a window of ``--seconds``; the lower readings,
    with the run's end-to-end metrics and notes beside them.
  * ``control`` (the mixed cell): the reference computed in bfloat16 put
    in the program's place, judged by ``pred_gap`` on the calls a run
    checks; an upper reading.
  * ``faults`` (the mixed cell): the reference with each planted fault
    (``reference_mixed.FAULTS``: an oblique weight dropped, a mask bit
    flipped, missing categories sent down the other branch) in the
    program's place, judged the same way; the other upper readings.

The training cell's upper readings are ``control.py``'s for
``gbt_higgs.train``: its reference grows the same trees whatever engine
the program ran. The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(cell: str, seed: int, mode: str, seconds: float,
             device: str = "cuda", overrides: dict | None = None) -> list:
    """[(label, {number: value})] of one seed."""
    from bench import harness, reference_mixed
    from bench.generators import score_mixed
    bench = harness.benchmark()
    run = harness.make_run(bench, cell, seed, seconds, False, device,
                           overrides)
    if mode == "program":
        out = harness.run_cell(run, time.perf_counter(), bench)
        return [("program", {k: v["value"] for k, v in out["checks"].items()}
                 | {"correct": out["correct"], "calls": out["attempted"],
                    "failed": out["failed"]}
                 | {k: v["value"] for k, v in out["metrics"].items()}
                 | {"notes": out["notes"]})]
    if run.traffic["generator"] != "score_mixed":
        raise SystemExit(f"{mode} readings are for the mixed cell; take "
                         "the training cell's from control.py")
    state = score_mixed.setup(run)
    state.model = None
    picks = score_mixed.sample_calls(run, run.params["check_calls"]
                                     * len(state.pool))
    kept = [(i % len(state.pool), None) for i in picks]
    cases = [("control", "bfloat16", None)] if mode == "control" else \
        [(f"fault_{f}", "float64", f) for f in reference_mixed.FAULTS]
    return [(label, {"pred_gap": score_mixed.score_gap(
        run, state, kept, precision, fault)})
        for label, precision, fault in cases]


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
