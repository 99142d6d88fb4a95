"""Host time of the Random Forest's winner-take-all head (``aggregate_rf``
through the ``_RfFinalize`` that ``RandomForestModel`` compiles) on a
per-tree stack as the traversal engines copy it back.

    python3 benchmarks/torch_head_times.py [--case c2 c3] [--rows 65536]
        [--trees 300] [--out FILE]

Cases:
  * ``c2``: (rows, trees, 2) float32 leaves made as the benchmark's RF
    (``bench/frozen.py`` ``rf_random``) makes them, (1 - p, p) with p
    uniform: the ``rf_higgs.score_bulk`` cell's head.
  * ``c3``: (rows, trees, 3) float32 distributions over 3 classes.

Per case: the median of 7 windows, each the mean of as many calls as fill
about 0.2 s, in milliseconds a call; ``--out`` appends the JSON line to
FILE. Runs on the host alone (no device); the package is the one on
``PYTHONPATH`` (``src`` by default), so two trees can be timed in one
process's environment each. To compare two trees, alternate the processes,
e.g. 10 turns a side:

    for i in $(seq 10); do for t in PARENT CHANGE; do
        PYTHONPATH=$t/src python3 benchmarks/torch_head_times.py \\
            --out times.jsonl; done; done
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def leaves(rows: int, trees: int, classes: int, seed: int) -> np.ndarray:
    r = np.random.default_rng(seed)
    if classes == 2:
        p = r.random((rows, trees), dtype=np.float32)
        return np.stack([1 - p, p], -1)
    v = r.random((rows, trees, classes), dtype=np.float32)
    return v / v.sum(-1, keepdims=True)


def rf_head(classes: int):
    """The head a winner-take-all classification RF of finite leaves
    compiles."""
    from repro_torch.core import Task
    from repro_torch.core.models import RandomForestModel
    model = RandomForestModel.__new__(RandomForestModel)
    model.winner_take_all, model.task = True, Task.CLASSIFICATION
    model.forest = SimpleNamespace(
        leaf_value=np.full((1, 1, classes), 1.0 / classes, np.float32))
    return model._compile_finalize()


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
    ap.add_argument("--case", choices=("c2", "c3"), nargs="+",
                    default=["c2", "c3"])
    ap.add_argument("--rows", type=int, default=65536)
    ap.add_argument("--trees", type=int, default=300)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not os.environ.get("PYTHONPATH"):
        sys.path.insert(0, str(ROOT / "src"))
    out = {"package": None, "rows": args.rows, "trees": args.trees,
           "ms_per_call": {}}
    for case in args.case:
        classes = int(case[1:])
        head = rf_head(classes)
        per_tree = leaves(args.rows, args.trees, classes, seed=classes)
        out["ms_per_call"][case] = 1e3 * time_call(lambda: head(per_tree))
        del per_tree
    out["package"] = str(Path(sys.modules["repro_torch"].__file__).parent)
    line = json.dumps(out)
    print(line)
    if args.out:
        with open(args.out, "a") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
