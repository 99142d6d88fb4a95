"""Host time of the raw-column encoder on raw rows: ``BatchEncoder.encode``
(serving) or ``encode_dataset`` (training).

    python3 benchmarks/torch_encode_times.py
        [--case higgs|adult|distinct|dataset] [--rows 1 52 300 65536]
        [--typed 1] [--out FILE]

Cases:
  * ``higgs`` (the default): 28 NUMERICAL float64 columns with 2% NaN for
    missing, the columns the benchmark's HIGGS scoring and serving cells
    send. ``--typed 0`` sends the same values as Python lists, which take
    the per-column object path.
  * ``adult``: the mixed cell's batches (``bench/frozen_mixed.py``): 6
    int64 columns and 8 CATEGORICAL object columns of ``str`` with None,
    against the dataspec of 32,561 training rows of the same make.
  * ``distinct``: one CATEGORICAL column whose every value is a distinct
    string (an ID column; its vocabulary holds 4,096 of the ids).
  * ``dataset``: ``encode_dataset`` over the ``higgs`` case's columns, the
    parse a training makes of its raw columns (``--rows 100000``).

Per row count: the median of 7 windows, each the mean of as many calls as
fill about 0.2 s, in microseconds a call; ``--out`` appends the JSON line
to FILE. Runs on the host alone (no device); the package is the one on
``PYTHONPATH`` (``src`` by default), so two trees can be timed in one
process's environment each. To compare two trees, alternate the processes,
e.g. 10 turns a side:

    for i in $(seq 10); do for t in PARENT CHANGE; do
        PYTHONPATH=$t/src python3 benchmarks/torch_encode_times.py \
            --case adult --rows 65536 --out times.jsonl; done; done
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


def adult_case():
    """(features, spec, batch maker) of the mixed cell's columns."""
    sys.path.append(str(ROOT))
    from bench import frozen_mixed, harness
    from repro_torch.core.dataspec import spec_from_dict
    data = harness.load_json(harness.BENCH / "configs"
                             / "gbt_rank1_adult.json")["data"]
    trained = frozen_mixed.adult_rows(data, data["rows_published"], 0, 0)
    spec = spec_from_dict(frozen_mixed.spec_dict(trained, data))
    return (frozen_mixed.features(data), spec,
            lambda n: frozen_mixed.adult_rows(data, n, n + 1, 100,
                                              labels=False))


def distinct_case():
    """(features, spec, batch maker) of one all-distinct string column."""
    from repro_torch.core.dataspec import OOD, Column, DataSpec, Semantic
    vocab = [f"id_{i:07d}" for i in range(4096)]
    col = Column(name="id", semantic=Semantic.CATEGORICAL,
                 vocab=[OOD] + vocab, counts=dict.fromkeys(vocab, 1))
    spec = DataSpec(columns={"id": col}, n_rows=4096)

    def batch(n):
        r = np.random.default_rng(n + 1)
        ids = r.permutation(10 * max(n, 4096))[:n]
        return {"id": np.array([f"id_{i:07d}" for i in ids], dtype=object)}
    return ["id"], spec, batch


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
    ap.add_argument("--case",
                    choices=("higgs", "adult", "distinct", "dataset"),
                    default="higgs")
    ap.add_argument("--rows", type=int, nargs="+", default=[1, 52, 300, 65536])
    ap.add_argument("--typed", type=int, choices=(0, 1), default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not os.environ.get("PYTHONPATH"):
        sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.dataspec import (BatchEncoder, encode_dataset,
                                           infer_dataspec)
    if args.case in ("higgs", "dataset"):
        names = [f"num_{j}" for j in range(F)]
        spec = infer_dataspec(columns(4096, 0))
        make = lambda n: columns(n, n + 1)
    else:
        case = adult_case if args.case == "adult" else distinct_case
        names, spec, make = case()
    if args.case == "dataset":
        encode = lambda batch: encode_dataset(batch, spec)
    else:
        encode = BatchEncoder(spec, names).encode
    out = {"package": str(Path(sys.modules["repro_torch"].__file__).parent),
           "case": args.case, "typed": bool(args.typed), "us_per_call": {}}
    for n in args.rows:
        batch = make(n)
        if not args.typed:
            batch = {k: v.tolist() for k, v in batch.items()}
        out["us_per_call"][n] = 1e6 * time_call(lambda: encode(batch))
    line = json.dumps(out)
    print(line)
    if args.out:
        with open(args.out, "a") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
