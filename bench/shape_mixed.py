"""The trained shape the mixed-column forest maker draws at: trains the
port's rank1 GBT (``bench/configs/gbt_rank1_adult.json``) on Adult's
32,561 training rows made from the seed, and prints one JSON line with
its trees' splits and depths, the shares of axis-aligned, oblique and
categorical conditions, the columns an oblique projection holds, the mask
words used and the leaves' spread.

    python3 bench/shape_mixed.py --seed 1 --trees 300 [--device cuda] \\
        [--out out/shape_mixed.json]

The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def shape(forest) -> dict:
    """The shape numbers of a trained forest's SoA."""
    T = forest.n_trees
    internal = forest.left_child >= 0
    feat = forest.feature
    obl = internal & (feat == -2)
    cat = internal & ~obl & forest.cat_mask.any(-1)
    axis = internal & ~obl & ~cat
    splits = internal.sum(1)
    n = int(internal.sum())
    nnz = (forest.obl_weights[obl] != 0).sum(-1) if obl.any() \
        else np.zeros(0, np.int64)
    depth = np.zeros_like(feat)
    for t in range(T):
        for k in range(int(forest.n_nodes[t])):
            if internal[t, k]:
                depth[t, forest.left_child[t, k]] = depth[t, k] + 1
                depth[t, forest.left_child[t, k] + 1] = depth[t, k] + 1
    tree_depth = [int(depth[t, :int(forest.n_nodes[t])].max())
                  for t in range(T)]
    words = forest.cat_mask[cat]
    used = sorted({int(w) for w in np.nonzero(words.any(0))[0]}) \
        if cat.any() else []
    leaves = forest.leaf_value[..., 0][(~internal)
                                       & (np.arange(feat.shape[1])[None, :]
                                          < forest.n_nodes[:, None])]
    names = forest.feature_names
    by_col = lambda kind: {names[j]: int(c) for j, c in enumerate(
        np.bincount(feat[kind], minlength=len(names))) if c}
    return {
        "trees": T, "max_nodes": int(feat.shape[1]),
        "axis_columns": by_col(axis), "categorical_columns": by_col(cat),
        "splits_min": int(splits.min()), "splits_mean": float(splits.mean()),
        "splits_max": int(splits.max()),
        "splits_hist": np.bincount(splits).tolist(),
        "depth_hist": np.bincount(tree_depth).tolist(),
        "axis_share": float(axis.sum() / n), "oblique_share":
            float(obl.sum() / n), "categorical_share": float(cat.sum() / n),
        "P": int(forest.obl_weights.shape[-1])
            if forest.obl_weights is not None else 0,
        "nnz_hist": np.bincount(nnz).tolist(),
        "mask_words_used": used,
        "mask_ood_bit_share": float((words[:, 0] & 1).mean())
            if cat.any() else 0.0,
        "leaf_std": float(leaves.std()), "leaf_abs_max":
            float(np.abs(leaves).max()),
        "init_pred": float(forest.init_pred[0]),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--trees", type=int, default=300)
    ap.add_argument("--rows", type=int, default=0,
                    help="rows to train on (0: the configuration's "
                         "rows_published)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--early-stopping", default="",
                    help="in place of the configuration's early_stopping")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from bench import frozen_mixed, harness
    import repro_torch.core.gbt  # noqa: F401  (registers the learner)
    from repro_torch.core.api import get_learner
    cfg = harness.load_json(ROOT / "bench/configs/gbt_rank1_adult.json")
    data = cfg["data"]
    n = args.rows or data["rows_published"]
    rows = frozen_mixed.adult_rows(data, n, args.seed, 0)
    hp = {**cfg["hparams"], "num_trees": args.trees}
    if args.early_stopping:
        hp["early_stopping"] = args.early_stopping
    t0 = time.perf_counter()
    model = get_learner(cfg["learner"])(
        label=data["label"], seed=cfg["learner_seed"], device=args.device,
        **hp).train(rows)
    seconds = time.perf_counter() - t0
    logs = model.training_logs
    out = {"seed": args.seed, "rows": n, "seconds": seconds,
           "early_stopping": hp.get("early_stopping", "LOSS_INCREASE"),
           "growth_engine": logs.get("growth_engine"),
           "engine_fallback": logs.get("engine_fallback"),
           "histogram_backend": logs.get("histogram_backend"),
           "device": args.device, **shape(model.forest)}
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
