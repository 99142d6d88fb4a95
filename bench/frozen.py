"""Frozen copies of what the benchmark feeds the program.

These are copies, kept here so that a change to the program cannot move
the yardstick:

  * ``synth_rows``: ``repro_torch.data.tabular.make_dataset`` for the
    ``synth_higgs_like`` spec (numerical columns only, 2 classes, 2%
    missing), drawn from the run's seed. Columns are float64 arrays with
    NaN for missing, as a DataFrame hands them over; the label is an object
    array of "c0" / "c1".
  * ``gbt_complete`` and ``rf_random``: the forest makers of
    ``chip_smoke.build_default_gbt`` / ``chip_smoke.random_forest``, at the
    shapes the configuration files state, drawn on the device from a
    ``torch.Generator`` in a few large calls.
  * ``request_sizes``: ``chip_smoke.request_sizes`` (log-uniform sizes).
  * the H100 SXM peaks of NVIDIA's data sheet (``workcount`` uses them).

Nothing here imports the program.
"""
from __future__ import annotations

import numpy as np
import torch


def rng(seed: int, *stream: int) -> np.random.Generator:
    """A numpy generator for one stream of one run's seed (any integer)."""
    return np.random.default_rng([seed % 2 ** 64, *stream])


def torch_gen(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((seed * 1_000_003 + stream) % 2 ** 63)
    return g


def synth_rules(data: dict, seed: int) -> dict:
    """The ground truth of one run: the random shallow forest over the
    numerical columns and the smooth part (``make_dataset``'s rules)."""
    r = rng(seed, 0)
    F = data["n_num"]
    rules = []
    for _ in range(8 + F):
        w = r.normal()
        j, t = int(r.integers(F)), r.normal()
        j2 = t2 = None
        if r.random() < 0.3 and F > 1:          # an interaction
            j2, t2 = int(r.integers(F)), r.normal()
        rules.append((w, j, t, j2, t2))
    return {"rules": rules, "beta": r.normal(size=F) * 0.5}


def synth_rows(data: dict, n: int, seed: int, stream: int,
               labels: bool = True) -> dict:
    """``n`` rows of raw columns num_0 .. num_{F-1} (float64, NaN missing)
    and, with ``labels``, "label" ("c0" / "c1", split at the median
    score). ``stream`` tells apart the datasets and batches of one run."""
    F = data["n_num"]
    truth = synth_rules(data, seed)
    r = rng(seed, 1, stream)
    X = r.standard_normal((n, F))
    out = {}
    if labels:
        score = np.zeros(n)
        for w, j, t, j2, t2 in truth["rules"]:
            cond = X[:, j] > t
            if j2 is not None:
                cond &= X[:, j2] > t2
            score += w * cond
        score += np.tanh(X @ truth["beta"])
        score += r.normal(scale=data["noise"] * max(score.std(), 1e-6),
                          size=n)
        y = (score > np.median(score)).astype(np.int64)
        out["label"] = np.array(["c0", "c1"], dtype=object)[y]
    X[r.random((n, F)) < data["missing_rate"]] = np.nan
    for j in range(F):
        out[f"num_{j}"] = np.ascontiguousarray(X[:, j])
    return out


def features(data: dict) -> list[str]:
    return [f"num_{j}" for j in range(data["n_num"])]


def spec_dict(rows: dict, data: dict) -> dict:
    """The dataspec (JSON form) a model made from the seed carries: each
    numerical column's statistics over ``rows``, and the label."""
    cols = {}
    for name in features(data):
        v = rows[name]
        present = v[~np.isnan(v)]
        cols[name] = {"name": name, "semantic": "NUMERICAL", "vocab": [],
                      "counts": {}, "mean": float(present.mean()),
                      "std": float(present.std()),
                      "min": float(present.min()),
                      "max": float(present.max()),
                      "n_missing": int(len(v) - len(present)),
                      "manually_defined": False}
    classes = data["classes"]
    cols["label"] = {"name": "label", "semantic": "CATEGORICAL",
                     "vocab": ["<OOD>", *classes],
                     "counts": {c: 1 for c in classes}, "mean": 0.0,
                     "std": 0.0, "min": 0.0, "max": 0.0, "n_missing": 0,
                     "manually_defined": False}
    return {"n_rows": len(rows[features(data)[0]]), "columns": cols}


def _column_values(rows: dict, data: dict, device) -> torch.Tensor:
    """(R, F) float32 values the thresholds are drawn from: each column's
    present values, missing cells replaced by the column's first value."""
    X = np.stack([rows[f] for f in features(data)], axis=1)
    first = np.nan_to_num(X[np.argmax(~np.isnan(X), axis=0),
                            np.arange(X.shape[1])])
    X = np.where(np.isnan(X), first[None, :], X).astype(np.float32)
    return torch.from_numpy(X).to(device)


def gbt_complete(forest: dict, data: dict, rows: dict, seed: int,
                 device) -> dict:
    """Forest arrays of ``trees`` complete trees of depth ``depth``
    (breadth-first, node i's children at 2i+1 and 2i+2): split columns
    uniform, each threshold a value of its column, leaves normal with std
    ``leaf_std``."""
    g = torch_gen(seed, 1, device)
    T, D, F = forest["trees"], forest["depth"], data["n_num"]
    n_int, M = 2 ** D - 1, 2 ** (D + 1) - 1
    vals = _column_values(rows, data, device)
    feat = torch.randint(0, F, (T, n_int), generator=g, device=device)
    row = torch.randint(0, vals.shape[0], (T, n_int), generator=g,
                        device=device)
    leaves = torch.randn((T, M), generator=g, device=device) \
        * forest["leaf_std"]
    feature = torch.full((T, M), -1, dtype=torch.int32, device=device)
    feature[:, :n_int] = feat.to(torch.int32)
    threshold = torch.zeros((T, M), dtype=torch.float32, device=device)
    threshold[:, :n_int] = vals[row, feat]
    left = torch.full((T, M), -1, dtype=torch.int32, device=device)
    left[:, :n_int] = 2 * torch.arange(n_int, dtype=torch.int32,
                                       device=device) + 1
    leaf_value = torch.where(feature >= 0, 0.0, leaves)[..., None]
    return _host(feature=feature, threshold=threshold, left_child=left,
                 leaf_value=leaf_value, n_nodes=torch.full((T,), M),
                 depth=D, tree_class=torch.zeros(T, dtype=torch.int32),
                 init_pred=torch.tensor([forest["init_pred"]]), out_dim=1)


def rf_random(forest: dict, data: dict, rows: dict, seed: int,
              device) -> dict:
    """Forest arrays of ``trees`` trees of ``splits`` splits each: every
    split at a uniformly drawn leaf of depth below ``max_depth``, on a
    uniform column at a value of that column; leaves hold a distribution
    (1 - p, p) over the 2 classes, p uniform. All trees grow together, one
    split a step."""
    g = torch_gen(seed, 2, device)
    T, S, F = forest["trees"], forest["splits"], data["n_num"]
    D, M = forest["max_depth"], 2 * forest["splits"] + 1
    vals = _column_values(rows, data, device)
    u = torch.rand((S, T), generator=g, device=device, dtype=torch.float64)
    feat = torch.randint(0, F, (S, T), generator=g, device=device)
    row = torch.randint(0, vals.shape[0], (S, T), generator=g, device=device)
    p = torch.rand((T, M), generator=g, device=device)
    i64 = dict(dtype=torch.int64, device=device)
    ar = torch.arange(T, device=device)
    feature = torch.full((T, M), -1, **i64)
    threshold = torch.zeros((T, M), dtype=torch.float32, device=device)
    left = torch.full((T, M), -1, **i64)
    depth = torch.zeros((T, M), **i64)
    open_ = torch.zeros((T, M), **i64)        # the splittable leaves
    n_open = torch.ones(T, **i64)
    for s in range(S):
        k = torch.minimum((u[s] * n_open).to(torch.int64), n_open - 1)
        node = open_[ar, k]
        nxt = 2 * s + 1
        feature[ar, node] = feat[s]
        threshold[ar, node] = vals[row[s], feat[s]]
        left[ar, node] = nxt
        d = depth[ar, node] + 1
        depth[:, nxt] = d
        depth[:, nxt + 1] = d
        deeper = d < D
        last = open_[ar, n_open - 1]
        # the left child takes the split leaf's place and the right child
        # goes last; at the depth cap the last leaf takes the place instead
        open_[ar, k] = torch.where(deeper, nxt, last)
        open_[ar, torch.where(deeper, n_open, n_open - 1)] = \
            torch.where(deeper, nxt + 1, last)
        n_open = torch.where(deeper, n_open + 1, n_open - 1)
    dist = torch.stack([1.0 - p, p], dim=-1)
    leaf_value = torch.where((feature >= 0)[..., None], 0.0, dist)
    return _host(feature=feature.to(torch.int32), threshold=threshold,
                 left_child=left.to(torch.int32), leaf_value=leaf_value,
                 n_nodes=torch.full((T,), M), depth=int(depth.max()),
                 out_dim=2)


MAKERS = {"gbt_complete": gbt_complete, "rf_random": rf_random}


def _host(**fields) -> dict:
    out = {}
    for k, v in fields.items():
        out[k] = v.cpu().numpy() if isinstance(v, torch.Tensor) else v
    T, M = out["feature"].shape
    out["cat_mask"] = np.zeros((T, M, 8), np.uint32)
    out["n_nodes"] = out["n_nodes"].astype(np.int32)
    out["leaf_value"] = out["leaf_value"].astype(np.float32)
    return out


def request_sizes(n_requests: int, lo: int, hi: int, seed: int) -> np.ndarray:
    """Log-uniform request sizes from ``lo`` to ``hi`` rows."""
    r = rng(seed, 3)
    return np.round(np.exp(r.uniform(np.log(lo), np.log(hi), n_requests))
                    ).astype(np.int64)


# NVIDIA H100 SXM data sheet (dense, 700 W): HBM3 bytes/s, fp32 ops/s
# outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12
