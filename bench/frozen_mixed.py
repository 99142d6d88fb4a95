"""What the benchmark feeds the program for the mixed-column configuration
(``bench/configs/gbt_rank1_adult.json``), made from the run's seed:

  * ``adult_rows``: raw columns at the widths of UCI Adult as a DataFrame
    of ``adult.data`` hands them over: the 6 numerical columns as int64
    arrays, the 8 categorical ones as object arrays of ``str`` with None
    where a value is missing, and, with ``labels``, the label ``income``.
  * ``spec_dict``: the dataspec (JSON form) a model trained on such rows
    carries, as the port's ``infer_dataspec`` writes it: each numerical
    column's statistics, each categorical column's vocabulary ("<OOD>"
    first, then the present values by count, ties by value).
  * ``gbt_mixed``: a forest at the rank1 GBT's trained shape, drawn on the
    device from a ``torch.Generator``: axis-aligned thresholds on the
    numerical columns, sparse-oblique projections over them (MIN_MAX
    weights, as the port folds the normalisation into the weights), and
    categorical-set masks over each column's vocabulary.

A missing categorical value is encoded as the column's most frequent
value (code 1), so it takes that code's branch of every mask: the port
keeps no other direction for it. Nothing here imports the program.
"""
from __future__ import annotations

import numpy as np
import torch

from bench.frozen import rng, torch_gen
from bench.reference_mixed import pairwise

OOD = "<OOD>"
MASK_WORDS = 8
THRESHOLD_ROWS = 2048       # sample rows the thresholds are drawn among
PROJECTION_NODES = 64       # oblique nodes projected at a time


def features(data: dict) -> list[str]:
    return list(data["columns"])


def numerical(data: dict) -> list[str]:
    return [c for c in data["columns"] if c in data["numerical"]]


def _shares(data: dict, col: str) -> np.ndarray:
    """Frequencies of a categorical column's values: the first takes
    ``top_share``, the k-th of the rest a share of what is left in
    proportion to 1 / k (Zipf's law), so that every published value
    appears in a training set of Adult's size."""
    n = len(data["categorical"][col])
    top = data["top_share"][col]
    if n == 1:
        return np.ones(1)
    tail = 1.0 / np.arange(1, n)
    return np.concatenate([[top], (1 - top) * tail / tail.sum()])


EDUCATION_NUM = {"Preschool": 1, "1st-4th": 2, "5th-6th": 3, "7th-8th": 4,
                 "9th": 5, "10th": 6, "11th": 7, "12th": 8, "HS-grad": 9,
                 "Some-college": 10, "Assoc-voc": 11, "Assoc-acdm": 12,
                 "Bachelors": 13, "Masters": 14, "Prof-school": 15,
                 "Doctorate": 16}


def adult_rows(data: dict, n: int, seed: int, stream: int,
               labels: bool = True) -> dict:
    """``n`` rows of raw Adult-width columns (see the module's docstring);
    ``stream`` tells apart the datasets and batches of one run."""
    r = rng(seed, 11, stream)
    rows: dict = {}
    codes = {}
    for col, values in data["categorical"].items():
        c = r.choice(len(values), size=n, p=_shares(data, col))
        codes[col] = c
        rows[col] = np.array(values, dtype=object)[c]
    lim = data["numerical"]

    def clip(name, v):
        return np.clip(np.round(v), lim[name]["min"],
                       lim[name]["max"]).astype(np.int64)

    rows["age"] = clip("age", 17 + r.gamma(2.0, 10.8, n))
    rows["fnlwgt"] = clip("fnlwgt", r.lognormal(np.log(178_000), 0.55, n))
    edu = np.array([EDUCATION_NUM[v] for v in data["categorical"]
                    ["education"]], np.int64)
    rows["education_num"] = edu[codes["education"]]
    gain = np.exp(r.uniform(np.log(114), np.log(99_999), n))
    rows["capital_gain"] = clip("capital_gain",
                                np.where(r.random(n) < 0.083, gain, 0))
    loss = r.normal(1_900, 350, n)
    rows["capital_loss"] = clip("capital_loss",
                                np.where(r.random(n) < 0.047, loss, 0))
    hours = np.where(r.random(n) < 0.47, 40, r.normal(40, 12, n))
    rows["hours_per_week"] = clip("hours_per_week", hours)
    # missing cells at the published counts per 32,561 rows; occupation is
    # missing wherever workclass is
    per = data["rows_published"]
    u = r.random(n)
    miss = {"workclass": u < data["missing"]["workclass"] / per,
            "occupation": u < data["missing"]["occupation"] / per,
            "native_country": r.random(n) < data["missing"]["native_country"]
            / per}
    for col, m in miss.items():
        rows[col][m] = None
    if labels:
        married = codes["marital_status"] == 0
        score = (0.3 * (rows["education_num"] - 10)
                 + 0.03 * (rows["age"] - 38) + 1.6 * married
                 + 0.4 * (codes["sex"] == 0)
                 + 1.2 * (rows["capital_gain"] > 5_000)
                 + 0.6 * (rows["capital_loss"] > 1_500)
                 + 0.03 * (rows["hours_per_week"] - 40)
                 + 0.5 * ((codes["occupation"] <= 2) & ~miss["occupation"])
                 + r.normal(0.0, 1.0, n))
        cut = np.quantile(score, 1.0 - data["positive_share"])
        rows[data["label"]] = np.array(data["classes"], dtype=object)[
            (score > cut).astype(np.int64)]
    return {k: rows[k] for k in features(data)
            + ([data["label"]] if labels else [])}


def spec_dict(rows: dict, data: dict) -> dict:
    """The dataspec (JSON form) of a model trained on ``rows``."""
    cols = {}
    for name in features(data):
        v = rows[name]
        base = {"name": name, "vocab": [], "counts": {}, "mean": 0.0,
                "std": 0.0, "min": 0.0, "max": 0.0, "n_missing": 0,
                "manually_defined": False}
        if name in data["numerical"]:
            x = np.asarray(v, np.float64)
            base.update(semantic="NUMERICAL", mean=float(x.mean()),
                        std=float(x.std()), min=float(x.min()),
                        max=float(x.max()))
        else:
            present = [s for s in v if s is not None]
            uniq, cnt = np.unique(np.array(present, dtype=str),
                                  return_counts=True)
            order = sorted(range(len(uniq)), key=lambda i: (-cnt[i], uniq[i]))
            base.update(semantic="CATEGORICAL",
                        vocab=[OOD] + [str(uniq[i]) for i in order],
                        counts={str(uniq[i]): int(cnt[i]) for i in order},
                        n_missing=len(v) - len(present))
        cols[name] = base
    classes = data["classes"]
    cols[data["label"]] = {"name": data["label"], "semantic": "CATEGORICAL",
                           "vocab": [OOD, *classes],
                           "counts": {c: 1 for c in classes}, "mean": 0.0,
                           "std": 0.0, "min": 0.0, "max": 0.0, "n_missing": 0,
                           "manually_defined": False}
    return {"n_rows": len(rows[features(data)[0]]), "columns": cols}


# ------------------------------------------------------------- the forest

def _grow(T: int, splits: torch.Tensor, D: int, g: torch.Generator,
          device) -> tuple:
    """Shapes of T trees, tree t with ``splits[t]`` splits: every split at
    a uniformly drawn leaf of depth below D; children allocated in pairs
    (node k's at ``left_child[k]`` and ``+ 1``). Returns (is_split,
    left_child, depth), (T, M) each, M = 2 * max(splits) + 1."""
    S = int(splits.max())
    M = 2 * S + 1
    i64 = dict(dtype=torch.int64, device=device)
    ar = torch.arange(T, device=device)
    u = torch.rand((S, T), generator=g, device=device, dtype=torch.float64)
    split = torch.zeros((T, M), dtype=torch.bool, device=device)
    left = torch.full((T, M), -1, **i64)
    depth = torch.zeros((T, M), **i64)
    open_ = torch.zeros((T, M), **i64)
    n_open = torch.ones(T, **i64)
    for s in range(S):
        live = s < splits
        k = torch.minimum((u[s] * n_open).to(torch.int64), n_open - 1)
        node = open_[ar, k]
        nxt = 2 * s + 1
        split[ar[live], node[live]] = True
        left[ar[live], node[live]] = nxt
        d = depth[ar, node] + 1
        depth[:, nxt] = torch.where(live, d, 0)
        depth[:, nxt + 1] = torch.where(live, d, 0)
        deeper = d < D
        last = open_[ar, n_open - 1]
        new_k = torch.where(deeper, nxt, last)
        open_[ar, k] = torch.where(live, new_k, open_[ar, k])
        slot = torch.where(deeper, n_open, n_open - 1)
        open_[ar, slot] = torch.where(
            live, torch.where(deeper, nxt + 1, last), open_[ar, slot])
        n_open = torch.where(live, torch.where(deeper, n_open + 1,
                                               n_open - 1), n_open)
    return split, left, depth


def _between(sorted_vals: torch.Tensor, pick: torch.Tensor) -> torch.Tensor:
    """A threshold between two adjacent distinct values of each row of
    ``sorted_vals`` (n, R), at the ``pick``-th value (n,): the midpoint of
    that value and the next larger one (the next smaller one where it is
    the largest), rounded to float32."""
    n, R = sorted_vals.shape
    lo = sorted_vals.gather(1, pick[:, None])
    up = torch.searchsorted(sorted_vals, lo, right=True)          # (n, 1)
    top = up >= R
    down = (torch.searchsorted(sorted_vals, lo) - 1).clamp_min(0)
    hi = sorted_vals.gather(1, up.clamp_max(R - 1))
    below = sorted_vals.gather(1, down)
    a = torch.where(top, below, lo)
    b = torch.where(top, lo, hi)
    return ((a + b) / 2)[:, 0].to(torch.float32)


def gbt_mixed(forest: dict, data: dict, rows: dict, spec: dict, seed: int,
              device) -> dict:
    """Forest arrays of ``trees`` trees at the trained shape: a tree's
    split count drawn from ``splits_hist`` (its entry k the trained trees
    with k splits), every
    split at a uniformly drawn leaf of depth below ``depth``; of a tree's
    splits, drawn at random, ``oblique_share`` are oblique and
    ``categorical_share`` categorical (rounded, one at least), the rest
    axis-aligned; an axis-aligned or categorical split's column is drawn
    by the trained model's counts (``axis_columns``,
    ``categorical_columns``), an oblique one's columns uniformly.

      * axis-aligned: the midpoint of two adjacent distinct values of its
        column over ``THRESHOLD_ROWS`` rows of ``rows``, at a uniformly
        drawn row (so thresholds fall where the rows are);
      * oblique: ``nnz`` columns drawn from ``nnz_shares`` (its entry k the
        share of projections with k + 1 columns), weights +-1 / (max -
        min) of each column over the dataspec (MIN_MAX, folded as the port
        folds it), the pairs padded to P = the numerical columns with
        weight 0 on column 0; the threshold between two adjacent distinct
        projections of the same rows;
      * categorical: each code of the column's vocabulary ("<OOD>"
        included) goes right with probability 1/2, at least one present
        value each way.

    Leaves are normal with std ``leaf_std``; the initial prediction is
    ``init_pred``."""
    g = torch_gen(seed, 21, device)
    T, D = forest["trees"], forest["depth"]
    feats = features(data)
    num_idx = torch.tensor([feats.index(c) for c in numerical(data)],
                           device=device)
    cat_names = [c for c in feats if c not in data["numerical"]]
    cat_idx = torch.tensor([feats.index(c) for c in cat_names],
                           device=device)
    vsize = torch.tensor([len(spec["columns"][c]["vocab"])
                          for c in cat_names], device=device)
    Fn, P = len(num_idx), len(num_idx)

    hist = torch.tensor(forest["splits_hist"], dtype=torch.float64,
                        device=device)
    splits = torch.multinomial(hist, T, replacement=True, generator=g)
    split, left, depth = _grow(T, splits, D, g, device)
    M = split.shape[1]
    # each tree's splits take the kinds at the shares, one of each at
    # least: its splits in a drawn order, the first oblique, the next
    # categorical, the rest axis-aligned
    key = torch.where(split, torch.rand((T, M), generator=g, device=device),
                      2.0)
    rank = key.argsort(dim=1).argsort(dim=1)
    n_obl = (splits * forest["oblique_share"]).round().clamp(1, None)
    n_cat = (splits * forest["categorical_share"]).round().clamp(1, None)
    n_cat = torch.minimum(n_cat, splits - n_obl - 1)
    kind = torch.where(rank < n_obl[:, None], 2,
                       torch.where(rank < (n_obl + n_cat)[:, None], 1, 0))
    kind = torch.where(split, kind, -1)          # -1 leaf, 0 axis, 1 cat, 2 obl

    # rows the thresholds are drawn among: the first THRESHOLD_ROWS
    R = min(THRESHOLD_ROWS, len(rows[feats[0]]))
    vals = torch.from_numpy(np.stack(
        [np.asarray(rows[feats[j]][:R], np.float64) for j in
         num_idx.tolist()], 1).astype(np.float32)).to(device)    # (R, Fn)
    full = torch.zeros((R, len(feats)), dtype=torch.float32, device=device)
    full[:, num_idx] = vals

    feature = torch.full((T, M), -1, dtype=torch.int64, device=device)
    threshold = torch.zeros((T, M), dtype=torch.float32, device=device)
    cat_mask = torch.zeros((T, M, MASK_WORDS), dtype=torch.int64,
                           device=device)
    obl_w = torch.zeros((T, M, P), dtype=torch.float32, device=device)
    obl_f = torch.zeros((T, M, P), dtype=torch.int64, device=device)

    def columns(names: list[str], key: str, n: int) -> torch.Tensor:
        """``n`` draws of a column among ``names``, by the trained counts
        of ``forest[key]``."""
        w = torch.tensor([float(forest[key].get(c, 0)) for c in names],
                         dtype=torch.float64, device=device)
        return torch.multinomial(w, n, replacement=True, generator=g)

    ax = (kind == 0).nonzero()
    if len(ax):
        c = columns(numerical(data), "axis_columns", len(ax))
        pick = torch.randint(0, R, (len(ax),), generator=g, device=device)
        srt = vals.T.sort(dim=1).values                      # (Fn, R)
        feature[ax[:, 0], ax[:, 1]] = num_idx[c]
        threshold[ax[:, 0], ax[:, 1]] = _between(srt[c], pick)

    ct = (kind == 1).nonzero()
    if len(ct):
        c = columns(cat_names, "categorical_columns", len(ct))
        V = vsize[c]
        bits = torch.rand((len(ct), MASK_WORDS * 32), generator=g,
                          device=device) < 0.5
        code = torch.arange(MASK_WORDS * 32, device=device)
        bits &= code[None, :] < V[:, None]
        present = (code[None, :] >= 1) & (code[None, :] < V[:, None])
        right = (bits & present).sum(1)
        # at least one present value each way: flip a drawn one where not
        fix = torch.randint(0, 2 ** 30, (len(ct),), generator=g,
                            device=device) % (V - 1).clamp_min(1) + 1
        bad = (right == 0) | (right == present.sum(1))
        bits[bad, fix[bad]] = ~bits[bad, fix[bad]]
        words = (bits.view(len(ct), MASK_WORDS, 32).to(torch.int64)
                 << torch.arange(32, device=device)).sum(-1)
        feature[ct[:, 0], ct[:, 1]] = cat_idx[c]
        cat_mask[ct[:, 0], ct[:, 1]] = words

    ob = (kind == 2).nonzero()
    if len(ob):
        shares = torch.tensor(forest["nnz_shares"], dtype=torch.float64,
                              device=device)
        nnz = torch.multinomial(shares, len(ob), replacement=True,
                                generator=g) + 1
        order = torch.rand((len(ob), Fn), generator=g,
                           device=device).argsort(dim=1)
        sign = torch.randint(0, 2, (len(ob), Fn), generator=g,
                             device=device) * 2 - 1
        cols_num = [spec["columns"][c] for c in numerical(data)]
        lo = torch.tensor([c["min"] for c in cols_num], dtype=torch.float64,
                          device=device)
        hi = torch.tensor([c["max"] for c in cols_num], dtype=torch.float64,
                          device=device)
        scale = 1.0 / torch.clamp_min(hi - lo, 1e-12)
        live = torch.arange(P, device=device)[None, :] < nnz[:, None]
        w = torch.where(live, sign * scale[order], 0.0).to(torch.float32)
        f = torch.where(live, num_idx[order], 0)
        pick = torch.randint(0, R, (len(ob),), generator=g, device=device)
        feature[ob[:, 0], ob[:, 1]] = -2
        obl_w[ob[:, 0], ob[:, 1]] = w
        obl_f[ob[:, 0], ob[:, 1]] = f
        # float32 projections of the rows in the port's order, (n, R), a
        # block of nodes at a time so that set-up holds no more than the
        # forest and the traffic
        for k in range(0, len(ob), PROJECTION_NODES):
            b = slice(k, k + PROJECTION_NODES)
            proj = pairwise(w[b, None, :] * full[:, f[b]].permute(1, 0, 2)) \
                .sort(dim=1).values
            threshold[ob[b, 0], ob[b, 1]] = _between(proj, pick[b])

    leaves = torch.randn((T, M), generator=g, device=device) \
        * forest["leaf_std"]
    leaf_value = torch.where(split, 0.0, leaves)[..., None]
    n_nodes = 2 * splits + 1
    host = lambda t: t.cpu().numpy()
    return {"feature": host(feature).astype(np.int32),
            "threshold": host(threshold),
            "cat_mask": host(cat_mask).astype(np.uint32),
            "left_child": host(left).astype(np.int32),
            "leaf_value": host(leaf_value).astype(np.float32),
            "n_nodes": host(n_nodes).astype(np.int32),
            "depth": int(depth.max()),
            "tree_class": np.zeros(T, np.int32),
            "init_pred": np.array([forest["init_pred"]], np.float32),
            "out_dim": 1,
            "obl_weights": host(obl_w),
            "obl_features": host(obl_f).astype(np.int32)}


MAKERS = {"gbt_mixed": gbt_mixed}
