"""The plain reference that decides ``correct``.

Plain PyTorch (float64 unless a lower precision is asked for, on whatever
device it is handed) over the benchmark's own inputs: the raw columns, the
forest arrays the benchmark made, and the program's outputs, which it reads
only to judge them. It imports nothing of the program, and derives again
what the program derived: the column means that replace a missing value,
the bins, the splits and leaves of the first trees, the traversal and the
heads.

``precision="bfloat16"`` computes the same in bfloat16 (the sums in
float32): that is the control, the step below the float32 that the
configurations state, which the limits must refuse. ``fault=`` plants one
of the faults a training can have into the reference put in the program's
place (``grow_gbt``).
"""
from __future__ import annotations

import numpy as np
import torch

ROW_BLOCK = 16_384          # rows a traversal block holds


def _dtype(precision: str) -> torch.dtype:
    return {"float64": torch.float64, "bfloat16": torch.bfloat16}[precision]


def _round(t: torch.Tensor, precision: str) -> torch.Tensor:
    """``t`` rounded to ``precision``, carried in float64."""
    return t.to(_dtype(precision)).to(torch.float64)


# ------------------------------------------------------------- encoding

def column_means(rows: dict, feats: list[str]) -> np.ndarray:
    """The value that replaces a missing cell: the mean of the column's
    present raw values."""
    return np.array([rows[f][~np.isnan(rows[f])].mean() for f in feats])


def encode(rows: dict, feats: list[str], means: np.ndarray,
           device) -> torch.Tensor:
    """(N, F) float32: each raw value as float32, a missing one replaced by
    its column's mean (as float32)."""
    X = np.stack([np.asarray(rows[f], np.float64) for f in feats],
                 axis=1).astype(np.float32)
    fill = np.broadcast_to(means.astype(np.float32)[None, :], X.shape)
    X = np.where(np.isnan(X), fill, X)
    return torch.from_numpy(np.ascontiguousarray(X)).to(device)


# ------------------------------------------------------------- traversal

def traverse(forest: dict, X: torch.Tensor, precision: str = "float64"
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Leaf node of every (row, tree): (N, T) int64, and each row's number
    of internal nodes visited over all trees, (N,) int64. A row goes to
    ``left_child + 1`` where ``x >= threshold``, else to ``left_child``."""
    dev = X.device
    feat = torch.as_tensor(forest["feature"], device=dev).long()
    thr = torch.as_tensor(forest["threshold"], device=dev)
    left = torch.as_tensor(forest["left_child"], device=dev).long()
    if precision != "float64":
        thr, X = thr.to(_dtype(precision)), X.to(_dtype(precision))
    T, M = feat.shape
    N = X.shape[0]
    tree = torch.arange(T, device=dev)[None, :] * M
    ff, tf, lf = feat.reshape(-1), thr.reshape(-1), left.reshape(-1)
    out = torch.empty((N, T), dtype=torch.int64, device=dev)
    visits = torch.zeros(N, dtype=torch.int64, device=dev)
    for r0 in range(0, N, ROW_BLOCK):
        xb = X[r0:r0 + ROW_BLOCK]
        node = torch.zeros((xb.shape[0], T), dtype=torch.int64, device=dev)
        while True:
            flat = tree + node
            f = ff[flat]
            inner = f >= 0
            if not bool(inner.any()):
                break
            visits[r0:r0 + ROW_BLOCK] += inner.sum(dim=1)
            x = xb.gather(1, f.clamp(min=0))
            right = (x >= tf[flat]).long()
            node = torch.where(inner, lf[flat] + right, node)
        out[r0:r0 + ROW_BLOCK] = node
    return out, visits


def leaf_values(forest: dict, leaves: torch.Tensor,
                precision: str = "float64") -> torch.Tensor:
    """(N, T, O) leaf values of the reached leaves, in ``precision``."""
    lv = torch.as_tensor(forest["leaf_value"], device=leaves.device)
    T, M, O = lv.shape
    flat = (torch.arange(T, device=leaves.device)[None, :] * M + leaves)
    v = lv.reshape(T * M, O)[flat]
    return v.to(_dtype(precision)) if precision != "float64" \
        else v.to(torch.float64)


def head_gbt(values: torch.Tensor, init_pred: float) -> torch.Tensor:
    """Binomial GBT: (N, 2) probabilities (1 - p, p), p the sigmoid of the
    trees' sum plus the initial prediction (float32 sums in bfloat16)."""
    acc = torch.float64 if values.dtype == torch.float64 else torch.float32
    z = values.to(acc).sum(dim=1)[:, 0] + init_pred
    p = torch.sigmoid(z.to(values.dtype)).to(torch.float64)
    return torch.stack([1.0 - p, p], dim=1)


def head_rf_wta(values: torch.Tensor) -> torch.Tensor:
    """Winner-take-all RF: (N, C) share of trees whose leaf puts class c
    first (the lowest class on a tie)."""
    votes = values.argmax(dim=2)
    C = values.shape[2]
    return torch.stack([(votes == c).to(torch.float64).mean(dim=1)
                        for c in range(C)], dim=1)


HEADS = {"gbt": lambda v, f: head_gbt(v, float(np.asarray(f["init_pred"])[0])),
         "rf_wta": lambda v, f: head_rf_wta(v)}


def predict(forest: dict, head: str, X: torch.Tensor,
            precision: str = "float64") -> torch.Tensor:
    """(N, O) predictions of the forest on encoded rows."""
    out = []
    for r0 in range(0, X.shape[0], ROW_BLOCK):
        leaves, _ = traverse(forest, X[r0:r0 + ROW_BLOCK], precision)
        out.append(HEADS[head](leaf_values(forest, leaves, precision),
                               forest))
    return torch.cat(out) if out else torch.zeros((0, 2), dtype=torch.float64)


def widest_gap(got: np.ndarray, want: torch.Tensor) -> float:
    """The largest absolute difference of two prediction arrays."""
    got_t = torch.as_tensor(np.asarray(got, np.float64), device=want.device)
    if got_t.shape != want.shape:
        return float("inf")
    if got_t.numel() == 0:
        return 0.0
    return float((got_t - want).abs().max())


# ------------------------------------------------------------- training

def bin_columns(X: np.ndarray, max_bins: int) -> tuple[np.ndarray, list]:
    """Quantile bins of float32 columns (NaN missing): a missing value takes
    the mean of the present values; at most ``max_bins - 1`` boundaries,
    the midpoints of the unique values where there are few, else the
    distinct values nearest the quantiles; code = number of boundaries
    below the value."""
    N, F = X.shape
    codes = np.zeros((N, F), np.uint8)
    bounds = []
    for j in range(F):
        x = X[:, j].astype(np.float64)
        miss = np.isnan(x)
        x[miss] = x[~miss].mean() if (~miss).any() else 0.0
        uniq = np.unique(x)
        if len(uniq) <= 1:
            b = np.empty(0)
        elif len(uniq) <= max_bins:
            b = (uniq[1:] + uniq[:-1]) / 2.0
        else:
            b = np.unique(np.quantile(
                x, np.linspace(0, 1, max_bins + 1)[1:-1], method="nearest"))
        codes[:, j] = np.searchsorted(b, x, side="left")
        bounds.append(b.astype(np.float32))
    return codes, bounds


def label_index(labels: np.ndarray) -> np.ndarray:
    """0/1 class index, classes ordered by frequency (then name), the
    second class the positive one."""
    names, counts = np.unique(labels.astype(str), return_counts=True)
    order = sorted(range(len(names)), key=lambda i: (-counts[i], names[i]))
    pos = {names[i]: k for k, i in enumerate(order)}
    return np.array([pos[v] for v in labels.astype(str)], np.int64)


def _score(g: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    return 0.5 * g * g / (h + 1e-12)


B = 256                     # codes a column


def _init(y: np.ndarray) -> float:
    """The initial prediction: the log-odds of the positive class, as the
    float32 value a model stores."""
    p0 = float(np.clip(y.mean(), 1e-6, 1 - 1e-6))
    return float(np.float32(np.log(p0 / (1 - p0))))


def _stats(pred: torch.Tensor, y: torch.Tensor, precision: str,
           acc: torch.dtype) -> torch.Tensor:
    """(N, 3) per-row gradient, hessian and count of the binomial loss."""
    p = torch.sigmoid(pred)
    g = p - y
    h = torch.clamp_min(p * (1 - p), 1e-12)
    return _round(torch.stack([g, h, torch.ones_like(g)], dim=1),
                  precision).to(acc)


def _level(C: torch.Tensor, w: torch.Tensor, slot: torch.Tensor, P: int,
           min_examples: int) -> tuple:
    """The (P, F * B) split gains of the P frontier nodes (-inf where a
    side holds fewer than ``min_examples`` rows, or nothing goes right)
    and the nodes' summed stats (P, 3).
    ``slot`` is each row's frontier slot, -1 off the frontier. The gain
    of "codes >= b + 1 go right" at position b is the score of the left
    and right sums less the node's, each score 0.5 G^2 / count."""
    N, F = C.shape
    act = slot >= 0
    idx = ((slot[act][:, None] * F + torch.arange(F, device=C.device)) * B
           + C[act]).reshape(-1)
    hist = torch.zeros((P * F * B, 3), dtype=w.dtype, device=C.device)
    hist.index_add_(0, idx, w[act][:, None, :].expand(-1, F, 3).reshape(-1, 3))
    hist = hist.view(P, F, B, 3)
    cum = hist.cumsum(dim=2)
    par = hist[:, 0].sum(dim=1)                              # (P, 3)
    right = par[:, None, None, :] - cum
    gain = (_score(cum[..., 0], cum[..., 2])
            + _score(right[..., 0], right[..., 2])
            - _score(par[:, 0], par[:, 2])[:, None, None])
    ok = ((cum[..., 2] >= min_examples) & (right[..., 2] >= min_examples)
          & (torch.arange(B, device=C.device) < B - 1))
    return torch.where(ok, gain, -torch.inf).reshape(P, F * B), par


def _floor(par: torch.Tensor) -> torch.Tensor:
    """The least gain that makes a split: 4e-6 of the node's own score."""
    return torch.clamp_min(4e-6 * _score(par[:, 0], par[:, 2]).abs(), 1e-12)


def _leaf(stats: torch.Tensor, shrinkage: float) -> torch.Tensor:
    """Newton leaf: - shrinkage * G / H."""
    return -shrinkage * stats[..., 0].double() / (stats[..., 1].double()
                                                  + 1e-12)


EARLY_TREES = 4             # trees the "early" fault keeps
STALE_FROM = 10             # the first tree the "stale" fault leaves out


def grow_gbt(codes: np.ndarray, y: np.ndarray, hp: dict, n_trees: int,
             device, precision: str = "float64",
             fault: str | None = None) -> dict:
    """The first ``n_trees`` trees of the binomial GBT that ``hp`` states
    (LOCAL growth to ``max_depth``, no l2, gain on counts, Newton leaves
    times ``shrinkage``), grown level by level from the codes: at each
    node the first (column, bin) of the largest gain, where it passes the
    floor. Used in the program's place: in ``precision`` (the control),
    or with ``fault``: "unchanged" leaves the boosting state unmoved by
    each tree, "half" grows each tree on the first half of the rows,
    "altered" moves the first tree's largest leaf by 1%, "early"
    stops the boosting after ``EARLY_TREES`` trees, "stale" leaves the
    state unmoved by tree ``STALE_FROM`` and every later one.

    Returns the trees as forest arrays ``feature``, ``split_bin``,
    ``left_child``, ``leaf_value`` (T, M) and ``n_nodes`` (T,)."""
    dev = torch.device(device)
    C = torch.as_tensor(codes, device=dev).long()
    N, F = C.shape
    D = hp["max_depth"]
    M = 2 ** (D + 1)
    yt = torch.as_tensor(y, device=dev, dtype=torch.float64)
    pred = torch.full((N,), _init(y), dtype=torch.float64, device=dev)
    acc = torch.float64 if precision == "float64" else torch.float32
    if fault == "early":
        n_trees = min(n_trees, EARLY_TREES)
    out = {k: np.full((n_trees, M), -1, np.int32)
           for k in ("feature", "left_child")}
    out["split_bin"] = np.zeros((n_trees, M), np.int32)
    out["leaf_value"] = np.zeros((n_trees, M), np.float64)
    out["n_nodes"] = np.ones(n_trees, np.int32)
    on = torch.ones(N, dtype=torch.bool, device=dev)
    if fault == "half":
        on[N // 2:] = False
    for t in range(n_trees):
        w = _stats(pred, yt, precision, acc) * on[:, None]
        node_of = torch.where(on, 0, -1)
        frontier = torch.zeros(1, dtype=torch.int64, device=dev)
        nn = 1
        for _level_no in range(D):
            P = len(frontier)
            slot = torch.full((M,), -1, dtype=torch.int64, device=dev)
            slot[frontier] = torch.arange(P, device=dev)
            s_row = torch.where(node_of >= 0, slot[node_of.clamp(min=0)], -1)
            gain, par = _level(C, w, s_row, P, hp["min_examples"])
            best, arg = gain.max(dim=1), gain.argmax(dim=1)
            valid = torch.isfinite(best.values) & (best.values > _floor(par))
            nv = int(valid.sum())
            if nv == 0:
                break
            f_s, b_s = arg // B, arg % B + 1
            rank = torch.cumsum(valid.long(), 0) - valid.long()
            left_id = nn + 2 * rank
            tn = frontier[valid].cpu().numpy()
            out["feature"][t, tn] = f_s[valid].cpu().numpy()
            out["split_bin"][t, tn] = b_s[valid].cpu().numpy()
            out["left_child"][t, tn] = left_id[valid].cpu().numpy()
            s_c = s_row.clamp(min=0)
            moving = (s_row >= 0) & valid[s_c]
            code = C.gather(1, f_s[s_c][:, None])[:, 0]
            node_of = torch.where(moving, left_id[s_c]
                                  + (code >= b_s[s_c]).long(), node_of)
            lv = left_id[valid]
            frontier = torch.stack([lv, lv + 1], dim=1).reshape(-1)
            nn += 2 * nv
        sums = torch.zeros((M, 3), dtype=acc, device=dev)
        sums.index_add_(0, node_of[node_of >= 0], w[node_of >= 0])
        lv_t = _round(_leaf(sums, hp["shrinkage"]), precision)
        lv_t[0] = 0.0
        lv_t[nn:] = 0.0
        if fault == "altered" and t == 0:
            leaf = torch.as_tensor(out["feature"][0] < 0, device=dev)
            lv_t[torch.where(leaf, lv_t.abs(), -1.0).argmax()] *= 1.01
        out["leaf_value"][t] = lv_t.cpu().numpy()
        out["n_nodes"][t] = nn
        if fault != "unchanged" and not (fault == "stale"
                                         and t >= STALE_FROM):
            pred = pred + lv_t[route(out, t, C)]
    return out


def route(trees: dict, t: int, C: torch.Tensor) -> torch.Tensor:
    """Each row's leaf in tree ``t`` of ``trees``, routed by the codes
    (``code >= split_bin`` goes right)."""
    node = torch.zeros(C.shape[0], dtype=torch.int64, device=C.device)
    feat = torch.as_tensor(trees["feature"][t], device=C.device).long()
    sb = torch.as_tensor(trees["split_bin"][t], device=C.device).long()
    left = torch.as_tensor(trees["left_child"][t], device=C.device).long()
    while True:
        f = feat[node]
        inner = f >= 0
        if not bool(inner.any()):
            return node
        code = C.gather(1, f.clamp(min=0)[:, None])[:, 0]
        node = torch.where(inner, left[node] + (code >= sb[node]).long(),
                           node)


def judge_gbt(codes: np.ndarray, y: np.ndarray, hp: dict, prog: dict,
              trees: list[int], device) -> dict:
    """Judge the program's trees ``trees`` (indices) node by node, in
    float64, each from the state the program had: tree t from the
    boosting state its trees 0 .. t-1 leave (each row's sum of their
    leaf values, routed by the codes), each node from the rows the
    program's splits sent there. The start, the initial prediction, is
    the reference's own; a tree not judged still moves the state.

    ``split_gap``: over the program's nodes above ``max_depth``, the
    largest shortfall of the gain of the program's split from the best
    gain at that node, as a share of the best; 1 where the program splits
    a node that no split passes the floor of, or leaves one that a split
    does. ``leaf_gap``: over the program's leaves, the largest gap of its
    leaf value from the Newton leaf of the leaf's rows, against the larger
    of that value's magnitude and the median magnitude of the tree's."""
    dev = torch.device(device)
    C = torch.as_tensor(codes, device=dev).long()
    N, F = C.shape
    D = hp["max_depth"]
    yt = torch.as_tensor(y, device=dev, dtype=torch.float64)
    pred = torch.full((N,), _init(y), dtype=torch.float64, device=dev)
    split_gap = leaf_gap = 0.0
    judged = set(int(t) for t in trees)

    def moved(pred: torch.Tensor, t: int) -> torch.Tensor:
        return pred + torch.as_tensor(prog["leaf_value"][t], device=dev,
                                      dtype=torch.float64)[route(prog, t, C)]

    for t in range(max(judged, default=-1) + 1):
        if t not in judged:
            pred = moved(pred, t)
            continue
        feat = np.asarray(prog["feature"][t])
        sb = np.asarray(prog["split_bin"][t]).astype(np.int64)
        left = np.asarray(prog["left_child"][t])
        M = len(feat)
        w = _stats(pred, yt, "float64", torch.float64)
        node_of = torch.zeros(N, dtype=torch.int64, device=dev)
        frontier = np.array([0])
        for _level_no in range(D):
            if not len(frontier):
                break
            P = len(frontier)
            slot = torch.full((M,), -1, dtype=torch.int64, device=dev)
            slot[torch.as_tensor(frontier, device=dev)] = \
                torch.arange(P, device=dev)
            s_row = slot[node_of]
            gain, par = _level(C, w, s_row, P, hp["min_examples"])
            best = gain.max(dim=1).values
            splits = best > _floor(par)
            inner = feat[frontier] >= 0
            pos = torch.as_tensor(np.maximum(feat[frontier], 0) * B
                                  + np.clip(sb[frontier] - 1, 0, B - 1),
                                  device=dev)
            chosen = gain.gather(1, pos[:, None])[:, 0]
            ok_pos = torch.as_tensor((sb[frontier] >= 1)
                                     & (sb[frontier] <= B - 1), device=dev)
            inner_t = torch.as_tensor(inner, device=dev)
            short = torch.where(
                inner_t & splits & ok_pos & torch.isfinite(chosen),
                (best - chosen) / best.abs().clamp_min(1e-300), 1.0)
            short = torch.where(~inner_t & ~splits, 0.0, short)
            split_gap = max(split_gap, float(short.max()))
            # rows of the program's split nodes move to its children
            f_row = torch.as_tensor(np.maximum(feat, 0), device=dev)[node_of]
            code = C.gather(1, f_row[:, None])[:, 0]
            sb_row = torch.as_tensor(sb, device=dev)[node_of]
            l_row = torch.as_tensor(left, device=dev).long()[node_of]
            moving = (s_row >= 0) & torch.as_tensor(feat >= 0,
                                                    device=dev)[node_of]
            node_of = torch.where(moving, l_row + (code >= sb_row).long(),
                                  node_of)
            kids = left[frontier[inner]]
            frontier = np.stack([kids, kids + 1], axis=1).reshape(-1)
        sums = torch.zeros((M, 3), dtype=torch.float64, device=dev)
        sums.index_add_(0, node_of, w)
        want = _leaf(sums, hp["shrinkage"]).cpu().numpy()
        leaves = np.unique(node_of.cpu().numpy())
        med = float(np.median(np.abs(want[leaves])))
        got = np.asarray(prog["leaf_value"][t], np.float64)[leaves]
        gap = np.abs(got - want[leaves]) / np.maximum(
            np.maximum(np.abs(want[leaves]), med), 1e-300)
        leaf_gap = max(leaf_gap, float(gap.max()))
        pred = moved(pred, t)
    return {"split_gap": split_gap, "leaf_gap": leaf_gap}
