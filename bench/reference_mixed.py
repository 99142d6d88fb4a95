"""The plain reference that decides ``correct`` in the mixed-column cell.

Plain PyTorch over the benchmark's own inputs (raw columns, the dataspec
dict and forest arrays the benchmark made) and the program's answers,
which it reads only to judge them. It imports nothing of the program and
derives again, from the port's documented semantics:

  * the encoding (``core/dataspec.py``'s docstring): a numerical value as
    float32, a missing one (None, NaN or a missing token) as its column's
    mean; a categorical value as its index in the column's vocabulary,
    "<OOD>" (0) where it is not there, and a missing one as the most
    frequent value (1, where the vocabulary holds one);
  * the traversal of the three kinds of condition (``core/tree.py``): an
    axis-aligned node goes right where ``x >= threshold``; a categorical
    node (one whose 256-bit mask is not empty) where the bit of the code
    of ``x`` is set; an oblique node (``feature == -2``) where its
    projection is ``>= threshold``;
  * the binomial GBT head: the sigmoid of the trees' sum plus the initial
    prediction.

Near ties: an oblique projection is a float32 sum of P float32 products,
and a float64 sum would flip the few rows within a rounding of the
threshold. The port documents its order (``core/tree.py``: numpy's
float32 pairwise order over all P pairs, the padding included; B2 rounds
each product and adds in that order), so the reference computes each
projection in float32 in that order (``pairwise``), and everything else in
float64: its decisions are exact, and no tie needs counting.

``precision="bfloat16"`` is the control: the rows, thresholds, weights,
products and sums of the projections and the leaves in bfloat16 (the
trees' sum in float32), the step below the configuration's float32.
``fault=`` plants a fault into the reference put in the program's place:
"weight" drops the first weight of the oblique node nearest a root,
"mask" flips the bit of code 1 (the most frequent value) in the
categorical node nearest a root, "missing" sends every missing
categorical value down the other branch from its code's.
"""
from __future__ import annotations

import numpy as np
import torch

from bench.reference import widest_gap  # noqa: F401  (the same judge)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ROW_BLOCK = 8_192           # rows a traversal block holds
MASK_BITS = 256
MISSING_TOKENS = {"", "na", "n/a", "nan", "none", "null", "?"}
PAIRWISE_BLOCK = 128
FAULTS = ("weight", "mask", "missing")


def _cond_dtype(precision: str) -> torch.dtype:
    """The type conditions are tested in: float32, the rows' and tables'
    own, or bfloat16 for the control."""
    return {"float64": torch.float32, "bfloat16": torch.bfloat16}[precision]


# ------------------------------------------------------------- encoding

def _missing(v) -> bool:
    if v is None:
        return True
    if isinstance(v, (float, np.floating)):
        return bool(np.isnan(v))
    return isinstance(v, str) and v.strip().lower() in MISSING_TOKENS


def encode(rows: dict, spec: dict, feats: list[str], device
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """(N, F) float32 encoded rows and (N, F) bool missing cells."""
    cols, miss = [], []
    for name in feats:
        c = spec["columns"][name]
        raw = np.asarray(rows[name])
        if c["semantic"] == "NUMERICAL":
            if raw.dtype == object:
                m = np.array([_missing(v) for v in raw], bool)
                x = np.array([0.0 if mm else float(v)
                              for v, mm in zip(raw, m)], np.float64)
            else:
                x = raw.astype(np.float64)
                m = np.isnan(x)
            x = x.astype(np.float32)
            x[m] = np.float32(c["mean"])
        else:
            index = {v: i for i, v in enumerate(c["vocab"])}
            fill = 1 if len(c["vocab"]) > 1 else 0
            memo: dict = {}
            for v in raw:
                if v not in memo:
                    memo[v] = (True, fill) if _missing(v) \
                        else (False, index.get(str(v), 0))
            m = np.array([memo[v][0] for v in raw], bool)
            x = np.array([memo[v][1] for v in raw], np.float32)
        cols.append(x)
        miss.append(m)
    X = torch.from_numpy(np.ascontiguousarray(np.stack(cols, 1)))
    return X.to(device), torch.from_numpy(np.stack(miss, 1)).to(device)


# ------------------------------------------------------------- traversal

def pairwise(p: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in numpy's pairwise order with elementwise
    adds: below 8 terms in order from -0.0; up to 128, eight running sums
    combined ((r0 + r1) + (r2 + r3)) + ((r4 + r5) + (r6 + r7)), then the
    rest in order; past 128, the two halves (split at n/2 less its
    remainder mod 8) summed alike and added."""
    n = p.shape[-1]
    if n < 8:
        acc = torch.full(p.shape[:-1], -0.0, dtype=p.dtype, device=p.device)
        for i in range(n):
            acc = acc + p[..., i]
        return acc
    if n <= PAIRWISE_BLOCK:
        r = [p[..., j] for j in range(8)]
        i = 8
        while i + 8 <= n:
            r = [r[j] + p[..., i + j] for j in range(8)]
            i += 8
        acc = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]))
        for k in range(i, n):
            acc = acc + p[..., k]
        return acc
    h = n // 2 - (n // 2) % 8
    return pairwise(p[..., :h]) + pairwise(p[..., h:])


def _tables(forest: dict, device, precision: str) -> dict:
    dt = _cond_dtype(precision)
    t = {k: torch.as_tensor(np.asarray(forest[k]), device=device)
         for k in ("feature", "left_child", "threshold", "obl_weights",
                   "obl_features")}
    mask = np.asarray(forest["cat_mask"], np.uint32).astype(np.int64)
    bits = (mask[..., :, None] >> np.arange(32)) & 1        # (T, M, 8, 32)
    t["bits"] = torch.as_tensor(bits.reshape(mask.shape[:2] + (MASK_BITS,))
                                .astype(bool), device=device)
    t["is_cat"] = t["bits"].any(-1)
    t["nnz"] = (t["obl_weights"] != 0).sum(-1)
    t["feature"] = t["feature"].long()
    t["left_child"] = t["left_child"].long()
    t["obl_features"] = t["obl_features"].long()
    t["threshold"] = t["threshold"].to(dt)
    t["obl_weights"] = t["obl_weights"].to(dt)
    return t


def traverse(forest: dict, X: torch.Tensor, miss: torch.Tensor,
             precision: str = "float64", fault: str | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Leaf node of every (row, tree), (N, T) int64, and the visits of each
    kind of condition over all rows and trees, (4,) int64: axis-aligned,
    oblique, categorical, and the non-zero (column, weight) pairs of the
    oblique nodes visited. A row stops at its tree's first leaf."""
    dev = X.device
    if fault in ("weight", "mask"):
        forest = planted(forest, fault)
    t = _tables(forest, dev, precision)
    T, M = t["feature"].shape
    Xp = X.to(_cond_dtype(precision))
    tree = torch.arange(T, device=dev)[None, :] * M
    flat = {k: v.reshape((T * M,) + v.shape[2:]) for k, v in t.items()}
    N = X.shape[0]
    out = torch.empty((N, T), dtype=torch.int64, device=dev)
    visits = torch.zeros(4, dtype=torch.int64, device=dev)
    for r0 in range(0, N, ROW_BLOCK):
        xb, mb = Xp[r0:r0 + ROW_BLOCK], miss[r0:r0 + ROW_BLOCK]
        node = torch.zeros((xb.shape[0], T), dtype=torch.int64, device=dev)
        while True:
            at = tree + node
            f = flat["feature"][at]
            inner = flat["left_child"][at] >= 0
            if not bool(inner.any()):
                break
            obl = inner & (f == -2)
            cat = inner & ~obl & flat["is_cat"][at]
            axis = inner & ~obl & ~cat
            visits += torch.stack([axis.sum(), obl.sum(), cat.sum(),
                                   (flat["nnz"][at] * obl).sum()])
            col = f.clamp(min=0)
            x = xb.gather(1, col)
            thr = flat["threshold"][at]
            go = x >= thr
            xf = x.float()
            code = torch.where(torch.isfinite(xf), xf, 0.0).clamp(
                0, MASK_BITS - 1).long()
            bit = flat["bits"][at, code]
            if fault == "missing":
                bit = torch.where(mb.gather(1, col), ~bit, bit)
            go = torch.where(cat, bit, go)
            if bool(obl.any()):
                w = flat["obl_weights"][at]                   # (n, T, P)
                oc = flat["obl_features"][at]
                xs = xb.gather(1, oc.reshape(oc.shape[0], -1)).reshape(
                    oc.shape)
                go = torch.where(obl, pairwise(w * xs) >= thr, go)
            node = torch.where(inner, flat["left_child"][at] + go.long(),
                               node)
        out[r0:r0 + ROW_BLOCK] = node
    return out, visits


def planted(forest: dict, fault: str) -> dict:
    """A copy of ``forest`` with the "weight" or "mask" fault planted in
    the node of its kind nearest a root (the least depth, then the first
    tree, then the first node)."""
    f = {k: np.array(v, copy=True) if isinstance(v, np.ndarray) else v
         for k, v in forest.items()}
    feat, left = f["feature"], f["left_child"]
    T, M = feat.shape
    depth = np.full((T, M), 10 ** 6, np.int64)
    depth[:, 0] = 0
    for k in range(M):            # children are allocated after parents
        inner = left[:, k] >= 0
        for side in (0, 1):
            ch = left[inner, k] + side
            depth[inner, ch] = depth[inner, k] + 1
    inner = left >= 0
    if fault == "weight":
        where = inner & (feat == -2)
    else:
        where = inner & (feat != -2) & f["cat_mask"].any(-1)
    t, n = np.unravel_index(np.argmin(np.where(where, depth, 10 ** 9)
                                      .ravel()), (T, M))
    if fault == "weight":
        f["obl_weights"][t, n, 0] = 0.0
    else:
        f["cat_mask"][t, n, 0] ^= np.uint32(1 << 1)
    return f


def leaf_values(forest: dict, leaves: torch.Tensor,
                precision: str = "float64") -> torch.Tensor:
    """(N, T) values of the reached leaves, in float64 or bfloat16."""
    lv = torch.as_tensor(np.asarray(forest["leaf_value"])[..., 0],
                         device=leaves.device)
    T, M = lv.shape
    v = lv.reshape(-1)[torch.arange(T, device=leaves.device)[None, :] * M
                       + leaves]
    return v.to(torch.bfloat16) if precision == "bfloat16" \
        else v.to(torch.float64)


def predict(forest: dict, X: torch.Tensor, miss: torch.Tensor,
            precision: str = "float64", fault: str | None = None
            ) -> torch.Tensor:
    """(N, 2) probabilities (1 - p, p): p the sigmoid of the reached
    leaves' sum plus the initial prediction (float64; the control sums its
    bfloat16 leaves in float32)."""
    leaves, _ = traverse(forest, X, miss, precision, fault)
    v = leaf_values(forest, leaves, precision)
    acc = torch.float64 if precision == "float64" else torch.float32
    z = v.to(acc).sum(dim=1) + float(np.asarray(forest["init_pred"])[0])
    p = torch.sigmoid(z.to(v.dtype)).to(torch.float64)
    return torch.stack([1.0 - p, p], dim=1)
