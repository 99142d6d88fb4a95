"""Depth-bucketed traversal in PyTorch (DESIGN.md §10.2), the port of the
reference's XLA-compiled ``bucketed.py``.

Runs a ``core.tree.BucketedForest`` on one device: every bucket is scored
by its own strategy and its own (shorter) round count, the buckets'
outputs are concatenated and put back in original tree order. The
reference traces all buckets into one jit program; here each scan round is
a few eager PyTorch ops, so at small batches the launch count, not the
work, sets the time (PERF.md).

Strategies (tables built in ``repro_torch.core.tree``):

* ``scan`` — flat global-id node tables with SENTINEL LEAVES: a leaf's slot
  holds feature = (virtual zero column), threshold = +inf, child = itself,
  so finished lanes self-loop through ``child[node] + (x >= thr)`` and the
  round needs no leaf mask, no select, no bounds fixup.
* ``leaf_path`` — evaluate all internal conditions in one pass, then count
  per-path correct decisions with a batched matmul over the signed path
  matrix; the true leaf is the unique argmax. No loop at all.

Bit-exactness: both strategies select the leaves of ``predict_naive``,
categorical codes included: the cast is ``ref.cat_code`` (numpy's float32
-> int64 cast, then the clip: NaN, +-inf and |x| >= 2^63 give code 0), and
mask words are int32 holding the uint32 bits (``ops._mask_words``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.api import YdfError
from repro_torch.core.tree import MASK_WORDS, BucketedForest
from repro_torch.kernels.forest_infer.ref import cat_code

# leaf_path materialises (rows, k, I) conditions and (rows, k, L) hits per
# bucket; rows are taken in chunks of at most this many elements of the
# larger one, so a bulk batch over a wide bucket stays within a few hundred
# MB of temporaries. Rows are independent, so the output is the same.
LEAF_PATH_CHUNK_ELEMS = 1 << 25

_SCAN_KEYS = ("feature", "threshold", "child", "leaf_value", "root",
              "is_cat", "cat_words")
_PATH_KEYS = ("feature", "threshold", "is_cat", "cat_words", "paths",
              "base", "path_len", "leaf_value")
_INDEX_KEYS = ("feature", "child", "root")   # int64 on the device: indices


def _bit(words: torch.Tensor, code: torch.Tensor) -> torch.Tensor:
    """Bit ``code & 31`` of int32 mask words (the uint32 bits): promoted to
    int64, an arithmetic shift by k < 32 still leaves bit k lowest."""
    return ((words.to(torch.int64) >> (code & 31)) & 1) == 1


def _scan_block(Xflat, row, tb, has_cat: bool, depth: int, F: int):
    """One bucket, scan strategy: ``depth`` lockstep rounds over the
    bucket's flat tables. ``row`` pre-multiplies the example index by the
    padded feature stride, so each round's gather is one flat
    ``Xflat[f + row]``."""
    feat = torch.where(tb["feature"] < 0, F, tb["feature"])  # leaf -> zero col
    thr, child = tb["threshold"], tb["child"]
    node = tb["root"][None, :].expand(row.shape[0], -1)
    for _ in range(depth):
        x = Xflat[feat[node] + row]
        go = x >= thr[node]
        if has_cat:
            code = cat_code(x)
            word = tb["cat_words"].reshape(-1)[node * MASK_WORDS + (code >> 5)]
            go = torch.where(tb["is_cat"][node], _bit(word, code), go)
        node = child[node] + go
    return tb["leaf_value"][node]                           # (N, k, O)


def _leaf_path_block(Xs, tb, has_cat: bool):
    """One bucket, leaf_path strategy: one pass of condition evaluation,
    then predicate-matrix scoring. ``hits - path_len`` is 0 exactly at the
    true leaf and <= -1 at every other real leaf (the first divergent
    decision is wrong), so argmax is the traversal result.

    Exactness of the matmul on any device: C holds 0/1 and P 0/+-1, which
    float32, TF32 (``allow_tf32``) and bf16 (matmul precision "medium") all
    hold exactly, and every product sum is an integer below 2^24 that the
    float32 accumulation keeps exactly. ``argmax`` returns the first
    maximum, as ``jnp.argmax`` does, and there is only one."""
    feat, thr = tb["feature"], tb["threshold"]
    k, I = feat.shape
    x = Xs[:, feat]                                         # (N, k, I)
    go = x >= thr
    if has_cat:
        code = cat_code(x)
        flat_node = (torch.arange(k * I, device=Xs.device).reshape(k, I)
                     * MASK_WORDS)
        word = tb["cat_words"].reshape(-1)[flat_node + (code >> 5)]
        go = torch.where(tb["is_cat"], _bit(word, code), go)
    C = go.to(torch.float32)
    hits = torch.einsum("nki,kil->nkl", C, tb["paths"]) + tb["base"]
    sel = torch.argmax(hits - tb["path_len"], dim=-1)       # (N, k)
    return tb["leaf_value"][torch.arange(k, device=Xs.device), sel]


def _leaf_path_chunked(Xs, tb, has_cat: bool):
    k, I = tb["feature"].shape
    L = tb["paths"].shape[-1]
    step = max(1, LEAF_PATH_CHUNK_ELEMS // (k * max(I, L)))
    if Xs.shape[0] <= step:
        return _leaf_path_block(Xs, tb, has_cat)
    return torch.cat([_leaf_path_block(Xs[i:i + step], tb, has_cat)
                      for i in range(0, Xs.shape[0], step)])


def _run(X, tables, inv, spec):
    """spec: per-bucket (strategy, depth, has_cat) tuples; tables: the
    buckets' device tables; inv: packed slot of each original tree."""
    N, F = X.shape
    Xs = torch.cat([X, X.new_zeros((N, 1))], dim=1)
    Xflat = Xs.reshape(-1)
    row = (torch.arange(N, dtype=torch.int64, device=X.device)
           * (F + 1))[:, None]
    outs = []
    for (strategy, depth, has_cat), tb in zip(spec, tables):
        if strategy == "leaf_path":
            outs.append(_leaf_path_chunked(Xs, tb, has_cat))
        else:
            outs.append(_scan_block(Xflat, row, tb, has_cat, depth, F))
    out = torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]
    return out.index_select(1, inv)                        # original tree order


def _upload(table: np.ndarray, key: str, device) -> torch.Tensor:
    if key == "cat_words":
        table = np.ascontiguousarray(table, np.uint32).view(np.int32)
    elif key in _INDEX_KEYS:
        table = table.astype(np.int64)
    return torch.from_numpy(np.ascontiguousarray(table)).to(device)


class BucketedRunner:
    """A BucketedForest's tables on one device, uploaded once. Calling it
    runs ``X: (N, F) float32`` (host) -> (N, T, out_dim) float32 numpy in
    the original tree order; ``device_call`` does the same from and to
    device tensors. X narrower than the columns the trees split on raises
    ``YdfError`` before anything runs (an out-of-range gather on the card
    would poison the context)."""

    def __init__(self, bf: BucketedForest, device):
        self.device = torch.device(device)
        self.n_trees, self.out_dim = bf.n_trees, bf.out_dim
        self.spec = tuple((b.strategy, b.depth, bool(b.tables["has_cat"]))
                          for b in bf.buckets)
        keys = {"scan": _SCAN_KEYS, "leaf_path": _PATH_KEYS}
        self.tables = tuple({k: _upload(b.tables[k], k, self.device)
                             for k in keys[b.strategy]} for b in bf.buckets)
        self.inv = torch.from_numpy(bf.inv_order.astype(np.int64)).to(
            self.device)
        self.min_features = 1 + max(
            [int(b.tables["feature"].max(initial=-1)) for b in bf.buckets],
            default=-1)

    def _check(self, shape) -> None:
        if len(shape) != 2 or shape[1] < self.min_features:
            raise YdfError(
                f"The request matrix has shape {tuple(shape)}; the forest "
                f"splits on feature index {self.min_features - 1}, so it "
                f"needs (N, >= {self.min_features}) columns.")

    def device_call(self, Xd: torch.Tensor) -> torch.Tensor:
        self._check(Xd.shape)
        if Xd.shape[0] == 0 or self.n_trees == 0:
            return Xd.new_zeros((Xd.shape[0], self.n_trees, self.out_dim))
        return _run(Xd, self.tables, self.inv, self.spec)

    def __call__(self, X) -> np.ndarray:
        X = np.ascontiguousarray(np.asarray(X), np.float32)
        self._check(X.shape)
        if X.shape[0] == 0 or self.n_trees == 0:
            return np.zeros((X.shape[0], self.n_trees, self.out_dim),
                            np.float32)
        return self.device_call(torch.from_numpy(X).to(self.device)).cpu(
        ).numpy()


def build_bucketed_runner(bf: BucketedForest, device) -> BucketedRunner:
    """Upload a BucketedForest to ``device`` once; see ``BucketedRunner``."""
    return BucketedRunner(bf, device)
