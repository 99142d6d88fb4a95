"""Distributed decision-forest training (paper §3.9; Guillame-Bert & Teytaud
2018) over ``torch.distributed``, the port of ``repro.core.distributed``.

The 2-D training grid composes both of the paper's distributions:
  * example-parallel over the mesh's "data" axis: each rank histograms its
    block of rows and the histograms are summed over the data group, so the
    traffic per level is the histogram's size, independent of the number
    of examples (the 2018 paper's scaling property);
  * feature-parallel over the "model" axis: each rank owns a block of
    feature columns and exchanges only (gain, feature, bin) per node (an
    all-gather over the model group) and the winning partition as a
    bit-packed bitmap of 32 rows a word (32x less traffic than a float
    mask: the delta-bit encoding of §3.9 restated).

A ``Mesh`` is the port's ``jax.make_mesh((data, model), ("data",
"model"))``: the port's one process mesh (``core.mesh.ProcessMesh``) over
those two axes, rank r at row r // model, column r % model; the data
axis's groups reduce, the model axis's gather. Every rank calls ``DistributedGBT(cfg, mesh).fit`` with the full
arrays and takes its own block, as each shard of the reference's
``shard_map`` does. ``run_world`` starts a world on this machine (in
process for one rank, spawned processes otherwise) and ``fit_on_world``
fits on one or more mesh shapes in one world.

Trees grown here use a fixed-depth COMPLETE layout in level order (node n ->
children 2n+1/2n+2): nodes without a valid split emit a degenerate all-left
split with gain -inf. ``complete_trees_to_forest`` converts them to the
pointer SoA ``Forest`` the engines serve (B2 on the card). Numerical
(binned uint8) features only, as in the reference.

A third backend, the paper's single-process SIMULATION backend for
development, debugging and fault injection, is ``SimulatedCluster``.

Histograms are B3 (``kernels/histogram``) on the card, once per rank per
level and once per live worker per level, and its plain version on the
CPU. The gain scan runs on the rank's device in a fixed order (see
``split_gain_tensor``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import multiprocessing
import os
import queue
import shutil
import sys
import tempfile
import traceback
from dataclasses import dataclass
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.api import YdfError
from repro_torch.core.mesh import ProcessMesh
from repro_torch.core.tree import Forest, empty_forest
from repro_torch.obs import clock, trace
from repro_torch.obs.logs import build_training_logs, validate_training_logs


# =====================================================================
# gh-gain machinery on tensors (device mirror of splitters.best_splits)
# =====================================================================

# The gain scan's fixed summation orders, the ones XLA's CPU backend uses for
# the reference's jnp.cumsum and sum over the bin axis: a cumulative sum is
# sequential within blocks of _SCAN_BLOCK bins, then each block adds the
# (recursively scanned) total of the blocks before it; a total is sequential
# within windows of _SUM_WINDOW bins, then over the window sums. With them
# the port's gains equal the reference's bit for bit on the CPU (for up to
# 32 bins or a multiple of 32), and on every device a column's gains do not
# depend on which other columns share the batch. A simpler order (one
# sequential or log-step scan, float64 sums rounded to float32) misses the
# reference's gains near zero by far more than a relative 1e-6: such a gain
# is the difference of large scores, and one rounding of a sum moves it.
_SCAN_BLOCK = 16
_SUM_WINDOW = 32


def _blocks(x: torch.Tensor, size: int) -> torch.Tensor:
    """(..., n) -> (..., ceil(n / size), size), zero-padded at the end."""
    n = x.shape[-1]
    k = -(-n // size)
    x = torch.nn.functional.pad(x, (0, k * size - n))
    return x.reshape(*x.shape[:-1], k, size)


def _sequential_scan(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums over the last axis, one add per element in
    index order (the first is 0 + x[0])."""
    acc = [x[..., 0] + 0.0]
    for i in range(1, x.shape[-1]):
        acc.append(acc[-1] + x[..., i])
    return torch.stack(acc, -1)


def _sequential_sum(x: torch.Tensor) -> torch.Tensor:
    """The last of ``_sequential_scan``'s sums, without the others."""
    acc = x[..., 0] + 0.0
    for i in range(1, x.shape[-1]):
        acc = acc + x[..., i]
    return acc


def _cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums over the last axis in the blocked order."""
    n = x.shape[-1]
    if n <= _SCAN_BLOCK:
        return _sequential_scan(x)
    c = _sequential_scan(_blocks(x, _SCAN_BLOCK))
    carry = _cumsum(c[..., -1])                    # scanned block totals
    c[..., 1:, :] += carry[..., :-1, None]
    return c.reshape(*x.shape[:-1], -1)[..., :n]


def _total(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in the windowed order."""
    if x.shape[-1] <= _SUM_WINDOW:
        return _sequential_sum(x)
    return _total(_sequential_sum(_blocks(x, _SUM_WINDOW)))


def _gh_score(g, h, l2):
    return 0.5 * torch.square(g) / (h + l2 + 1e-12)


def split_gain_tensor(hist: torch.Tensor, min_examples: int, l2: float):
    """hist: (nodes, F, B, 3) [g, h, n] float32 -> full gain tensor (nodes,
    F, B-1), invalid splits = -inf. Each column's gains are a function of
    that column alone, in a fixed order on every device, so a feature's gain
    values do not depend on which other features share the histogram batch
    (the property the fault-recovery merge relies on)."""
    bins_last = hist.permute(0, 1, 3, 2)                  # (nodes, F, 3, B)
    parent = _total(bins_last)                            # (nodes, F, 3)
    cum = _cumsum(bins_last)[..., :-1].permute(0, 1, 3, 2)  # (nodes, F, B-1, 3)
    ps = _gh_score(parent[..., 0], parent[..., 1], l2)
    right = parent[:, :, None] - cum
    gain = (_gh_score(cum[..., 0], cum[..., 1], l2)
            + _gh_score(right[..., 0], right[..., 1], l2) - ps[..., None])
    ok = (cum[..., 2] >= min_examples) & (right[..., 2] >= min_examples)
    return torch.where(ok, gain, float("-inf"))


def best_split_gh(hist: torch.Tensor, min_examples: int, l2: float):
    """hist: (nodes, F, B, 3) [g, h, n] -> (gain, feat, bin) per node (local
    feature indices; bin = first right bin). The flat first-max argmax: ties
    go to the smallest feature, then the smallest bin."""
    gain = split_gain_tensor(hist, min_examples, l2)
    flat = gain.reshape(gain.shape[0], -1)                # (nodes, F*(B-1))
    idx = torch.argmax(flat, dim=1)
    best = flat.gather(1, idx[:, None])[:, 0]
    B1 = hist.shape[2] - 1
    return (best, torch.div(idx, B1, rounding_mode="floor").to(torch.int32),
            (idx % B1 + 1).to(torch.int32))


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(N,) {0,1} -> (N/32,) int32 words (N a multiple of 32): bit j of word
    w is row 32w + j, bit 31 the sign bit. torch has no uint32 arithmetic
    or collective, so the words are the reference's uint32 words viewed as
    int32. Summing words over the model group is still an OR: each row's
    bit is set on one rank at most (the node's winner), so no bit carries
    and no signed sum overflows."""
    b = bits.reshape(-1, 32).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    words = (b << shifts[None, :]).sum(1)                  # [0, 2^32)
    return torch.where(words >= 2 ** 31, words - 2 ** 32,
                       words).to(torch.int32)


def _unpack_bits(words: torch.Tensor) -> torch.Tensor:
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    return ((words[:, None] >> shifts[None, :]) & 1).reshape(-1)


# =====================================================================
# config, mesh and worlds
# =====================================================================

HIST_IMPLS = (None, "cuda", "ref")


@dataclass(frozen=True)
class DistGBTConfig:
    """The reference's fields and defaults (the axis names are the
    port's Mesh's, fixed). ``hist_impl`` follows
    ``kernels/histogram/ops.histogram``: None follows the device (B3 on the
    card, its plain version on the CPU), "cuda" is B3 (CUDA tensors only),
    "ref" the plain version on any device."""
    max_depth: int = 5
    n_bins: int = 64
    min_examples: int = 2
    l2: float = 0.0
    shrinkage: float = 0.1
    num_trees: int = 20
    data_axis: str = "data"
    model_axis: str = "model"
    hist_impl: str | None = None

    def __post_init__(self):
        if (self.data_axis, self.model_axis) != ("data", "model"):
            raise YdfError(
                f"axes ({self.data_axis!r}, {self.model_axis!r}): the port's "
                "Mesh names its axes 'data' and 'model'; keep the defaults.")
        if self.hist_impl not in HIST_IMPLS:
            raise YdfError(
                f"hist_impl={self.hist_impl!r} is not one of {HIST_IMPLS}. "
                "The reference's 'pallas' is its TPU kernel; here the "
                "histogram kernel is 'cuda' (or None, which picks it on the "
                "card), and 'ref' is its plain version.")


def _device(device) -> torch.device:
    from repro_torch.core.engines import resolve_device
    return resolve_device(device)


class Mesh(ProcessMesh):
    """The (data, model) grid of the distributed GBT: a process mesh over
    ("data", "model"), rank r at (r // model, r % model), with this rank's
    ``data_index`` and ``model_index``. ``device`` is where every tensor of
    this rank lives (None is cuda; the same device on every rank of a
    one-card machine, never ``cuda:<rank>``); under gloo with the card
    every collective is staged through the host (``host_staged``).
    Construction is collective."""

    def __init__(self, data: int, model: int, device=None):
        super().__init__((data, model), ("data", "model"), device)
        self.data_index, self.model_index = self.coords["data"], self.coords["model"]


def default_backend(device, world_size: int) -> str:
    """"nccl" for a world of one on the card, else "gloo": several ranks
    share the one card, and NCCL refuses two ranks on one device."""
    return ("nccl" if _device(device).type == "cuda" and world_size == 1
            else "gloo")


# seconds a world may take: the process groups' collective timeout and
# run_world's deadline
WORLD_TIMEOUT_S = 900.0


def _run_rank(rank, world_size, init_method, backend, timeout_s, fn, args):
    # init_process_group replaces sys.excepthook (a rank prefix on every
    # traceback line); a world run in process leaves the process as it was
    hook = sys.excepthook
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=timedelta(seconds=timeout_s))
    try:
        return fn(*args)
    finally:
        dist.destroy_process_group()
        sys.excepthook = hook


def _rank_main(rank, world_size, init_method, backend, timeout_s, fn, args,
               results):
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    try:
        value = _run_rank(rank, world_size, init_method, backend, timeout_s,
                          fn, args)
        results.put((rank, True, value if rank == 0 else None))
    except BaseException:       # reported to the parent, which re-raises
        results.put((rank, False, traceback.format_exc()))


def run_world(fn, world_size: int, *args, device=None,
              timeout_s: float = WORLD_TIMEOUT_S):
    """Run ``fn(*args)`` on every rank of a new world of ``world_size`` ranks
    on this machine and return rank 0's result.

    One rank runs in this process; more are spawned processes, each of
    which imports ``fn`` by its module path (so keep ``fn`` in an
    importable module that pulls in nothing heavy) and sends rank 0's
    result back pickled. As with any spawned process, a script that calls
    this needs an ``if __name__ == "__main__":`` guard: each rank imports
    the main module again. Rendezvous goes through a file store in a fresh
    temporary directory, so concurrent worlds never share a port. The
    backend is ``default_backend``'s; ``device`` (None is cuda) is only
    checked here, ``fn`` receives what it needs in ``args``. A rank that
    raises or dies, or a world that outlasts ``timeout_s``, fails the call
    (with the rank's traceback where it had one), and the other ranks are
    killed at once: SIGKILL, since a rank inside a checkpoint session
    captures SIGTERM as a request to stop at its next tree.
    """
    backend = default_backend(device, world_size)
    tmp = tempfile.mkdtemp(prefix="repro_torch-world-")
    init = "file://" + os.path.join(tmp, "store")
    try:
        if world_size == 1:
            return _run_rank(0, 1, init, backend, timeout_s, fn, args)
        ctx = multiprocessing.get_context("spawn")
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, world_size, init, backend, timeout_s,
                                   fn, args, results))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        finished = False
        try:
            out, pending = None, world_size
            deadline = clock.monotonic() + timeout_s
            while pending:
                try:
                    rank, ok, value = results.get(timeout=1.0)
                except queue.Empty:
                    dead = [(r, p.exitcode) for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(f"rank {dead[0][0]} of "
                                           f"{world_size} exited with code "
                                           f"{dead[0][1]}") from None
                    if clock.monotonic() > deadline:
                        raise RuntimeError(
                            f"a world of {world_size} ranks did not finish "
                            f"in {timeout_s} s") from None
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of {world_size} "
                                       f"failed:\n{value}")
                pending -= 1
                if rank == 0:
                    out = value
            finished = True
            return out
        finally:
            for p in procs:     # every rank has reported when finished
                p.join(timeout=30 if finished else 0)
                if p.is_alive():
                    p.kill()
                    p.join()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# =====================================================================
# the level step (one tree level on the 2-D grid, per rank)
# =====================================================================

def make_level_step(mesh: Mesh, cfg: DistGBTConfig, n_nodes: int,
                    F_local: int):
    """fn(codes_l, stats_l, node_of_l) -> (feat_global, bin, gain,
    go_bits_l, hist) executing one tree level on this rank: codes_l
    (N_l, F_local) uint8, stats_l (N_l, 3) float32 and node_of_l (N_l,)
    int32 on ``mesh.device``; every output on it too."""
    from repro_torch.kernels.histogram.ops import histogram

    def level(codes, stats, node_of):
        hist = histogram(codes, stats, node_of, n_nodes, cfg.n_bins,
                         impl=cfg.hist_impl)
        hist = mesh.all_reduce(hist, "data")          # example-parallel
        gain, feat_l, bin_ = best_split_gh(hist, cfg.min_examples, cfg.l2)
        # feature-parallel candidate exchange: 3 scalars per node per rank
        gains = mesh.all_gather(gain[None], "model")  # (W, nodes)
        fb = mesh.all_gather(torch.stack([feat_l, bin_])[None], "model")
        feats, bins = fb[:, 0], fb[:, 1]
        winner = torch.argmax(torch.where(torch.isfinite(gains), gains,
                                          float("-inf")), dim=0)
        nid = torch.arange(n_nodes, device=gains.device)
        w_gain = gains[winner, nid]
        w_feat_local = feats[winner, nid]
        w_bin = bins[winner, nid]
        me = mesh.model_index
        owner_feat = torch.where(winner == me, w_feat_local, 0)
        valid = torch.isfinite(w_gain)
        # the owner computes the partition of ITS rows; the sum over the
        # model group broadcasts it (the others add zero words)
        node = node_of.clamp(min=0).long()
        my_codes = codes.gather(1, owner_feat[node].long()[:, None])[:, 0]
        go = ((winner[node] == me) & (my_codes.int() >= w_bin[node])
              & (node_of >= 0)).to(torch.int32)
        packed = mesh.all_reduce(_pack_bits(go), "model")
        go_all = _unpack_bits(packed)
        w_feat_global = w_feat_local + winner.to(torch.int32) * F_local
        return (w_feat_global, w_bin,
                torch.where(valid, w_gain, float("-inf")), go_all, hist)

    return level


def make_leaf_step(mesh: Mesh, cfg: DistGBTConfig, n_leaves: int):
    """fn(stats_l, node_of_l) -> (n_leaves, 3) [g, h, n] per leaf, summed
    over the data group: one B3 launch over a constant code column (every
    row in bin 0), so each leaf's totals are one rounding of an exact sum
    and equal on every rank of a data group. (The reference sums the 64
    float32 bins of its shard's first feature column.)"""
    from repro_torch.kernels.histogram.ops import histogram

    def leaves(stats, node_of):
        zero = torch.zeros((node_of.shape[0], 1), dtype=torch.uint8,
                           device=node_of.device)
        hist = histogram(zero, stats, node_of, n_leaves, 1,
                         impl=cfg.hist_impl)
        return mesh.all_reduce(hist, "data")[:, 0, 0, :]

    return leaves


# =====================================================================
# tree growth and boosting state
# =====================================================================

def grow_tree_complete(level_fns, leaf_fn, codes_l, stats_l, node_of0,
                       cfg: DistGBTConfig):
    """Grow one fixed-depth complete tree on this rank. Returns (feat, bin,
    gain) arrays in level order (2^D - 1 internal nodes), the per-leaf
    [g, h, n] (float32, host) and the rank's rows' leaf ids (device)."""
    feats, bins, gains = [], [], []
    node_of = node_of0
    for d in range(cfg.max_depth):
        f, b, g, go, _ = level_fns[d](codes_l, stats_l, node_of)
        feats.append(f.cpu().numpy())
        bins.append(b.cpu().numpy())
        gains.append(g.cpu().numpy())
        valid = torch.isfinite(g)
        go = torch.where(valid[node_of.clamp(min=0).long()], go, 0)
        node_of = torch.where(node_of >= 0, node_of * 2 + go, node_of)
    leaf_stats = leaf_fn(stats_l, node_of).cpu().numpy()
    return (np.concatenate(feats), np.concatenate(bins), np.concatenate(gains),
            leaf_stats, node_of)


# ---- shared boosting-state helpers (host side, backend-agnostic) ----

def _init_pred(y: np.ndarray, task: str) -> float:
    if task == "binary":
        p0 = np.clip(y.mean(), 1e-6, 1 - 1e-6)
        return float(np.log(p0 / (1 - p0)))
    return float(y.mean())


def _grad_hess(pred: np.ndarray, y: np.ndarray, task: str):
    if task == "binary":
        p = 1 / (1 + np.exp(-pred))
        return p - y, np.maximum(p * (1 - p), 1e-12)
    return pred - y, np.ones(len(y))


def predict_scores_complete(trees: list[dict], init_pred: float, D: int,
                            codes: np.ndarray) -> np.ndarray:
    """Score complete-layout trees (shared by both distributed backends)."""
    s = np.full(codes.shape[0], init_pred, np.float64)
    for tree in trees:
        node = np.zeros(codes.shape[0], np.int64)
        off = 0
        for d in range(D):
            nid = off + node
            f, b = tree["feat"][nid], tree["bin"][nid]
            go = (codes[np.arange(len(codes)), f] >= b) \
                & np.isfinite(tree["gain"][nid])
            node = node * 2 + go
            off += 2 ** d
        s += tree["leaf"][node]
    return s


def complete_trees_to_forest(trees: list[dict], init_pred: float, D: int,
                             feature_names: list[str] | None = None) -> Forest:
    """Convert complete-layout trees to the pointer SoA for the engines."""
    T = len(trees)
    M = 2 ** (D + 1)
    forest = empty_forest(T, M, 1, feature_names=feature_names)
    forest.depth = D
    forest.init_pred = np.array([init_pred], np.float32)
    for t, tree in enumerate(trees):
        # complete level order -> pointer layout (children in pairs).
        # Invalid (degenerate) splits become always-false conditions so
        # inference routes everything left, matching training.
        nxt = 1
        ptr = {0: 0}  # complete-id -> pointer-id
        off = 0
        for d in range(D):
            for i in range(2 ** d):
                cid = off + i
                pid = ptr[cid]
                valid = bool(np.isfinite(tree["gain"][cid]))
                forest.feature[t, pid] = max(int(tree["feat"][cid]), 0)
                if valid:
                    forest.split_bin[t, pid] = tree["bin"][cid]
                    forest.threshold[t, pid] = float(tree["bin"][cid]) - 0.5
                    forest.split_gain[t, pid] = max(
                        float(tree["gain"][cid]), 0.0)
                else:
                    forest.split_bin[t, pid] = 65535
                    forest.threshold[t, pid] = np.float32(3e38)
                forest.left_child[t, pid] = nxt
                left_cid = off + 2 ** d + 2 * i  # = 2^(d+1)-1 + 2i
                ptr[left_cid] = nxt
                ptr[left_cid + 1] = nxt + 1
                nxt += 2
            off += 2 ** d
        for i in range(2 ** D):  # off == 2^D - 1 here
            pid = ptr[off + i]
            forest.left_child[t, pid] = -1
            forest.feature[t, pid] = -1
            forest.leaf_value[t, pid, 0] = tree["leaf"][i]
        forest.n_nodes[t] = nxt
    return forest


_TREE_KEYS = ("feat", "bin", "gain", "leaf")


def _stack_trees(trees: list[dict]) -> dict:
    """The checkpoint form of a tree list: each field stacked (T, ...)."""
    return {k: np.stack([t[k] for t in trees]) for k in _TREE_KEYS}


def _unstack_trees(stacked: dict) -> list[dict]:
    return [{k: np.copy(stacked[k][t]) for k in _TREE_KEYS}
            for t in range(stacked["feat"].shape[0])]


def _check_shape(N: int, F: int, data: int, model: int) -> None:
    if N % (data * 32):
        raise YdfError(f"N={N} must be divisible by 32*data={32 * data}")
    if F % model:
        raise YdfError(f"F={F} must divide model axis {model}")


def _open_session(checkpoint, config: dict, codes, y, device: torch.device):
    from repro_torch.core.rf import training_data_fingerprint
    from repro_torch.train.checkpoint import open_session
    return open_session(checkpoint, config,
                        training_data_fingerprint(codes, y),
                        device=device.type)


class DistributedGBT:
    """Boosted trees on the (data x model) mesh. Binary classification /
    regression on pre-binned numerical features (uint8 codes).

    Fault tolerance rides the checkpoint layer (``train.checkpoint``):
    ``fit(..., checkpoint=CheckpointPolicy(dir))`` writes atomic
    tree-boundary checkpoints and resumes. Rank 0 alone writes, polls
    ``should_stop`` (the cancel callback and captured signals) and
    broadcasts its answer, so every rank leaves the loop at the same tree;
    a barrier follows each tree's save. Rank 0 resumes first (a corrupt
    checkpoint is set aside once), then the others read the same directory,
    which every rank must see. The stored config excludes the mesh shape:
    trees agree across mesh placements within 1e-4, so a run checkpointed
    on one grid may resume on another, on the same device type.

    A fitted model pickles without its mesh (``fit_on_world`` returns such
    copies); it predicts and converts, and fits again only given a mesh.
    """

    def __init__(self, cfg: DistGBTConfig, mesh: Mesh | None):
        self.cfg = cfg
        self.mesh = mesh
        self.trees: list[dict] = []
        self.init_pred = 0.0
        self.training_logs: dict = {}

    def __getstate__(self):
        return {**self.__dict__, "mesh": None}

    def _train_config(self, task: str) -> dict:
        return {"trainer": "DistributedGBT", "task": task,
                "cfg": dataclasses.asdict(self.cfg)}

    def fit(self, codes: np.ndarray, y: np.ndarray, *, task: str = "binary",
            checkpoint=None):
        cfg, mesh = self.cfg, self.mesh
        if mesh is None:
            raise YdfError("This DistributedGBT has no mesh; build one with "
                           "DistributedGBT(cfg, Mesh(data, model, device)) "
                           "on every rank, or use fit_on_world.")
        N, F = codes.shape
        da, ma = mesh.shape["data"], mesh.shape["model"]
        _check_shape(N, F, da, ma)
        N_l, F_l = N // da, F // ma
        rows = slice(mesh.data_index * N_l, (mesh.data_index + 1) * N_l)
        cols = slice(mesh.model_index * F_l, (mesh.model_index + 1) * F_l)
        dev = mesh.device
        codes_l = torch.from_numpy(
            np.ascontiguousarray(codes[rows, cols], np.uint8)).to(dev)
        level_fns = [make_level_step(mesh, cfg, 2 ** d, F_l)
                     for d in range(cfg.max_depth)]
        leaf_fn = make_leaf_step(mesh, cfg, 2 ** cfg.max_depth)
        y_l = y[rows]
        self.init_pred = _init_pred(y, task)
        pred = np.full(N_l, self.init_pred, np.float64)
        self.trees = []

        sess = _open_session(checkpoint, self._train_config(task), codes, y,
                             dev)
        interrupted = False
        if sess is not None:
            state = None
            if mesh.rank == 0:
                try:
                    state = sess.resume()
                finally:
                    mesh.barrier()
            else:
                mesh.barrier()
                state = sess.resume()
            if state is not None:
                self.trees = _unstack_trees(state["trees"])
                pred = np.copy(state["pred"][rows])
                self.init_pred = float(state["init_pred"])

        with (sess if sess is not None else contextlib.nullcontext()):
            for it in range(len(self.trees), cfg.num_trees):
                g, h = _grad_hess(pred, y_l, task)
                stats = torch.from_numpy(np.stack(
                    [g, h, np.ones(N_l)], 1).astype(np.float32)).to(dev)
                node0 = torch.zeros(N_l, dtype=torch.int32, device=dev)
                with trace.span("distributed/tree", tree=it):
                    feat, bin_, gain, leaf_stats, node_of = \
                        grow_tree_complete(level_fns, leaf_fn, codes_l,
                                           stats, node0, cfg)
                leaf = -cfg.shrinkage * leaf_stats[:, 0] / (leaf_stats[:, 1]
                                                            + cfg.l2 + 1e-12)
                self.trees.append({"feat": feat, "bin": bin_, "gain": gain,
                                   "leaf": leaf.astype(np.float32)})
                # node_of is in leaf-level space [0, 2^D) after D rounds
                pred += self.trees[-1]["leaf"][node_of.cpu().numpy()]
                if sess is not None:
                    done = len(self.trees) == cfg.num_trees
                    if not done:
                        interrupted = mesh.broadcast_flag(
                            mesh.rank == 0 and sess.should_stop())
                    force = done or interrupted
                    if mesh.rank == 0 and (force
                                           or sess.due(len(self.trees))):
                        # every row's score: the reference's pred array,
                        # the same float64 sums in the same order
                        sess.save(len(self.trees), {
                            "kind": "dist_gbt",
                            "trees": _stack_trees(self.trees),
                            "pred": predict_scores_complete(
                                self.trees, self.init_pred, cfg.max_depth,
                                codes),
                            "init_pred": self.init_pred},
                            done=done, force=True)
                    mesh.barrier()
                    if interrupted:
                        break
        self.training_logs = build_training_logs(
            learner="distributed_gbt", num_trees=len(self.trees),
            resilience=sess.events if sess is not None else None,
            interrupted=interrupted)
        return self

    def predict_scores(self, codes: np.ndarray) -> np.ndarray:
        return predict_scores_complete(self.trees, self.init_pred,
                                       self.cfg.max_depth, codes)

    def to_forest(self, feature_names: list[str] | None = None) -> Forest:
        return complete_trees_to_forest(self.trees, self.init_pred,
                                        self.cfg.max_depth, feature_names)


def _fit_meshes_rank(cfg, codes, y, meshes, checkpoints, task, device):
    """One rank's part of ``fit_on_world``."""
    from repro_torch.kernels.histogram import histogram
    out = []
    for (data, model), checkpoint in zip(meshes, checkpoints):
        mesh = Mesh(data, model, device)
        launches0, t0 = histogram.LAUNCHES, clock.perf()
        gbt = DistributedGBT(cfg, mesh).fit(codes, y, task=task,
                                            checkpoint=checkpoint)
        seconds = clock.perf() - t0
        launches = mesh.all_gather(torch.tensor(
            [histogram.LAUNCHES - launches0], device=mesh.device), None)
        gbt.training_logs = validate_training_logs({
            **gbt.training_logs, "mesh": [data, model],
            "fit_seconds": seconds,
            "histogram_launches": launches.reshape(-1).tolist()})
        out.append(gbt)
    return out


def fit_on_world(cfg: DistGBTConfig, codes: np.ndarray, y: np.ndarray,
                 meshes, *, task: str = "binary", checkpoints=None,
                 device=None):
    """Fit ``cfg`` once on each ``(data, model)`` shape of ``meshes`` (all
    of one world size) in one world on this machine, and return rank 0's
    models, pickled back without their meshes. ``checkpoints``: one policy
    (or None) per shape. Each model's ``training_logs`` adds its mesh, the
    fit's seconds on rank 0 and every rank's B3 launches during the fit, in
    rank order (0 each on the CPU)."""
    meshes = [tuple(m) for m in meshes]
    worlds = {d * m for d, m in meshes}
    if len(worlds) != 1:
        raise YdfError(f"meshes {meshes} span worlds of {sorted(worlds)} "
                       "ranks; fit_on_world runs one world")
    for data, model in meshes:
        _check_shape(*codes.shape, data, model)
    dev = _device(device)
    checkpoints = list(checkpoints or [None] * len(meshes))
    return run_world(_fit_meshes_rank, worlds.pop(), cfg, codes, y, meshes,
                     checkpoints, task, str(dev), device=dev)


class CancelAfter:
    """A picklable ``CheckpointPolicy.cancel`` probe that stops training at
    its ``n``-th poll (one poll per tree): the stop a spawned rank 0 can
    carry, where a closure cannot travel."""

    def __init__(self, n: int):
        self.n, self.calls = n, 0

    def __call__(self) -> bool:
        self.calls += 1
        return self.calls >= self.n


# =====================================================================
# Simulation backend (paper §3.9's third implementation) + fault tolerance
# =====================================================================

@dataclass(frozen=True)
class WorkerFaultPlan:
    """A deterministic worker-death schedule for the simulation backend,
    mirroring ``serving/faults.py``: explicit ``(tree, level, worker)``
    triples for targeted scenarios plus a seeded per-(tree, level, worker)
    Bernoulli ``death_rate`` for soak runs. Pure counter-hash, no wall
    clock, so every fault run is exactly reproducible.
    """
    seed: int = 0
    deaths: tuple = ()           # ((tree, level, worker), ...)
    death_rate: float = 0.0

    def deaths_at(self, tree: int, level: int,
                  worker_ids: list[int]) -> list[int]:
        out = [w for (t, l, w) in self.deaths
               if t == tree and l == level and w in worker_ids]
        if self.death_rate > 0.0:
            for w in worker_ids:
                if w in out:
                    continue
                u = np.random.default_rng(
                    (self.seed & 0xFFFFFFFF, 7919, tree, level, w)).random()
                if u < self.death_rate:
                    out.append(w)
        return sorted(out)


class SimulatedWorker:
    """A training worker owning a set of feature columns. ``codes`` is the
    full host matrix (the worker reads only its columns) and
    ``device_codes`` its copy on the cluster's device (None when the
    cluster histograms with numpy)."""

    def __init__(self, wid: int, codes: np.ndarray, feature_ids: list[int],
                 device_codes: torch.Tensor | None = None):
        self.wid = wid
        self.feature_ids = list(feature_ids)
        self.codes = codes
        self.device_codes = device_codes
        self.alive = True

    def local_best(self, stats, node_of, n_nodes, cfg) -> list[tuple]:
        """Per node, the best (gain, global feature id, bin) over this
        worker's features. ``stats`` and ``node_of`` are host arrays when
        the cluster histograms with numpy (the port's
        ``splitters.build_histogram``, the reference's route on the CPU)
        and tensors on the device otherwise (B3 on the card)."""
        if not self.feature_ids:
            return [(-np.inf, -1, 0)] * n_nodes
        # scan features in GLOBAL-id order so the within-worker tie-break
        # (first max = smallest feature id, then smallest bin) is a property
        # of the features themselves, not of the assignment order: after a
        # death reassigns features, the surviving workers still propose the
        # exact same candidates (fault runs stay bit-identical to clean)
        fids = sorted(self.feature_ids)
        if self.device_codes is None:
            from repro_torch.core.splitters import build_histogram
            hist = torch.from_numpy(build_histogram(
                self.codes[:, fids], stats, node_of, n_nodes, cfg.n_bins))
        else:
            from repro_torch.kernels.histogram.ops import histogram
            sub = self.device_codes[:, fids]
            hist = histogram(sub, stats, node_of, n_nodes, cfg.n_bins,
                             impl=cfg.hist_impl)
        gain = split_gain_tensor(hist, cfg.min_examples, cfg.l2)
        B1 = gain.shape[2]
        flat = gain.reshape(n_nodes, -1)
        idx = flat.argmax(1)
        best = flat.gather(1, idx[:, None])[:, 0].cpu().numpy()
        idx = idx.cpu().numpy()
        return [(float(best[i]), fids[int(idx[i]) // B1],
                 int(idx[i]) % B1 + 1) for i in range(n_nodes)]

    def partition(self, feature: int, bin_: int) -> np.ndarray:
        return self.codes[:, feature] >= bin_


class SimulatedCluster:
    """Single-process multi-worker simulation: breakpoint-able, step-wise,
    with worker-failure injection and dynamic feature reassignment (§3.9).

    Fault-tolerant by construction:

    * a ``WorkerFaultPlan`` kills workers at scheduled ``(tree, level)``
      points: candidates computed in that level pass are treated as LOST
      and the level RESTARTS against the surviving workers after dynamic
      feature reassignment;
    * candidate merge uses a total order (highest gain, then smallest
      feature id, then smallest bin), so the chosen split is independent of
      which worker proposed it. With column-independent gains
      (``split_gain_tensor``) that makes a faulted run's forest
      BIT-IDENTICAL to the clean run, on the CPU and on the card;
    * ``fit(..., checkpoint=CheckpointPolicy(dir))`` writes the same atomic
      tree-boundary checkpoints as every other trainer (the trees stacked
      per field), so a full cluster crash resumes mid-forest on the same
      device type.

    Every death / reassignment / restart is recorded in
    ``training_logs["resilience"]``. ``device`` (None is cuda) is where the
    workers' histograms and gains run; ``hist_builds`` counts the
    histograms the workers built (one B3 launch each on the card).
    """

    def __init__(self, codes: np.ndarray, n_workers: int, cfg: DistGBTConfig,
                 seed: int = 0, fault_plan: WorkerFaultPlan | None = None,
                 *, device=None):
        self.cfg = cfg
        self.codes = codes
        self.seed = seed
        self.device = _device(device)
        # the reference's route on the CPU: numpy histograms of float64 stats
        self._numpy_hist = (self.device.type == "cpu"
                            and cfg.hist_impl is None)
        device_codes = (None if self._numpy_hist else torch.from_numpy(
            np.ascontiguousarray(codes, np.uint8)).to(self.device))
        F = codes.shape[1]
        rng = np.random.default_rng(seed)
        assign = np.array_split(rng.permutation(F), n_workers)
        self.workers = [SimulatedWorker(w, codes, list(a), device_codes)
                        for w, a in enumerate(assign)]
        self.traffic_bytes = 0
        self.hist_builds = 0
        self.fault_plan = fault_plan if fault_plan is not None else WorkerFaultPlan()
        self.trees: list[dict] = []
        self.init_pred = 0.0
        self.resilience: list[dict] = []
        # pre-fit logs hold a LIVE reference to the resilience list so
        # direct grow_tree() users see deaths as they happen; fit() rebuilds
        # the dict through the same schema with final values
        self.training_logs: dict = validate_training_logs({
            "schema_version": 1, "learner": "simulated_cluster",
            "num_trees": 0, "growth_engine": None, "engine_fallback": None,
            "resilience": self.resilience, "interrupted": False})
        self._tree_counter = 0

    def kill_worker(self, wid: int, *, tree: int | None = None,
                    level: int | None = None) -> None:
        """Fault injection: reassign the dead worker's features round-robin
        (the paper's dynamic feature re-allocation)."""
        dead = self.workers[wid]
        dead.alive = False
        alive = [w for w in self.workers if w.alive]
        if not alive:
            raise RuntimeError("all workers failed")
        n_feats = len(dead.feature_ids)
        for i, f in enumerate(dead.feature_ids):
            alive[i % len(alive)].feature_ids.append(f)
        dead.feature_ids = []
        self.resilience.append(
            {"event": "worker_death", "worker": wid, "tree": tree,
             "level": level, "features_reassigned": n_feats,
             "workers_alive": len(alive)})
        trace.event("distributed/worker_death", worker=wid, tree=tree,
                    level=level, features_reassigned=n_feats)

    def _train_config(self, task: str) -> dict:
        return {"trainer": "SimulatedCluster", "task": task,
                "cfg": dataclasses.asdict(self.cfg)}

    def grow_tree(self, stats: np.ndarray, tree_index: int | None = None) -> dict:
        t = self._tree_counter if tree_index is None else tree_index
        self._tree_counter = t + 1
        cfg = self.cfg
        N = self.codes.shape[0]
        node_of = np.zeros(N, np.int32)
        stats_in = stats if self._numpy_hist else torch.from_numpy(
            np.ascontiguousarray(stats, np.float32)).to(self.device)
        feats, bins, gains = [], [], []
        for d in range(cfg.max_depth):
            n_nodes = 2 ** d
            node_in = node_of if self._numpy_hist else torch.from_numpy(
                node_of).to(self.device)
            level_ctx = trace.span("distributed/level", tree=t, level=d,
                                   nodes=n_nodes)
            level_ctx.__enter__()
            while True:
                cands = []
                for w in self.workers:
                    if not w.alive:
                        continue
                    with trace.span("distributed/worker_best", worker=w.wid,
                                    tree=t, level=d,
                                    features=len(w.feature_ids)):
                        cands.append(w.local_best(stats_in, node_in, n_nodes,
                                                  cfg))
                    self.hist_builds += bool(w.feature_ids)
                self.traffic_bytes += sum(len(c) for c in cands) * 12  # 3 scalars
                dead = self.fault_plan.deaths_at(
                    t, d, [w.wid for w in self.workers if w.alive])
                if not dead:
                    break
                # deaths mid-level: the level pass's candidates are lost.
                # Reassign the dead workers' features, restart the level.
                # Histograms are pure functions of (data, node_of), and the
                # merge order is total, so the restarted level is
                # bit-identical to a clean level over the same partition.
                for wid in dead:
                    self.kill_worker(wid, tree=t, level=d)
                self.resilience.append(
                    {"event": "level_restart", "tree": t, "level": d,
                     "deaths": list(dead)})
                trace.event("distributed/level_restart", tree=t, level=d,
                            deaths=len(dead))
            for i in range(n_nodes):
                # assignment-independent merge: gain desc, feature id asc,
                # bin asc; a worker death can never change the winner
                g, f, b = max((c[i] for c in cands),
                              key=lambda x: (x[0], -x[1], -x[2]))
                feats.append(f if np.isfinite(g) else 0)
                bins.append(b)
                gains.append(g)
            level = np.array(gains[-n_nodes:])
            go = np.zeros(N, bool)
            for i in range(n_nodes):
                if np.isfinite(level[i]):
                    f, b = feats[-n_nodes + i], bins[-n_nodes + i]
                    owner = next(w for w in self.workers
                                 if w.alive and f in w.feature_ids)
                    sel = node_of == i
                    go[sel] = owner.partition(f, b)[sel]
            self.traffic_bytes += (N + 7) // 8  # bit-packed partition
            node_of = node_of * 2 + go
            level_ctx.__exit__(None, None, None)
        # leaves
        leaf = np.zeros(2 ** cfg.max_depth, np.float32)
        for i in range(2 ** cfg.max_depth):
            sel = node_of == i
            G, H = stats[sel, 0].sum(), stats[sel, 1].sum()
            leaf[i] = -cfg.shrinkage * G / (H + cfg.l2 + 1e-12)
        return {"feat": np.array(feats), "bin": np.array(bins),
                "gain": np.array(gains), "leaf": leaf, "node_of": node_of}

    # ---- boosting driver (same loop shape as DistributedGBT.fit) ----
    def fit(self, y: np.ndarray, *, task: str = "binary", checkpoint=None):
        cfg = self.cfg
        N = self.codes.shape[0]
        pred = np.zeros(N, np.float64)
        self.init_pred = _init_pred(y, task)
        pred[:] = self.init_pred
        self.trees = []

        sess = _open_session(checkpoint, self._train_config(task), self.codes,
                             y, self.device)
        interrupted = False
        if sess is not None:
            state = sess.resume()
            if state is not None:
                self.trees = _unstack_trees(state["trees"])
                pred = np.copy(state["pred"])
                self.init_pred = float(state["init_pred"])

        with (sess if sess is not None else contextlib.nullcontext()):
            for it in range(len(self.trees), cfg.num_trees):
                g, h = _grad_hess(pred, y, task)
                stats = np.stack([g, h, np.ones(N)], 1)
                tree = self.grow_tree(stats, tree_index=it)
                self.trees.append({k: tree[k] for k in _TREE_KEYS})
                pred += tree["leaf"][tree["node_of"]]
                if sess is not None:
                    done = len(self.trees) == cfg.num_trees
                    if not done and sess.should_stop():
                        interrupted = True
                    sess.save(len(self.trees),
                              {"kind": "sim_gbt",
                               "trees": _stack_trees(self.trees),
                               "pred": np.copy(pred),
                               "init_pred": self.init_pred},
                              done=done, force=done or interrupted)
                    if interrupted:
                        break
        self.training_logs = build_training_logs(
            learner="simulated_cluster", num_trees=len(self.trees),
            resilience=self.resilience, interrupted=interrupted,
            extra={"checkpoint":
                   sess.events if sess is not None else []})
        return self

    def predict_scores(self, codes: np.ndarray) -> np.ndarray:
        return predict_scores_complete(self.trees, self.init_pred,
                                       self.cfg.max_depth, codes)

    def to_forest(self, feature_names: list[str] | None = None) -> Forest:
        return complete_trees_to_forest(self.trees, self.init_pred,
                                        self.cfg.max_depth, feature_names)
