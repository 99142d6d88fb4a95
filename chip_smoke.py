#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Drives the port's main paths on the card: train the default Gradient
Boosted Trees model (core/hparams.py: 300 trees, max_depth 6, shrinkage
0.1, LOSS_INCREASE early stopping on a 10% self-extracted validation set)
on ``synth_higgs_like`` (100,000 rows of 28 numerical columns and a binary
label, the widths of UCI HIGGS, made from a numpy seed) through the device
growth engine (growth_engine="device") and through the default batched
engine (no override), compile it, and serve it through the traversal
kernel; train the default Random Forest (max_depth 16, 4,096 nodes, sqrt(F)
candidates, bootstrap, out-of-bag evaluation; the first RF_TREES of its 300
trees) and the default CART tree on the same data and serve the forest; and
run the single-tree traversal kernel on the trained forest and the GBT.
The serving front end is also driven at the full width of the
default GBT over the Adult-like schema, with random weights from a numpy
seed (trees grown breadth-first to depths of 3 to 6, thresholds drawn from
each column's range, category masks over each vocabulary). Phases, one
JSON line each:

  1. device        — the card (nvidia-smi name and power limit), torch, CUDA.
  2. build         — every kernel source (``kernels/_build.SOURCES``) built
                     from ``csrc/`` with nvcc, one nvcc per source, all
                     started together.
  3. kernel        — the traversal kernel against its plain PyTorch version
                     at the serving shapes, hostile values included
                     (``torch.equal``), and the full traversal against the
                     numpy ``predict_naive`` (``array_equal``).
  4. kernel_hist   — the histogram kernel against its plain version at the
                     batched engine's shapes (N = 90,000, F = 28, gh stats
                     with a duplicated column, 5% inactive rows, n_nodes 1,
                     8 and 32) and on edge cases (ragged N, code 255 in every
                     column, every row inactive, one row, no row, class
                     stats of S = 17, 27 and 130, 70,000 nodes, one node
                     with every row, a hot bin that draws every row): the
                     count channel equal, the other stats within the
                     tolerance of ``check_hist_case``; two launches give the
                     same bits.
  5. kernel_fused  — the split-search kernel against its plain version at
                     the training shapes (N = 90,000, kf = 28, gh stats, every
                     frontier width W = 1 .. 64; class and moment stats at
                     N = 5,000) and on hostile inputs (S = 17, 27 and 130,
                     70,000 slots, one slot with every row, a hot bin), under
                     the tie rule of ``check_fused_case``; three runs of the
                     same inputs must give the same bits.
  6. train         — the default GBT trained on the card with the device
                     engine (counts reset just before, read just after: every
                     level step launched the split-search kernel); a 4-tree
                     run on 20,000 rows on the card against the same run on
                     the CPU; and a traced 20-tree run: seconds per span and
                     the card's busy time.
  7. train_batched — the default GBT with no override: the batched engine,
                     whose every histogram is built by the histogram kernel
                     (counts reset just before, read just after: launches ==
                     builds); the same card-against-CPU check (numpy backend
                     on the CPU); a traced 20-tree run with the histogram
                     build split into host-to-device copies, kernel time and
                     device-to-host copies, and the card's idle share.
  8. train_best_first — a few trees with BEST_FIRST_GLOBAL growth and RANDOM
                     categorical splits on the Adult-like data: the kernel on
                     row subsets and categorical codes (launches == builds),
                     against the same run on the CPU with its plain version.
  9. serve_trained — the trained model's predictions for its 10,000
                     validation rows through the CUDA traversal engine,
                     equal to ``predict_naive`` bit for bit.
 10. serve         — a ``ForestServer`` with the default chain answers ~50
                     raw-column requests; every answer equals the host oracle
                     ``finalize(predict_naive(encode(batch)))``, every
                     dispatch went through the kernel engine, and the kernel
                     launched (counts reset just before, read just after).
 11. train_rf      — the default Random Forest with no override (batched
                     engine, tree by tree, every histogram built by the
                     histogram kernel: launches == builds), cut to RF_TREES
                     trees (the cut and the seconds per tree printed); a
                     4-tree card run against the CPU's (numpy backend,
                     lockstep block), equal on every forest field; a traced
                     run of RF_PROFILE_TREES trees.
 12. train_rf_device — the same with growth_engine="device" (the split-search
                     kernel, "class" stats, blocks of 8): >= 99.5% of each
                     structure field as train_rf's, and two card runs of its
                     first block equal bit for bit.
 13. train_cart    — the default CART tree (batched engine, histogram kernel,
                     host pruning); on COMPARE_ROWS rows the card's tree
                     equals the CPU's on every field.
 13b. train_wide   — 26 classes (S = 27) at synth_higgs_like's width
                     (WIDE: 20,000 rows): the default RF cut to 3 trees of
                     depth 6 on the batched engine (the histogram kernel,
                     launches == builds) and on the device engine (the
                     split-search kernel), and a CART tree of depth 6, each
                     equal to the CPU's on every forest field (the device
                     engine: two card runs equal, >= 99.5% of each structure
                     field as the CPU's).
 14. serve_rf      — the trained forest through the tiled traversal kernel
                     (M = 4,096, depth up to 16), equal to ``predict_naive``.
 15. kernel_single — the single-tree traversal kernel driven through
                     ``forest_predict(impl="single")`` on the trained forest
                     and the GBT (counts reset just before, read just
                     after), then held to its plain version (``torch.equal``)
                     and to ``predict_naive`` on the host (``array_equal``)
                     on the trained forest, the GBT and a hand-built zoo
                     (mask words 0x80000001 and 0xFFFFFFFF, codes 0, 31, 32
                     and 255, NaN, +-inf and |x| >= 2^63, a stump forest, a
                     0-row batch that launches nothing).
 16. timings       — per kernel: time per call (CUDA events around each call,
                     median of 20 after warm-up; the wrapper's host-side
                     checks fall inside the window), device time (the same
                     events with the host hidden behind a sleep kernel,
                     ``device_only_ms``), the plain version's time, the bound
                     and, for the histogram kernel, one ``index_add_`` over
                     precomputed flat ids (the library call that computes
                     its function; no PyTorch call traverses a tree), and
                     the kernels launched per call (as the kernel library
                     counts its launch calls) of B1 and B3, at HIST_TIMED and FUSED_TIMED (the GBT's levels,
                     the RF's 2,048-node level, 26 classes, the RF device
                     engine's 512-slot chunks); the
                     serve phase's latency and rows/s (a smoke
                     reading over ~50 requests, server built before the clock
                     starts).

Then the kernels line (``{"kernels": [...]}``), the card's name and power
limit, and last ``{"ok": true, "device": {...}}``. Any failed check raises
and the script exits non-zero; without a CUDA device it exits 1 at once.
It imports nothing of JAX and nothing of the JAX package ``repro``.
"""
from __future__ import annotations

import json
import platform
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SEED = 0
N_TREES, MAX_DEPTH, MIN_DEPTH, MAX_NODES = 300, 6, 3, 128
KERNEL_SIZES = (1, 7, 32, 1024, 4096)
TIMED_SIZES = (1024, 4096)
HOSTILE = (float("nan"), float("inf"), float("-inf"), 1e20, -3.0, 255.9,
           256.0, 300.0, -1e20, 3e38)
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and non-tensor fp32 ops/s
PEAK_BYTES_S, PEAK_FP32_S = 3.35e12, 67e12

# The training main path: synth_higgs_like (repro_torch/data/tabular.py
# SyntheticSpec), the widths of UCI HIGGS at the repo's scaled training size
HIGGS = dict(name="synth_higgs_like", n=100_000, n_num=28, n_cat=0,
             n_classes=2, seed=9)
LEARNER_SEED = 1234          # the learners' default seed
COMPARE_ROWS, COMPARE_TREES = 20_000, 4
PROFILE_TREES = 20
FUSED_N, FUSED_KF, FUSED_WIDTHS = 90_000, 28, (1, 2, 4, 8, 16, 32, 64)
FUSED_SMALL_N = 5_000
FUSED_KERNELS = ("prep_kernel", "split_kernel",
                 "(anonymous namespace)::reduce_kernel")
STRUCT_FIELDS = ("feature", "split_bin", "cat_mask", "left_child", "n_nodes")
HIST_N, HIST_F, HIST_NODES = 90_000, 28, (1, 8, 32)
HIST_KERNELS = ("prep_kernel", "hist_kernel")
# kernel vs plain version: the kernel rounds an exact sum of fixed-point
# values (each value quantized at 2^-45 of its stat's max |v|), the plain
# version a float64 sum, both to float32
HIST_RTOL, HIST_ATOL = 1e-6, 1e-6   # atol in units of the stat's max |v|
# C1: stat widths past the old 16-stat limit (26 classes + the count = 27),
# and more nodes / slots than a grid's y axis held (65,535)
WIDE_STATS, WIDE_N, MANY_SLOTS = (17, 27, 130), 20_000, 70_000
HOT_CODE = 17             # the bin every row draws in the hot-bin cases
# timed shapes: (label, N, columns, stat kind, classes or None, nodes)
HIST_TIMED = (("n_nodes=8", HIST_N, HIST_F, "gh", None, 8),
              ("n_nodes=32", HIST_N, HIST_F, "gh", None, 32),
              ("RF level n_nodes=2048 S=3", 100_000, HIST_F, "class", 2, 2048),
              ("C1 n_nodes=32 S=27", HIST_N, HIST_F, "class", 26, 32))
FUSED_TIMED = (("W=1", FUSED_N, FUSED_KF, "gh", None, 1),
               ("W=64", FUSED_N, FUSED_KF, "gh", None, 64),
               ("RF device W=512 kf=5 S=3", 100_000, 5, "class", 2, 512))
BEST_FIRST_ROWS, BEST_FIRST_TREES = 3_000, 5
# the default Random Forest (300 trees) cut to two lockstep blocks of 8;
# every tree is grown alone, so the seconds per tree scale to 300
RF_TREES, RF_PROFILE_TREES = 16, 4
# C1's training phase: 26 classes at the widths of synth_higgs_like, cut to
# 20,000 rows and 3 trees of depth 6 (the batched engine copies and scans
# (nodes, 28, 256, 27) histograms on the host; deeper trees take minutes)
WIDE = dict(HIGGS, name="synth_higgs_like_26", n=20_000, n_classes=26)
WIDE_TREES, WIDE_DEPTH = 3, 6
FOREST_FIELDS = STRUCT_FIELDS + ("threshold", "leaf_value", "split_gain")
SINGLE_TIMED = (("gbt", 1024), ("gbt", 4096), ("rf", 10_000))
NAIVE_ROWS = 512          # rows held to the host's per-example predict_naive

# The Adult-like schema (repro/data/tabular.py adult_like) as a dataspec in
# the JSON form of dataspec.json: dictionaries ordered by frequency, code 0
# is out-of-dictionary.
_WORKCLASS = ["Private", "Government", "Self-emp-inc"]
_EDUCATION = ["HS-grad", "Some-college", "Bachelors", "Assoc-voc", "10th",
              "Masters", "7th-8th", "Doctorate"]
_OCCUPATION = ["Exec-managerial", "Prof-specialty", "Sales", "Adm-clerical",
               "Other-service", "Machine-op-inspct", "Handlers-cleaners"]
FEATURES = ["age", "workclass", "education", "occupation", "hours_per_week",
            "capital_gain"]
NUMERICAL_RANGE = {"age": (17.0, 90.0), "hours_per_week": (1.0, 99.0),
                   "capital_gain": (0.0, 30000.0)}


def _num(name, mean, std, lo, hi):
    return {"name": name, "semantic": "NUMERICAL", "vocab": [], "counts": {},
            "mean": mean, "std": std, "min": lo, "max": hi, "n_missing": 0,
            "manually_defined": False}


def _cat(name, vocab, n_missing=0):
    return {"name": name, "semantic": "CATEGORICAL",
            "vocab": ["<OOD>"] + list(vocab), "counts": {}, "mean": 0.0,
            "std": 0.0, "min": 0.0, "max": 0.0, "n_missing": n_missing,
            "manually_defined": False}


SPEC = {"n_rows": 3000, "columns": {
    "age": _num("age", 53.5, 21.4, 17.0, 90.0),
    "workclass": _cat("workclass", _WORKCLASS, 90),
    "education": _cat("education", _EDUCATION),
    "occupation": _cat("occupation", _OCCUPATION, 90),
    "hours_per_week": _num("hours_per_week", 40.1, 11.6, 1.0, 99.0),
    "capital_gain": _num("capital_gain", 490.0, 3100.0, 0.0, 99999.0),
    "income": _cat("income", ["<=50K", ">50K"]),
}}


def build_default_gbt(seed: int = SEED, n_trees: int = N_TREES):
    """The default GBT at full width with random weights from ``seed``."""
    from repro_torch import convert
    rng = np.random.default_rng(seed)
    T, M, W = n_trees, MAX_NODES, 8
    feature = np.full((T, M), -1, np.int32)
    threshold = np.zeros((T, M), np.float32)
    cat_mask = np.zeros((T, M, W), np.uint32)
    left_child = np.full((T, M), -1, np.int32)
    leaf_value = np.zeros((T, M, 1), np.float32)
    n_nodes = np.ones(T, np.int32)
    depth = 0
    for t in range(T):
        target = int(rng.integers(MIN_DEPTH, MAX_DEPTH + 1))
        frontier, count = [(0, 0)], 1
        while frontier:                                    # breadth-first
            nxt = []
            for node, d in frontier:
                if d >= target or (d >= 2 and rng.random() < 0.2):
                    leaf_value[t, node, 0] = rng.normal(0.0, 0.1)
                    continue
                j = int(rng.integers(len(FEATURES)))
                name = FEATURES[j]
                feature[t, node] = j
                if name in NUMERICAL_RANGE:
                    threshold[t, node] = rng.uniform(*NUMERICAL_RANGE[name])
                else:
                    V = len(SPEC["columns"][name]["vocab"])
                    bits = rng.random(V) < 0.5
                    bits[rng.integers(V)] = True           # never empty
                    for code in np.flatnonzero(bits):
                        cat_mask[t, node, code // 32] |= np.uint32(1 << (code % 32))
                left_child[t, node] = count
                nxt += [(count, d + 1), (count + 1, d + 1)]
                count += 2
                depth = max(depth, d + 1)
            frontier = nxt
        n_nodes[t] = count
    arrays = dict(feature=feature, threshold=threshold, cat_mask=cat_mask,
                  left_child=left_child, leaf_value=leaf_value,
                  n_nodes=n_nodes, depth=depth,
                  tree_class=np.zeros(T, np.int32),
                  init_pred=np.array([np.log(0.24 / 0.76)], np.float32),
                  out_dim=1)
    return convert.model_from_arrays(
        "gbt", arrays, SPEC, FEATURES, task="CLASSIFICATION",
        classes=["<=50K", ">50K"], loss="BINOMIAL_LOG_LIKELIHOOD")


def encoded_inputs(n: int, seed: int) -> np.ndarray:
    """(n, F) encoded rows: plausible values, and every third row (row 0
    first) hostile in every column — NaN, +-inf, huge, negative and
    out-of-range category codes."""
    rng = np.random.default_rng(seed)
    X = np.empty((n, len(FEATURES)), np.float32)
    for j, name in enumerate(FEATURES):
        if name in NUMERICAL_RANGE:
            lo, hi = NUMERICAL_RANGE[name]
            X[:, j] = rng.uniform(lo, hi, n)
        else:
            X[:, j] = rng.integers(0, len(SPEC["columns"][name]["vocab"]), n)
    for r in range(0, n, 3):
        for j in range(len(FEATURES)):
            X[r, j] = HOSTILE[(r // 3 + j) % len(HOSTILE)]
    return X


def raw_request(rng, n: int) -> dict:
    """One request of ``n`` rows of raw columns, as a client sends them:
    numbers, strings, missing values and unknown categories."""
    def missing(col, rate=0.05):
        col = np.asarray(col, dtype=object)
        col[rng.random(n) < rate] = None
        return col
    return {
        "age": missing(rng.integers(17, 91, n)),
        "workclass": missing(rng.choice(_WORKCLASS + ["Never-worked"], n)),
        "education": missing(rng.choice(_EDUCATION, n)),
        "occupation": missing(rng.choice(_OCCUPATION + ["Armed-Forces"], n)),
        "hours_per_week": missing(rng.integers(1, 100, n)),
        "capital_gain": missing(np.where(rng.random(n) < 0.1,
                                         rng.integers(1, 99999, n), 0)),
    }


def request_sizes(n_requests: int, seed: int) -> list[int]:
    """Log-uniform request sizes from 1 to 300 rows."""
    rng = np.random.default_rng(seed)
    return [int(v) for v in np.round(np.exp(rng.uniform(0, np.log(300),
                                                        n_requests)))]


def emit(**fields) -> None:
    print(json.dumps(fields, default=float), flush=True)


# ------------------------------------------------------------------ phases

def build_kernels() -> dict:
    """Build every kernel source with nvcc, one process per source, all
    started together, then load each library."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.forest_infer import forest_infer
    from repro_torch.kernels.histogram import fused, histogram
    results = _build.build_all()
    for load in (forest_infer.library, forest_infer.single_library,
                 fused.library, histogram.library):
        load()
    return {src.name: {
        "seconds": r.seconds,
        "ptxas": [ln.strip() for ln in r.log.splitlines()
                  if "registers" in ln or "spill" in ln]}
        for src, r in results.items()}


def check_kernel(model, device, sizes=KERNEL_SIZES, naive_rows=64) -> dict:
    """The kernel against its plain version on ``device`` at each size, and
    the whole traversal against the numpy oracle. Returns the largest
    absolute difference seen (0.0 when bit-identical)."""
    import torch
    from repro_torch.core.tree import predict_naive
    from repro_torch.kernels.forest_infer import ops
    from repro_torch.kernels.forest_infer.forest_infer import forest_predict_tiled
    from repro_torch.kernels.forest_infer.ref import forest_predict_packed_ref
    forest = model.forest
    packed = ops.device_packed(forest, device)
    B, TB, M = packed.feature.shape
    err = 0.0
    for n in sizes:
        X = torch.from_numpy(encoded_inputs(n, seed=n)).to(device)
        got = forest_predict_tiled(X, *packed.tables)
        want = forest_predict_packed_ref(X, *packed.tables)
        full = ops.forest_predict(forest, X, "cuda", device)
        soa = ops.forest_predict(forest, X, "ref", device)
        if device.type == "cuda":
            torch.cuda.synchronize()
        err = max(err, float((got - want).abs().max()) if n else 0.0)
        if not torch.equal(got, want):
            raise AssertionError(f"kernel != plain version at N={n}: max abs "
                                 f"diff {float((got - want).abs().max())}")
        if not torch.equal(full, soa):
            raise AssertionError(f"packed traversal != SoA traversal at N={n}")
    Xn = encoded_inputs(naive_rows, seed=7)
    got = ops.forest_predict(forest, Xn, "cuda", device).cpu().numpy()
    if not np.array_equal(got, predict_naive(forest, Xn)):
        raise AssertionError("kernel path != numpy predict_naive")
    return {"B": B, "TB": TB, "M": M, "sizes": list(sizes),
            "naive_rows": naive_rows, "max_abs_err": err}


def serve(model, device, n_requests: int = 50, wave: int = 5,
          seed: int = SEED) -> dict:
    """Drive a ForestServer with the default chain through submit / pump /
    result and hold every answer to the host oracle."""
    from repro_torch.core.dataspec import BatchEncoder
    from repro_torch.core.tree import predict_naive
    from repro_torch.obs import clock
    from repro_torch.serving.server import ForestServer
    rng = np.random.default_rng(seed + 1)
    requests = [raw_request(rng, n) for n in request_sizes(n_requests, seed)]
    server = ForestServer(model, device=device)
    t0 = clock.perf()
    answers = []
    for i in range(0, len(requests), wave):
        tickets = [server.submit(r, pump=False) for r in requests[i:i + wave]]
        server.pump()
        answers += [server.result(t) for t in tickets]
    seconds = clock.perf() - t0
    m = server.metrics
    head = server.engine_status()[0]["engine"]
    encoder = BatchEncoder(model.spec, model.features)
    finalize = model._compile_finalize()
    for i, (req, got) in enumerate(zip(requests, answers)):
        want = finalize(predict_naive(model.forest, encoder.encode(req)))
        if not np.array_equal(got, want):
            raise AssertionError(f"request {i}: served answer != host oracle")
    if m.engine_dispatches != {head: m.dispatches}:
        raise AssertionError(f"dispatches went through {m.engine_dispatches}, "
                             f"not only {head!r}")
    for name in ("fallback_dispatches", "failed", "retries", "shed",
                 "timed_out", "poisoned_rejected"):
        if getattr(m, name):
            raise AssertionError(f"server {name} = {getattr(m, name)}")
    if m.completed != len(requests):
        raise AssertionError(f"{m.completed} of {len(requests)} completed")
    rows = sum(len(a) for a in answers)
    lat = m.latency_percentiles()
    return {"requests": len(requests), "rows": rows,
            "dispatches": m.dispatches, "rows_padded": m.rows_padded,
            "engine_dispatches": m.engine_dispatches,
            "fallback_dispatches": m.fallback_dispatches,
            "failed": m.failed, "retries": m.retries,
            "seconds": seconds, "rows_per_s": rows / seconds,
            "p50_ms": lat["p50_ms"], "p99_ms": lat["p99_ms"]}


# ------------------------------------------------- split search (B1) checks

def fused_inputs(n: int, kf: int, width: int, kind: str, seed: int,
                 device, inactive: float = 0.05, n_classes: int = 2):
    """(codes, stats, slot_of) on ``device`` as a level step gives them:
    uint8 codes, float32 stats of the kind (gh: g, h_gain, h_true, bag as
    the GBT builds them; class: one-hot labels of ``n_classes`` and the
    count, S = n_classes + 1), int32 slots in [0, width) with a share of
    inactive rows (-1)."""
    import torch
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 256, (n, kf)).astype(np.uint8)
    if kind == "gh":
        p = rng.uniform(0.02, 0.98, n)
        y = (rng.random(n) < p).astype(np.float64)
        stats = np.stack([p - y, np.ones(n), p * (1 - p), np.ones(n)], 1)
    elif kind == "class":
        c = rng.integers(0, n_classes, n)
        stats = np.zeros((n, n_classes + 1))
        stats[np.arange(n), c] = 1.0
        stats[:, -1] = 1.0
    else:
        yv = rng.normal(size=n)
        stats = np.stack([yv, yv * yv, np.ones(n)], 1)
    slot = rng.integers(0, width, n).astype(np.int32)
    slot[rng.random(n) < inactive] = -1
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in
                 (codes, stats.astype(np.float32), slot))


def check_fused_case(codes, stats, slot, width, *, kind="gh", l2=0.0,
                     min_examples=5, runs=3) -> dict:
    """The split-search kernel against its plain version on the same
    tensors. Tie rule: with g* the plain best gain of a slot and
    eps = REL_GAIN_EPS * |score(parent)| + 1e-6 * |g*|, the kernel's gain
    lies within eps of g*; where the plain runner-up (the best other
    (column, bin) candidate) lies more than 2 * eps below g*, the
    (column, split_bin) pairs are identical. Unscoreable slots are
    (-1e30, -1, 0) in both. On the card, ``runs`` launches on the same
    inputs give the same bits (the plain version on the CPU promises no
    such thing: torch's vectorized and scalar ``log`` may differ by an ulp
    with the threads' split of a tensor)."""
    import torch
    from repro_torch.core.splitters import REL_GAIN_EPS
    from repro_torch.kernels.histogram.fused import (
        NEG_INF, _numerical_gains, fused_split, score_stats)
    from repro_torch.kernels.histogram.ref import (
        fused_split_ref, histogram_ref)
    kw = dict(kind=kind, l2=l2, min_examples=min_examples)
    runs = runs if codes.is_cuda else 1
    outs = [fused_split(codes, stats, slot, width, **kw) for _ in range(runs)]
    gain, col, sbin = outs[0]
    for o in outs[1:]:
        if not all(torch.equal(a, b) for a, b in zip(outs[0], o)):
            raise AssertionError("split-search kernel: repeated launches on "
                                 "the same inputs gave different outputs")
    pg, pc, pb = fused_split_ref(codes, stats, slot, width, **kw)
    hist = histogram_ref(codes, stats.double(), slot, width, 256)
    parent = hist.sum(dim=2)
    g = _numerical_gains(hist, parent, kind, l2, min_examples).reshape(width, -1)
    pscore = score_stats(parent[:, 0], kind, l2)
    gain, col, sbin, pg, pc, pb, pscore = (
        t.cpu().numpy() for t in (gain, col, sbin, pg, pc, pb, pscore))
    g = g.cpu().numpy()
    none = pc < 0
    if not np.array_equal(none, col < 0):
        raise AssertionError(f"scoreable slots differ: kernel columns {col}, "
                             f"plain {pc}")
    if (gain[none] != np.float32(NEG_INF)).any() or (sbin[none] != 0).any():
        raise AssertionError("an unscoreable slot is not (-1e30, -1, 0)")
    err, pinned = 0.0, 0
    for w in np.flatnonzero(~none):
        best = (int(pc[w]) * 256 + int(pb[w]) - 1)
        others = np.delete(g[w], best)
        runner = float(others.max()) if others.size else -np.inf
        eps = REL_GAIN_EPS * abs(float(pscore[w])) + 1e-6 * abs(float(pg[w]))
        diff = abs(float(gain[w]) - float(pg[w]))
        err = max(err, diff)
        if diff > eps:
            raise AssertionError(f"slot {w}: kernel gain {gain[w]} vs plain "
                                 f"{pg[w]} (eps {eps})")
        if float(pg[w]) - runner > 2 * eps:
            pinned += 1
            if (col[w], sbin[w]) != (pc[w], pb[w]):
                raise AssertionError(
                    f"slot {w}: kernel split ({col[w]}, {sbin[w]}) != plain "
                    f"({pc[w]}, {pb[w]}) with a clear winner")
    return {"slots": int(width), "scoreable": int((~none).sum()),
            "pinned": pinned, "max_abs_err": err, "columns": col.tolist()}


def check_fused(device) -> dict:
    """B1 against its plain version at the training shapes and on hostile
    inputs. Returns the cases' summaries and the largest gain error."""
    import torch
    cases = {}
    for w in FUSED_WIDTHS:
        cases[f"gh N={FUSED_N} W={w}"] = check_fused_case(
            *fused_inputs(FUSED_N, FUSED_KF, w, "gh", 10 + w, device), w)
    for kind in ("class", "moment"):
        cases[f"{kind} N={FUSED_SMALL_N} W=8"] = check_fused_case(
            *fused_inputs(FUSED_SMALL_N, FUSED_KF, 8, kind, 3, device), 8,
            kind=kind)
    # empty slots: rows only in slots 0..4 of 8
    codes, stats, slot = fused_inputs(4_999, FUSED_KF, 5, "gh", 4, device)
    r = cases["empty slots, ragged N=4999"] = check_fused_case(
        codes, stats, slot, 8)
    if r["columns"][5:] != [-1, -1, -1]:
        raise AssertionError(f"empty slots were split: {r['columns']}")
    # every row inactive
    r = cases["all rows inactive"] = check_fused_case(
        codes, stats, torch.full_like(slot, -1), 4)
    if r["scoreable"]:
        raise AssertionError("a slot with no active row was split")
    # ragged, tiny N
    for n in (1, 7):
        cases[f"ragged N={n}"] = check_fused_case(
            *fused_inputs(n, FUSED_KF, 2, "gh", n, device, inactive=0.0), 2,
            min_examples=1)
    # min_examples boundaries: slots of 10 and 9 rows with min_examples 5
    # (one feasible split point, none), and min_examples 0 (empty sides)
    codes, stats, _ = fused_inputs(19, FUSED_KF, 2, "gh", 5, device)
    slot = torch.tensor([0] * 10 + [1] * 9, dtype=torch.int32, device=device)
    r = cases["min_examples=5, slots of 10 and 9"] = check_fused_case(
        codes, stats, slot, 2)
    if r["columns"][1] != -1:
        raise AssertionError("a 9-row slot was split with min_examples=5")
    cases["min_examples=0"] = check_fused_case(
        codes, stats, slot, 3, min_examples=0)
    # C1: class stats past 16 (S = 17, 27, 130) and 70,000 slots
    for S in WIDE_STATS:
        cases[f"class S={S} N={WIDE_N} W=16"] = check_fused_case(
            *fused_inputs(WIDE_N, FUSED_KF, 16, "class", 40 + S, device,
                          n_classes=S - 1), 16, kind="class")
    cases[f"W={MANY_SLOTS}, N=3000, kf=2"] = check_fused_case(
        *fused_inputs(3_000, 2, MANY_SLOTS, "gh", 41, device), MANY_SLOTS,
        min_examples=1)
    # one slot with every row; a hot bin that draws every row (nothing is
    # scoreable), then 90% of the rows
    codes, stats, slot = fused_inputs(FUSED_N, FUSED_KF, 1, "gh", 42, device,
                                      inactive=0.0)
    cases["one slot, every row"] = check_fused_case(codes, stats, slot, 1)
    hot = torch.full_like(codes, HOT_CODE)
    r = cases["hot bin, every row"] = check_fused_case(hot, stats, slot, 1)
    if r["scoreable"]:
        raise AssertionError("a slot whose rows share one bin was split")
    hot[::10] = codes[::10]
    cases["hot bin, 90% of the rows"] = check_fused_case(hot, stats, slot, 1)
    # a duplicated column ties exactly and the lower column wins
    codes, stats, slot = fused_inputs(FUSED_N, FUSED_KF, 16, "gh", 6, device)
    codes[:, 7] = codes[:, 2]
    r = cases["duplicated column 7 == 2"] = check_fused_case(
        codes, stats, slot, 16)
    if 7 in r["columns"]:
        raise AssertionError("the duplicate of column 2 won a tie")
    err = max(c["max_abs_err"] for c in cases.values())
    for c in cases.values():
        del c["columns"]
    return {"cases": cases, "max_abs_err": err}


# ---------------------------------------------------- histogram (B3) checks

def check_hist_case(codes, stats, node_of, n_nodes, runs=2) -> dict:
    """The histogram kernel against its plain version on the same tensors:
    the count channel (the last stat) equal, every other output within
    HIST_RTOL * |plain| + HIST_ATOL * max |v_s| (max over the active rows of
    stat s); ``runs`` launches give the same bits."""
    import torch
    from repro_torch.kernels.histogram.histogram import histogram
    from repro_torch.kernels.histogram.ref import histogram_f32_ref
    outs = [histogram(codes, stats, node_of, n_nodes) for _ in range(runs)]
    got = outs[0]
    for o in outs[1:]:
        if not torch.equal(got, o):
            raise AssertionError("histogram kernel: repeated launches on the "
                                 "same inputs gave different outputs")
    want = histogram_f32_ref(codes, stats, node_of, n_nodes)
    if got.shape != want.shape or got.dtype != torch.float32:
        raise AssertionError(f"histogram kernel gave {tuple(got.shape)} "
                             f"{got.dtype}, plain {tuple(want.shape)}")
    if not torch.equal(got[..., -1], want[..., -1]):
        raise AssertionError(f"n_nodes={n_nodes}: the count channel differs")
    active = node_of >= 0
    amax = (stats[active].abs().amax(0) if bool(active.any())
            else torch.zeros(stats.shape[1], device=stats.device))
    diff = (got - want).abs()
    tol = HIST_RTOL * want.abs() + HIST_ATOL * amax
    if bool((diff > tol).any()):
        raise AssertionError(f"n_nodes={n_nodes}: kernel vs plain differ by "
                             f"{float(diff.max())} beyond the tolerance")
    return {"rows": int(codes.shape[0]), "active": int(active.sum()),
            "n_nodes": int(n_nodes),
            "max_abs_err": float(diff.max()) if diff.numel() else 0.0,
            "cells_differing": int((diff > 0).sum())}


def check_hist(device) -> dict:
    """B3 against its plain version at the batched engine's shapes and on
    edge cases. Returns the cases' summaries and the largest error."""
    import torch
    from repro_torch.kernels.histogram import histogram
    cases = {}
    for k in HIST_NODES:
        codes, stats, node_of = fused_inputs(HIST_N, HIST_F, k, "gh", 20 + k,
                                             device)
        codes[0] = 255                       # the top code in every column
        cases[f"N={HIST_N} n_nodes={k}"] = check_hist_case(
            codes, stats, node_of, k)
    codes, stats, node_of = fused_inputs(4_999, HIST_F, 5, "gh", 21, device)
    codes[:, 3] = 255
    cases["ragged N=4999 n_nodes=5, column 3 all 255"] = check_hist_case(
        codes, stats, node_of, 5)
    r = cases["all rows inactive"] = check_hist_case(
        codes, stats, torch.full_like(node_of, -1), 4)
    if r["active"]:
        raise AssertionError("inactive rows counted as active")
    cases["N=1"] = check_hist_case(*fused_inputs(1, HIST_F, 1, "gh", 22, device,
                                                 inactive=0.0), 1)
    # C1: class stats past 16 (S = 17, 27, 130) and 70,000 nodes
    for S in WIDE_STATS:
        cases[f"class S={S} N={WIDE_N} n_nodes=32"] = check_hist_case(
            *fused_inputs(WIDE_N, HIST_F, 32, "class", 30 + S, device,
                          n_classes=S - 1), 32)
    cases[f"n_nodes={MANY_SLOTS}, N=3000, F=2"] = check_hist_case(
        *fused_inputs(3_000, 2, MANY_SLOTS, "gh", 31, device), MANY_SLOTS)
    # one node with every row, and a hot bin that draws every row
    codes, stats, node_of = fused_inputs(HIST_N, HIST_F, 1, "gh", 32, device,
                                         inactive=0.0)
    cases["one node, every row"] = check_hist_case(codes, stats, node_of, 1)
    cases["hot bin, every row"] = check_hist_case(
        torch.full_like(codes, HOT_CODE), stats, node_of, 1)
    before = histogram.LAUNCHES
    empty = histogram.histogram(codes[:0], stats[:0], node_of[:0], 1)
    if histogram.LAUNCHES != before or bool(empty.any()):
        raise AssertionError("a call with no rows launched or gave non-zeros")
    for case in cases.values():
        if not case["active"] and case["max_abs_err"]:
            raise AssertionError("no active row, yet a non-zero histogram")
    return {"cases": cases,
            "max_abs_err": max(c["max_abs_err"] for c in cases.values())}


# ------------------------------------------------------------- training

def higgs_like(n: int = HIGGS["n"]) -> dict:
    """synth_higgs_like at ``n`` rows: raw columns num_0..num_27 + label."""
    from repro_torch.data.tabular import SyntheticSpec, make_dataset
    return make_dataset(SyntheticSpec(**{**HIGGS, "n": n}))


def train_default(data: dict, device, label: str = "label", **hparams):
    """The default GBT (batched engine, histogram_backend "auto": the CUDA
    histogram kernel on a CUDA device, numpy on the CPU), trained on
    ``device``."""
    from repro_torch.core.gbt import GradientBoostedTreesLearner
    return GradientBoostedTreesLearner(
        label=label, seed=LEARNER_SEED, device=device, **hparams).train(data)


def train_gbt(data: dict, device, **hparams):
    """The default GBT with the device growth engine, trained on ``device``."""
    return train_default(data, device, growth_engine="device", **hparams)


def validation_rows(data: dict) -> dict:
    """The rows the learner extracted as its validation set (not trained
    on): the held-out rows of the serve_trained phase."""
    from repro_torch.core.models import extract_validation
    n = len(data["label"])
    _, valid = extract_validation(n, 0.1, LEARNER_SEED)
    return {k: v[valid] for k, v in data.items()}


def agreement(a, b) -> dict:
    """Share of equal entries of each structure field of two forests."""
    return {k: float((getattr(a.forest, k) == getattr(b.forest, k)).mean())
            for k in STRUCT_FIELDS}


def compare_card_and_cpu(device, fit=train_gbt) -> dict:
    """A 4-tree ``fit`` run on the card against the same run on the CPU (the
    kernels' plain versions, or numpy for the batched engine): >= 99.5% of
    each structure field agrees, and predictions agree to 1e-4. A second
    card run gives the same forest bit for bit (the kernels' sums and the
    device engine's segment sums are exact on the card)."""
    data = higgs_like(COMPARE_ROWS)
    card = fit(data, device, num_trees=COMPARE_TREES)
    again = fit(data, device, num_trees=COMPARE_TREES)
    cpu = fit(data, "cpu", num_trees=COMPARE_TREES)
    repeat = all(np.array_equal(getattr(card.forest, k), getattr(again.forest, k))
                 for k in STRUCT_FIELDS + ("leaf_value", "threshold"))
    if not repeat:
        raise AssertionError("two card runs of the same training differ")
    agree = agreement(card, cpu)
    low = {k: v for k, v in agree.items() if v < 0.995}
    if low:
        raise AssertionError(f"card vs CPU structure agrees only {low}")
    rows = {k: v[:2000] for k, v in data.items() if k != "label"}
    pa = card.predict(rows, engine="ref", device="cpu")
    pb = cpu.predict(rows, engine="ref", device="cpu")
    diff = float(np.abs(pa - pb).max())
    if not np.allclose(pa, pb, atol=1e-4, rtol=0):
        raise AssertionError(f"card vs CPU predictions differ by {diff}")
    return {"rows": COMPARE_ROWS, "trees": COMPARE_TREES, "agree": agree,
            "pred_max_abs_diff": diff, "card_runs_identical": repeat}


def profile_training(data: dict, device, fit=train_gbt,
                     kernels: tuple = FUSED_KERNELS,
                     n_trees: int = PROFILE_TREES, tree_span: str = "gbt/tree",
                     **hparams) -> dict:
    """Where a training run's time goes: a traced ``n_trees`` ``fit`` run
    (with ``hparams``; a GBT without early stopping), with seconds per span
    (the repro_torch.obs tracer; while tracing, the device engine's
    level-step span closes after a CUDA sync, and the batched engine's
    histogram build ends in its device-to-host copy, so each holds its
    device time) and the card's busy time (torch.profiler: the sum of every
    kernel, copy and memset over the run), split into host-to-device copies,
    device-to-host copies and the path's kernel (the device activities whose
    names contain one of ``kernels``); the idle share is taken over the wall
    and over the ``tree_span`` spans."""
    if tree_span == "gbt/tree":
        hparams.setdefault("early_stopping", "NONE")
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.obs import clock, trace
    from repro_torch.obs.export import phase_summary
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with trace.capture() as tracer:
            t0 = clock.perf()
            fit(data, device, num_trees=n_trees, **hparams)
            wall = clock.perf() - t0
        torch.cuda.synchronize()
    phases = {name: {"count": int(d["count"]), "total_s": d["total_s"]}
              for name, d in phase_summary(tracer).items()}
    averages = prof.key_averages()
    events = [(ev.key, getattr(ev, "device_time_total", 0.0) / 1e3)
              for ev in averages]
    busy_ms = sum(ms for _, ms in events)
    trees_s = phases[tree_span]["total_s"]
    return {"trees": n_trees, "wall_s": wall, "phases": phases,
            # the profiler may drop records (see device_only_ms): the
            # kernel's record count, against its launches, says how many
            # it kept, and the busy time is a lower bound
            "kernel_records": {ev.key[:48]: ev.count for ev in averages
                               if any(n in ev.key for n in kernels)},
            "device_busy_ms": busy_ms,
            "device_ms": {
                "h2d_copies": sum(ms for k, ms in events if "HtoD" in k),
                "d2h_copies": sum(ms for k, ms in events if "DtoH" in k),
                "kernel": sum(ms for k, ms in events
                              if any(n in k for n in kernels))},
            # the wall includes the host's data preparation
            "device_idle_share_of_wall": 1.0 - busy_ms / 1e3 / wall,
            "device_idle_share_of_tree_spans": 1.0 - busy_ms / 1e3 / trees_s}


def serve_trained(model, rows: dict, device) -> dict:
    """The trained model's predictions through the CUDA traversal engine,
    held to ``finalize(predict_naive(encode(rows)))`` bit for bit."""
    from repro_torch.core.dataspec import BatchEncoder
    from repro_torch.core.tree import predict_naive
    from repro_torch.obs import clock
    feats = {k: rows[k] for k in model.features}
    predictor = model.predictor("cuda", device)
    t0 = clock.perf()
    got = predictor.predict(feats)
    seconds = clock.perf() - t0
    X = BatchEncoder(model.spec, model.features).encode(feats)
    want = model._compile_finalize()(predict_naive(model.forest, X))
    if not np.array_equal(got, want):
        raise AssertionError("trained model: cuda engine != predict_naive")
    return {"rows": len(X), "engine": predictor.name, "seconds": seconds}


def device_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of one call, from CUDA events around each call."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_only_ms(fn, reps: int = 20, warmup: int = 3,
                   sleep_cycles: int = 2_000_000) -> float:
    """Median device time of one call of ``fn``, the host excluded: CUDA
    events recorded around the call while a sleep kernel of
    ``sleep_cycles`` (~1 ms; ``torch.cuda._sleep``) holds the stream, so
    the events and the call's kernels run back to back on the card however
    long the host takes to enqueue them. (torch.profiler, over 20 calls in
    this long process, was seen to keep the records of only 16-17 calls of
    the split-search and histogram kernels and of none of the traversal
    kernels.)"""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def traversal_bound(forest, X, extra_bytes: int = 0) -> dict:
    """The least time the card could take for one traversal call: bytes
    (X read once, the nodes each tree holds read once — feature, threshold
    and left_child 4 B each, the 32 B mask, 4 * O B of leaf value, and not
    the padding of a packed layout —, ``extra_bytes`` of other inputs, and
    one output per example and tree written once) over HBM bandwidth,
    against node visits (one fp32 compare each, counted on this input by
    traversing with each node's depth as its leaf value) over the fp32
    peak."""
    import torch
    from repro_torch.core.tree import node_depths
    from repro_torch.kernels.forest_infer import ops
    from repro_torch.kernels.forest_infer.ref import forest_predict_ref
    O = forest.leaf_value.shape[-1]
    n = X.shape[0]
    node_bytes = 4 + 4 + 4 + 32 + 4 * O                   # 48 B when O = 1
    nbytes = (X.numel() * X.element_size() + int(forest.n_nodes.sum()) * node_bytes
              + extra_bytes + n * forest.n_trees * O * 4)
    soa = ops.device_soa(forest, X.device)
    depth = np.maximum(node_depths(forest), 0).astype(np.float32)[..., None]
    visits = float(forest_predict_ref(
        X, soa.feature, soa.threshold, soa.cat_mask, soa.left_child,
        torch.from_numpy(depth).to(X.device), depth=forest.depth).sum())
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, visits / PEAK_FP32_S * 1e3
    return {"bytes": nbytes, "nodes_held": int(forest.n_nodes.sum()),
            "node_visits": visits,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def kernel_bound(model, X, packed) -> dict:
    """``traversal_bound`` of the tiled kernel: its per-block depths are
    the one input beside X and the nodes."""
    return traversal_bound(model.forest, X, packed.block_depth.numel() * 4)


def time_kernel(model, device) -> dict:
    import torch
    from repro_torch.kernels.forest_infer import ops
    from repro_torch.kernels.forest_infer.forest_infer import forest_predict_tiled
    from repro_torch.kernels.forest_infer.ref import forest_predict_packed_ref
    packed = ops.device_packed(model.forest, device)
    out = {}
    for n in TIMED_SIZES:
        X = torch.from_numpy(encoded_inputs(n, seed=100 + n)).to(device)
        kernel = lambda: forest_predict_tiled(X, *packed.tables)
        row = {"kernel_ms": device_ms(kernel),
               "kernel_device_ms": device_only_ms(kernel),
               "plain_ms": device_ms(
                   lambda: forest_predict_packed_ref(X, *packed.tables)),
               "kernel_path_ms": device_ms(
                   lambda: ops.forest_predict(model.forest, X, "cuda", device))}
        row.update(kernel_bound(model, X, packed))
        out[n] = row
    return out


def fused_bound(codes, stats, slot, width) -> dict:
    """The least time the card could take for one split search: the bytes
    it must move (codes, stats and slots read once, three outputs per slot
    written once) over HBM bandwidth, against its operations (one add per
    active row, column and stat into the histogram, and per slot, column,
    bin and stat one prefix-sum add and ~4 score operations) over the fp32
    peak."""
    N, kf = codes.shape
    S = stats.shape[1]
    active = int((slot >= 0).sum())
    nbytes = (codes.numel() + stats.numel() * 4 + slot.numel() * 4
              + width * 12)
    ops = active * kf * S + width * kf * 256 * S * 5
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_FP32_S * 1e3
    return {"bytes": nbytes, "ops": ops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def timed_inputs(shape, seed: int, device) -> tuple:
    """(label, (codes, stats, slot_of), nodes) of a HIST_TIMED / FUSED_TIMED
    row."""
    label, n, cols, kind, classes, nodes = shape
    return label, fused_inputs(n, cols, nodes, kind, seed, device,
                               n_classes=classes or 2), nodes


def launches_per_call(fn, library, calls: int = 4) -> float:
    """Kernels one call of ``fn`` launches, as the kernel library counts
    its own launch calls (``library`` returns that count), over ``calls``
    calls; B1 and B3 launch at most 3."""
    before = library()
    for _ in range(calls):
        fn()
    per_call = (library() - before) / calls
    if not 1 <= per_call <= 3:
        raise AssertionError(f"{per_call} kernel launches per call")
    return per_call


def time_fused(device) -> dict:
    """B1 and its plain version at FUSED_TIMED: the GBT's first and widest
    level (N = 90,000, kf = 28, gh stats) and the RF device engine's
    512-slot chunks (N = 100,000, kf = 5, class stats, S = 3)."""
    from repro_torch.kernels.histogram import fused
    from repro_torch.kernels.histogram.fused import fused_split
    from repro_torch.kernels.histogram.ref import fused_split_ref
    out = {}
    for seed, shape in enumerate(FUSED_TIMED, 200):
        label, args, w = timed_inputs(shape, seed, device)
        kind = shape[3]
        kernel = lambda: fused_split(*args, w, kind=kind, min_examples=5)
        row = {"kernel_ms": device_ms(kernel),
               "kernel_device_ms": device_only_ms(kernel),
               "plain_ms": device_ms(
                   lambda: fused_split_ref(*args, w, kind=kind,
                                           min_examples=5)),
               "launches_per_call": launches_per_call(
                   kernel, fused.library().fused_split_kernel_launches)}
        row.update(fused_bound(*args, w))
        out[label] = row
    return out


def hist_bound(codes, stats, node_of, n_nodes) -> dict:
    """The least time the card could take for one histogram build: the
    bytes it must move (codes N * F, stats N * S * 4 and node ids N * 4 read
    once, the float32 output n_nodes * F * 256 * S * 4 written once) over
    HBM bandwidth, against its operations (one add per active row, column
    and stat) over the fp32 peak."""
    N, F = codes.shape
    S = stats.shape[1]
    active = int((node_of >= 0).sum())
    nbytes = (codes.numel() + stats.numel() * 4 + node_of.numel() * 4
              + n_nodes * F * 256 * S * 4)
    ops = active * F * S
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_FP32_S * 1e3
    return {"bytes": nbytes, "ops": ops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def time_hist(device) -> dict:
    """B3, its plain version and the library call at HIST_TIMED: the
    batched GBT's middle and widest level (N = 90,000, F = 28, gh stats),
    the default RF's widest level (N = 100,000, S = 3, 2,048 nodes) and a
    26-class level (S = 27). The library call is one ``index_add_`` of the
    rows' stats over flat (node, feature, code) ids computed beforehand
    (inactive rows to a sink row), as the plain version does it; only that
    call is timed."""
    import torch
    from repro_torch.kernels.histogram import histogram as hist
    from repro_torch.kernels.histogram.histogram import histogram
    from repro_torch.kernels.histogram.ref import histogram_f32_ref
    out = {}
    for seed, shape in enumerate(HIST_TIMED, 300):
        label, (codes, stats, node_of), k = timed_inputs(shape, seed, device)
        N, F = codes.shape
        S = stats.shape[1]
        node = node_of.long()
        seg = ((node.clamp(min=0)[:, None] * F
                + torch.arange(F, device=device)[None]) * 256 + codes.long())
        seg = torch.where((node >= 0)[:, None], seg, k * F * 256).reshape(-1)
        vals = stats[:, None, :].expand(N, F, S).reshape(N * F, S).contiguous()
        flat = torch.zeros((k * F * 256 + 1, S), device=device)
        kernel = lambda: histogram(codes, stats, node_of, k)
        row = {"kernel_ms": device_ms(kernel),
               "kernel_device_ms": device_only_ms(kernel),
               "plain_ms": device_ms(
                   lambda: histogram_f32_ref(codes, stats, node_of, k)),
               "library_ms": device_ms(lambda: flat.index_add_(0, seg, vals)),
               "launches_per_call": launches_per_call(
                   kernel, hist.library().histogram_kernel_launches)}
        del seg, vals, flat
        row.update(hist_bound(codes, stats, node_of, k))
        out[label] = row
    return out


def train_best_first(device, backend) -> dict:
    """A few trees of BEST_FIRST_GLOBAL growth with RANDOM categorical
    splits on the Adult-like data: the batched engine builds one histogram
    per evaluated leaf over its row subset, categorical codes included.
    The same run on the CPU with the kernel's plain version
    (histogram_backend="torch": the same float32 stats, both children built)
    agrees on >= 99.5% of each structure field. Against the CPU's numpy
    backend (float64 stats, siblings by subtraction) the agreement is only
    reported: there, 1-ulp differences in float32 histograms reorder the
    best-first heap and flip RANDOM trials, and the boosted trees diverge."""
    from repro_torch.data.tabular import adult_like
    from repro_torch.kernels.histogram import histogram
    from repro_torch.obs import clock
    data = adult_like(BEST_FIRST_ROWS, seed=SEED)
    kw = dict(label="income", num_trees=BEST_FIRST_TREES,
              growing_strategy="BEST_FIRST_GLOBAL",
              categorical_algorithm="RANDOM")
    histogram.LAUNCHES = 0               # the best-first run starts here
    backend.builds = 0
    t0 = clock.perf()
    card = train_default(data, device, **kw)
    seconds = clock.perf() - t0
    launches, builds = histogram.LAUNCHES, backend.builds   # ... ends here
    logs = card.training_logs
    if logs["growth_engine"] != "batched" or logs["histogram_backend"] != "cuda":
        raise AssertionError(f"best-first trained with {logs['growth_engine']}"
                             f" / {logs.get('histogram_backend')}")
    if builds <= 0 or launches != builds:
        raise AssertionError(f"{builds} histogram builds made {launches} "
                             "kernel launches")
    plain = agreement(card, train_default(data, "cpu", histogram_backend="torch",
                                          **kw))
    low = {k: v for k, v in plain.items() if v < 0.995}
    if low:
        raise AssertionError(f"best-first card vs CPU (plain version) "
                             f"structure agrees only {low}")
    return {"rows": BEST_FIRST_ROWS, "trees_grown": len(logs["train_loss"]),
            "trees_kept": card.forest.n_trees, "seconds": seconds,
            "builds": builds, "launches": launches,
            "nodes": int(card.forest.n_nodes.sum()),
            "card_vs_cpu_plain_agree": plain,
            "card_vs_cpu_numpy_agree": agreement(
                card, train_default(data, "cpu", **kw)),
            "valid_accuracy": card.self_evaluation["accuracy"]}


# ------------------------------------------- single-tree traversal (B4)

def _hand_forest(trees: list, M: int = 8, O: int = 2):
    """A port Forest from hand-written trees: each tree a dict node ->
    (column, threshold or None, {word: mask}) for internal nodes, children
    at 2i+1 and 2i+2 of a heap layout, every leaf's value [t + node, -node]."""
    from repro_torch.core.tree import empty_forest, node_depths
    forest = empty_forest(len(trees), M, O)
    for t, nodes in enumerate(trees):
        for node, (col, thr, words) in nodes.items():
            forest.feature[t, node] = col
            forest.left_child[t, node] = 2 * node + 1
            if thr is not None:
                forest.threshold[t, node] = thr
            for w, bits in words.items():
                forest.cat_mask[t, node, w] = np.uint32(bits)
        n = max([0] + [2 * i + 2 for i in nodes]) + 1
        forest.n_nodes[t] = n
        for node in range(n):
            forest.leaf_value[t, node] = [t + node, -node][:O]
    forest.depth = int(max(0, node_depths(forest).max()))
    return forest


def single_zoo() -> dict:
    """Hand-built (forest, X) cases for the single-tree kernel: category
    masks whose words float32 cannot hold (0x80000001) and full words
    (0xFFFFFFFF), codes 0, 31, 32 and 255, NaN, +-inf, |x| >= 2^63 and huge
    or negative values in every column, and a forest of stumps (depth 0:
    one round)."""
    mixed = _hand_forest([
        # codes 0 and 31 right at the root; codes 32 and 255 right below
        {0: (0, None, {0: 0x80000001}), 1: (1, None, {1: 0x1, 7: 0x80000000}),
         2: (2, 0.5, {})},
        {0: (1, None, {w: 0xFFFFFFFF for w in range(8)})},   # all go right
        {},                                                   # a stump
        {0: (2, -1.0, {}), 2: (0, None, {0: 0x7FFFFFFE, 3: 0xFFFF0000})},
    ])
    stumps = _hand_forest([{}, {}, {}], M=1, O=1)
    codes = [0.0, 31.0, 32.0, 255.0, 1.0, 5.0, 96.0, 127.5]
    hostile = [float("nan"), float("inf"), float("-inf"), 2.0 ** 63,
               -(2.0 ** 63), 1e20, 3e38, -3.0, 256.0, -0.5]
    rng = np.random.default_rng(11)
    vals = np.array(codes + hostile, np.float32)
    X = rng.choice(vals, (600, 3)).astype(np.float32)
    X[:len(vals)] = vals[:, None]                   # each value in every column
    return {"mixed": (mixed, X), "stumps": (stumps, X),
            "mixed, 0 rows": (mixed, X[:0])}


def check_single_case(forest, X: np.ndarray, device) -> float:
    """The single-tree kernel against its plain version on ``device`` on
    every row (``torch.equal``), and the traversal against the host's
    ``predict_naive`` on the first NAIVE_ROWS rows (``array_equal``).
    Returns the largest absolute difference (0.0 when bit-identical)."""
    import torch
    from repro_torch.core.tree import predict_naive
    from repro_torch.kernels.forest_infer import ops
    from repro_torch.kernels.forest_infer.forest_infer import forest_predict_single
    from repro_torch.kernels.forest_infer.ref import forest_predict_ref
    soa = ops.device_soa(forest, device)
    Xd = torch.from_numpy(np.ascontiguousarray(X, np.float32)).to(device)
    got = forest_predict_single(Xd, *soa[:5], depth=forest.depth)
    want = forest_predict_ref(Xd, *soa[:5], depth=forest.depth)
    if device.type == "cuda":
        torch.cuda.synchronize()
    if got.shape != (len(X), forest.n_trees, forest.leaf_value.shape[-1]):
        raise AssertionError(f"single-tree kernel gave {tuple(got.shape)}")
    if not torch.equal(got, want):
        raise AssertionError(f"single-tree kernel != plain version: max abs "
                             f"diff {float((got - want).abs().max())}")
    naive = predict_naive(forest, X[:NAIVE_ROWS])
    if not np.array_equal(got[:NAIVE_ROWS].cpu().numpy(), naive):
        raise AssertionError("single-tree kernel != numpy predict_naive")
    return float((got - want).abs().max()) if got.numel() else 0.0


def check_single(cases: dict, device) -> dict:
    """``check_single_case`` over named (forest, X) cases; a 0-row case
    must launch nothing."""
    from repro_torch.kernels.forest_infer import forest_infer
    out = {}
    for name, (forest, X) in cases.items():
        before = forest_infer.SINGLE_LAUNCHES
        err = check_single_case(forest, X, device)
        if len(X) == 0 and forest_infer.SINGLE_LAUNCHES != before:
            raise AssertionError(f"{name}: a 0-row batch launched the kernel")
        out[name] = {"rows": len(X), "trees": forest.n_trees,
                     "max_nodes": forest.max_nodes, "depth": forest.depth,
                     "out_dim": int(forest.leaf_value.shape[-1]),
                     "max_abs_err": err}
    return {"cases": out, "max_abs_err": max(c["max_abs_err"]
                                             for c in out.values())}


def time_single(cases: dict, device) -> dict:
    """The single-tree kernel, its plain version and its bound per named
    (forest, X) case."""
    import torch
    from repro_torch.kernels.forest_infer import ops
    from repro_torch.kernels.forest_infer.forest_infer import forest_predict_single
    from repro_torch.kernels.forest_infer.ref import forest_predict_ref
    out = {}
    for name, (forest, X) in cases.items():
        soa = ops.device_soa(forest, device)
        Xd = torch.from_numpy(np.ascontiguousarray(X, np.float32)).to(device)
        kernel = lambda: forest_predict_single(Xd, *soa[:5], depth=forest.depth)
        row = {"kernel_ms": device_ms(kernel),
               "kernel_device_ms": device_only_ms(kernel),
               "plain_ms": device_ms(lambda: forest_predict_ref(
                   Xd, *soa[:5], depth=forest.depth))}
        row.update(traversal_bound(forest, Xd))
        out[name] = row
    return out


# ------------------------------------------------------- Random Forest, CART

def train_rf(data: dict, device, label: str = "label", **hparams):
    """The default Random Forest (batched engine, histogram_backend "auto":
    the CUDA histogram kernel on a CUDA device, numpy lockstep blocks on
    the CPU), trained on ``device``."""
    from repro_torch.core.rf import RandomForestLearner
    return RandomForestLearner(
        label=label, seed=LEARNER_SEED, device=device, **hparams).train(data)


def train_rf_device(data: dict, device, **hparams):
    """The default Random Forest with the device growth engine."""
    return train_rf(data, device, growth_engine="device", **hparams)


def train_cart(data: dict, device, label: str = "label", **hparams):
    """The default CART tree, trained on ``device``."""
    from repro_torch.core.cart import CartLearner
    return CartLearner(label=label, seed=LEARNER_SEED, device=device,
                       **hparams).train(data)


def identical(a, b, n_trees: int | None = None) -> bool:
    """Every forest field of the first ``n_trees`` trees (all when None)
    equal, and the depth when all trees are compared."""
    sl = slice(None) if n_trees is None else slice(0, n_trees)
    same = all(np.array_equal(getattr(a.forest, k)[sl], getattr(b.forest, k)[sl])
               for k in FOREST_FIELDS)
    return same and (n_trees is not None or a.forest.depth == b.forest.depth)


def compare_exact(fit, device, n_rows: int = COMPARE_ROWS, **hparams) -> dict:
    """A ``fit`` run on the card against the same run on the CPU (numpy
    backend): every forest field equal (the stats are integer bootstrap
    counts or one-hot labels, so every histogram cell is exact in float32 on
    both), the out-of-bag or training logs' metrics equal; a second card
    run equal too."""
    data = higgs_like(n_rows)
    card = fit(data, device, **hparams)
    again = fit(data, device, **hparams)
    cpu = fit(data, "cpu", **hparams)
    if not identical(card, again):
        raise AssertionError("two card runs of the same training differ")
    if not identical(card, cpu):
        raise AssertionError(f"card vs CPU forests differ: agreement "
                             f"{agreement(card, cpu)}")
    oob = [m.self_evaluation and m.self_evaluation.metrics for m in (card, cpu)]
    if oob[0] != oob[1]:
        raise AssertionError(f"card vs CPU out-of-bag metrics differ: {oob}")
    return {"rows": n_rows, **hparams, "identical": True,
            "cpu_engine": cpu.training_logs["growth_engine"],
            "cpu_backend": cpu.training_logs.get("histogram_backend"),
            "nodes": int(card.forest.n_nodes.sum())}


def run_rf(data: dict, device, backend) -> tuple:
    """The default Random Forest cut to RF_TREES trees on the card, counts
    reset just before and read just after: every level histogram built by
    the histogram kernel (launches == builds). Returns (model, summary)."""
    from repro_torch.kernels.histogram import histogram
    from repro_torch.obs import clock
    histogram.LAUNCHES = 0               # the Random Forest run starts here
    backend.builds = 0
    t0 = clock.perf()
    model = train_rf(data, device, num_trees=RF_TREES)
    seconds = clock.perf() - t0
    launches, builds = histogram.LAUNCHES, backend.builds  # ... ends here
    logs = model.training_logs
    if (logs["growth_engine"], logs["engine_fallback"],
            logs["histogram_backend"]) != ("batched", None, "cuda"):
        raise AssertionError(f"Random Forest trained with {logs}")
    if builds <= 0 or launches != builds:
        raise AssertionError(f"{builds} histogram builds made {launches} "
                             "kernel launches")
    f = model.forest
    if f.n_trees != RF_TREES or f.max_nodes != 4096:
        raise AssertionError(f"forest of {f.n_trees} trees x {f.max_nodes}")
    return model, {
        "rows": len(data["label"]), "trees": RF_TREES,
        "cut": f"{RF_TREES} of the default 300 trees",
        "seconds": seconds, "seconds_per_tree": seconds / RF_TREES,
        "builds": builds, "launches": launches,
        "nodes_mean": float(f.n_nodes.mean()), "depth": f.depth,
        "oob_accuracy": model.self_evaluation["accuracy"],
        "oob_coverage": logs["oob"]["coverage"]}


def run_rf_device(data: dict, device, batched) -> tuple:
    """The default Random Forest with the device engine, RF_TREES trees:
    every level step launches the split-search kernel; >= 99.5% of each
    structure field as the batched run ``batched``; a second card run of
    its first block (tree_parallelism trees) equal bit for bit."""
    from repro_torch.core import grower_device
    from repro_torch.kernels.histogram import fused
    from repro_torch.obs import clock
    fused.LAUNCHES = 0                   # the device-engine run starts here
    grower_device.LEVEL_STEPS = 0
    t0 = clock.perf()
    model = train_rf_device(data, device, num_trees=RF_TREES)
    seconds = clock.perf() - t0
    launches, steps = fused.LAUNCHES, grower_device.LEVEL_STEPS  # ... ends
    logs = model.training_logs
    if (logs["growth_engine"], logs["device_impl"]) != ("device", "cuda"):
        raise AssertionError(f"Random Forest trained with {logs}")
    if steps <= 0 or launches < steps:
        raise AssertionError(f"{steps} level steps made {launches} "
                             "split-search launches")
    agree = agreement(model, batched)
    low = {k: v for k, v in agree.items() if v < 0.995}
    if low:
        raise AssertionError(f"device vs batched forest agrees only {low}")
    block = logs["tree_parallelism"]
    again = train_rf_device(data, device, num_trees=block)
    if not identical(model, again, block):
        raise AssertionError("two card runs of the device engine differ")
    return model, {
        "rows": len(data["label"]), "trees": RF_TREES, "seconds": seconds,
        "seconds_per_tree": seconds / RF_TREES, "level_steps": steps,
        "launches": launches, "agree_with_batched": agree,
        "repeat_trees_identical": block,
        "oob_accuracy": model.self_evaluation["accuracy"]}


def run_cart(data: dict, device, backend) -> dict:
    """The default CART tree on the card (histogram kernel, launches ==
    builds, then host pruning), and on COMPARE_ROWS rows the card's tree
    equal to the CPU's on every field."""
    from repro_torch.kernels.histogram import histogram
    from repro_torch.obs import clock, trace
    from repro_torch.obs.export import phase_summary
    histogram.LAUNCHES = 0               # the CART run starts here
    backend.builds = 0
    t0 = clock.perf()
    with trace.capture() as tracer:
        model = train_cart(data, device)
    seconds = clock.perf() - t0
    launches, builds = histogram.LAUNCHES, backend.builds  # ... ends here
    logs = model.training_logs
    if (logs["growth_engine"], logs["histogram_backend"]) != ("batched", "cuda"):
        raise AssertionError(f"CART trained with {logs}")
    if builds <= 0 or launches != builds:
        raise AssertionError(f"{builds} histogram builds made {launches} "
                             "kernel launches")
    spans = phase_summary(tracer)
    return {"rows": len(data["label"]), "seconds": seconds,
            "grow_s": spans["cart/grow"]["total_s"],
            "prune_s": spans["cart/prune"]["total_s"],
            "builds": builds, "launches": launches,
            "nodes": int(model.forest.n_nodes[0]),
            "internal_after_pruning": int((model.forest.left_child[0] >= 0).sum()),
            "depth": model.forest.depth,
            "card_vs_cpu": compare_exact(train_cart, device)}


def run_wide(device, backend) -> dict:
    """C1 on the card: WIDE (26 classes, so S = 27 stats, at the widths of
    synth_higgs_like) through the default Random Forest cut to WIDE_TREES
    trees of depth WIDE_DEPTH on the batched engine (the histogram kernel,
    launches == builds) and on the device engine (the split-search kernel,
    "class" stats), and a CART tree of the same depth; each equals the same
    training on the CPU on every forest field, except the device engine's,
    which is held as the other device-engine phases are: two card runs
    equal, >= 99.5% of each structure field as the CPU's. Its gains are
    float32 scores whose entropy terms take the card's ``logf`` and the
    CPU's ``torch.log`` (summed in another order), so a near-tie may break
    the other way and change the subtree below it."""
    from repro_torch.data.tabular import SyntheticSpec, make_dataset
    from repro_torch.kernels.histogram import fused, histogram
    data = make_dataset(SyntheticSpec(**WIDE))
    kw = dict(max_depth=WIDE_DEPTH)
    out = {"rows": WIDE["n"], "classes": WIDE["n_classes"], "trees": WIDE_TREES,
           "max_depth": WIDE_DEPTH}
    for name, fit, extra in (("rf", train_rf, dict(num_trees=WIDE_TREES)),
                             ("cart", train_cart, {})):
        histogram.LAUNCHES = 0           # this training starts here
        backend.builds = 0
        card = fit(data, device, **kw, **extra)
        launches, builds = histogram.LAUNCHES, backend.builds  # ... ends here
        if card.training_logs["histogram_backend"] != "cuda":
            raise AssertionError(f"{name} trained with {card.training_logs}")
        if builds <= 0 or launches != builds:
            raise AssertionError(f"{name}: {builds} histogram builds made "
                                 f"{launches} kernel launches")
        cpu = fit(data, "cpu", **kw, **extra)
        if card.forest.leaf_value.shape[-1] != WIDE["n_classes"]:
            raise AssertionError(f"{name}: leaves of "
                                 f"{card.forest.leaf_value.shape[-1]} classes")
        if not identical(card, cpu):
            raise AssertionError(f"26-class {name}: card vs CPU forests "
                                 f"differ: {agreement(card, cpu)}")
        out[name] = {"launches": launches, "identical": True,
                     "nodes": int(card.forest.n_nodes.sum())}
    fused.LAUNCHES = 0                   # the device-engine training starts
    card = train_rf_device(data, device, num_trees=WIDE_TREES, **kw)
    launches = fused.LAUNCHES            # ... and ends here
    if card.training_logs["device_impl"] != "cuda" or launches <= 0:
        raise AssertionError(f"device engine: {launches} split-search "
                             f"launches, {card.training_logs}")
    if not identical(card, train_rf_device(data, device,
                                           num_trees=WIDE_TREES, **kw)):
        raise AssertionError("two card runs of the 26-class device engine "
                             "differ")
    agree = agreement(card, train_rf_device(data, "cpu",
                                            num_trees=WIDE_TREES, **kw))
    low = {k: v for k, v in agree.items() if v < 0.995}
    if low:
        raise AssertionError(f"26-class device engine: card vs CPU structure "
                             f"agrees only {low}")
    out["rf_device"] = {"launches": launches, "card_runs_identical": True,
                        "card_vs_cpu_agree": agree,
                        "nodes": int(card.forest.n_nodes.sum())}
    return out


def nvidia_smi() -> str:
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; this script measures "
              "the port on a GPU and has nothing to run here.", file=sys.stderr)
        return 1
    from repro_torch.core import grower_device
    from repro_torch.core.dataspec import BatchEncoder
    from repro_torch.core.hist_backend import resolve_backend
    from repro_torch.kernels.forest_infer import forest_infer, ops
    from repro_torch.kernels.histogram import fused, histogram
    from repro_torch.obs import clock
    device = torch.device("cuda")
    card = nvidia_smi()
    print(card, flush=True)
    emit(phase="device", nvidia_smi=card, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=platform.python_version(),
         machine=platform.machine())

    emit(phase="build", kernels=build_kernels())

    model = build_default_gbt()
    kern = check_kernel(model, device)
    if (kern["B"], kern["TB"], kern["M"]) != (38, 8, 128):
        raise AssertionError(f"default GBT packed as {kern}, expected "
                             "38 blocks of 8 trees x 128 nodes")
    if forest_infer.LAUNCHES <= 0:
        raise AssertionError("the kernel check made no kernel launch")
    emit(phase="kernel", **kern, launches=forest_infer.LAUNCHES)

    hist_check = check_hist(device)
    if histogram.LAUNCHES <= 0:
        raise AssertionError("the histogram check made no kernel launch")
    emit(phase="kernel_hist", **hist_check, launches=histogram.LAUNCHES)

    fused_check = check_fused(device)
    emit(phase="kernel_fused", **fused_check, launches=fused.LAUNCHES)

    # the training path: _resolve_impl("auto") on numerical data is the kernel
    if grower_device._resolve_impl("auto", False, device) != "cuda":
        raise AssertionError("auto does not resolve to the CUDA kernel")
    data = higgs_like()
    fused.LAUNCHES = 0                   # the training run starts here
    grower_device.LEVEL_STEPS = 0
    t0 = clock.perf()
    trained = train_gbt(data, device)
    train_s = clock.perf() - t0
    train_launches = fused.LAUNCHES      # ... and ends here
    steps = grower_device.LEVEL_STEPS
    logs = trained.training_logs
    if logs["growth_engine"] != "device" or logs["device_impl"] != "cuda":
        raise AssertionError(f"trained with {logs['growth_engine']} / "
                             f"{logs['device_impl']}, not device / cuda")
    if steps <= 0 or train_launches < steps:
        raise AssertionError(f"{steps} level steps made {train_launches} "
                             "split-search launches")
    kept = trained.forest.n_trees
    valid = validation_rows(data)
    emit(phase="train", rows=len(data["label"]), seconds=train_s,
         trees_grown=len(logs["train_loss"]), trees_kept=kept,
         level_steps=steps, launches=train_launches,
         valid_loss=logs["valid_loss"][kept - 1],
         valid_accuracy=trained.self_evaluation["accuracy"],
         valid_rows=len(valid["label"]),
         card_vs_cpu=compare_card_and_cpu(device),
         profile=profile_training(data, device))

    # the default learner: the batched engine, "auto" is the CUDA backend
    backend = resolve_backend("auto", device)
    if backend.name != "cuda":
        raise AssertionError(f"auto resolves to {backend.name!r}, not 'cuda'")
    histogram.LAUNCHES = 0               # the batched training run starts here
    backend.builds = 0
    t0 = clock.perf()
    batched = train_default(data, device)
    batched_s = clock.perf() - t0
    batched_launches = histogram.LAUNCHES  # ... and ends here
    builds = backend.builds
    blogs = batched.training_logs
    if (blogs["growth_engine"], blogs["engine_fallback"],
            blogs["histogram_backend"]) != ("batched", None, "cuda"):
        raise AssertionError(f"trained with {blogs['growth_engine']} / "
                             f"{blogs['engine_fallback']} / "
                             f"{blogs.get('histogram_backend')}")
    if builds <= 0 or batched_launches != builds:
        raise AssertionError(f"{builds} histogram builds made "
                             f"{batched_launches} kernel launches")
    bkept = batched.forest.n_trees
    emit(phase="train_batched", rows=len(data["label"]), seconds=batched_s,
         trees_grown=len(blogs["train_loss"]), trees_kept=bkept,
         builds=builds, launches=batched_launches,
         valid_loss=blogs["valid_loss"][bkept - 1],
         valid_accuracy=batched.self_evaluation["accuracy"],
         card_vs_cpu=compare_card_and_cpu(device, fit=train_default),
         profile=profile_training(data, device, fit=train_default,
                                  kernels=HIST_KERNELS))

    emit(phase="train_best_first", **train_best_first(device, backend))

    forest_infer.LAUNCHES = 0            # serving the trained model
    served = serve_trained(trained, valid, device)
    trained_launches = forest_infer.LAUNCHES
    if trained_launches <= 0:
        raise AssertionError("serving the trained model launched no kernel")
    emit(phase="serve_trained", **served, launches=trained_launches)

    forest_infer.LAUNCHES = 0            # the serving run starts here
    stats = serve(model, device)
    launches = forest_infer.LAUNCHES     # ... and ends here
    if stats["engine_dispatches"] != {"cuda": stats["dispatches"]}:
        raise AssertionError(f"served through {stats['engine_dispatches']}")
    if launches <= 0:
        raise AssertionError("the served requests launched no kernel")
    emit(phase="serve", **stats, launches=launches)

    # the default Random Forest, cut to RF_TREES trees, and CART
    rf, rf_run = run_rf(data, device, backend)
    emit(phase="train_rf", **rf_run,
         card_vs_cpu=compare_exact(train_rf, device, num_trees=4),
         profile=profile_training(data, device, fit=train_rf,
                                  kernels=HIST_KERNELS,
                                  n_trees=RF_PROFILE_TREES,
                                  tree_span="rf/block"))
    _, rf_device_run = run_rf_device(data, device, rf)
    emit(phase="train_rf_device", **rf_device_run)
    emit(phase="train_cart", **run_cart(data, device, backend))
    emit(phase="train_wide", **run_wide(device, backend))

    forest_infer.LAUNCHES = 0            # serving the trained forest
    served_rf = serve_trained(rf, valid, device)
    rf_served_launches = forest_infer.LAUNCHES
    if rf_served_launches <= 0:
        raise AssertionError("serving the trained forest launched no kernel")
    emit(phase="serve_rf", **served_rf, launches=rf_served_launches,
         trees=rf.forest.n_trees, max_nodes=rf.forest.max_nodes,
         depth=rf.forest.depth)

    # the single-tree kernel's path: forest_predict(impl="single") on the
    # trained forest and on the default GBT
    X_rf = BatchEncoder(rf.spec, rf.features).encode(
        {k: valid[k] for k in rf.features})
    X_gbt = encoded_inputs(TIMED_SIZES[0], seed=12)
    forest_infer.SINGLE_LAUNCHES = 0     # the single-tree path starts here
    single_out = [ops.forest_predict(m.forest, X, "single", device)
                  for m, X in ((rf, X_rf), (model, X_gbt))]
    torch.cuda.synchronize()
    single_launches = forest_infer.SINGLE_LAUNCHES   # ... and ends here
    if single_launches != 2:
        raise AssertionError(f"two single-tree calls made {single_launches} "
                             "kernel launches")
    for (m, X), got in zip(((rf, X_rf), (model, X_gbt)), single_out):
        if not torch.equal(got, ops.forest_predict(m.forest, X, "cuda", device)):
            raise AssertionError("single-tree traversal != tiled traversal")
    single_check = check_single(
        {"rf, trained": (rf.forest, X_rf),
         "gbt, default": (model.forest, encoded_inputs(TIMED_SIZES[-1], 13)),
         **single_zoo()}, device)
    emit(phase="kernel_single", launches=single_launches, **single_check)

    timings = time_kernel(model, device)
    fused_t = time_fused(device)
    hist_t = time_hist(device)
    single_t = time_single({
        f"{name} N={n}": ((rf if name == "rf" else model).forest,
                          X_rf[:n] if name == "rf" else encoded_inputs(n, 100 + n))
        for name, n in SINGLE_TIMED}, device)
    emit(phase="timings", card=card, **{f"N={n}": row for n, row in timings.items()},
         **{f"fused {k}": row for k, row in fused_t.items()},
         **{f"hist {k}": row for k, row in hist_t.items()},
         **{f"single {k}": row for k, row in single_t.items()},
         server_p50_ms=stats["p50_ms"], server_p99_ms=stats["p99_ms"],
         server_rows_per_s=stats["rows_per_s"])

    main_n = TIMED_SIZES[0]   # the largest dispatch bucket of the server
    t = timings[main_n]
    main_w = FUSED_TIMED[1]           # the widest level of a depth-6 tree
    f = fused_t[main_w[0]]
    main_k = HIST_TIMED[1]            # the widest level of a depth-6 tree
    h = hist_t[main_k[0]]
    main_s = "rf N={}".format(SINGLE_TIMED[-1][1])   # the trained forest
    s1 = single_t[main_s]
    print(json.dumps({"kernels": [{
        "name": "forest_infer_tiled",
        "route": "cuda",
        "source": "src/repro_torch/kernels/forest_infer/csrc/forest_infer.cu",
        "replaces": "src/repro/kernels/forest_infer/forest_infer.py:192",
        "launches": launches,
        "max_abs_err": kern["max_abs_err"],
        "ms": t["kernel_ms"], "device_ms": t["kernel_device_ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": None,
        "shape": f"N={main_n}, B={kern['B']}, TB={kern['TB']}, M={kern['M']}, O=1",
    }, {
        "name": "fused_split",
        "route": "cuda",
        "source": "src/repro_torch/kernels/histogram/csrc/fused_split.cu",
        "replaces": "src/repro/kernels/histogram/fused.py:148",
        "launches": train_launches,
        "max_abs_err": fused_check["max_abs_err"],
        "ms": f["kernel_ms"], "device_ms": f["kernel_device_ms"],
        "plain_ms": f["plain_ms"],
        "bound_ms": f["bound_ms"], "bound_by": f["bound_by"],
        "library_ms": None,
        "shape": f"N={FUSED_N}, kf={FUSED_KF}, S=4 (gh), W={main_w[-1]}",
        "launches_per_call": f["launches_per_call"],
    }, {
        "name": "histogram",
        "route": "cuda",
        "source": "src/repro_torch/kernels/histogram/csrc/histogram.cu",
        "replaces": "src/repro/kernels/histogram/histogram.py:61",
        "launches": batched_launches,
        "max_abs_err": hist_check["max_abs_err"],
        "ms": h["kernel_ms"], "device_ms": h["kernel_device_ms"],
        "plain_ms": h["plain_ms"],
        "bound_ms": h["bound_ms"], "bound_by": h["bound_by"],
        "library_ms": h["library_ms"],
        "shape": f"N={HIST_N}, F={HIST_F}, S=4 (gh), n_nodes={main_k[-1]}",
        "launches_per_call": h["launches_per_call"],
    }, {
        "name": "forest_single",
        "route": "cuda",
        "source": "src/repro_torch/kernels/forest_infer/csrc/forest_single.cu",
        "replaces": "src/repro/kernels/forest_infer/forest_infer.py:94",
        "launches": single_launches,
        "max_abs_err": single_check["max_abs_err"],
        "ms": s1["kernel_ms"], "device_ms": s1["kernel_device_ms"],
        "plain_ms": s1["plain_ms"],
        "bound_ms": s1["bound_ms"], "bound_by": s1["bound_by"],
        "library_ms": None,
        "shape": (f"{main_s}, T={rf.forest.n_trees}, M={rf.forest.max_nodes}, "
                  f"depth={rf.forest.depth}, O={rf.forest.leaf_value.shape[-1]}"),
    }]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
