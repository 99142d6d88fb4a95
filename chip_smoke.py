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
kernel. The serving front end is also driven at the full width of the
default GBT over the Adult-like schema, with random weights from a numpy
seed (trees grown breadth-first to depths of 3 to 6, thresholds drawn from
each column's range, category masks over each vocabulary). Phases, one
JSON line each:

  1. device        — the card (nvidia-smi name and power limit), torch, CUDA.
  2. build         — every kernel source built from ``csrc/`` with nvcc, one
                     nvcc per source, all started together.
  3. kernel        — the traversal kernel against its plain PyTorch version
                     at the serving shapes, hostile values included
                     (``torch.equal``), and the full traversal against the
                     numpy ``predict_naive`` (``array_equal``).
  4. kernel_hist   — the histogram kernel against its plain version at the
                     batched engine's shapes (N = 90,000, F = 28, gh stats
                     with a duplicated column, 5% inactive rows, n_nodes 1,
                     8 and 32) and on edge cases (ragged N, code 255 in every
                     column, every row inactive, one row, no row): the count
                     channel equal, the other stats within the tolerance of
                     ``check_hist_case``; two launches give the same bits.
  5. kernel_fused  — the split-search kernel against its plain version at
                     the training shapes (N = 90,000, kf = 28, gh stats, every
                     frontier width W = 1 .. 64; class and moment stats at
                     N = 5,000) and on hostile inputs, under the tie rule of
                     ``check_fused_case``; three runs of the same inputs
                     must give the same bits.
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
 11. timings       — per kernel: time per call (CUDA events around each call,
                     median of 20 after warm-up; the wrapper's host-side
                     checks fall inside the window), device time
                     (torch.profiler), the plain version's time, the bound
                     and, for the histogram kernel, one ``index_add_`` over
                     precomputed flat ids (the library call that computes
                     its function); the serve phase's latency and rows/s (a smoke
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
from concurrent.futures import ThreadPoolExecutor
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
FUSED_TIMED_WIDTHS = (1, 64)
FUSED_KERNELS = ("amax_kernel", "accumulate_kernel", "scan_kernel",
                 "reduce_kernel", "Memset")
STRUCT_FIELDS = ("feature", "split_bin", "cat_mask", "left_child", "n_nodes")
HIST_N, HIST_F, HIST_NODES = 90_000, 28, (1, 8, 32)
HIST_TIMED_NODES = (8, 32)        # a middle level and the widest of depth 6
HIST_KERNELS = ("amax_kernel", "accumulate_kernel", "convert_kernel",
                "Memset")
# kernel vs plain version: the kernel rounds an exact sum of fixed-point
# values (each value quantized at 2^-45 of its stat's max |v|), the plain
# version a float64 sum, both to float32
HIST_RTOL, HIST_ATOL = 1e-6, 1e-6   # atol in units of the stat's max |v|
BEST_FIRST_ROWS, BEST_FIRST_TREES = 3_000, 5

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
    """Build every kernel source of the path with nvcc, one process per
    source, all started together, then load each library."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.forest_infer import forest_infer
    from repro_torch.kernels.histogram import fused, histogram
    modules = (forest_infer, fused, histogram)
    with ThreadPoolExecutor(len(modules)) as pool:
        results = list(pool.map(lambda m: _build.build(m.SOURCE), modules))
    for m in modules:
        m.library()
    return {m.SOURCE.name: {
        "seconds": r.seconds,
        "ptxas": [ln.strip() for ln in r.log.splitlines()
                  if "registers" in ln or "spill" in ln]}
        for m, r in zip(modules, results)}


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
                 device, inactive: float = 0.05):
    """(codes, stats, slot_of) on ``device`` as a level step gives them:
    uint8 codes, float32 stats of the kind (gh: g, h_gain, h_true, bag as
    the GBT builds them), int32 slots in [0, width) with a share of
    inactive rows (-1)."""
    import torch
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 256, (n, kf)).astype(np.uint8)
    if kind == "gh":
        p = rng.uniform(0.02, 0.98, n)
        y = (rng.random(n) < p).astype(np.float64)
        stats = np.stack([p - y, np.ones(n), p * (1 - p), np.ones(n)], 1)
    elif kind == "class":
        c = rng.integers(0, 2, n)
        stats = np.stack([c == 0, c == 1, np.ones(n)], 1).astype(np.float64)
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
                     n_trees: int = PROFILE_TREES) -> dict:
    """Where a training run's time goes: a traced ``n_trees`` ``fit`` run,
    with seconds per span (the repro_torch.obs tracer; while tracing, the
    device engine's level-step span closes after a CUDA sync, and the
    batched engine's histogram build ends in its device-to-host copy, so
    each holds its device time) and the card's busy time (torch.profiler:
    the sum of every kernel, copy and memset over the run), split into
    host-to-device copies, device-to-host copies and the path's kernel
    (the device activities whose names contain one of ``kernels``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.obs import clock, trace
    from repro_torch.obs.export import phase_summary
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with trace.capture() as tracer:
            t0 = clock.perf()
            fit(data, device, num_trees=n_trees, early_stopping="NONE")
            wall = clock.perf() - t0
        torch.cuda.synchronize()
    phases = {name: {"count": int(d["count"]), "total_s": d["total_s"]}
              for name, d in phase_summary(tracer).items()}
    events = [(ev.key, getattr(ev, "device_time_total", 0.0) / 1e3)
              for ev in prof.key_averages()]
    busy_ms = sum(ms for _, ms in events)
    trees_s = phases["gbt/tree"]["total_s"]
    return {"trees": n_trees, "wall_s": wall, "phases": phases,
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


def profiled_ms(fn, kernels: tuple, reps: int = 20) -> float | None:
    """Device time per call of ``fn``: the CUDA activity whose names
    contain one of ``kernels``, from torch.profiler over ``reps`` calls;
    None when the profiler records no device time for them."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = sum(getattr(ev, "device_time_total", 0.0)
                   for ev in prof.key_averages()
                   if any(k in ev.key for k in kernels))
    return total_us / reps / 1e3 if total_us else None


def kernel_bound(model, X, packed) -> dict:
    """The least time the card could take for one traversal call: bytes
    (X read once, the nodes each tree holds read once — not the padding of
    the packed layout — and one output per example and tree written once)
    over HBM bandwidth, against node visits (one fp32 compare each, counted
    on this input by traversing with each node's depth as its leaf value)
    over the fp32 peak."""
    import torch
    from repro_torch.core.tree import node_depths
    from repro_torch.kernels.forest_infer import ops
    from repro_torch.kernels.forest_infer.ref import forest_predict_ref
    B, TB, M = packed.feature.shape
    O = packed.leaf_value.shape[-1]
    n = X.shape[0]
    forest = model.forest
    slots = B * TB * M
    node_bytes = sum(t.numel() * t.element_size() // slots
                     for t in packed.tables[:5])           # 48 B when O = 1
    nbytes = (X.numel() * X.element_size() + int(forest.n_nodes.sum()) * node_bytes
              + packed.block_depth.numel() * 4 + n * forest.n_trees * O * 4)
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
               "kernel_device_ms": profiled_ms(
                   kernel, ("forest_infer_tiled_kernel",)),
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


def time_fused(device) -> dict:
    """B1 and its plain version at the training shape (N = 90,000, kf = 28,
    gh stats) for the first and the widest level."""
    from repro_torch.kernels.histogram.fused import fused_split
    from repro_torch.kernels.histogram.ref import fused_split_ref
    out = {}
    for w in FUSED_TIMED_WIDTHS:
        args = fused_inputs(FUSED_N, FUSED_KF, w, "gh", 200 + w, device)
        kernel = lambda: fused_split(*args, w, kind="gh", min_examples=5)
        row = {"kernel_ms": device_ms(kernel),
               "kernel_device_ms": profiled_ms(kernel, FUSED_KERNELS),
               "plain_ms": device_ms(
                   lambda: fused_split_ref(*args, w, kind="gh",
                                           min_examples=5))}
        row.update(fused_bound(*args, w))
        out[w] = row
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
    """B3, its plain version and the library call at the batched engine's
    shape (N = 90,000, F = 28, gh stats) for a middle and the widest level.
    The library call is one ``index_add_`` of the rows' stats over flat
    (node, feature, code) ids computed beforehand (inactive rows to a sink
    row), as the plain version does it; only that call is timed."""
    import torch
    from repro_torch.kernels.histogram.histogram import histogram
    from repro_torch.kernels.histogram.ref import histogram_f32_ref
    out = {}
    for k in HIST_TIMED_NODES:
        codes, stats, node_of = fused_inputs(HIST_N, HIST_F, k, "gh", 300 + k,
                                             device)
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
               "kernel_device_ms": profiled_ms(kernel, HIST_KERNELS),
               "plain_ms": device_ms(
                   lambda: histogram_f32_ref(codes, stats, node_of, k)),
               "library_ms": device_ms(lambda: flat.index_add_(0, seg, vals))}
        row.update(hist_bound(codes, stats, node_of, k))
        out[k] = row
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
    from repro_torch.core.hist_backend import resolve_backend
    from repro_torch.kernels.forest_infer import forest_infer
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

    timings = time_kernel(model, device)
    fused_t = time_fused(device)
    hist_t = time_hist(device)
    emit(phase="timings", card=card, **{f"N={n}": row for n, row in timings.items()},
         **{f"fused W={w}": row for w, row in fused_t.items()},
         **{f"hist n_nodes={k}": row for k, row in hist_t.items()},
         server_p50_ms=stats["p50_ms"], server_p99_ms=stats["p99_ms"],
         server_rows_per_s=stats["rows_per_s"])

    main_n = TIMED_SIZES[0]   # the largest dispatch bucket of the server
    t = timings[main_n]
    main_w = FUSED_TIMED_WIDTHS[-1]   # the widest level of a depth-6 tree
    f = fused_t[main_w]
    main_k = HIST_TIMED_NODES[-1]     # the widest level of a depth-6 tree
    h = hist_t[main_k]
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
        "shape": f"N={FUSED_N}, kf={FUSED_KF}, S=4 (gh), W={main_w}",
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
        "shape": f"N={HIST_N}, F={HIST_F}, S=4 (gh), n_nodes={main_k}",
    }]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
