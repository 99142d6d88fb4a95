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
trees) and the default CART tree on the same data and serve the forest;
run the single-tree traversal kernel on the trained forest and the GBT;
train the paper's best settings, the benchmark_rank1 GBT and Random
Forest (sparse-oblique splits; 2 trees each), and serve them through both
traversal kernels; and train the tasks (LambdaMART ranking through both
histogram kernels, uplift trees, an isolation forest) and serve them; serve
through the depth-bucketed engines and the asyncio front end.
The serving front end is also driven at the full width of the
default GBT over the Adult-like schema, with random weights from a numpy
seed (trees grown breadth-first to depths of 3 to 6, thresholds drawn from
each column's range, category masks over each vocabulary). Phases, one
JSON line each:

  1. device        — the card (nvidia-smi name and power limit), torch, CUDA.
  2. build         — every kernel source (``kernels/_build.SOURCES``) built
                     from ``csrc/`` with nvcc, one nvcc per source, all
                     started together.
  3. kernel        — the tiled traversal kernel (B2) against its plain
                     PyTorch version at the serving shapes, hostile values
                     included (``torch.equal``), and the full traversal
                     against the numpy ``predict_naive`` (``array_equal``);
                     ``forest_predict(impl="cuda")`` is one launch a call
                     with ``index_select`` refused; and each plan variant
                     (records staged in shared memory, or read from global
                     memory) in packed and tree order on the GBT, the
                     hand-built zoo, trees of 16,384 nodes (global only)
                     and 3-wide leaves (``check_variants``).
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
                     equal to ``predict_naive`` bit for bit; both traversal
                     kernels in each plan variant on those rows.
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
                     (M = 4,096, depth up to 16), equal to ``predict_naive``;
                     both traversal kernels in each plan variant.
 15. kernel_single — the single-tree traversal kernel driven through
                     ``forest_predict(impl="single")`` on the trained forest
                     and the GBT (counts reset just before, read just
                     after), then held to its plain version (``torch.equal``)
                     and to ``predict_naive`` on the host (``array_equal``)
                     on the trained forest, the GBT and a hand-built zoo
                     (mask words 0x80000001 and 0xFFFFFFFF, codes 0, 31, 32
                     and 255, NaN, +-inf and |x| >= 2^63, a stump forest, a
                     0-row batch that launches nothing), and in each plan
                     variant on those, the 16,384-node trees and O = 3.
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
                     engine's 512-slot chunks); B2 at TIMED_SIZES and B4 at
                     SINGLE_TIMED over their cached layouts, with the
                     device time of each plan variant, the whole
                     ``forest_predict`` (``kernel_path_ms``) and the plan
                     each took; the
                     serve phase's latency and rows/s (a smoke
                     reading over ~50 requests, server built before the clock
                     starts).

 17. model_io      — the trained device-engine GBT, the 16-tree Random Forest
                     and the CART tree saved (``Model.save``: plain data,
                     no pickle) and loaded (``Model.load``) in a scratch
                     directory under ``build/``: each loaded model holds no
                     predictor, predicts the validation rows through the cuda
                     engine (B2, counts reset just before, read just after)
                     ``array_equal`` with its prediction before the save, and
                     gives equal ``evaluate()`` metrics, ``summary()`` and
                     ``variable_importances()``; the loaded forest through
                     ``forest_predict(impl="single")`` (B4) equals the saved
                     forest's and ``predict_naive``. Save and load seconds
                     and the directory's bytes.
 18. checkpoint    — stop and resume on the card: the default GBT on the
                     device engine at full width (CKPT_EVERY-tree
                     checkpoints, stopped after CKPT_STOP_AT trees,
                     ``resume_training(device="cuda")``) equals the train
                     phase's uninterrupted forest on every Forest field (B1
                     counted over both runs); the device-engine RF stopped
                     after its first block of 8 and resumed equals
                     train_rf_device's forest; the batched GBT (B3) and
                     CART's grown stage, cut to CKPT_ROWS rows and
                     CKPT_TREES trees, each equal an uninterrupted run of
                     the same cut. Checkpoint write seconds and bytes, and
                     resume seconds.
 19. train_rank1   — the benchmark_rank1 GBT (best-first, RANDOM categorical
                     splits, sparse oblique) and Random Forest at full width,
                     cut to RANK1_TREES trees each: the batched engine, every
                     axis-aligned histogram built by B3 (counts reset just
                     before each run, read just after: launches == builds),
                     the projections host numpy; seconds per tree, oblique
                     nodes, span seconds and the gain scan's share. Gates at
                     COMPARE_ROWS rows: the RF's card forest equals the
                     CPU's on every field, twice; the GBT agrees with the
                     CPU's plain-version run on >= 99.5% of each field.
 20. kernel_oblique — B2 and B4 in every plan variant on oblique forests:
                     the hand zoo (P = 1, 7, 8, 9, 28, 128, 129, 300 over
                     NaN, +-inf and +-1e20 in projected columns and column
                     0), the near tie, and the trained rank1 forests over
                     the validation rows and hostile rows; each equal to
                     its plain version and to the vectorized engine bit for
                     bit, ``predict_naive`` (``np.dot``) reported with each
                     differing node's margin (only the near tie differs).
 21. serve_rank1   — the rank1 models serve the 10,000 validation rows
                     through ``compile_predictor`` with no engine named (the
                     cuda engine: one B2 launch a call) and through
                     ``forest_predict(impl="single")`` (B4), every answer
                     equal to ``finalize`` of the vectorized engine (counts
                     reset just before, read just after); the RF saved and
                     loaded predicts the same.

 22. train_ranking — LambdaMART (the default GBT, task=RANKING, NDCG@5 early
                     stopping) on grouped_relevance (RANKING: 8,000 groups
                     of 8-16 rows, 3 numerical columns), 70% of the groups
                     trained on and 30% held out: on the batched engine
                     (B3, launches == builds) and on the device engine
                     (B1, launches == level steps), counts reset just
                     before each run and read just after; seconds and trees
                     kept; NDCG@5 on the held-out groups against a
                     pointwise-regression GBT on the same split; traced
                     20-tree runs of both engines with the lambda pass's
                     share (``gbt/grad_hess``). Gates at
                     RANKING_COMPARE_GROUPS groups and RANKING_COMPARE_TREES
                     trees (``ranking_gates``): the batched card forest
                     equals the CPU's numpy forest on every field but
                     split_gain, which agrees within GAIN_RTOL; the
                     device engine agrees with the CPU's on >= 99.5% of
                     each structure field and repeats on the card, on data
                     with pairless groups too, whose pairless leaves have
                     the CPU's values.
 23. train_uplift  — the default uplift forest (depth 8, 4,096 nodes, SQRT
                     of 4 columns, bootstrap) on randomized_treatment
                     (100,000 rows), cut to UPLIFT_TREES trees: B3 builds
                     every histogram of the four uplift stats (launches ==
                     builds); the card's forest equals the CPU's on every
                     field; Qini > 0; growth_engine="device" raises; a
                     traced block.
 24. train_isolation — the default isolation forest (100 trees, psi 256,
                     depth <= 8; host numpy training) on planted_anomaly
                     (104,000 rows): equal to the CPU's; AUC >= 0.9; served
                     through ``make_forest_server`` (B2) in 40 requests,
                     each equal to ``finalize(predict_naive(encode(batch)))``
                     bit for bit, and all rows at once equal to the
                     vectorized engine; B4 equal to B2; both kernels in
                     each plan variant (``check_variants``).
 25. serve_tasks   — the trained ranking and uplift models serve
                     TASK_SERVE_ROWS rows each through
                     ``make_forest_server`` (B2), equal to ``model.predict``
                     on the CPU bit for bit.

 26. serve_bucketed — the depth-bucketed engines (ROADMAP A5, PyTorch
                     tensor code, no kernel of their own): "bucketed" (each
                     bucket's strategy from the card's cost model,
                     ``ops.MATMUL_CHEAP``), "leaf_path" (with TF32 matmuls
                     allowed and not) and the scan forced, over the serving
                     GBT at 4,096 rows, the trained device-engine GBT, the
                     trained RF (leaf_path gated out by LEAF_PATH_BUDGET,
                     asserted), the isolation, uplift and LambdaMART
                     models and the zoo of ``traversal_cases`` (hostile
                     rows, codes 0/31/32/255, 16,384-node trees, O = 3):
                     each answer ``array_equal`` to ``predict_naive`` and
                     to the cuda engine (B2, counted); an oblique rank1
                     model asked for "bucketed" raises YdfError naming the
                     compatible engines.
 27. serve_async   — ``AsyncForestServer`` over a ``ForestServer`` with the
                     default chain (["cuda"]) on the serving GBT: ~50
                     concurrent raw-column requests of 1 to 300 rows fanned
                     in with ``asyncio.gather`` against a queue cap that
                     sheds the number the admission rule gives, every
                     answer equal to ``finalize(predict_naive(encode(batch)))``,
                     B2 launched once a dispatch (counts reset just before,
                     read just after); the same requests through a bundle
                     warmed by ``warm_ladder(up_to=1024)``; a bulk sweep of
                     BULK_ROWS rows through ``predict_encoded_bulk`` in
                     BULK_CHUNK-row chunks equal to one direct call; a
                     ``CompiledPredictor`` on the bucketed engine pickled
                     and loaded on the card, its engine kept, its answers
                     equal.

train_uplift also trains the numerical-outcome case (``numerical_uplift``)
and holds it to the CPU with ``equal_but_gain``. After the timings phase,
``timings_bucketed`` times the bucketed engines (auto, scan and leaf_path
forced: the whole ``engine.per_tree`` and the device time) beside the cuda
engine, B2 and B4 on the same rows (the serving GBT at TIMED_SIZES, the
trained RF at BUCKETED_RF_TIMED), each bucket of the serving GBT's layout
scan against leaf_path (``time_buckets``, what the card's MATMUL_CHEAP is
read from), and prints ``benchmark_inference`` on the serving GBT at 4,096
rows.

The timings phase also times B2 and B4 on the rank1 forests at 10,000 rows
(``time_tiled``, ``time_single``; the bound counts 8 P bytes and 2 P
operations per oblique node), and the kernels line carries those numbers
under each traversal kernel's "oblique" key, and on the isolation forest
at 104,000 rows under its "isolation" key; B1 and B3 carry the task phases'
launches under "task_launches". Then the kernels line (``{"kernels": [...]}``), the card's name and power
limit, and last ``{"ok": true, "device": {...}}``. Any failed check raises
and the script exits non-zero; without a CUDA device it exits 1 at once.
It imports nothing of JAX and nothing of the JAX package ``repro``.
"""
from __future__ import annotations

import json
import os
import platform
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SEED = 0
N_TREES, MAX_DEPTH, MIN_DEPTH, MAX_NODES = 300, 6, 3, 128
KERNEL_SIZES = (1, 7, 32, 1024, 4096)
# B2 timed at the serving ladder's smallest and largest buckets
# (serving/forest.py), 4,096 rows and bulk scoring of 65,536 rows, whose
# (N, 300) float32 output alone is 78.6 MB
TIMED_SIZES = (32, 1024, 4096, 65_536)
MAIN_N = 1024             # the largest dispatch bucket of the server
BIG_NODES = 16_384        # trees past a block's shared memory: record-global
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
FOREST_FIELDS = STRUCT_FIELDS + ("threshold", "leaf_value", "split_gain",
                                 "obl_weights", "obl_features")
SINGLE_TIMED = (("gbt", 1024), ("gbt", 4096), ("rf", 10_000),
                ("rf", 100_000))
NAIVE_ROWS = 512          # rows held to the host's per-example predict_naive
# checkpointed training: the full-width GBT checkpoints every CKPT_EVERY
# trees and is stopped after CKPT_STOP_AT; the batched GBT and CART's grown
# stage are cut to CKPT_ROWS rows (and the GBT to CKPT_TREES trees)
CKPT_EVERY, CKPT_STOP_AT = 50, 100
CKPT_ROWS, CKPT_TREES = 20_000, 20
# sparse-oblique forests (benchmark_rank1@v1, paper App. C.1): both templates
# at synth_higgs_like's full width, cut to RANK1_TREES trees (their
# projections are host numpy, ~20 s a tree on a CPU at 100,000 rows); the
# gates at COMPARE_ROWS rows; the hand zoo's projection widths P (below 8,
# 8 to 128 and past 128, where numpy's pairwise sum splits)
RANK1_TREES = 2
OBLIQUE_DIMS = (1, 7, 8, 9, 28, 128, 129, 300)
OBLIQUE_F = 24            # columns of the zoo's rows
OBLIQUE_HOSTILE = (float("nan"), float("inf"), float("-inf"), 1e20, -1e20)
# the tasks (ROADMAP A4; repro_torch/data/tabular.py), at the default
# hyper-parameters: LambdaMART on grouped_relevance (RANKING_GROUPS groups
# of 8-16 rows, 3 numerical columns; RANKING_HOLDOUT of the groups held out
# with split seed 99, as tests/test_tasks.py:121 splits), its gates at
# RANKING_COMPARE_GROUPS groups and RANKING_COMPARE_TREES trees; uplift
# trees on randomized_treatment, cut from 100 to UPLIFT_TREES trees (the
# only cut), the gates on the same run; the isolation forest on
# planted_anomaly; TASK_SERVE_ROWS rows served per ranking / uplift model
RANKING = dict(n_groups=8_000, seed=7)
RANKING_HOLDOUT = 0.3
RANKING_COMPARE_GROUPS, RANKING_COMPARE_TREES = 1_700, 10
UPLIFT = dict(n=100_000, seed=11)
UPLIFT_TREES = 16
ANOMALY = dict(n_inlier=100_000, n_anomaly=4_000, seed=13)
TASK_SERVE_ROWS = 10_000
# split_gain of a GBT grown from float gradients, card (B3) against the
# CPU's numpy histograms: see equal_but_gain
GAIN_RTOL = 1e-4
# the uplift forest's numerical-outcome case: outcome * UPLIFT_SCALE plus
# N(0, UPLIFT_NOISE) noise from UPLIFT_NOISE_SEED (float stats in B3)
UPLIFT_SCALE, UPLIFT_NOISE, UPLIFT_NOISE_SEED = 3.7, 0.9, 5
# the bucketed engines (ROADMAP A5) timed beside B2 and B4: the serving GBT
# at TIMED_SIZES, the trained RF at BUCKETED_RF_TIMED rows; the async phase:
# a queue cap of ASYNC_CAP_SHARE of the requests' rows (the rest shed), the
# bulk sweep over BULK_ROWS rows in chunks of BULK_CHUNK
BUCKETED_RF_TIMED = (10_000, 100_000)
ASYNC_CAP_SHARE = 0.8
BULK_ROWS, BULK_CHUNK = 65_536, 4096

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
                  if "registers" in ln or "spill" in ln or "smem" in ln
                  or "Compiling entry" in ln]}
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
            "naive_rows": naive_rows, "max_abs_err": err,
            "path_launches_per_call": path_launches(forest, device)}


def path_launches(forest, device, calls: int = 3) -> float:
    """Tiled-kernel launches per ``forest_predict(impl="cuda")`` call, with
    ``index_select`` refused: the kernel stores tree order itself."""
    import torch
    from repro_torch.kernels.forest_infer import forest_infer, ops
    X = torch.from_numpy(encoded_inputs(MAIN_N, seed=5)).to(device)

    def refuse(*a, **k):
        raise AssertionError("index_select on the traversal path")

    saved = torch.index_select, torch.Tensor.index_select
    torch.index_select = torch.Tensor.index_select = refuse
    try:
        before = forest_infer.LAUNCHES
        for _ in range(calls):
            ops.forest_predict(forest, X, "cuda", device)
        per_call = (forest_infer.LAUNCHES - before) / calls
    finally:
        torch.index_select, torch.Tensor.index_select = saved
    if device.type == "cuda" and per_call != 1:
        raise AssertionError(f"forest_predict launched {per_call} kernels a call")
    return per_call


def random_forest(n_trees: int, n_splits: int, n_features: int, out_dim: int,
                  seed: int, cat_feats=(), max_nodes: int | None = None):
    """A random axis-aligned forest: each tree splits a random leaf
    ``n_splits`` times; a split on a column of ``cat_feats`` gets a random
    mask over all 256 codes (never empty), any other a normal threshold."""
    from repro_torch.core.tree import empty_forest, node_depths
    rng = np.random.default_rng(seed)
    f = empty_forest(n_trees, max_nodes or 2 * n_splits + 1, out_dim,
                     feature_names=[f"f{j}" for j in range(n_features)])
    for t in range(n_trees):
        f.leaf_value[t, 0] = rng.normal(size=out_dim)
        leaves, count = [0], 1
        for _ in range(n_splits):
            node = leaves.pop(int(rng.integers(len(leaves))))
            j = int(rng.integers(n_features))
            f.feature[t, node] = j
            if j in cat_feats:
                words = rng.integers(0, 2 ** 32, size=8, dtype=np.uint64)
                f.cat_mask[t, node] = words.astype(np.uint32) | np.uint32(1)
            else:
                f.threshold[t, node] = rng.normal()
            f.left_child[t, node] = count
            f.leaf_value[t, count:count + 2] = rng.normal(size=(2, out_dim))
            leaves += [count, count + 1]
            count += 2
        f.n_nodes[t] = count
    f.depth = int(max(0, node_depths(f).max()))
    return f


def hostile_rows(n: int, F: int, seed: int, cat_feats=()) -> np.ndarray:
    """(n, F) float32: normal values, codes -5 .. 299 in ``cat_feats``, and
    every third row the HOSTILE values (NaN, +-inf, huge, codes past 255)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, F)).astype(np.float32)
    for j in cat_feats:
        X[:, j] = rng.integers(-5, 300, n)
    bad = np.array(HOSTILE, np.float32)
    X[::3] = bad[(np.arange(0, n, 3)[:, None] + np.arange(F)) % len(bad)]
    return X


def traversal_cases() -> dict:
    """(forest, X) cases for both traversal kernels beyond the served GBT:
    the hand-built zoo, trees of BIG_NODES nodes (past a block's shared
    memory, so the plan reads their records from global memory) and a
    forest of 3-wide leaves over 700-split trees with categorical columns."""
    big = random_forest(4, BIG_NODES // 2 - 1, 5, 1, seed=8, cat_feats=(2,),
                        max_nodes=BIG_NODES)
    o3 = random_forest(37, 700, 9, 3, seed=4, cat_feats=(1, 5))
    return {**single_zoo(),
            f"{BIG_NODES} nodes": (big, hostile_rows(600, 5, 9, (2,))),
            "O=3": (o3, hostile_rows(300, 9, 5, (1, 5)))}


def traversal_plan(forest, X, kernel: str, device, variant=None):
    """The plan a traversal kernel takes for X over ``forest``'s layout
    (``variant`` None: the one the plan picks)."""
    from repro_torch.kernels.forest_infer import forest_infer, ops
    tabs = (ops.device_packed if kernel == "tiled" else ops.device_soa)(
        forest, device)
    return forest_infer.plan_of(tabs.layout, X.shape[0], variant)


def plan_variants(forest, X, kernel: str, device) -> tuple:
    """The plan variants a traversal kernel can take for X over
    ``forest``'s layout: "global" always, "staged" where the group fits the
    shared memory a block may have (the plan picks it only within
    ``plan.STAGE_BUDGET``; forcing it past the block's limit raises)."""
    try:
        traversal_plan(forest, X, kernel, device, "staged")
    except ValueError:
        return ("global",)
    return ("staged", "global")


def check_variants(forest, X: np.ndarray, device,
                   kernels=("tiled", "single")) -> dict:
    """Each traversal kernel of ``kernels`` in each plan variant its shapes
    allow (``plan_variants``) against its plain version on the same tensors
    (``torch.equal``; the tiled kernel in packed order and in tree order)
    and, in tree order, against the host: ``predict_naive`` on the first
    NAIVE_ROWS rows (``array_equal``), or for a forest with sparse-oblique
    nodes the port's vectorized engine (``compile_predict_raw``: numpy's
    pairwise projection sums, the kernels' order) on every row, with
    ``predict_naive`` (``np.dot``) on the first NAIVE_ROWS rows reported by
    ``naive_divergence``. Returns the variants run, with their plans, and
    the largest absolute difference (0.0 when bit-identical)."""
    import torch
    from repro_torch.core.tree import compile_predict_raw, predict_naive
    from repro_torch.kernels.forest_infer import ops
    from repro_torch.kernels.forest_infer.forest_infer import run_single, run_tiled
    from repro_torch.kernels.forest_infer.ref import (
        forest_predict_packed_ref, forest_predict_ref)
    Xd = torch.from_numpy(np.ascontiguousarray(X, np.float32)).to(device)
    X32 = np.ascontiguousarray(X, np.float32)
    oblique = forest.has_oblique()
    host_rows = len(X) if oblique else NAIVE_ROWS
    host = (compile_predict_raw(forest)(X32) if oblique
            else predict_naive(forest, X32[:NAIVE_ROWS]))
    out, err = {}, 0.0
    for kernel in kernels:
        if kernel == "tiled":
            tabs = ops.device_packed(forest, device)
            want = forest_predict_packed_ref(Xd, *tabs.tables, **tabs.obl)
            calls = {"packed": (lambda v: run_tiled(Xd, tabs.layout, variant=v),
                                want),
                     "tree order": (lambda v: run_tiled(
                         Xd, tabs.layout, tree_order=True, variant=v),
                         want[:, tabs.inv_order])}
        else:
            tabs = ops.device_soa(forest, device)
            want = forest_predict_ref(Xd, *tabs[:5], depth=forest.depth,
                                      **tabs.obl)
            calls = {"tree order": (lambda v: run_single(Xd, tabs.layout,
                                                         variant=v), want)}
        chosen = traversal_plan(forest, X, kernel, device)
        rows = {}
        for v in plan_variants(forest, X, kernel, device):
            for what, (fn, plain) in calls.items():
                got = fn(v)
                if device.type == "cuda":
                    torch.cuda.synchronize()
                if not torch.equal(got, plain):
                    raise AssertionError(
                        f"{kernel} ({v}, {what}) != plain version: max abs "
                        f"diff {float((got - plain).abs().max())}")
                if what == "tree order" and not np.array_equal(
                        got[:host_rows].cpu().numpy(), host):
                    raise AssertionError(f"{kernel} ({v}) != " + (
                        "the vectorized engine" if oblique
                        else "predict_naive"))
                if got.numel():
                    err = max(err, float((got - plain).abs().max()))
            p = traversal_plan(forest, X, kernel, device, v)
            rows[v] = {"picked": v == chosen.variant, "group": p.group,
                       "blocks": p.blocks, "smem": p.smem}
        out[kernel] = rows
    res = {"rows": len(X), "trees": forest.n_trees,
           "max_nodes": forest.max_nodes, "depth": forest.depth,
           "variants": out, "max_abs_err": err}
    if oblique:
        res["naive"] = naive_divergence(forest, X32[:NAIVE_ROWS],
                                        host[:NAIVE_ROWS])
    return res


def check_all_variants(cases: dict, device, kernels) -> dict:
    """``check_variants`` over named (forest, X) cases; every kernel must
    have run in both variants somewhere among them."""
    out = {name: check_variants(f, X, device, kernels)
           for name, (f, X) in cases.items()}
    for kernel in kernels:
        seen = {v for r in out.values() for v in r["variants"][kernel]}
        if seen != {"staged", "global"}:
            raise AssertionError(f"{kernel} ran only in {seen}")
    return {"cases": out,
            "max_abs_err": max(r["max_abs_err"] for r in out.values())}


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


def train_default(data: dict, device, label: str = "label", checkpoint=None,
                  **hparams):
    """The default GBT (batched engine, histogram_backend "auto": the CUDA
    histogram kernel on a CUDA device, numpy on the CPU), trained on
    ``device``."""
    from repro_torch.core.gbt import GradientBoostedTreesLearner
    return GradientBoostedTreesLearner(
        label=label, seed=LEARNER_SEED, device=device,
        **hparams).train(data, checkpoint=checkpoint)


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


def oblique_depths(forest) -> np.ndarray:
    """(T, M) float32: the sparse-oblique nodes on the path from the root
    to each node, the node excluded (children follow their parents in the
    SoA, so one pass in node order)."""
    T, M = forest.feature.shape
    out = np.zeros((T, M), np.float32)
    t = np.arange(T)
    for node in range(M):
        lc = forest.left_child[:, node]
        live = lc >= 0
        add = out[t[live], node] + (forest.feature[t[live], node] == -2)
        out[t[live], lc[live]] = add
        out[t[live], lc[live] + 1] = add
    return out


def traversal_bound(forest, X, lay, extra_bytes: int = 0) -> dict:
    """The least time the card could take for one traversal call over the
    node layout ``lay``: bytes (X read once; each node the trees hold read
    once as its 16-byte record, and not the padding of a packed layout;
    each mask of the layout's side table, 32 B, once; each oblique node's
    P (column, weight) pairs, 8 P B, once; when O > 1 each held node's leaf
    row, 4 * O B, once; ``extra_bytes`` of other inputs; one output per
    example and tree written once) over HBM bandwidth, against operations
    over the fp32 peak: one compare per node visit, and per oblique node
    visit P multiplies and P adds (visits counted on this input by
    traversing with each node's depth, and its oblique depth, as its leaf
    value)."""
    import torch
    from repro_torch.core.tree import node_depths
    from repro_torch.kernels.forest_infer import ops, plan
    from repro_torch.kernels.forest_infer.ref import forest_predict_ref
    O = forest.leaf_value.shape[-1]
    n = X.shape[0]
    nodes = int(forest.n_nodes.sum())
    masks = int(lay.mask_start[-1])
    pairs = int(lay.obl_start[-1]) * lay.obl_dims
    node_bytes = plan.RECORD_BYTES + (4 * O if O > 1 else 0)
    nbytes = (X.numel() * X.element_size() + nodes * node_bytes
              + masks * plan.MASK_BYTES + pairs * plan.PAIR_BYTES
              + extra_bytes + n * forest.n_trees * O * 4)
    soa = ops.device_soa(forest, X.device)

    def path_sum(per_node: np.ndarray) -> float:
        leaf = torch.from_numpy(per_node[..., None]).to(X.device)
        return float(forest_predict_ref(
            X, soa.feature, soa.threshold, soa.cat_mask, soa.left_child,
            leaf, depth=forest.depth, **soa.obl).sum())

    visits = path_sum(np.maximum(node_depths(forest), 0).astype(np.float32))
    obl_visits = path_sum(oblique_depths(forest)) if pairs else 0.0
    ops_count = visits + obl_visits * 2 * lay.obl_dims
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, ops_count / PEAK_FP32_S * 1e3
    return {"bytes": nbytes, "nodes_held": nodes, "masks_held": masks,
            "oblique_pairs_held": pairs, "node_visits": visits,
            "oblique_visits": obl_visits, "operations": ops_count,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def kernel_bound(model, X, packed) -> dict:
    """``traversal_bound`` of the tiled kernel: its per-block depths are
    the one input beside X and the nodes."""
    return traversal_bound(model.forest, X, packed.layout,
                           packed.block_depth.numel() * 4)


def time_kernel(model, device) -> dict:
    """B2 at TIMED_SIZES: the wrapper over the cached layout in packed order
    (per call and device), its device time in each plan variant, its
    tree-order store (device), the plain version, the whole
    ``forest_predict(impl="cuda")`` and the bound."""
    import torch
    from repro_torch.kernels.forest_infer import ops
    from repro_torch.kernels.forest_infer.forest_infer import run_tiled
    from repro_torch.kernels.forest_infer.ref import forest_predict_packed_ref
    packed = ops.device_packed(model.forest, device)
    out = {}
    for n in TIMED_SIZES:
        X = torch.from_numpy(encoded_inputs(n, seed=100 + n)).to(device)
        kernel = lambda: run_tiled(X, packed.layout)
        p = traversal_plan(model.forest, X, "tiled", device)
        row = {"kernel_ms": device_ms(kernel),
               "kernel_device_ms": device_only_ms(kernel),
               "variant_device_ms": {
                   v: device_only_ms(lambda: run_tiled(X, packed.layout,
                                                       variant=v))
                   for v in plan_variants(model.forest, X, "tiled", device)},
               "tree_order_device_ms": device_only_ms(
                   lambda: run_tiled(X, packed.layout, tree_order=True)),
               "plain_ms": device_ms(
                   lambda: forest_predict_packed_ref(X, *packed.tables)),
               "kernel_path_ms": device_ms(
                   lambda: ops.forest_predict(model.forest, X, "cuda", device)),
               "plan": {"variant": p.variant, "group": p.group,
                        "blocks": p.blocks, "smem": p.smem}}
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
    """The single-tree kernel over the cached layout (per call and
    device, and device in each plan variant), its plain version, the whole
    ``forest_predict(impl="single")`` and its bound per named (forest, X)
    case."""
    import torch
    from repro_torch.kernels.forest_infer import ops
    from repro_torch.kernels.forest_infer.forest_infer import run_single
    from repro_torch.kernels.forest_infer.ref import forest_predict_ref
    out = {}
    for name, (forest, X) in cases.items():
        soa = ops.device_soa(forest, device)
        Xd = torch.from_numpy(np.ascontiguousarray(X, np.float32)).to(device)
        kernel = lambda: run_single(Xd, soa.layout)
        p = traversal_plan(forest, X, "single", device)
        row = {"kernel_ms": device_ms(kernel),
               "kernel_device_ms": device_only_ms(kernel),
               "variant_device_ms": {
                   v: device_only_ms(lambda: run_single(Xd, soa.layout,
                                                        variant=v))
                   for v in plan_variants(forest, X, "single", device)},
               "plain_ms": device_ms(lambda: forest_predict_ref(
                   Xd, *soa[:5], depth=forest.depth, **soa.obl)),
               "kernel_path_ms": device_ms(lambda: ops.forest_predict(
                   forest, Xd, "single", device)),
               "plan": {"variant": p.variant, "group": p.group,
                        "blocks": p.blocks, "smem": p.smem}}
        row.update(traversal_bound(forest, Xd, soa.layout))
        out[name] = row
    return out


# ------------------------------------------------------- Random Forest, CART

def train_rf(data: dict, device, label: str = "label", checkpoint=None,
             **hparams):
    """The default Random Forest (batched engine, histogram_backend "auto":
    the CUDA histogram kernel on a CUDA device, numpy lockstep blocks on
    the CPU), trained on ``device``."""
    from repro_torch.core.rf import RandomForestLearner
    return RandomForestLearner(
        label=label, seed=LEARNER_SEED, device=device,
        **hparams).train(data, checkpoint=checkpoint)


def train_rf_device(data: dict, device, **hparams):
    """The default Random Forest with the device growth engine."""
    return train_rf(data, device, growth_engine="device", **hparams)


def train_cart(data: dict, device, label: str = "label", checkpoint=None,
               **hparams):
    """The default CART tree, trained on ``device``."""
    from repro_torch.core.cart import CartLearner
    return CartLearner(label=label, seed=LEARNER_SEED, device=device,
                       **hparams).train(data, checkpoint=checkpoint)


def identical(a, b, n_trees: int | None = None) -> bool:
    """Every forest field of the first ``n_trees`` trees (all when None)
    equal, and the depth when all trees are compared."""
    sl = slice(None) if n_trees is None else slice(0, n_trees)
    part = lambda m, k: None if getattr(m.forest, k) is None \
        else getattr(m.forest, k)[sl]
    same = all(np.array_equal(part(a, k), part(b, k)) for k in FOREST_FIELDS)
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


def run_cart(data: dict, device, backend) -> tuple:
    """The default CART tree on the card (histogram kernel, launches ==
    builds, then host pruning), and on COMPARE_ROWS rows the card's tree
    equal to the CPU's on every field. Returns (model, summary)."""
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
    return model, {"rows": len(data["label"]), "seconds": seconds,
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


# ------------------------------------------------ saving and checkpoints

def same_forest(a, b) -> bool:
    """Every Forest field of two forests equal: the arrays, the depth and
    the output dimension."""
    keys = FOREST_FIELDS + ("tree_class", "init_pred")
    return (a.n_trees == b.n_trees and a.depth == b.depth
            and a.out_dim == b.out_dim
            and all(np.array_equal(getattr(a, k), getattr(b, k)) for k in keys))


def dir_bytes(path) -> int:
    return sum(f.stat().st_size for f in Path(path).rglob("*") if f.is_file())


def scratch_dir() -> str:
    """A fresh directory under the checkout's git-ignored ``build/``."""
    (ROOT / "build").mkdir(exist_ok=True)
    return tempfile.mkdtemp(prefix="chip_smoke-", dir=ROOT / "build")


def check_model_io(models: dict, rows: dict, device, scratch: str) -> dict:
    """Save and load each of ``models`` (name -> model trained on the
    card); the loaded model's cuda-engine predictions of ``rows`` equal the
    ones before the save (``array_equal``), as do its evaluate() metrics,
    summary() and variable_importances(); on a Random Forest, the loaded
    forest through the single-tree kernel equals the saved one's and
    ``predict_naive``. The traversal counts are reset just before the
    loaded models predict and read just after."""
    import torch
    from repro_torch.core import Model
    from repro_torch.core.dataspec import BatchEncoder
    from repro_torch.core.tree import predict_naive
    from repro_torch.kernels.forest_infer import forest_infer, ops
    from repro_torch.obs import clock
    out = {}
    loaded = {}
    for name, model in models.items():
        feats = {k: rows[k] for k in model.features}
        before = model.predict(feats, device=device)
        ev = model.evaluate(rows, device=device).metrics
        text, vi = model.summary(), model.variable_importances()
        path = os.path.join(scratch, name)
        t0 = clock.perf()
        model.save(path)
        save_s = clock.perf() - t0
        t0 = clock.perf()
        back = Model.load(path)
        load_s = clock.perf() - t0
        if back._predictors or not same_forest(back.forest, model.forest):
            raise AssertionError(f"{name}: the loaded model differs")
        loaded[name] = (back, feats, before, ev, text, vi)
        out[name] = {"save_s": save_s, "load_s": load_s,
                     "dir_bytes": dir_bytes(path),
                     "files": sorted(os.listdir(path))}
    forest_infer.LAUNCHES = 0            # the loaded models predict from here
    forest_infer.SINGLE_LAUNCHES = 0
    for name, (back, feats, before, ev, text, vi) in loaded.items():
        after = back.predict(feats, device=device)
        if back.predictor(device=device).name != "cuda":
            raise AssertionError(f"{name}: loaded model served by "
                                 f"{back.predictor(device=device).name}")
        if not np.array_equal(before, after):
            raise AssertionError(f"{name}: predictions after the load differ")
        if back.evaluate(rows, device=device).metrics != ev:
            raise AssertionError(f"{name}: evaluate() after the load differs")
        if back.summary() != text or back.variable_importances() != vi:
            raise AssertionError(f"{name}: summary or importances differ")
        if name == "rf":
            X = BatchEncoder(back.spec, back.features).encode(feats)
            got = ops.forest_predict(back.forest, X, "single", device)
            want = ops.forest_predict(models[name].forest, X, "single", device)
            naive = predict_naive(back.forest, X[:NAIVE_ROWS])
            if not (torch.equal(got, want) and np.array_equal(
                    got[:NAIVE_ROWS].cpu().numpy(), naive)):
                raise AssertionError("loaded RF: single-tree traversal differs")
    torch.cuda.synchronize()
    launches = forest_infer.LAUNCHES     # ... and read here
    single = forest_infer.SINGLE_LAUNCHES
    if launches < len(models) or single != 2:
        raise AssertionError(f"loaded models made {launches} tiled and "
                             f"{single} single-tree launches")
    return {"models": out, "rows": len(rows["label"]),
            "tiled_launches": launches, "single_launches": single}


def stop_after(n: int):
    """A ``CheckpointPolicy.cancel`` probe that stops training at its
    ``n``-th poll (one poll per tree, or per block for a Random Forest)."""
    calls = {"n": 0}

    def cancel() -> bool:
        calls["n"] += 1
        return calls["n"] >= n
    return cancel


def stop_and_resume(fit, data: dict, device, scratch: str, name: str,
                    stop_at: int, every: int, **hparams) -> tuple:
    """``fit`` with a checkpoint policy that stops it at ``stop_at`` polls,
    then ``resume_training`` on ``device``. Returns (resumed model, numbers
    of the checkpoints and the resume)."""
    from repro_torch.core import CheckpointPolicy, resume_training
    from repro_torch.obs import clock
    ckdir = os.path.join(scratch, name)
    policy = CheckpointPolicy(ckdir, every_n_trees=every, keep_last=2,
                              cancel=stop_after(stop_at))
    t0 = clock.perf()
    part = fit(data, device, checkpoint=policy, **hparams)
    part_s = clock.perf() - t0
    if not part.training_logs["interrupted"]:
        raise AssertionError(f"{name}: the stop did not interrupt training")
    newest = max(p for p in os.listdir(ckdir) if "." not in p)
    ckpt_bytes = dir_bytes(os.path.join(ckdir, newest))
    t0 = clock.perf()
    resumed = resume_training(ckdir, data, device=device)
    resume_s = clock.perf() - t0
    events = (part.training_logs["resilience"]
              + resumed.training_logs["resilience"])
    saves = [e["save_s"] for e in events if e["event"] == "checkpoint"]
    restore = [e["restore_s"] for e in events if e["event"] == "resume"]
    return resumed, {
        "trees_at_stop": part.forest.n_trees, "trees": resumed.forest.n_trees,
        "interrupted_run_s": part_s, "resume_s": resume_s,
        "restore_s": restore[0], "checkpoints": len(saves),
        "save_s_max": max(saves), "save_s_total": sum(saves),
        "checkpoint_bytes": ckpt_bytes}


def check_checkpoint(data: dict, trained, rf_device, device,
                     scratch: str) -> dict:
    """Stop and resume on the card, each against its uninterrupted card
    run: the device-engine GBT at full width against the train phase's
    ``trained`` (B1), the device-engine RF against ``rf_device`` (B1), and
    at CKPT_ROWS rows the batched GBT (B3) and CART's grown stage (B3). The
    kernels' counts are reset just before each stopped run and read just
    after its resume."""
    from repro_torch.kernels.histogram import fused, histogram
    out = {}
    fused.LAUNCHES = 0                   # the GBT's two runs start here
    gbt, out["gbt_device"] = stop_and_resume(
        train_gbt, data, device, scratch, "gbt_device", CKPT_STOP_AT,
        CKPT_EVERY)
    out["gbt_device"]["launches"] = fused.LAUNCHES   # ... and end here
    if not same_forest(gbt.forest, trained.forest):
        raise AssertionError("resumed device-engine GBT != uninterrupted")
    block = rf_device.training_logs["tree_parallelism"]
    fused.LAUNCHES = 0                   # the RF's two runs start here
    rf, out["rf_device"] = stop_and_resume(
        train_rf_device, data, device, scratch, "rf_device", 1, block,
        num_trees=rf_device.forest.n_trees)
    out["rf_device"]["launches"] = fused.LAUNCHES    # ... and end here
    if out["rf_device"]["trees_at_stop"] != block:
        raise AssertionError(f"RF stopped at {out['rf_device']}")
    if not same_forest(rf.forest, rf_device.forest):
        raise AssertionError("resumed device-engine RF != uninterrupted")
    cut = higgs_like(CKPT_ROWS)
    for name, fit, stop, hparams in (
            ("gbt_batched", train_default, CKPT_TREES // 2,
             dict(num_trees=CKPT_TREES)),
            ("cart", train_cart, 1, {})):
        clean = fit(cut, device, **hparams)
        histogram.LAUNCHES = 0           # the stopped run starts here
        resumed, out[name] = stop_and_resume(
            fit, cut, device, scratch, name, stop, 5, **hparams)
        out[name]["launches"] = histogram.LAUNCHES   # ... resume ends here
        if out[name]["launches"] <= 0:
            raise AssertionError(f"{name}: no histogram kernel launch")
        if not same_forest(resumed.forest, clean.forest):
            raise AssertionError(f"resumed {name} != uninterrupted")
        out[name]["rows"] = CKPT_ROWS
    for name in ("gbt_device", "rf_device", "gbt_batched", "cart"):
        out[name]["equal_to_uninterrupted"] = True
    return out


# ------------------------------------------- sparse-oblique forests (A3)

def oblique_forest(P: int, seed: int, n_trees: int = 3, n_splits: int = 12,
                   n_features: int = OBLIQUE_F, cat_feats=(3,)):
    """A random forest of numerical, categorical and sparse-oblique splits
    (P (column, weight) slots a node; a random number of them live, the rest
    the padding: weight 0 on column 0). Columns may repeat within a node;
    weights span two decades around 1."""
    from repro_torch.core.tree import empty_forest, node_depths
    rng = np.random.default_rng(seed)
    f = empty_forest(n_trees, 2 * n_splits + 1, 1, oblique_dims=P,
                     feature_names=[f"f{j}" for j in range(n_features)])
    num = [j for j in range(n_features) if j not in cat_feats]
    for t in range(n_trees):
        f.leaf_value[t, 0] = rng.normal()
        leaves, count = [0], 1
        for _ in range(n_splits):
            node = leaves.pop(int(rng.integers(len(leaves))))
            kind = int(rng.integers(3))
            if kind == 2:
                live = int(rng.integers(1, P + 1))
                f.feature[t, node] = -2
                f.obl_features[t, node, :live] = rng.integers(0, n_features,
                                                              live)
                f.obl_weights[t, node, :live] = (
                    rng.normal(size=live) * 10.0 ** rng.uniform(-1, 1, live))
                f.threshold[t, node] = rng.normal() * np.sqrt(live)
            elif kind == 1 and cat_feats:
                f.feature[t, node] = int(rng.choice(cat_feats))
                words = rng.integers(0, 2 ** 32, size=8, dtype=np.uint64)
                f.cat_mask[t, node] = words.astype(np.uint32) | np.uint32(1)
            else:
                f.feature[t, node] = int(rng.choice(num))
                f.threshold[t, node] = rng.normal()
            f.left_child[t, node] = count
            f.leaf_value[t, count:count + 2] = rng.normal(size=(2, 1))
            leaves += [count, count + 1]
            count += 2
        f.n_nodes[t] = count
    f.depth = int(max(0, node_depths(f).max()))
    return f


def oblique_rows(n: int, F: int, seed: int, cat_feats=(3,)) -> np.ndarray:
    """(n, F) float32: normal values, codes -5 .. 299 in ``cat_feats``, and
    in every third row OBLIQUE_HOSTILE values (NaN, +-inf, +-1e20) in column
    0 (the padding's column) and in a third of the other columns."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, F)).astype(np.float32)
    for j in cat_feats:
        X[:, j] = rng.integers(-5, 300, n)
    bad = np.array(OBLIQUE_HOSTILE, np.float32)
    for r in range(0, n, 3):
        cols = np.concatenate([[0], np.nonzero(rng.random(F) < 0.33)[0]])
        X[r, cols] = bad[(r // 3 + np.arange(len(cols))) % len(bad)]
    return X


def oblique_zoo() -> dict:
    """(forest, X) cases: a forest for each projection width of
    OBLIQUE_DIMS over hostile rows."""
    return {f"P={P}": (oblique_forest(P, seed=40 + P),
                       oblique_rows(300, OBLIQUE_F, seed=P))
            for P in OBLIQUE_DIMS}


def near_tie(P: int = 28, seed: int = 0):
    """A one-node oblique forest and one row on which ``np.dot`` (the
    reference's ``predict_naive``) and numpy's pairwise sum (its
    ``predict_raw``, and the kernels) differ, the threshold set to the
    larger of the two: the pairwise order and ``np.dot`` send the row to
    different leaves. Searched from ``seed`` on this host's numpy."""
    from repro_torch.core.tree import empty_forest
    rng = np.random.default_rng(seed)
    while True:
        w = rng.normal(size=P).astype(np.float32)
        x = (rng.normal(size=P) * 10).astype(np.float32)
        dot, pw = np.float32(np.dot(w, x)), (w * x).sum()
        if dot != pw:
            break
    f = empty_forest(1, 3, 1, oblique_dims=P,
                     feature_names=[f"f{j}" for j in range(P)])
    f.feature[0, 0], f.left_child[0, 0], f.n_nodes[0] = -2, 1, 3
    f.obl_features[0, 0] = np.arange(P)
    f.obl_weights[0, 0] = w
    f.threshold[0, 0] = max(dot, pw)
    f.leaf_value[0, 1:3, 0] = (-1.0, 1.0)
    f.depth = 1
    return f, x[None]


def naive_divergence(forest, X: np.ndarray, vec: np.ndarray) -> dict:
    """``predict_naive`` (``np.dot`` projections) against the vectorized
    engine's per-tree answers ``vec`` on rows ``X``: the (row, tree) pairs
    that differ and, for the first few, the oblique node where the two sums
    fall on opposite sides of the threshold, with both sums and the
    pairwise sum's margin to the threshold."""
    from repro_torch.core.tree import cat_code, predict_naive
    naive = predict_naive(forest, X)
    rows, trees = np.nonzero((naive != vec).any(-1))
    ties = []
    for n, t in list(zip(rows.tolist(), trees.tolist()))[:8]:
        node = 0
        while forest.left_child[t, node] >= 0:
            f, thr = forest.feature[t, node], forest.threshold[t, node]
            if f == -2:
                w = forest.obl_weights[t, node]
                xs = X[n, forest.obl_features[t, node]]
                dot, pw = np.float32(np.dot(w, xs)), (w * xs).sum()
                if (dot >= thr) != (pw >= thr):
                    ties.append({"row": n, "tree": t, "node": node,
                                 "dot": float(dot), "pairwise": float(pw),
                                 "threshold": float(thr),
                                 "margin": float(pw) - float(thr)})
                    break
                go = pw >= thr
            elif forest.cat_mask[t, node].any():
                code = int(cat_code(X[n, f]))
                go = bool((forest.cat_mask[t, node, code // 32]
                           >> (code % 32)) & 1)
            else:
                go = X[n, f] >= thr
            node = forest.left_child[t, node] + int(go)
    return {"rows": len(X), "pairs_differ": int(len(rows)),
            "near_ties": ties}


def rank1_agreement(a, b) -> dict:
    """Share of equal entries of each structure field and of the oblique
    tables of two forests."""
    return {k: float((getattr(a.forest, k) == getattr(b.forest, k)).mean())
            for k in STRUCT_FIELDS + ("obl_features", "obl_weights")}


def train_rank1(data: dict, device, backend) -> tuple:
    """The benchmark_rank1 GBT (BEST_FIRST_GLOBAL, RANDOM categorical
    splits, sparse-oblique projections) and Random Forest (RANDOM
    categorical, sparse oblique) at ``data``'s full width, cut to
    RANK1_TREES trees, on the card. Each resolves to the batched engine,
    whose every axis-aligned histogram is built by B3 (counts reset just
    before the run, read just after: launches == builds); the projections
    are host numpy. A traced run gives the span seconds and the gain
    scan's share (the projection pass is inside ``grower/gain_scan``).
    Gates at COMPARE_ROWS rows: the RF's card forest equals the CPU's on
    every field and a second card run repeats it (``compare_exact``); the
    GBT agrees with the CPU's ``histogram_backend="torch"`` run on >= 99.5%
    of each field (as ``train_best_first``)."""
    from repro_torch.kernels.histogram import histogram
    from repro_torch.obs import clock, trace
    from repro_torch.obs.export import phase_summary
    models, out = {}, {}
    for name, fit, tree_span in (("gbt", train_default, "gbt/tree"),
                                 ("rf", train_rf, "rf/block")):
        histogram.LAUNCHES = 0           # the training run starts here
        backend.builds = 0
        with trace.capture() as tracer:
            t0 = clock.perf()
            model = fit(data, device, template="benchmark_rank1",
                        num_trees=RANK1_TREES)
            seconds = clock.perf() - t0
        launches, builds = histogram.LAUNCHES, backend.builds  # ... ends here
        logs = model.training_logs
        if (logs["growth_engine"], logs.get("histogram_backend")) != (
                "batched", "cuda"):
            raise AssertionError(f"rank1 {name} trained with "
                                 f"{logs['growth_engine']} / "
                                 f"{logs.get('histogram_backend')}")
        if builds <= 0 or launches != builds:
            raise AssertionError(f"rank1 {name}: {builds} histogram builds "
                                 f"made {launches} kernel launches")
        f = model.forest
        internal = f.left_child >= 0
        n_obl = int(((f.feature == -2) & internal).sum())
        if not n_obl:
            raise AssertionError(f"rank1 {name} grew no oblique node")
        phases = {k: {"count": int(d["count"]), "total_s": d["total_s"]}
                  for k, d in phase_summary(tracer).items()}
        tree_s = phases[tree_span]["total_s"]
        out[name] = {
            "rows": len(data["label"]), "trees": f.n_trees,
            "seconds": seconds, "seconds_per_tree": seconds / f.n_trees,
            "builds": builds, "launches": launches,
            "internal_nodes": int(internal.sum()), "oblique_nodes": n_obl,
            "depth": f.depth, "obl_dims": int(f.obl_weights.shape[-1]),
            "phases": phases,
            "gain_scan_share_of_trees":
                phases["grower/gain_scan"]["total_s"] / tree_s,
            "self_evaluation": {k: v for k, v in
                                model.self_evaluation.metrics.items()
                                if isinstance(v, float)}}
        models[name] = model
    out["rf"]["card_vs_cpu"] = compare_exact(
        train_rf, device, template="benchmark_rank1", num_trees=RANK1_TREES)
    cut = higgs_like(COMPARE_ROWS)
    kw = dict(template="benchmark_rank1", num_trees=RANK1_TREES,
              early_stopping="NONE")
    card = train_default(cut, device, **kw)
    agree = rank1_agreement(card, train_default(cut, "cpu",
                                                histogram_backend="torch",
                                                **kw))
    low = {k: v for k, v in agree.items() if v < 0.995}
    if low:
        raise AssertionError(f"rank1 GBT card vs CPU (plain version) "
                             f"agrees only {low}")
    out["gbt"]["card_vs_cpu_plain"] = {"rows": COMPARE_ROWS, "agree": agree}
    return models, out


def check_oblique(models: dict, rows: dict, device) -> dict:
    """B2 and B4 on sparse-oblique forests in every plan variant
    (``check_variants``: their plain versions bit for bit, the vectorized
    engine bit for bit on every row, ``predict_naive`` reported on the
    first NAIVE_ROWS rows): the hand zoo (P of OBLIQUE_DIMS over hostile
    rows), the near-tie forest, and the trained rank1 forests over the
    validation rows and over hostile rows. On the near tie ``predict_naive``
    must differ from the vectorized engine, and nowhere else."""
    from repro_torch.core.dataspec import BatchEncoder
    cases = {**oblique_zoo(), "near tie": near_tie()}
    for name, m in models.items():
        X = BatchEncoder(m.spec, m.features).encode(
            {k: rows[k] for k in m.features})
        cases[f"{name}, trained"] = (m.forest, X)
        cases[f"{name}, trained, hostile"] = (
            m.forest, oblique_rows(600, X.shape[1], seed=17, cat_feats=()))
    res = check_all_variants(cases, device, ("tiled", "single"))
    differ = {k: r["naive"]["pairs_differ"] for k, r in res["cases"].items()}
    if differ.pop("near tie") != 1:
        raise AssertionError("the near tie did not split np.dot from the "
                             "pairwise sum")
    res["naive_differs_elsewhere"] = {k: v for k, v in differ.items() if v}
    return res


def serve_rank1(models: dict, rows: dict, device, scratch: str) -> dict:
    """The trained rank1 models serve ``rows``: ``compile_predictor`` with
    no engine named (the card's chain: B2, one launch a call) and
    ``forest_predict(impl="single")`` (B4), every answer equal to
    ``finalize`` of the vectorized engine bit for bit (counts reset just
    before, read just after); then the Random Forest saved and loaded
    predicts the same."""
    import torch
    from repro_torch.core import Model
    from repro_torch.core.engines import compile_predictor
    from repro_torch.core.tree import compile_predict_raw
    from repro_torch.kernels.forest_infer import forest_infer, ops
    from repro_torch.obs import clock
    out, served = {}, {}
    forest_infer.LAUNCHES = 0            # serving starts here
    forest_infer.SINGLE_LAUNCHES = 0
    for name, m in models.items():
        feats = {k: rows[k] for k in m.features}
        pred = compile_predictor(m, device=device)
        if pred.name != "cuda":
            raise AssertionError(f"rank1 {name} compiled to {pred.name}")
        t0 = clock.perf()
        got = pred.predict(feats)
        seconds = clock.perf() - t0
        X = pred.encode(feats)
        want = pred.finalize(compile_predict_raw(m.forest)(X))
        single = pred.finalize(ops.forest_predict(
            m.forest, X, "single", device).cpu().numpy())
        if not (np.array_equal(got, want) and np.array_equal(single, want)):
            raise AssertionError(f"rank1 {name}: served answers != "
                                 "finalize(vectorized)")
        served[name] = got
        out[name] = {"rows": len(X), "engine": pred.name, "seconds": seconds}
    torch.cuda.synchronize()
    launches = forest_infer.LAUNCHES     # ... and ends here
    single = forest_infer.SINGLE_LAUNCHES
    if launches != len(models) or single != len(models):
        raise AssertionError(f"{len(models)} models served with {launches} "
                             f"B2 and {single} B4 launches")
    rf = models["rf"]
    path = os.path.join(scratch, "rank1_rf")
    rf.save(path)
    back = Model.load(path)
    if not same_forest(back.forest, rf.forest) or not np.array_equal(
            back.predict({k: rows[k] for k in rf.features}, device=device),
            served["rf"]):
        raise AssertionError("the loaded rank1 RF predicts differently")
    return {**out, "tiled_launches": launches, "single_launches": single,
            "rf_saved_and_loaded": True, "rf_dir_bytes": dir_bytes(path)}


def time_tiled(cases: dict, device) -> dict:
    """B2 over the cached packed layout (per call and device, in packed
    order; its tree-order store and each plan variant, device), its plain
    version, the whole ``forest_predict(impl="cuda")`` and its bound per
    named (forest, X) case."""
    import torch
    from repro_torch.kernels.forest_infer import ops
    from repro_torch.kernels.forest_infer.forest_infer import run_tiled
    from repro_torch.kernels.forest_infer.ref import forest_predict_packed_ref
    out = {}
    for name, (forest, X) in cases.items():
        packed = ops.device_packed(forest, device)
        Xd = torch.from_numpy(np.ascontiguousarray(X, np.float32)).to(device)
        kernel = lambda: run_tiled(Xd, packed.layout)
        p = traversal_plan(forest, X, "tiled", device)
        row = {"kernel_ms": device_ms(kernel),
               "kernel_device_ms": device_only_ms(kernel),
               "variant_device_ms": {
                   v: device_only_ms(lambda: run_tiled(Xd, packed.layout,
                                                       variant=v))
                   for v in plan_variants(forest, X, "tiled", device)},
               "tree_order_device_ms": device_only_ms(
                   lambda: run_tiled(Xd, packed.layout, tree_order=True)),
               "plain_ms": device_ms(lambda: forest_predict_packed_ref(
                   Xd, *packed.tables, **packed.obl)),
               "kernel_path_ms": device_ms(lambda: ops.forest_predict(
                   forest, Xd, "cuda", device)),
               "plan": {"variant": p.variant, "group": p.group,
                        "blocks": p.blocks, "smem": p.smem}}
        row.update(traversal_bound(forest, Xd, packed.layout,
                                   packed.block_depth.numel() * 4))
        out[name] = row
    return out


# ------------------------------------------------- the tasks (ROADMAP A4)

def ranking_data(n_groups: int = RANKING["n_groups"]) -> tuple:
    """grouped_relevance at ``n_groups`` groups, split by group into the
    training groups and the RANKING_HOLDOUT held out (split seed 99)."""
    from repro_torch.data.tabular import grouped_relevance
    from repro_torch.tasks.ranking import group_aware_split
    data = grouped_relevance(n_groups=n_groups, seed=RANKING["seed"])
    gid = np.asarray(data["group"], np.int64)
    tr, te = group_aware_split(gid, RANKING_HOLDOUT, 99)
    return ({k: v[tr] for k, v in data.items()},
            {k: v[te] for k, v in data.items()})


def train_ranking(data: dict, device, **hparams):
    """The default LambdaMART GBT (``GBTHparams()``, task=RANKING: the
    batched engine unless ``growth_engine`` is named), trained on
    ``device``."""
    from repro_torch.core.api import Task
    return train_default(data, device, label="rel", task=Task.RANKING,
                         **hparams)


def train_ranking_device(data: dict, device, **hparams):
    """The default LambdaMART GBT with the device growth engine."""
    return train_ranking(data, device, growth_engine="device", **hparams)


def pairless(data: dict) -> dict:
    """``data`` with every third group's relevance flattened: those rows
    have no pair, so their lambdas are 0 and their hessians the 1e-12
    guard, far below the device engine's fixed-point resolution."""
    gid = np.asarray(data["group"], np.int64)
    rel = np.asarray(data["rel"], np.float64).copy()
    rel[gid % 3 == 0] = 1.0
    return dict(data, rel=rel.astype(object))


def field_equal(a, b) -> dict:
    """Per Forest field of two models: equal or not."""
    return {k: bool(np.array_equal(getattr(a.forest, k), getattr(b.forest, k)))
            for k in FOREST_FIELDS}


def equal_but_gain(card, cpu) -> dict:
    """Two GBTs grown from float gradients on the batched engine, the card's
    (B3) and the CPU's (numpy): every Forest field equal but
    ``split_gain``, which agrees within GAIN_RTOL of each gain. B3 rounds
    an exact sum of values quantized at ~2^-45 of each stat's largest
    |value|, numpy a float64 sum of the values: a few histogram cells
    differ in their last float32 bit, and the gain's cancellation (score of
    the children less the parent's) carries that to ~1e-5 of the gain
    (1.4e-5 when the quantization is emulated on the CPU). Integer stats
    (RF, CART, uplift with a 0/1 outcome) have no such rounding; their
    gains are equal."""
    fields = field_equal(card, cpu)
    a, b = card.forest.split_gain, cpu.forest.split_gain
    diff = np.abs(a.astype(np.float64) - b)
    live = b != 0
    rel = float((diff[live] / np.abs(b[live])).max()) if live.any() else 0.0
    others = {k: v for k, v in fields.items() if k != "split_gain"}
    if not all(others.values()) or not np.allclose(a, b, rtol=GAIN_RTOL,
                                                   atol=0):
        raise AssertionError(f"batched card vs CPU: fields equal {fields}, "
                             f"split_gain max relative diff {rel}")
    return {"fields_equal": fields, "split_gain_differ": int((diff > 0).sum()),
            "split_gains": int(live.sum()), "split_gain_max_rel_diff": rel}


def ranking_gates(device) -> dict:
    """The ranking GBT's gates at RANKING_COMPARE_GROUPS groups and
    RANKING_COMPARE_TREES trees. Batched: the card's forest (B3) equals the
    CPU's numpy-backend forest on every field but ``split_gain``, which
    agrees within GAIN_RTOL (``equal_but_gain``), with equal loss logs.
    Device engine: the card's forest (B1) agrees with the CPU's (the
    kernel's plain version) on >= 99.5% of each structure field, a second
    card run repeats it bit for bit; on data with pairless groups likewise;
    on data whose every group is pairless, each root holds only pairless
    rows and its leaf is the CPU's, 0."""
    train, _ = ranking_data(RANKING_COMPARE_GROUPS)
    kw = dict(num_trees=RANKING_COMPARE_TREES)
    card, cpu = train_ranking(train, device, **kw), train_ranking(train, "cpu",
                                                                  **kw)
    batched = equal_but_gain(card, cpu)
    for key in ("train_loss", "valid_loss"):
        if card.training_logs[key] != cpu.training_logs[key]:
            raise AssertionError(f"ranking batched card vs CPU {key} differ")
    out = {"rows": len(train["rel"]), "trees": RANKING_COMPARE_TREES,
           "batched": batched}
    for name, data in (("device", train), ("device_pairless",
                                           pairless(train))):
        a = train_ranking_device(data, device, **kw)
        b = train_ranking_device(data, device, **kw)
        c = train_ranking_device(data, "cpu", **kw)
        if not identical(a, b):
            raise AssertionError(f"ranking {name}: two card runs differ")
        agree = agreement(a, c)
        low = {k: v for k, v in agree.items() if v < 0.995}
        if low:
            raise AssertionError(f"ranking {name} card vs CPU agrees only "
                                 f"{low}")
        out[name] = {"agree": agree, "card_runs_identical": True,
                     "leaf_max_abs_diff": float(np.abs(
                         a.forest.leaf_value - c.forest.leaf_value).max())}
    # every group flattened: each root holds only pairless rows (g = 0, h
    # the 1e-12 guard), and its leaf is 0 on the card as on the CPU
    flat = dict(train, rel=np.full(len(train["rel"]), 2.0).astype(object))
    a, c = (train_ranking_device(flat, d, num_trees=2, early_stopping="NONE")
            for d in (device, "cpu"))
    if not (identical(a, c) and (a.forest.n_nodes == 1).all()
            and (a.forest.leaf_value == 0).all()):
        raise AssertionError("all-pairless roots: card and CPU leaves differ")
    out["all_pairless_roots"] = {"trees": a.forest.n_trees, "leaf_values": [
        float(v) for v in a.forest.leaf_value[:, 0, 0]]}
    return out


def run_ranking(device, backend, n_groups: int = RANKING["n_groups"]
                ) -> tuple:
    """LambdaMART at ``n_groups`` groups (the default GBT, task=RANKING) on
    the card, on the batched engine (B3: launches == builds) and on the
    device engine (B1: launches == level steps), counts reset just before
    each run and
    read just after; NDCG@5 over the held-out groups against a
    pointwise-regression GBT (the default, batched) on the same split;
    traced 20-tree runs of both engines (the lambda pass is the
    ``gbt/grad_hess`` span); the gates of ``ranking_gates``. Returns
    ({"batched": model, "device": model}, summary)."""
    from repro_torch.core import grower_device
    from repro_torch.core.api import Task
    from repro_torch.core.evaluation import ndcg_at_k
    from repro_torch.kernels.histogram import fused, histogram
    from repro_torch.obs import clock
    on_card = device.type == "cuda"
    train, test = ranking_data(n_groups)
    out = {"rows": len(train["rel"]), "holdout_rows": len(test["rel"]),
           "groups": n_groups}
    histogram.LAUNCHES = 0               # the batched run starts here
    backend.builds = 0
    t0 = clock.perf()
    batched = train_ranking(train, device)
    seconds = clock.perf() - t0
    launches, builds = histogram.LAUNCHES, backend.builds   # ... ends here
    logs = batched.training_logs
    if (logs["growth_engine"], logs.get("histogram_backend")) != (
            "batched", backend.name):
        raise AssertionError(f"ranking GBT trained with {logs}")
    if on_card and (builds <= 0 or launches != builds):
        raise AssertionError(f"ranking: {builds} histogram builds made "
                             f"{launches} kernel launches")
    fused.LAUNCHES = 0                   # the device-engine run starts here
    grower_device.LEVEL_STEPS = 0
    t0 = clock.perf()
    device_model = train_ranking_device(train, device)
    d_seconds = clock.perf() - t0
    d_launches, steps = fused.LAUNCHES, grower_device.LEVEL_STEPS  # ... ends
    dlogs = device_model.training_logs
    if (dlogs["growth_engine"], dlogs["device_impl"]) != (
            "device", "cuda" if on_card else "torch"):
        raise AssertionError(f"ranking GBT trained with {dlogs}")
    if steps <= 0 or on_card and d_launches != steps:
        raise AssertionError(f"ranking: {steps} level steps made "
                             f"{d_launches} split-search launches")
    histogram.LAUNCHES = 0               # the pointwise baseline
    backend.builds = 0
    pointwise = train_default({k: v for k, v in train.items() if k != "group"},
                              device, label="rel", task=Task.REGRESSION)
    p_launches, p_builds = histogram.LAUNCHES, backend.builds
    if on_card and (p_builds <= 0 or p_launches != p_builds):
        raise AssertionError(f"pointwise: {p_builds} builds made "
                             f"{p_launches} launches")
    gid = np.asarray(test["group"], np.int64)
    rel = np.asarray(test["rel"], np.float64)
    ndcg = {}
    for name, m in (("batched", batched), ("device", device_model),
                    ("pointwise_regression", pointwise)):
        scores = np.asarray(m.predict(test, device=device))
        if not np.isfinite(scores).all():
            raise AssertionError(f"ranking: {name} scores are not finite")
        ndcg[name] = ndcg_at_k(rel, scores, gid, 5)
    for name, m, s, n_launch in (("batched", batched, seconds, launches),
                                 ("device", device_model, d_seconds,
                                  d_launches)):
        lg = m.training_logs
        out[name] = {
            "seconds": s, "trees_grown": len(lg["train_loss"]),
            "trees_kept": m.forest.n_trees, "launches": n_launch,
            "valid_ndcg5": m.self_evaluation["ndcg@5"],
            "valid_loss": lg["valid_loss"][m.forest.n_trees - 1]}
    out["batched"]["builds"] = builds
    out["device"]["level_steps"] = steps
    out["pointwise"] = {"builds": p_builds, "launches": p_launches,
                        "trees_kept": pointwise.forest.n_trees}
    out["holdout_ndcg5"] = ndcg
    out["lambdamart_edge"] = ndcg["batched"] - ndcg["pointwise_regression"]
    for name, fit, kernels in (("batched", train_ranking, HIST_KERNELS),
                               ("device", train_ranking_device,
                                FUSED_KERNELS)):
        prof = profile_training(train, device, fit=fit, kernels=kernels)
        ph = prof["phases"]
        lam, trees = ph["gbt/grad_hess"]["total_s"], ph["gbt/tree"]["total_s"]
        prof["grad_hess_share_of_tree_spans"] = lam / trees
        prof["grad_hess_share_of_grad_hess_and_trees"] = lam / (lam + trees)
        out[name]["profile"] = prof
    out["gates"] = ranking_gates(device)
    return {"batched": batched, "device": device_model}, out


def train_uplift(data: dict, device, **hparams):
    """The default uplift forest (``UpliftHparams()``: the batched engine,
    histogram_backend "auto"), trained on ``device``."""
    from repro_torch.tasks import UpliftTreesLearner
    return UpliftTreesLearner(label="outcome", seed=LEARNER_SEED,
                              device=device, **hparams).train(data)


def run_uplift(device, backend, n: int = UPLIFT["n"],
               n_trees: int = UPLIFT_TREES) -> tuple:
    """The default uplift forest cut to ``n_trees`` trees on the card (tree
    by tree, every histogram of the four uplift stats built by B3: launches
    == builds, counts reset just before and read just after), equal to the
    CPU's run (numpy lockstep blocks) on every Forest field; Qini > 0 on
    the training rows; growth_engine="device" raises ``YdfError`` on the
    card too; a traced run of one block. Then the same cut on a numerical
    outcome (``numerical_uplift``): launches == builds; the card's forest
    equals the CPU's run through B3's plain version (float32 cells of
    float64 sums, ``histogram_backend="torch"``) on every field but
    ``split_gain``, which agrees within GAIN_RTOL (``equal_but_gain``), and
    the CPU's numpy run (float64 cells) on every field but ``split_gain``,
    whose largest relative difference is reported: the float32 rounding of
    the cells moves it on the CPU's plain version just as on the card.
    Returns (model, summary)."""
    from repro_torch.core.api import YdfError
    from repro_torch.data.tabular import randomized_treatment
    from repro_torch.kernels.histogram import histogram
    from repro_torch.obs import clock
    data = randomized_treatment(**{**UPLIFT, "n": n})
    histogram.LAUNCHES = 0               # the uplift run starts here
    backend.builds = 0
    t0 = clock.perf()
    model = train_uplift(data, device, num_trees=n_trees)
    seconds = clock.perf() - t0
    launches, builds = histogram.LAUNCHES, backend.builds   # ... ends here
    logs = model.training_logs
    if (logs["growth_engine"], logs.get("histogram_backend")) != (
            "batched", backend.name):
        raise AssertionError(f"uplift forest trained with {logs}")
    if device.type == "cuda" and (builds <= 0 or launches != builds):
        raise AssertionError(f"uplift: {builds} histogram builds made "
                             f"{launches} kernel launches")
    t0 = clock.perf()
    cpu = train_uplift(data, "cpu", num_trees=n_trees)
    cpu_seconds = clock.perf() - t0
    if not identical(model, cpu):
        raise AssertionError(f"uplift card vs CPU forests differ: "
                             f"{field_equal(model, cpu)}")
    ev = model.evaluate(data, device=device)
    if not ev["qini"] > 0.0:
        raise AssertionError(f"uplift Qini {ev['qini']} <= 0")
    try:
        train_uplift(data, device, num_trees=1, growth_engine="device")
    except YdfError as e:
        refused = str(e)
    else:
        raise AssertionError("uplift growth_engine='device' trained")
    f = model.forest
    prof = profile_training(data, device, fit=train_uplift,
                            kernels=HIST_KERNELS,
                            n_trees=logs["tree_parallelism"],
                            tree_span="uplift/block")
    # the numerical outcome: float stats, so B3 rounds its exact sums to
    # float32 where numpy sums in float64 (tasks/uplift.py)
    num_data = numerical_uplift(n)
    histogram.LAUNCHES = 0               # the numerical run starts here
    backend.builds = 0
    t0 = clock.perf()
    num_card = train_uplift(num_data, device, num_trees=n_trees)
    num_seconds = clock.perf() - t0
    num_launches, num_builds = histogram.LAUNCHES, backend.builds  # ends
    if device.type == "cuda" and (num_builds <= 0
                                  or num_launches != num_builds):
        raise AssertionError(f"numerical uplift: {num_builds} histogram "
                             f"builds made {num_launches} kernel launches")
    # held to the CPU's float32-cell run (B3's plain version) under
    # equal_but_gain's rule, and to its float64 run (numpy) on every field
    # but split_gain, whose difference is the cells' float32 rounding
    plain = equal_but_gain(num_card, train_uplift(
        num_data, "cpu", num_trees=n_trees, histogram_backend="torch"))
    cpu_num = train_uplift(num_data, "cpu", num_trees=n_trees)
    numpy_fields = field_equal(num_card, cpu_num)
    if not all(v for k, v in numpy_fields.items() if k != "split_gain"):
        raise AssertionError(f"numerical uplift card vs CPU (numpy): "
                             f"fields equal {numpy_fields}")
    g_card = num_card.forest.split_gain.astype(np.float64)
    g_cpu = cpu_num.forest.split_gain.astype(np.float64)
    live = g_cpu != 0
    numerical = {
        "vs_cpu_plain_version": plain,
        "vs_cpu_numpy": {
            "fields_equal": numpy_fields,
            "split_gain_differ": int((g_card != g_cpu).sum()),
            "split_gains": int(live.sum()),
            "split_gain_max_rel_diff": float(
                (np.abs(g_card - g_cpu)[live] / np.abs(g_cpu[live])).max())
            if live.any() else 0.0}}
    return model, {
        "rows": n, "trees": n_trees,
        "cut": f"{n_trees} of the default 100 trees",
        "seconds": seconds, "seconds_per_tree": seconds / n_trees,
        "cpu_seconds": cpu_seconds, "builds": builds, "launches": launches,
        "card_equals_cpu": True, "nodes_mean": float(f.n_nodes.mean()),
        "depth": f.depth, "qini": ev["qini"], "auuc": ev["auuc"],
        "device_engine_refused": refused, "profile": prof,
        "numerical_outcome": {
            "outcome": (f"outcome * {UPLIFT_SCALE} + N(0, {UPLIFT_NOISE}) "
                        f"(noise seed {UPLIFT_NOISE_SEED})"),
            "seconds": num_seconds, "builds": num_builds,
            "launches": num_launches, **numerical}}


def numerical_uplift(n: int = UPLIFT["n"]) -> dict:
    """randomized_treatment with a NUMERICAL outcome: outcome *
    UPLIFT_SCALE plus N(0, UPLIFT_NOISE) noise from UPLIFT_NOISE_SEED."""
    from repro_torch.data.tabular import randomized_treatment
    data = randomized_treatment(**{**UPLIFT, "n": n})
    rng = np.random.default_rng(UPLIFT_NOISE_SEED)
    y = (np.asarray(data["outcome"], np.float64) * UPLIFT_SCALE
         + rng.normal(0.0, UPLIFT_NOISE, n))
    return dict(data, outcome=y.astype(object))


def run_isolation(device, n_requests: int = 40) -> tuple:
    """The default isolation forest on planted_anomaly (host numpy
    training; no kernel) on ``device`` and on the CPU: equal on every
    Forest field; AUC >= 0.9. Served on the card through
    ``make_forest_server`` (B2): ``n_requests`` requests of 1 to 300 rows,
    each equal to ``finalize(predict_naive(encode(batch)))`` bit for bit,
    and all rows in one dispatch equal to ``finalize`` of the vectorized
    engine; ``forest_predict(impl="single")`` (B4) equal to the tiled
    kernel; counts reset just before, read just after. Returns (model,
    encoded rows, summary)."""
    import torch
    from repro_torch.core.dataspec import BatchEncoder
    from repro_torch.core.tree import compile_predict_raw, predict_naive
    from repro_torch.data.tabular import planted_anomaly
    from repro_torch.kernels.forest_infer import forest_infer, ops
    from repro_torch.obs import clock
    from repro_torch.serving.forest import make_forest_server
    from repro_torch.tasks import IsolationForestLearner
    data = planted_anomaly(**ANOMALY)
    fit = lambda dev: IsolationForestLearner(
        label="anomaly", seed=LEARNER_SEED, device=dev).train(data)
    t0 = clock.perf()
    model = fit(device)
    seconds = clock.perf() - t0
    if not identical(model, fit("cpu")):
        raise AssertionError("isolation forest: card vs CPU training differ")
    f = model.forest
    if (f.n_trees, f.max_nodes) != (100, 513) or not 1 <= f.depth <= 8:
        raise AssertionError(f"isolation forest of {f.n_trees} trees x "
                             f"{f.max_nodes} nodes, depth {f.depth}")
    feats = {k: data[k] for k in model.features}
    X = BatchEncoder(model.spec, model.features).encode(feats)
    finalize = model._compile_finalize()
    forest_infer.LAUNCHES = 0            # serving starts here
    forest_infer.SINGLE_LAUNCHES = 0
    bundle = make_forest_server(model, device=device)
    sizes = request_sizes(n_requests, seed=SEED + 2)
    starts = np.cumsum([0] + sizes[:-1])
    t0 = clock.perf()
    answers = [bundle.predict({k: v[s:s + n] for k, v in feats.items()})
               for s, n in zip(starts, sizes)]
    req_seconds = clock.perf() - t0
    for s, n, got in zip(starts, sizes, answers):
        if not np.array_equal(got, finalize(predict_naive(f, X[s:s + n]))):
            raise AssertionError(f"isolation request at row {s}: served "
                                 "answer != host oracle")
    t0 = clock.perf()
    every = bundle.predict(feats)
    all_seconds = clock.perf() - t0
    if not np.array_equal(every, finalize(compile_predict_raw(f)(X))):
        raise AssertionError("isolation: all rows served != the vectorized "
                             "engine")
    single = ops.forest_predict(f, X, "single", device)
    tiled = ops.forest_predict(f, X, "cuda", device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    if not torch.equal(single, tiled):
        raise AssertionError("isolation: single-tree traversal != tiled")
    launches = forest_infer.LAUNCHES     # ... and ends here
    single_launches = forest_infer.SINGLE_LAUNCHES
    # one B2 launch a dispatch: the warm-up, the requests, all rows at
    # once, and the tiled call beside the single-tree one
    if device.type == "cuda" and (launches != n_requests + 3
                                  or single_launches != 1):
        raise AssertionError(f"isolation serving made {launches} B2 and "
                             f"{single_launches} B4 launches")
    ev = model.evaluate(data, device=device)
    if not ev["auc"] >= 0.9:
        raise AssertionError(f"isolation AUC {ev['auc']} < 0.9")
    return model, X, {
        "rows": len(X), "train_seconds": seconds, "card_equals_cpu": True,
        "trees": f.n_trees, "max_nodes": f.max_nodes, "depth": f.depth,
        "nodes_mean": float(f.n_nodes.mean()), "auc": ev["auc"],
        "requests": n_requests, "request_rows": int(sum(sizes)),
        "requests_seconds": req_seconds, "all_rows_seconds": all_seconds,
        "tiled_launches": launches, "single_launches": single_launches}


def serve_tasks(models: dict, rows: dict, device) -> dict:
    """The trained ranking and uplift models serve TASK_SERVE_ROWS rows
    each through ``make_forest_server`` on ``device`` (B2, one padded
    dispatch after the warm-up), equal to ``model.predict`` on the CPU bit
    for bit."""
    from repro_torch.obs import clock
    from repro_torch.serving.forest import make_forest_server
    out = {}
    for name, m in models.items():
        feats = {k: v[:TASK_SERVE_ROWS] for k, v in rows[name].items()
                 if k in m.features}
        bundle = make_forest_server(m, device=device)
        t0 = clock.perf()
        got = np.asarray(bundle.predict(feats))
        seconds = clock.perf() - t0
        if not np.array_equal(got, m.predict(feats, device="cpu")):
            raise AssertionError(f"{name}: served answers != model.predict "
                                 "on the CPU")
        out[name] = {"rows": len(got), "engine": bundle.predictor.name,
                     "seconds": seconds}
    return out


# ------------------------------------ the bucketed engines (ROADMAP A5)

def _strategies(forest, strategy, device) -> tuple:
    """(bucket depths, strategies) of ``forest``'s bucketed layout with
    ``strategy`` forced, or the device's cost model when None."""
    from repro_torch.core.tree import pack_depth_buckets
    from repro_torch.kernels.forest_infer import ops
    bf = pack_depth_buckets(forest, strategy=strategy,
                            matmul_cheap=ops.MATMUL_CHEAP[device.type])
    return ([b.depth for b in bf.buckets], [b.strategy for b in bf.buckets])


def serve_bucketed(cases: dict, budget_gated: set, oblique_model,
                   device) -> dict:
    """The "bucketed" engine (each bucket's strategy from the device's cost
    model), the "leaf_path" engine (with TF32 matmuls allowed and not) and
    the scan forced on every bucket, over named (forest, X) cases: each
    answer ``array_equal`` to ``predict_naive`` on the first NAIVE_ROWS
    rows and to the cuda engine (B2, tree order; its plain version on the
    CPU) on every row. The cases of ``budget_gated`` must have leaf_path
    refused by LEAF_PATH_BUDGET; any other case's gate is reported. An
    oblique model asked for "bucketed" raises ``YdfError`` naming the
    compatible engines."""
    import torch
    from repro_torch.core import engines
    from repro_torch.core.api import YdfError
    from repro_torch.core.tree import leaf_path_sizes, predict_naive
    from repro_torch.kernels.forest_infer import ops
    out = {}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    try:
        for name, (forest, X) in cases.items():
            X = np.ascontiguousarray(X, np.float32)
            naive = predict_naive(forest, X[:NAIVE_ROWS])
            cuda = ops.forest_predict(forest, X, "cuda", device).cpu().numpy()
            avail = engines.available_engines(device, forest)
            runs = [("bucketed", None), ("scan", "scan")]
            if "leaf_path" in avail:
                runs += [("leaf_path", True), ("leaf_path", False)]
            if name in budget_gated and "leaf_path" in avail:
                raise AssertionError(f"{name}: leaf_path not gated out")
            for engine, how in runs:
                if engine == "scan":
                    got = ops.forest_predict_bucketed(forest, X, "scan",
                                                      device)
                else:
                    if engine == "leaf_path":
                        torch.backends.cuda.matmul.allow_tf32 = how
                    got = engines._compile_forest_engine(
                        forest, engine, device).per_tree(X)
                if not (np.array_equal(got[:NAIVE_ROWS], naive)
                        and np.array_equal(got, cuda)):
                    raise AssertionError(
                        f"{name}: {engine} ({how}) != predict_naive / the "
                        "cuda engine")
            i, l = leaf_path_sizes(forest)
            out[name] = {
                "rows": len(X), "trees": forest.n_trees,
                "max_nodes": forest.max_nodes, "depth": forest.depth,
                "leaf_path_sizes": [i, l],
                "leaf_path": ("equal, allow_tf32 on and off"
                              if "leaf_path" in avail else "refused: budget"),
                **dict(zip(("bucket_depths", "auto"),
                           _strategies(forest, None, device))),
                "strategies": {s: _strategies(forest, s, device)[1]
                               for s in ("scan", "leaf_path")
                               if s == "scan" or "leaf_path" in avail}}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        engines.compile_predictor(oblique_model, "bucketed", device)
    except YdfError as e:
        refused = str(e)
    else:
        raise AssertionError("an oblique model compiled the bucketed engine")
    if "Compatible engines" not in refused:
        raise AssertionError(f"oblique refusal names no engines: {refused}")
    return {"cases": out, "oblique_refused": refused,
            "matmul_cheap": ops.MATMUL_CHEAP[device.type]}


def serve_async(model, device, n_requests: int = 50,
                bulk_rows: int = BULK_ROWS, chunk_rows: int = BULK_CHUNK,
                seed: int = SEED) -> dict:
    """The asyncio front end over a ForestServer with the default chain:
    ``n_requests`` raw-column requests of 1 to 300 rows fanned in with
    ``asyncio.gather`` against a queue cap of ASYNC_CAP_SHARE of their rows,
    which sheds the number the admission rule gives for those sizes (all
    are submitted before the first pump); every answer equals
    ``finalize(predict_naive(encode(batch)))``. Then the same requests
    through a bundle warmed with ``warm_ladder(up_to=1024)``, a bulk sweep
    of ``bulk_rows`` rows through ``predict_encoded_bulk(chunk_rows=...)``
    equal to one direct call, and a ``CompiledPredictor`` on the bucketed
    engine pickled (the bytes a worker process is sent,
    ``ForkingPickler``) and loaded: the same engine, equal answers."""
    import asyncio
    from multiprocessing.reduction import ForkingPickler
    from repro_torch.core.dataspec import BatchEncoder
    from repro_torch.core.engines import compile_predictor
    from repro_torch.core.tree import predict_naive
    from repro_torch.kernels.forest_infer import forest_infer
    from repro_torch.obs import clock
    from repro_torch.serving.forest import DEFAULT_BUCKETS, make_forest_server
    from repro_torch.serving.server import (AsyncForestServer, ForestServer,
                                            RequestShed)
    rng = np.random.default_rng(seed + 3)
    sizes = request_sizes(n_requests, seed + 3)
    requests = [raw_request(rng, n) for n in sizes]
    cap = int(sum(sizes) * ASYNC_CAP_SHARE)
    queued, expected_shed = 0, 0
    for n in sizes:                      # ForestServer.submit's queue rule
        if queued + n > cap:
            expected_shed += 1
        else:
            queued += n
    encoder = BatchEncoder(model.spec, model.features)
    finalize = model._compile_finalize()
    oracle = [finalize(predict_naive(model.forest, encoder.encode(req)))
              for req in requests]
    server = ForestServer(model, device=device, max_queue_rows=cap)

    async def fan_in():
        async with AsyncForestServer(server) as front:
            return await asyncio.gather(*(front.predict(r) for r in requests),
                                        return_exceptions=True)

    before = forest_infer.LAUNCHES
    t0 = clock.perf()
    answers = asyncio.run(fan_in())
    seconds = clock.perf() - t0
    async_launches = forest_infer.LAUNCHES - before
    shed = 0
    for i, (got, want) in enumerate(zip(answers, oracle)):
        if isinstance(got, RequestShed):
            shed += 1
        elif isinstance(got, BaseException):
            raise got
        elif not np.array_equal(got, want):
            raise AssertionError(f"async request {i}: answer != host oracle")
    m = server.metrics
    head = server.engine_status()[0]["engine"]
    if (shed, m.shed, m.completed) != (expected_shed, expected_shed,
                                       n_requests - expected_shed):
        raise AssertionError(f"{shed} shed ({m.shed} counted, {m.completed} "
                             f"completed), expected {expected_shed}")
    if m.engine_dispatches != {head: m.dispatches} or m.failed:
        raise AssertionError(f"async dispatches {m.engine_dispatches}, "
                             f"failed {m.failed}")
    if device.type == "cuda" and (head != "cuda" or async_launches
                                  != m.dispatches):
        raise AssertionError(f"{m.dispatches} {head} dispatches made "
                             f"{async_launches} B2 launches")
    lat = m.latency_percentiles()

    bundle = make_forest_server(model, device=device)
    warmed = bundle.warm_ladder(len(model.features), up_to=1024)
    if warmed != list(DEFAULT_BUCKETS):
        raise AssertionError(f"warm_ladder touched {warmed}")
    t0 = clock.perf()
    warmed_answers = [bundle.predict(req) for req in requests]
    warmed_seconds = clock.perf() - t0
    for i, (got, want) in enumerate(zip(warmed_answers, oracle)):
        if not np.array_equal(got, want):
            raise AssertionError(f"warmed bundle, request {i} != oracle")

    X = encoded_inputs(bulk_rows, seed=77)
    pred = bundle.predictor
    direct = pred.predict_encoded(X)
    calls = []
    call = pred.predict_encoded
    pred.predict_encoded = lambda Z: (calls.append(len(Z)), call(Z))[1]
    try:
        t0 = clock.perf()
        bulk = bundle.predict_encoded_bulk(X, chunk_rows=chunk_rows)
        bulk_seconds = clock.perf() - t0
    finally:
        del pred.predict_encoded
    top = DEFAULT_BUCKETS[-1]
    step = max(top, chunk_rows - chunk_rows % top)
    if not np.array_equal(bulk, direct) or len(calls) != -(-bulk_rows // step):
        raise AssertionError(f"bulk sweep in {calls} != one direct call")

    bucketed = compile_predictor(model, "bucketed", device)
    blob = bytes(ForkingPickler.dumps(bucketed))
    clone = ForkingPickler.loads(blob)
    Xp = encoded_inputs(4096, seed=78)
    got = clone.predict_encoded(Xp)
    if (clone.name, clone.engine.device.type) != ("bucketed", device.type) \
            or not np.array_equal(got, bucketed.predict_encoded(Xp)) \
            or not np.array_equal(got[:NAIVE_ROWS], finalize(predict_naive(
                model.forest, Xp[:NAIVE_ROWS]))):
        raise AssertionError("the pickled bucketed predictor differs")
    return {"requests": n_requests, "request_rows": int(sum(sizes)),
            "max_queue_rows": cap, "expected_shed": expected_shed,
            "shed": shed, "completed": m.completed,
            "dispatches": m.dispatches, "engine_dispatches":
            m.engine_dispatches, "async_launches": async_launches,
            "seconds": seconds, "p50_ms": lat["p50_ms"],
            "p99_ms": lat["p99_ms"], "warmed": warmed,
            "warmed_seconds": warmed_seconds, "bulk_rows": bulk_rows,
            "bulk_dispatches": len(calls), "bulk_seconds": bulk_seconds,
            "pickled_engine": clone.name, "pickled_bytes": len(blob)}


def time_bucketed(cases: dict, device) -> dict:
    """Per named (forest, X) case, from one run: the whole engine call
    (``engine.per_tree``: host rows in, host numpy out; ``device_ms``) of
    the cuda engine and of the bucketed engines ("bucketed": the device's
    cost model; "scan" and "leaf_path" forced; leaf_path only within its
    budget), the bucketed runner's device time over device rows
    (``device_only_ms`` of ``device_call``), and B2's (tree order) and
    B4's device time on the same rows."""
    import torch
    from repro_torch.core import engines
    from repro_torch.kernels.forest_infer import ops
    from repro_torch.kernels.forest_infer.forest_infer import (run_single,
                                                               run_tiled)
    out = {}
    for name, (forest, X) in cases.items():
        X = np.ascontiguousarray(X, np.float32)
        Xd = torch.from_numpy(X).to(device)
        packed = ops.device_packed(forest, device)
        soa = ops.device_soa(forest, device)
        row = {"rows": len(X), "trees": forest.n_trees,
               "cuda_per_tree_ms": device_ms(   # the cuda engine's per_tree
                   lambda: ops.forest_predict(forest, X, "cuda",
                                              device).cpu().numpy()),
               "b2_device_ms": device_only_ms(
                   lambda: run_tiled(Xd, packed.layout, tree_order=True)),
               "b4_device_ms": device_only_ms(
                   lambda: run_single(Xd, soa.layout))}
        avail = engines.available_engines(device, forest)
        for mode, strategy in (("bucketed", None), ("scan", "scan"),
                               ("leaf_path", "leaf_path")):
            if mode == "leaf_path" and mode not in avail:
                row[mode] = "refused: budget"
                continue
            runner = ops.bucketed_runner(forest, strategy, device)
            row[mode] = {
                "per_tree_ms": device_ms(lambda: ops.forest_predict_bucketed(
                    forest, X, strategy, device)),
                "device_ms": device_only_ms(lambda: runner.device_call(Xd)),
                "strategies": [s for s, _, _ in runner.spec],
                "bucket_depths": [d for _, d, _ in runner.spec]}
        out[name] = row
    return out


def time_buckets(forest, sizes, device) -> dict:
    """Per bucket of ``forest``'s layout, the scan's rounds against the
    leaf-path matmul on the same bucket and rows: each block's device time
    (``device_only_ms``) and time per call (``device_ms``) at each N of
    ``sizes`` (rows from ``encoded_inputs``). The card's MATMUL_CHEAP is
    read from these numbers."""
    import torch
    from repro_torch.core.tree import pack_depth_buckets
    from repro_torch.kernels.forest_infer import bucketed
    scan = bucketed.build_bucketed_runner(
        pack_depth_buckets(forest, strategy="scan"), device)
    path = bucketed.build_bucketed_runner(
        pack_depth_buckets(forest, strategy="leaf_path"), device)
    out = {}
    for b, ((_, depth, has_cat), ts, tp) in enumerate(
            zip(scan.spec, scan.tables, path.tables)):
        k, I = tp["feature"].shape
        rows = {}
        for n in sizes:
            X = torch.from_numpy(encoded_inputs(n, seed=200 + n)).to(device)
            Xs = torch.cat([X, X.new_zeros((n, 1))], dim=1)
            Xflat = Xs.reshape(-1)
            F = X.shape[1]
            row = torch.arange(n, dtype=torch.int64, device=device)[:, None] \
                * (F + 1)
            fs = lambda: bucketed._scan_block(Xflat, row, ts, has_cat, depth,
                                              F)
            fp = lambda: bucketed._leaf_path_chunked(Xs, tp, has_cat)
            if not torch.equal(fs(), fp()):
                raise AssertionError(f"bucket {b}: scan != leaf_path")
            r = {"scan_ms": device_ms(fs), "scan_device_ms": device_only_ms(fs),
                 "leaf_path_ms": device_ms(fp),
                 "leaf_path_device_ms": device_only_ms(fp)}
            r["leaf_path_faster"] = r["leaf_path_device_ms"] < r["scan_device_ms"]
            rows[n] = r
        out[f"bucket {b}: depth={depth}, trees={k}, I={I}, "
            f"L={tp['paths'].shape[-1]}"] = rows
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
    from repro_torch.data.tabular import randomized_treatment
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
    cases = traversal_cases()
    gbt_cases = {f"gbt N={n}": (model.forest, encoded_inputs(n, seed=30 + n))
                 for n in (1, MAIN_N, 4096)}
    tiled_variants = check_all_variants({**gbt_cases, **cases}, device,
                                        ("tiled",))
    kern["max_abs_err"] = max(kern["max_abs_err"],
                              tiled_variants["max_abs_err"])
    emit(phase="kernel", **kern, variants=tiled_variants,
         launches=forest_infer.LAUNCHES)

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
    X_valid = BatchEncoder(trained.spec, trained.features).encode(
        {k: valid[k] for k in trained.features})
    emit(phase="serve_trained", **served, launches=trained_launches,
         variants=check_variants(trained.forest, X_valid, device))

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
    rf_device, rf_device_run = run_rf_device(data, device, rf)
    emit(phase="train_rf_device", **rf_device_run)
    cart, cart_run = run_cart(data, device, backend)
    emit(phase="train_cart", **cart_run)
    emit(phase="train_wide", **run_wide(device, backend))

    forest_infer.LAUNCHES = 0            # serving the trained forest
    served_rf = serve_trained(rf, valid, device)
    rf_served_launches = forest_infer.LAUNCHES
    if rf_served_launches <= 0:
        raise AssertionError("serving the trained forest launched no kernel")
    X_rf = BatchEncoder(rf.spec, rf.features).encode(
        {k: valid[k] for k in rf.features})
    emit(phase="serve_rf", **served_rf, launches=rf_served_launches,
         trees=rf.forest.n_trees, max_nodes=rf.forest.max_nodes,
         depth=rf.forest.depth,
         variants=check_variants(rf.forest, X_rf, device))

    scratch = scratch_dir()
    try:
        emit(phase="model_io", card=card, **check_model_io(
            {"gbt": trained, "rf": rf, "cart": cart}, valid, device,
            scratch))
        emit(phase="checkpoint", card=card, **check_checkpoint(
            data, trained, rf_device, device, scratch))

        # sparse-oblique forests: the benchmark_rank1 templates
        rank1, rank1_run = train_rank1(data, device, backend)
        emit(phase="train_rank1", card=card, cut=(
            f"{RANK1_TREES} trees of each template (300 by default); "
            "gates at COMPARE_ROWS rows"), **rank1_run)
        emit(phase="kernel_oblique", **check_oblique(rank1, valid, device))
        rank1_served = serve_rank1(rank1, valid, device, scratch)
        emit(phase="serve_rank1", **rank1_served)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)

    # the tasks (ROADMAP A4): LambdaMART through B3 and B1, uplift trees
    # through B3, the isolation forest and the trained task models served
    # through B2 and B4
    ranking_models, ranking_run = run_ranking(device, backend)
    emit(phase="train_ranking", card=card, **ranking_run)
    uplift, uplift_run = run_uplift(device, backend)
    emit(phase="train_uplift", card=card, **uplift_run)
    isolation, X_iso, iso_run = run_isolation(device)
    emit(phase="train_isolation", card=card, **iso_run,
         variants=check_variants(isolation.forest, X_iso, device))
    forest_infer.LAUNCHES = 0            # serving the task models
    tasks_served = serve_tasks(
        {"ranking": ranking_models["batched"], "uplift": uplift},
        {"ranking": ranking_data()[1],
         "uplift": randomized_treatment(**UPLIFT)}, device)
    tasks_launches = forest_infer.LAUNCHES
    if tasks_launches != 4:
        raise AssertionError(f"two served models made {tasks_launches} B2 "
                             "launches (a warm-up and a dispatch each)")
    emit(phase="serve_tasks", **tasks_served, launches=tasks_launches)

    # the bucketed engines and the async front end (ROADMAP A5)
    uplift_rows = randomized_treatment(**UPLIFT)
    X_uplift = BatchEncoder(uplift.spec, uplift.features).encode(
        {k: uplift_rows[k][:TASK_SERVE_ROWS] for k in uplift.features})
    rank_model = ranking_models["batched"]
    rank_rows = ranking_data()[1]
    X_rank = BatchEncoder(rank_model.spec, rank_model.features).encode(
        {k: rank_rows[k][:TASK_SERVE_ROWS] for k in rank_model.features})
    forest_infer.LAUNCHES = 0            # the bucketed phase starts here
    bucketed_served = serve_bucketed({
        "serving gbt N=4096": (model.forest, encoded_inputs(4096, seed=40)),
        "trained gbt, device engine": (trained.forest, X_valid),
        "trained rf": (rf.forest, X_rf),
        "isolation": (isolation.forest, X_iso),
        "uplift": (uplift.forest, X_uplift),
        "ranking": (rank_model.forest, X_rank),
        **cases}, {"trained rf", f"{BIG_NODES} nodes", "O=3"},
        rank1["gbt"], device)
    bucketed_launches = forest_infer.LAUNCHES   # ... and ends here
    if bucketed_launches <= 0:
        raise AssertionError("the bucketed phase's cuda engine launched "
                             "nothing")
    emit(phase="serve_bucketed", card=card, **bucketed_served,
         launches=bucketed_launches)
    forest_infer.LAUNCHES = 0            # the async phase starts here
    served_async = serve_async(model, device)
    async_launches = forest_infer.LAUNCHES      # ... and ends here
    if async_launches < served_async["async_launches"] or async_launches <= 0:
        raise AssertionError(f"the async phase made {async_launches} B2 "
                             "launches")
    emit(phase="serve_async", card=card, **served_async,
         launches=async_launches)

    # the single-tree kernel's path: forest_predict(impl="single") on the
    # trained forest and on the default GBT
    X_gbt = encoded_inputs(MAIN_N, seed=12)
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
         "gbt, default": (model.forest, encoded_inputs(4096, 13)),
         **single_zoo()}, device)
    single_variants = check_all_variants(
        {"rf, trained": (rf.forest, X_rf), **gbt_cases, **cases}, device,
        ("single",))
    single_check["max_abs_err"] = max(single_check["max_abs_err"],
                                      single_variants["max_abs_err"])
    emit(phase="kernel_single", launches=single_launches, **single_check,
         variants=single_variants)

    timings = time_kernel(model, device)
    fused_t = time_fused(device)
    hist_t = time_hist(device)
    X_rf_all = BatchEncoder(rf.spec, rf.features).encode(
        {k: data[k] for k in rf.features})       # 100,000 rows
    single_t = time_single({
        f"{name} N={n}": ((rf if name == "rf" else model).forest,
                          X_rf_all[:n] if name == "rf"
                          else encoded_inputs(n, 100 + n))
        for name, n in SINGLE_TIMED}, device)
    oblique_cases = {}
    for name, m in rank1.items():
        X_valid_m = BatchEncoder(m.spec, m.features).encode(
            {k: valid[k] for k in m.features})
        oblique_cases[f"rank1 {name} N={len(X_valid_m)}"] = (m.forest,
                                                             X_valid_m)
    tiled_obl = time_tiled(oblique_cases, device)
    single_obl = time_single(oblique_cases, device)
    iso_case = {f"isolation N={len(X_iso)}": (isolation.forest, X_iso)}
    tiled_iso = time_tiled(iso_case, device)
    single_iso = time_single(iso_case, device)
    emit(phase="timings", card=card, **{f"N={n}": row for n, row in timings.items()},
         **{f"fused {k}": row for k, row in fused_t.items()},
         **{f"hist {k}": row for k, row in hist_t.items()},
         **{f"single {k}": row for k, row in single_t.items()},
         **{f"tiled oblique {k}": row for k, row in tiled_obl.items()},
         **{f"single oblique {k}": row for k, row in single_obl.items()},
         **{f"tiled {k}": row for k, row in tiled_iso.items()},
         **{f"single {k}": row for k, row in single_iso.items()},
         server_p50_ms=stats["p50_ms"], server_p99_ms=stats["p99_ms"],
         server_rows_per_s=stats["rows_per_s"])
    from repro_torch.core.engines import benchmark_inference
    emit(phase="timings_bucketed", card=card, engines=time_bucketed({
        **{f"gbt N={n}": (model.forest, encoded_inputs(n, seed=100 + n))
           for n in TIMED_SIZES},
        **{f"rf N={n}": (rf.forest, X_rf_all[:n])
           for n in BUCKETED_RF_TIMED}}, device),
         buckets=time_buckets(model.forest, TIMED_SIZES, device),
         benchmark_inference=benchmark_inference(
             model, raw_request(np.random.default_rng(SEED + 4), 4096),
             repetitions=1, device=device).splitlines())

    main_n = MAIN_N
    t = timings[main_n]
    main_w = FUSED_TIMED[1]           # the widest level of a depth-6 tree
    f = fused_t[main_w[0]]
    main_k = HIST_TIMED[1]            # the widest level of a depth-6 tree
    h = hist_t[main_k[0]]
    main_s = "rf N={}".format(SINGLE_TIMED[2][1])   # the trained forest
    s1 = single_t[main_s]
    main_o = next(k for k in oblique_cases if k.startswith("rank1 rf"))

    def oblique_row(row: dict, launches: int) -> dict:
        """A kernel's numbers on the rank1 Random Forest (serve_rank1)."""
        return {"launches": launches, "ms": row["kernel_ms"],
                "device_ms": row["kernel_device_ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"],
                "shape": (f"{main_o}, T={rank1['rf'].forest.n_trees}, "
                          f"M={rank1['rf'].forest.max_nodes}, "
                          f"P={rank1['rf'].forest.obl_weights.shape[-1]}")}

    main_i = next(iter(iso_case))

    def isolation_row(row: dict, launches: int) -> dict:
        """A kernel's numbers on the isolation forest (train_isolation)."""
        f = isolation.forest
        return {"launches": launches, "ms": row["kernel_ms"],
                "device_ms": row["kernel_device_ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"],
                "shape": (f"{main_i}, T={f.n_trees}, M={f.max_nodes}, "
                          f"depth={f.depth}, O=1")}
    task_hist = {"ranking": ranking_run["batched"]["launches"],
                 "ranking_pointwise": ranking_run["pointwise"]["launches"],
                 "uplift": uplift_run["launches"],
                 "uplift_numerical":
                     uplift_run["numerical_outcome"]["launches"]}
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
        "oblique": oblique_row(tiled_obl[main_o],
                               rank1_served["tiled_launches"]),
        "isolation": isolation_row(tiled_iso[main_i],
                                   iso_run["tiled_launches"]),
        "task_launches": {"isolation": iso_run["tiled_launches"],
                          "ranking_and_uplift_served": tasks_launches,
                          "serve_bucketed": bucketed_launches,
                          "serve_async": async_launches},
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
        "task_launches": {"ranking": ranking_run["device"]["launches"]},
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
        "rank1_launches": {k: v["launches"] for k, v in rank1_run.items()},
        "task_launches": task_hist,
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
        "oblique": oblique_row(single_obl[main_o],
                               rank1_served["single_launches"]),
        "isolation": isolation_row(single_iso[main_i],
                                   iso_run["single_launches"]),
    }]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
