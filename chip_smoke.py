#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Drives the port's serving path end to end on the card at the full width of
the default Gradient Boosted Trees model (core/hparams.py: 300 trees,
max_depth 6, node capacity 128, binary classification with the Binomial
head) over the feature schema of the Adult-like fixture. The model's
weights are random, made from a numpy seed: trees grown breadth-first to
depths of 3 to 6, thresholds drawn from each column's range, category
masks over each vocabulary. Phases, one JSON line each:

  1. device  — the card (nvidia-smi name and power limit), torch and CUDA.
  2. build   — the kernel built from ``csrc/`` with nvcc.
  3. kernel  — each kernel against its plain PyTorch version on the card,
               at the main path's shapes, hostile values included
               (``torch.equal``), and the full traversal against the numpy
               ``predict_naive`` (``array_equal``).
  4. serve   — a ``ForestServer`` with the default chain answers ~50
               raw-column requests; every answer equals the host oracle
               ``finalize(predict_naive(encode(batch)))``, every dispatch
               went through the kernel engine, and every kernel of the path
               launched (counts reset just before, read just after).
  5. timings — kernel and plain-version times per call (CUDA events around
               each call, median of 20 after warm-up; the wrapper's host-side
               checks fall inside the window), the kernel's own device time
               (torch.profiler), its bound, and the serve phase's latency and
               rows/s (a smoke reading over ~50 requests, server built
               before the clock starts).

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
    """Build the path's one kernel source with nvcc and load it."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.forest_infer import forest_infer
    r = _build.build(forest_infer.SOURCE)
    forest_infer.library()
    return {forest_infer.SOURCE.name: {
        "seconds": r.seconds,
        "ptxas": [ln.strip() for ln in r.log.splitlines()
                  if "registers" in ln or "spill" in ln]}}


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


def profiled_ms(fn, kernel: str, reps: int = 20) -> float | None:
    """Mean device time per launch of the CUDA kernel named ``kernel``, from
    torch.profiler's CUDA activity over ``reps`` calls; None when the
    profiler records no device time for it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us, count = 0.0, 0
    for ev in prof.key_averages():
        if kernel in ev.key:
            total_us += getattr(ev, "device_time_total", 0.0)
            count += ev.count
    return total_us / count / 1e3 if count and total_us else None


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
               "kernel_device_ms": profiled_ms(kernel,
                                               "forest_infer_tiled_kernel"),
               "plain_ms": device_ms(
                   lambda: forest_predict_packed_ref(X, *packed.tables)),
               "kernel_path_ms": device_ms(
                   lambda: ops.forest_predict(model.forest, X, "cuda", device))}
        row.update(kernel_bound(model, X, packed))
        out[n] = row
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
    from repro_torch.kernels.forest_infer import forest_infer
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

    forest_infer.LAUNCHES = 0            # the main path's run starts here
    stats = serve(model, device)
    launches = forest_infer.LAUNCHES     # ... and ends here
    if stats["engine_dispatches"] != {"cuda": stats["dispatches"]}:
        raise AssertionError(f"served through {stats['engine_dispatches']}")
    if launches <= 0:
        raise AssertionError("the served requests launched no kernel")
    emit(phase="serve", **stats, launches=launches)

    timings = time_kernel(model, device)
    emit(phase="timings", card=card, **{f"N={n}": row for n, row in timings.items()},
         server_p50_ms=stats["p50_ms"], server_p99_ms=stats["p99_ms"],
         server_rows_per_s=stats["rows_per_s"])

    main_n = TIMED_SIZES[0]   # the largest dispatch bucket of the server
    t = timings[main_n]
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
    }]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
