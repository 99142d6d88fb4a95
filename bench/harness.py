"""Runs one cell of ``BENCHMARK.json`` once.

Everything a cell is made of is found by name:

  * the configuration: the ``file`` its entry in ``BENCHMARK.json`` names
    (``bench/configs/<config>.json``);
  * the traffic mix: ``bench/traffic/<traffic>.json``, whose ``generator``
    names the general generator in ``bench/generators/<generator>.py`` and whose
    ``params`` it reads;
  * the limits that decide ``correct``: ``bench/limits/<cell>.json``;
  * each metric, end to end or per layer: ``bench/metrics/<name>.py``,
    whose ``read(rec)`` returns the value or None when the run gives it
    nothing to read.

A generator module has ``setup(run)`` (inputs from the seed, the program's
objects, the warm-up of the cell's shapes), ``window(run, state)`` (the
measured loop), ``facts(run, state, rec)`` (what the per-layer readers
need beyond spans and the trace, taken after a traced window) and
``check(run, state)`` (the numbers compared with the plain reference, once
the program's state is freed).
"""
from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "bench"


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def _module(path: Path):
    name = "bench_" + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def reader(name: str):
    """The reader module of metric ``name``."""
    return _module(BENCH / "metrics" / f"{name}.py")


def generator(name: str):
    """The generator module ``bench/generators/<name>.py``."""
    return importlib.import_module(f"bench.generators.{name}")


@dataclass
class Run:
    """One run of one cell: what the generators read."""
    cell: str
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    params: dict = field(default_factory=dict)


def make_run(bench: dict, cell: str, seed: int, seconds: float, trace: bool,
             device, overrides: dict | None = None) -> Run:
    """The cell's configuration, traffic and limits, by name. ``overrides``
    replaces traffic parameters and configuration keys (the CPU tests run
    cells at small sizes with it)."""
    work = {w["name"]: w for w in bench["workloads"]}[cell]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[work["config"]]
    config = load_json(ROOT / cfg_entry["file"])
    traffic = load_json(BENCH / "traffic" / f"{work['traffic']}.json")
    limits = load_json(BENCH / "limits" / f"{cell}.json")
    over = dict(overrides or {})
    params = {**traffic["params"], **over.pop("params", {})}
    for key, val in over.items():
        config[key] = {**config[key], **val} if isinstance(val, dict) else val
    return Run(cell, config, traffic, limits, seed, seconds, trace,
               torch.device(device), params)


def metrics_of(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics the cell reports: its end-to-end metrics untraced, its
    per-layer metrics traced."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(run: Run, t_start: float, bench: dict | None = None) -> dict:
    """Set-up, window, readings and check of one run; returns the result
    line's fields (``checks`` last)."""
    from repro_torch.obs import trace as obs_trace
    bench = bench or benchmark()
    drv = generator(run.traffic["generator"])
    state = drv.setup(run)
    sync(run.device)
    rec = {"cell": run.cell, "setup_s": time.perf_counter() - t_start,
           "config": run.config}
    if run.trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CUDA] if run.device.type == "cuda" \
            else [ProfilerActivity.CPU]
        with profile(activities=acts) as prof:
            with obs_trace.capture() as tracer:
                rec["epoch_minus_perf"] = time.time() - time.perf_counter()
                rec.update(drv.window(run, state))
            sync(run.device)
        rec.update(read_profile(prof, tracer, rec, run.device))
        rec["spans"] = tracer
    else:
        rec.update(drv.window(run, state))
    rec["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(run.device)
                                if run.device.type == "cuda" else 0)
    if run.trace:
        drv.facts(run, state, rec)
    checks = drv.check(run, state)
    del state
    gc.collect()
    metrics = {}
    for m in metrics_of(bench, run.cell, run.trace):
        value = reader(m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    compared = {name: {"value": float(v), "limit": run.limits[name]}
                for name, v in checks.items()}
    correct = all(c["value"] <= c["limit"] for c in compared.values()) \
        and set(compared) == set(run.limits)
    out = {"correct": correct, "attempted": rec["attempted"],
           "failed": rec["failed"], "metrics": metrics,
           "device": device_info(run, rec)}
    if run.trace and "breakdown" in rec:
        out["breakdown"] = rec["breakdown"]
    out["notes"] = rec.get("notes", {})
    out["checks"] = compared
    return out


def device_info(run: Run, rec: dict) -> dict:
    dev = run.device
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu"),
            "count": 1, "memory_peak_bytes": int(rec["memory_peak_bytes"])}
    if run.trace:
        info["busy_s"] = rec["busy_s"]
        info["window_s"] = rec["window_s"]
    return info


# ------------------------------------------------------------- the trace

def read_profile(prof, tracer, rec: dict, device: torch.device) -> dict:
    """From the profiler's raw device records: seconds and count by kernel
    name, the seconds in which an operation ran on the device (the union
    of the records' intervals), the ten costliest device operations, and
    the idle gaps summed by what the host was doing."""
    ivs, kernels = [], {}
    off = rec["epoch_minus_perf"]                     # epoch s -> perf s
    for e in device_records(prof):
        t0, t1 = e.start_ns() / 1e9 - off, e.end_ns() / 1e9 - off
        ivs.append((t0, t1))
        k = kernels.setdefault(e.name(), [0, 0.0])
        k[0] += 1
        k[1] += t1 - t0
    ivs.sort()
    busy, edge = 0.0, -float("inf")
    for a, b in ivs:
        if b > edge:
            busy += b - max(a, edge)
            edge = b
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]
    return {"kernels": kernels, "busy_s": busy,
            "breakdown": {"device_ops": [[k[:120], v[1]] for k, v in top],
                          "idle_gaps": idle_gaps(ivs, tracer, rec)}}


def device_records(prof) -> list:
    """The profiler's raw records of device operations (kernels, copies,
    sets), read without building its table of averages."""
    return [e for e in prof.profiler.kineto_results.events()
            if "CUDA" in str(e.device_type())]


def idle_gaps(ivs: list, tracer, rec: dict) -> list:
    """Gaps between device operations inside the window, summed by the
    innermost span that holds each gap's middle (``host`` where none):
    one sweep in time order with the stack of open spans."""
    spans = sorted(((s.t0, s.t1, s.name) for r in tracer.roots
                    for s in r.walk()), key=lambda s: (s[0], -s[1]))
    totals: dict[str, float] = {}
    stack: list = []
    i = 0
    edge = rec["window_t0"]
    for t0, t1 in ivs + [(rec["window_t1"], rec["window_t1"])]:
        if t0 > edge:
            mid = (edge + t0) / 2
            while i < len(spans) and spans[i][0] <= mid:
                while stack and stack[-1][1] < spans[i][0]:
                    stack.pop()
                stack.append(spans[i])
                i += 1
            while stack and stack[-1][1] < mid:
                stack.pop()
            name = stack[-1][2] if stack else "host"
            totals[name] = totals.get(name, 0.0) + (t0 - edge)
        edge = max(edge, t1)
    return [[k, v] for k, v in sorted(totals.items(), key=lambda kv: -kv[1])
            [:10]]


FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list[str]:
    """Modules loaded in this process whose top-level name is one of
    ``FORBIDDEN``, compared whole."""
    return sorted(n for n in sys.modules if n.split(".")[0] in FORBIDDEN)
