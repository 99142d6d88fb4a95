"""The port's spans and counters at its layer boundaries, and the tracer's
clock anchor.

A traced CPU training (the device growth engine on ``device="cpu"``) and a
traced prediction emit every span of the layer table with its nesting; the
bytes counters equal what crosses to and from the device; the server's
queue wait, on a ``FakeClock``, equals the ticks between submit and pump.
``trace.count``/``trace.observe`` do nothing with no tracer active. A
``record_function`` region run inside a span, carried to the tracer's
clock with ``Tracer.epoch_offset_s``, lies inside the span within 1 ms;
the twin marked ``cuda`` does the same with a kernel on the card, and the
CLI's ``profile`` verb there puts the device's operations on a lane of
their own.

Imports neither ``jax`` nor ``repro``.
"""
from __future__ import annotations

import json
import time

import numpy as np
import pytest
import torch

from repro_torch.core import GradientBoostedTreesLearner
from repro_torch.data.tabular import adult_like
from repro_torch.obs import trace
from repro_torch.obs.export import (chrome_trace, device_ops, profile_dict,
                                    validate_chrome_trace)
from repro_torch.serving.faults import FakeClock
from repro_torch.serving.server import ForestServer

CPU = "cpu"
LEVEL_PHASES = ("candidates", "split_search", "allocate", "write", "route",
                "child_stats")


@pytest.fixture(scope="module")
def data():
    return adult_like(300, seed=5)


@pytest.fixture(scope="module")
def traced_training(data):
    with trace.capture() as tr:
        model = GradientBoostedTreesLearner(
            label="income", num_trees=3, max_depth=3, early_stopping="NONE",
            growth_engine="device", device=CPU).train(data)
    return tr, model


@pytest.fixture(scope="module")
def traced_predict(traced_training, data):
    _, model = traced_training
    rows = {k: v[:100] for k, v in data.items() if k != "income"}
    pred = model.predictor(None, CPU)
    pred.predict(rows)                         # compiled outside the trace
    with trace.capture() as tr:
        out = pred.predict(rows)
    return tr, pred, rows, out


def parents(tr):
    """span id -> the name of its parent span (None for a root)."""
    up = {}
    for root in tr.roots:
        up[id(root)] = None
        for sp in root.walk():
            for c in sp.children:
                up[id(c)] = sp.name
    return up


def assert_nested(tr, child, parent):
    found = tr.find(child)
    assert found, f"no {child} span"
    up = parents(tr)
    assert all(up[id(s)] == parent for s in found), \
        {up[id(s)] for s in found}


TRAIN_NESTING = [
    ("grower/binning", "models/prepare"),
    ("models/dataspec", "models/prepare"),
    *[(f"grower_device/{p}", "grower_device/level_step")
      for p in LEVEL_PHASES],
    ("grower_device/setup", "gbt/tree"),
    ("grower_device/decode", "gbt/tree"),
]


@pytest.mark.parametrize("child,parent", TRAIN_NESTING,
                         ids=[c for c, _ in TRAIN_NESTING])
def test_training_spans_nest(traced_training, child, parent):
    assert_nested(traced_training[0], child, parent)


def test_boosting_loop_spans_once_a_tree(traced_training):
    tr, model = traced_training
    trees = model.forest.n_trees
    for name in ("gbt/grad_hess", "gbt/stats", "gbt/update", "gbt/loss",
                 "gbt/tree"):
        assert len(tr.find(name)) == trees, name
    assert len(tr.find("models/prepare")) == 1
    # each level step holds its six phases, once each
    for step in tr.find("grower_device/level_step"):
        names = [c.name for c in step.children]
        assert names == [f"grower_device/{p}" for p in LEVEL_PHASES]


PREDICT_NESTING = [
    ("engines/traverse", "engines/dispatch"),
    ("engines/copy_back", "engines/dispatch"),
    ("engines/encode", None),
    ("engines/dispatch", None),
    ("engines/finalize", None),
]


@pytest.mark.parametrize("child,parent", PREDICT_NESTING,
                         ids=[c for c, _ in PREDICT_NESTING])
def test_predict_spans_nest(traced_predict, child, parent):
    tr = traced_predict[0]
    assert_nested(tr, child, parent)
    assert all(s.args["rows"] == 100 for s in tr.find(child))


def test_bytes_counters_equal_what_crosses(traced_predict):
    tr, pred, rows, _ = traced_predict
    X = pred.encode(rows)
    per_tree = pred.engine.per_tree(X)
    m = tr.metrics
    assert m.counter("engines/h2d_bytes").value == X.nbytes
    assert m.counter("engines/d2h_bytes").value == per_tree.nbytes
    # adult_like's columns are object arrays: none takes the encoder's
    # typed path, and the call counts 0 typed columns
    assert profile_dict(tr)["metrics"]["counters"] == {
        "engines/d2h_bytes": per_tree.nbytes, "engines/h2d_bytes": X.nbytes,
        "engines/encode_typed_cols": 0}


def test_head_is_traced_and_pickles(traced_predict):
    import pickle
    _, pred, rows, out = traced_predict
    back = pickle.loads(pickle.dumps(pred))
    with trace.capture() as tr:
        again = back.predict(rows)
    np.testing.assert_array_equal(again, out)
    assert [s.args["rows"] for s in tr.find("engines/finalize")] == [100]


def test_count_and_observe_do_nothing_untraced():
    with trace.capture() as tr:
        trace.count("x/n", 3)
        trace.observe("x/s", 0.5)
    assert trace.active() is None
    trace.count("x/n", 4)
    trace.observe("x/s", 1.0)
    trace.count("y/n")
    assert len(tr.metrics) == 2
    assert tr.metrics.counter("x/n").value == 3
    h = tr.metrics.histogram("x/s")
    assert (h.count, h.total) == (1, 0.5)
    # a tracer that counted nothing exports no metrics key
    with trace.capture() as quiet:
        with trace.span("a/b"):
            pass
    assert "metrics" not in profile_dict(quiet)
    assert "metrics" in profile_dict(tr)


@pytest.fixture
def server(traced_training):
    _, model = traced_training
    clock = FakeClock()
    srv = ForestServer(model, device=CPU, clock=clock.now, sleep=clock.sleep)
    return srv, clock


def test_submit_holds_encode_and_dispatch_is_traced(server, data):
    srv, clock = server
    req = {k: v[:7] for k, v in data.items() if k != "income"}
    with trace.capture() as tr:
        tickets = [srv.submit(req, pump=False) for _ in range(3)]
        srv.pump()
    assert_nested(tr, "engines/encode", "server/submit")
    subs = tr.find("server/submit")
    assert [s.args for s in subs] == [{"rows": 7, "ticket": t}
                                      for t in tickets]
    (disp,) = tr.find("server/dispatch")
    assert disp.args == {"rows": 21, "requests": 3,
                         "first": tickets[0], "last": tickets[-1]}
    assert_nested(tr, "engines/dispatch", "server/dispatch")


def test_queue_wait_is_the_ticks_between_submit_and_pump(server, data):
    srv, clock = server
    req = {k: v[:5] for k, v in data.items() if k != "income"}
    with trace.capture() as tr:
        srv.submit(req, pump=False)         # waits 0.25 + 0.5
        clock.advance(0.25)
        srv.submit(req, pump=False)         # waits 0.5
        clock.advance(0.5)
        srv.pump()
        srv.submit(req, pump=False)         # waits 0.125
        clock.advance(0.125)
        srv.pump()
    h = tr.metrics.histogram("server/queue_wait_s")
    assert h.count == 3
    assert sorted(h.values) == [0.125, 0.5, 0.75]
    assert h.total == pytest.approx(1.375)
    # untraced, nothing is observed and the server serves as before
    srv.submit(req, pump=False)
    clock.advance(1.0)
    srv.pump()
    assert h.count == 3


def test_chrome_trace_carries_the_epoch_offset():
    before = time.time() - time.perf_counter()
    with trace.capture() as tr:
        with trace.span("a/b"):
            pass
    after = time.time() - time.perf_counter()
    doc = chrome_trace(tr)
    validate_chrome_trace(doc)
    other = doc["otherData"]
    assert other["origin_s"] == tr.roots[0].t0
    lo, hi = sorted((before, after))
    assert lo - 1e-3 <= other["epoch_offset_s"] <= hi + 1e-3
    assert abs(other["epoch_drift_s"]) < 1e-3
    # a list of spans has no tracer, so no offset
    assert "otherData" not in chrome_trace(tr.roots)


def _raw(prof, name):
    return [e for e in prof.profiler.kineto_results.events()
            if e.name() == name]


def test_profiler_region_lies_inside_its_span():
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.capture() as tr:
            with trace.span("anchor/outer"):
                time.sleep(0.005)
                with record_function("anchor_region"):
                    time.sleep(0.02)
                time.sleep(0.005)
    (sp,) = tr.find("anchor/outer")
    (ev,) = _raw(prof, "anchor_region")
    off = tr.epoch_offset_s
    t0, t1 = ev.start_ns() / 1e9 - off, ev.end_ns() / 1e9 - off
    assert sp.t0 - 1e-3 <= t0 < t1 <= sp.t1 + 1e-3
    assert t1 - t0 >= 0.019


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernel_lies_inside_its_span_on_the_card(card):
    from torch.profiler import ProfilerActivity, profile
    torch.cuda._sleep(1000)                       # load the module first
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with trace.capture() as tr:
            with trace.span("anchor/outer"):
                time.sleep(0.005)
                torch.cuda._sleep(20_000_000)     # ~10 ms at ~2 GHz
                torch.cuda.synchronize()
                time.sleep(0.005)
    (sp,) = tr.find("anchor/outer")
    ops = device_ops(prof, tr)
    assert ops
    _, t0, t1 = max(ops, key=lambda op: op[2] - op[1])   # the spin kernel
    assert sp.t0 - 1e-3 <= t0 < t1 <= sp.t1 + 1e-3
    assert t1 - t0 > 1e-3


@pytest.mark.cuda
def test_cli_profile_puts_device_operations_on_a_lane(card, tmp_path,
                                                      capsys):
    import csv

    from repro_torch.cli import main
    rows = adult_like(400, seed=9)
    path = tmp_path / "train.csv"
    cols = list(rows)
    with open(path, "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(cols)
        for i in range(len(rows[cols[0]])):
            w.writerow(["" if rows[c][i] is None else rows[c][i]
                        for c in cols])
    out = tmp_path / "trace.json"
    main(["profile", "train", f"--dataset=csv:{path}", "--label=income",
          f"--trace={out}", "--hparam", "num_trees=3", "--hparam",
          "growth_engine=device", "--device=cuda"])
    assert "device operations" in capsys.readouterr().out
    doc = json.loads(out.read_text())
    validate_chrome_trace(doc)
    lanes = {e["tid"]: e["args"]["name"] for e in doc["traceEvents"]
             if e["ph"] == "M"}
    dev = [e for e in doc["traceEvents"]
           if e["ph"] == "X" and lanes[e["tid"]] == "device"]
    steps = [e for e in doc["traceEvents"]
             if e["name"] == "grower_device/level_step"]
    assert dev and steps and "otherData" in doc
    # the level steps sync while tracing, so each holds device work
    # that starts inside it
    ends = [(s["ts"], s["ts"] + s["dur"]) for s in steps]
    inside = sum(any(a - 1e3 <= e["ts"] <= b for a, b in ends) for e in dev)
    assert inside >= len(steps)
