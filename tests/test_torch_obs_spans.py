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
    ("engines/encode_objects", "engines/encode"),
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
    # typed path, and the call's one object-path span holds all 6
    assert profile_dict(tr)["metrics"]["counters"] == {
        "engines/d2h_bytes": per_tree.nbytes, "engines/h2d_bytes": X.nbytes}
    assert [s.args for s in tr.find("engines/encode_objects")] == \
        [{"rows": 100, "cols": 6}]


def test_head_is_traced_and_pickles(traced_predict):
    import pickle
    _, pred, rows, out = traced_predict
    back = pickle.loads(pickle.dumps(pred))
    with trace.capture() as tr:
        again = back.predict(rows)
    np.testing.assert_array_equal(again, out)
    assert [s.args["rows"] for s in tr.find("engines/finalize")] == [100]


@pytest.fixture(scope="module")
def mixed():
    """A small rank1-shaped GBT over Adult-width columns (the benchmark's
    maker), a batch of its raw columns (6 int64, 8 object columns of str
    with None) and a HIGGS-width batch of float64 columns."""
    from bench import frozen, frozen_mixed, harness
    from bench.generators import score_mixed
    run = harness.make_run(harness.benchmark(),
                           "gbt_rank1_adult.score_bulk_mixed", 3, 1.0,
                           False, CPU, {"forest": {"trees": 6}})
    model, _, spec = score_mixed.make_model(run)
    rows = frozen_mixed.adult_rows(run.config["data"], 512, 3, 100,
                                   labels=False)
    higgs = frozen.synth_rows({"n_num": 28, "missing_rate": 0.02,
                               "noise": 0.1}, 512, 3, 100, labels=False)
    return model, rows, higgs, spec


def test_object_path_columns_are_counted_and_spanned(mixed):
    model, rows, _, _ = mixed
    pred = model.predictor(None, CPU)
    with trace.capture() as tr:
        for _ in range(2):
            pred.encode(rows)
    spans = tr.find("engines/encode_objects")
    assert [s.args for s in spans] == [{"rows": 512, "cols": 8}] * 2
    assert_nested(tr, "engines/encode_objects", "engines/encode")


def test_typed_batch_counts_no_object_column_and_opens_no_span(mixed):
    from repro_torch.core.dataspec import BatchEncoder, infer_dataspec
    _, _, higgs, _ = mixed
    enc = BatchEncoder(infer_dataspec(higgs), list(higgs))
    with trace.capture() as tr:
        enc.encode(higgs)
    assert not tr.find("engines/encode_objects")
    assert len(tr.metrics) == 0                # the encoder counts nothing


def test_object_path_span_leaves_the_bits_as_they_were(mixed):
    from bench import frozen_mixed, reference_mixed
    model, rows, _, spec = mixed
    pred = model.predictor(None, CPU)
    plain = pred.encode(rows)
    with trace.capture():
        traced = pred.encode(rows)
    np.testing.assert_array_equal(traced.view(np.uint32),
                                  plain.view(np.uint32))
    want, _ = reference_mixed.encode(rows, spec, model.features, CPU)
    np.testing.assert_array_equal(plain.view(np.uint32),
                                  want.numpy().view(np.uint32))


def test_traverse_names_its_plan(mixed):
    from repro_torch.core import engines
    from repro_torch.kernels.forest_infer import forest_infer, ops
    model, rows, _, _ = mixed
    X = model.predictor(None, CPU).encode(rows)
    dev = torch.device(CPU)
    with trace.capture() as tr:
        engines._traverse(model.forest, X, "cuda", dev)
        engines._traverse(model.forest, X, "ref", dev)
    lay = ops.device_packed(model.forest, dev).layout
    want = forest_infer.plan_of(lay, len(X)).variant
    a, b = tr.find("engines/traverse")
    assert a.args == {"rows": 512, "variant": want, "obl_width": 6}
    assert b.args == {"rows": 512}     # the reference walk runs no plan
    with trace.capture() as tr:     # an axis-aligned forest holds no pairs
        engines._traverse(_axis_forest(), X[:, :2].copy(), "cuda", dev)
    assert tr.find("engines/traverse")[0].args["obl_width"] == 0


def _axis_forest():
    from repro_torch.core.tree import empty_forest
    f = empty_forest(2, 3, 1)
    f.feature[:, 0], f.left_child[:, 0], f.n_nodes[:] = 1, 1, 3
    f.leaf_value[:, 1:, 0] = [-1.0, 1.0]
    f.depth = 1
    return f


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


def test_annotate_writes_the_innermost_open_span_only():
    trace.annotate(lost=1)                  # untraced: nothing to write
    with trace.capture() as tr:
        trace.annotate(lost=2)              # no span open: dropped
        with trace.span("a/outer", rows=3):
            with trace.span("a/inner"):
                trace.annotate(variant="staged")
            trace.annotate(width=6)
    outer, inner = tr.find("a/outer")[0], tr.find("a/inner")[0]
    assert outer.args == {"rows": 3, "width": 6}
    assert inner.args == {"variant": "staged"}


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
