"""The port's trace exporters (``repro_torch.obs.export``) against the JAX
package's (``repro.obs.export``), on the scenarios of
``tests/test_obs.py``'s exporter tests.

The same spans and events, recorded by each package's tracer on a fake
clock, export to equal Chrome trace-event documents, phase summaries and
profile payloads (tolerance: none, the clock is virtual). The validator
accepts what either exporter writes and rejects the same malformed
documents with the reference's messages. A traced port training run and a
traced prediction export valid traces with their spans.
"""
from __future__ import annotations

import json

import pytest

from repro.obs import trace as ref_trace
from repro.obs.export import chrome_trace as ref_chrome_trace
from repro.obs.export import phase_summary as ref_phase_summary
from repro.obs.export import profile_dict as ref_profile_dict
from repro.obs.export import validate_chrome_trace as ref_validate
from repro.serving.faults import FakeClock as RefFakeClock
from repro_torch.obs import trace
from repro_torch.obs.export import (
    chrome_trace,
    phase_summary,
    profile_dict,
    validate_chrome_trace,
    write_chrome_trace,
)
from repro_torch.serving.faults import FakeClock


def _sample(trace_mod, clock_cls):
    """The reference test's sample: a span with a child, and an event."""
    ck = clock_cls()
    with trace_mod.capture(clock=ck.now) as tr:
        with trace_mod.span("gbt/tree", tree=0):
            ck.advance(0.5)
            with trace_mod.span("grower/gain_scan", level=1):
                ck.advance(0.25)
        trace_mod.event("checkpoint/rollback", tree=5)
    return tr


def _threaded(trace_mod, clock_cls):
    """Spans on two threads and numpy-typed args."""
    import threading

    import numpy as np
    ck = clock_cls(start=10.0)
    with trace_mod.capture(clock=ck.now) as tr:
        with trace_mod.span("rf/block", trees=np.int64(8), share=np.float32(0.5)):
            ck.advance(1.0)

        def worker():
            with trace_mod.span("engines/dispatch", engine="ref", rows=3):
                ck.advance(0.125)
        t = threading.Thread(target=worker, name="w1")
        t.start()
        t.join()
        trace_mod.event("server/shed", rows=np.int32(4))
    return tr


@pytest.mark.parametrize("make", [_sample, _threaded],
                         ids=["sample", "threaded"])
def test_exports_equal_reference(make):
    tr, ref = make(trace, FakeClock), make(ref_trace, RefFakeClock)
    doc = chrome_trace(tr)
    validate_chrome_trace(doc)
    ref_validate(doc)
    json.dumps(doc)
    want = ref_chrome_trace(ref)
    # thread lanes are named by thread, whose names differ run to run only
    # in the worker's ident; compare everything but the lane names
    strip = lambda d: [{k: v for k, v in e.items() if e["ph"] != "M"
                        or k != "args"} for e in d["traceEvents"]]
    assert strip(doc) == strip(want)
    assert doc["displayTimeUnit"] == want["displayTimeUnit"]
    assert phase_summary(tr) == ref_phase_summary(ref)
    assert profile_dict(tr) == ref_profile_dict(ref)
    assert chrome_trace(tr, pid=7)["traceEvents"][0]["pid"] == 7


def test_chrome_trace_valid_and_normalized():
    tr = _sample(trace, FakeClock)
    doc = chrome_trace(tr)
    xs = {e["name"]: e for e in doc["traceEvents"] if e["ph"] == "X"}
    assert xs["gbt/tree"]["ts"] == 0.0
    assert xs["gbt/tree"]["dur"] == pytest.approx(0.75e6)
    assert xs["grower/gain_scan"]["cat"] == "grower"
    assert xs["grower/gain_scan"]["ts"] == pytest.approx(0.5e6)
    insts = [e for e in doc["traceEvents"] if e["ph"] == "i"]
    assert insts[0]["name"] == "checkpoint/rollback"
    metas = [e for e in doc["traceEvents"] if e["ph"] == "M"]
    assert metas and metas[0]["args"]["name"]
    # a span list exports like its tracer, without the events
    from_roots = chrome_trace(tr.roots)
    assert [e for e in from_roots["traceEvents"] if e["ph"] == "X"] == \
        [e for e in doc["traceEvents"] if e["ph"] == "X"]


BAD = [
    {"nope": []},
    [],
    {"traceEvents": [{"ph": "X"}]},
    {"traceEvents": [{"name": "a", "ph": "X", "ts": 0, "dur": 1, "pid": 1}]},
    {"traceEvents": [{"name": "a", "ph": "X", "ts": 0, "dur": -1, "pid": 1,
                      "tid": 1}]},
    {"traceEvents": [{"name": "a", "ph": "X", "ts": -2, "dur": 1, "pid": 1,
                      "tid": 1}]},
    {"traceEvents": [{"name": "a", "ph": "i"}]},
    {"traceEvents": ["x"]},
]


@pytest.mark.parametrize("doc", BAD, ids=[str(i) for i in range(len(BAD))])
def test_validator_rejects_as_the_reference(doc):
    with pytest.raises(ValueError) as ref_err:
        ref_validate(doc)
    with pytest.raises(ValueError) as err:
        validate_chrome_trace(doc)
    assert str(err.value) == str(ref_err.value)


def test_write_chrome_trace_and_a_traced_port_run(tmp_path):
    from repro_torch.core import GradientBoostedTreesLearner
    from repro_torch.data.tabular import adult_like
    data = adult_like(300, seed=3)
    with trace.capture() as tr:
        model = GradientBoostedTreesLearner(label="income", num_trees=3,
                                            device="cpu").train(data)
        model.predict(data, device="cpu")
    path = tmp_path / "trace.json"
    write_chrome_trace(str(path), tr)
    doc = json.loads(path.read_text())
    validate_chrome_trace(doc)
    names = {e["name"] for e in doc["traceEvents"] if e["ph"] == "X"}
    assert {"grower/binning", "grower/hist_build", "grower/gain_scan",
            "engines/compile", "engines/dispatch"} <= names
