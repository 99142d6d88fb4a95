"""Serving through the port against the JAX package, and the port's device
rule.

Models trained by the JAX package on ``adult_like`` (GBT binary, GBT
multiclass, RF classification, RF regression) are carried across as plain
arrays with ``repro_torch.convert.model_from_arrays`` and served by the
port on ``device="cpu"`` through ``CompiledPredictor``, ``MicroBatcher``
and ``ForestServer``. Tolerance: none (``atol=0``): every engine selects
the same leaves and the heads are the same numpy code.

Without a card every entry point raises unless given ``device="cpu"``, and
the kernel path never swaps in its plain version for a CUDA request.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.core import GradientBoostedTreesLearner, RandomForestLearner, Task
from repro.core.dataspec import spec_to_dict
from repro.data.tabular import adult_like
from repro_torch import convert
from repro_torch.core import engines
from repro_torch.core.api import EngineFailure, YdfError
from repro_torch.core.engines import compile_predictor
from repro_torch.kernels.forest_infer import forest_infer, ops
from repro_torch.serving.faults import FakeClock, FaultPlan
from repro_torch.serving.forest import MicroBatcher, make_forest_server
from repro_torch.serving.server import ForestServer

CPU = "cpu"
MODELS = ("gbt_binary", "gbt_multiclass", "rf_classification",
          "rf_regression")
FIELDS = ("feature", "threshold", "cat_mask", "left_child", "leaf_value",
          "n_nodes", "depth", "tree_class", "init_pred", "out_dim")


@pytest.fixture(scope="module")
def data():
    return adult_like(300, seed=11)


@pytest.fixture(scope="module")
def trained(data):
    """name -> (reference model, port model, reference predictions)."""
    ref = {
        "gbt_binary": GradientBoostedTreesLearner(
            label="income", num_trees=12).train(data),
        "gbt_multiclass": GradientBoostedTreesLearner(
            label="education", num_trees=3).train(data),
        "rf_classification": RandomForestLearner(
            label="income", num_trees=4).train(data),
        "rf_regression": RandomForestLearner(
            label="age", task=Task.REGRESSION, num_trees=4).train(data),
    }
    return {name: (m, to_port(m), m.predict(data)) for name, m in ref.items()}


def to_port(model):
    """A reference model carried across as arrays, spec dict and names."""
    kind = "gbt" if hasattr(model, "loss") else "rf"
    return convert.model_from_arrays(
        kind, {k: getattr(model.forest, k) for k in FIELDS},
        spec_to_dict(model.spec), model.features, task=model.task.value,
        classes=model.classes,
        loss=model.loss.name if kind == "gbt" else None,
        winner_take_all=getattr(model, "winner_take_all", True))


def requests(data, sizes=(1, 17, 40, 2, 90, 33, 117)):
    out, row = [], 0
    for n in sizes:
        out.append({k: v[row:row + n] for k, v in data.items()})
        row += n
    return out, row


# ------------------------------------------------------------ parity

@pytest.mark.parametrize("engine", ["ref", "vectorized", "naive"])
@pytest.mark.parametrize("name", MODELS)
def test_compiled_predictor_matches_reference(trained, data, name, engine):
    _, pm, want = trained[name]
    pred = compile_predictor(pm, engine, device=CPU)
    assert pred.name == engine
    got = pred.predict(data)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("name", MODELS)
def test_model_predict_defaults_to_the_chain_head(trained, data, name):
    _, pm, want = trained[name]
    assert pm.predictor(device=CPU).name == "ref"
    np.testing.assert_allclose(pm.predict(data, device=CPU), want,
                               rtol=0, atol=0)


@pytest.mark.parametrize("name", MODELS)
def test_micro_batcher_matches_reference(trained, data, name):
    _, pm, want = trained[name]
    batcher = MicroBatcher(make_forest_server(pm, device=CPU), max_batch=64)
    reqs, n = requests(data)
    tickets = [batcher.submit(r) for r in reqs]
    got = np.concatenate([batcher.result(t) for t in tickets])
    np.testing.assert_allclose(got, want[:n], rtol=0, atol=0)
    assert batcher.dispatches >= 2 and batcher.rows_dispatched == n


@pytest.mark.parametrize("name", MODELS)
def test_forest_server_matches_reference(trained, data, name):
    _, pm, want = trained[name]
    clock = FakeClock()
    server = ForestServer(pm, device=CPU, clock=clock.now, sleep=clock.sleep,
                          max_batch=128)
    assert [s["engine"] for s in server.engine_status()] == \
        ["ref", "vectorized", "naive"]
    reqs, n = requests(data)
    tickets = [server.submit(r) for r in reqs]
    got = np.concatenate([server.result(t) for t in tickets])
    np.testing.assert_allclose(got, want[:n], rtol=0, atol=0)
    m = server.metrics
    assert m.engine_dispatches == {"ref": m.dispatches}
    assert m.completed == len(reqs) and m.fallback_dispatches == 0


def test_fault_plan_resolves_every_ticket_exactly_once(trained, data):
    _, pm, want = trained["gbt_binary"]
    clock = FakeClock()
    server = ForestServer(pm, device=CPU, clock=clock.now, sleep=clock.sleep,
                          failure_threshold=2, cooldown_s=0.05)
    plan = FaultPlan(transient_calls=(0, 4), poison_calls=(2,),
                     dead_from=6, dead_until=9)
    faulty = server.inject_faults(plan)
    reqs, _ = requests(data, sizes=(5, 9, 3, 12, 7, 4, 8, 6, 10, 2, 11, 5))
    resolved, row = {}, 0
    for r in reqs:
        t = server.submit(r)
        server.pump()
        n = len(r["age"])
        resolved[t] = (row, n)
        row += n
        clock.advance(0.02)
    for t, (start, n) in resolved.items():
        np.testing.assert_allclose(server.result(t), want[start:start + n],
                                   rtol=0, atol=0)
        with pytest.raises(KeyError):
            server.result(t)                       # claimed exactly once
    m = server.metrics
    assert m.completed == len(reqs) and m.failed == 0
    assert faulty.counts["transient"] == 2 and faulty.counts["poison"] == 1
    assert faulty.counts["dead"] >= 1
    assert m.fallback_dispatches >= 1 and m.retries >= 2
    assert set(m.engine_dispatches) <= {"ref", "vectorized"}


# ------------------------------------------------------------ device rule

@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_a_card(no_card, trained, data):
    _, pm, _ = trained["gbt_binary"]
    for call in (lambda: compile_predictor(pm),
                 lambda: compile_predictor(pm, "cuda"),
                 lambda: make_forest_server(pm),
                 lambda: ForestServer(pm),
                 lambda: pm.predict(data),
                 lambda: engines.available_engines()):
        with pytest.raises(YdfError, match="device='cpu'"):
            call()


def test_cuda_engine_is_not_offered_on_the_cpu(trained):
    _, pm, _ = trained["gbt_binary"]
    assert engines.available_engines(CPU) == ["ref", "vectorized", "naive"]
    with pytest.raises(YdfError, match="Unknown engine 'cuda'"):
        compile_predictor(pm, "cuda", device=CPU)


def test_cuda_request_raises_instead_of_falling_back(no_card, trained, data):
    _, pm, _ = trained["gbt_binary"]
    X = compile_predictor(pm, "naive", device=CPU).encode(data)[:8]
    before = forest_infer.LAUNCHES
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.forest_predict(pm.forest, X, "cuda", "cuda")
    assert forest_infer.LAUNCHES == before


def test_kernel_build_error_is_not_an_engine_failure(trained, monkeypatch):
    """A kernel that does not build raises RuntimeError when the predictor
    or the server is built; the degradation chain never sees it."""
    _, pm, _ = trained["gbt_binary"]

    def broken_build():
        raise RuntimeError("nvcc failed to build forest_infer.cu")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(forest_infer, "library", broken_build)
    for call in (lambda: compile_predictor(pm, "cuda", device="cuda"),
                 lambda: ForestServer(pm)):
        with pytest.raises(RuntimeError, match="nvcc failed") as info:
            call()
        assert not isinstance(info.value, EngineFailure)


def test_dispatch_error_is_an_engine_failure_and_degrades(trained, data):
    """On the CPU, a fault AT DISPATCH of the plain engine is typed as
    EngineFailure and served by the next engine of the chain."""
    _, pm, want = trained["gbt_binary"]

    def failed_launch(X):
        raise RuntimeError("gather traversal failed")

    pred = compile_predictor(pm, "ref", device=CPU)
    pred.engine.per_tree = failed_launch
    with pytest.raises(EngineFailure) as info:
        pred.predict(data)
    assert info.value.engine == "ref"

    clock = FakeClock()
    server = ForestServer(pm, device=CPU, clock=clock.now, sleep=clock.sleep)
    server._state(None).bundle(0).predictor.engine.per_tree = failed_launch
    got = server.predict({k: v[:50] for k, v in data.items()})
    np.testing.assert_allclose(got, want[:50], rtol=0, atol=0)
    assert server.metrics.fallback_dispatches == 1
    assert server.metrics.engine_dispatches == {"vectorized": 1}


def test_kernel_launch_error_propagates_and_never_degrades(trained, data,
                                                           monkeypatch):
    """On the card the default chain is the kernel engine alone, and a
    failed launch raises its RuntimeError (not an EngineFailure) even in a
    chain that names host engines after it: no work moves to the host."""
    _, pm, _ = trained["gbt_binary"]

    def failed_launch(*args, **kwargs):
        raise RuntimeError("forest_infer_tiled launch failed: CUDA error 700")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(forest_infer, "library", lambda: None)
    monkeypatch.setattr(ops, "device_packed", lambda forest, device: None)
    monkeypatch.setattr(ops, "forest_predict", failed_launch)
    batch = {k: v[:20] for k, v in data.items()}
    with pytest.raises(RuntimeError, match="launch failed") as info:
        compile_predictor(pm, "cuda").predict(batch)
    assert not isinstance(info.value, EngineFailure)

    for engines in (None, ["cuda", "vectorized", "naive"]):
        clock = FakeClock()
        server = ForestServer(pm, engines=engines, clock=clock.now,
                              sleep=clock.sleep)
        if engines is None:
            assert [s["engine"] for s in server.engine_status()] == ["cuda"]
        tickets = [server.submit(batch, pump=False) for _ in range(2)]
        with pytest.raises(RuntimeError, match="launch failed"):
            server.pump()
        for t in tickets:                    # resolved once, with the error
            with pytest.raises(RuntimeError, match="launch failed"):
                server.result(t)
            with pytest.raises(KeyError):
                server.result(t)
        m = server.metrics
        assert m.failed == 2 and m.completed == 0
        assert m.engine_dispatches == {} and m.fallback_dispatches == 0


def test_convert_refuses_what_the_port_does_not_serve(trained):
    ref_model, _, _ = trained["gbt_binary"]
    arrays = {k: getattr(ref_model.forest, k) for k in FIELDS}
    spec = spec_to_dict(ref_model.spec)
    oblique = dict(arrays, feature=np.where(arrays["feature"] >= 0, -2,
                                            arrays["feature"]))
    with pytest.raises(YdfError, match="oblique"):
        convert.model_from_arrays("gbt", oblique, spec, ref_model.features,
                                  task="CLASSIFICATION")
    with pytest.raises(YdfError, match="not in the dataspec"):
        convert.model_from_arrays("gbt", arrays, spec, ["no_such_column"],
                                  task="CLASSIFICATION")
    with pytest.raises(YdfError, match="Unknown model kind"):
        convert.model_from_arrays("cart", arrays, spec, ref_model.features,
                                  task="CLASSIFICATION")


# ------------------------------------------- the chip smoke run, rehearsed

def test_chip_smoke_model_and_phases_on_the_cpu():
    """The full-width default GBT that ``chip_smoke.py`` serves on the card
    packs into 38 blocks of 8 trees x 128 nodes, and its phases pass on the
    CPU at a small request count (the plain version stands in for the
    kernel, so no launch is counted)."""
    import chip_smoke
    model = chip_smoke.build_default_gbt()
    dev = torch.device(CPU)
    kern = chip_smoke.check_kernel(model, dev, sizes=(0, 1, 7, 32))
    assert (kern["B"], kern["TB"], kern["M"]) == (38, 8, 128)
    assert kern["max_abs_err"] == 0.0
    stats = chip_smoke.serve(model, dev, n_requests=4, wave=2)
    assert stats["engine_dispatches"] == {"ref": 2}
    assert stats["fallback_dispatches"] == 0 and stats["failed"] == 0


def test_chip_smoke_model_matches_the_reference_forest():
    """The slice as a whole: the same full-width forest, built once in each
    package, gives the same per-tree outputs through the reference's
    predict_naive and the port's packed traversal, hostile rows included."""
    import chip_smoke
    from repro.core.tree import empty_forest, predict_naive
    model = chip_smoke.build_default_gbt()
    pf = model.forest
    rf = empty_forest(pf.n_trees, pf.max_nodes, 1)
    for k in ("feature", "threshold", "cat_mask", "left_child", "leaf_value",
              "n_nodes"):
        setattr(rf, k, getattr(pf, k))
    rf.depth = pf.depth
    X = chip_smoke.encoded_inputs(48, seed=3)
    got = ops.forest_predict(pf, X, "cuda", CPU).numpy()
    assert np.array_equal(got, predict_naive(rf, X))
