"""The port's asyncio front end (``AsyncForestServer``) against the JAX
package's scenario, on the CPU.

A GBT trained by the JAX package on ``adult_like`` crosses to the port as
plain arrays (``convert.model_from_arrays``) and is served by the port's
``ForestServer`` on ``device="cpu"`` behind ``AsyncForestServer``: the
scenario of ``tests/test_serving_server.py::
test_async_front_end_micro_batches_and_sheds`` (10 concurrent requests of
8 rows against a 40-row queue cap: exactly 5 admitted, 5 shed). Tolerance:
none (``array_equal``): every engine selects the same leaves and the heads
are the same numpy code, so each answer equals the reference model's
``predict`` and the port model's.

Also: the async server over the bucketed engines, a dead kernel failing
every pending future instead of hanging them, and CPU rehearsals of
``chip_smoke.py``'s phases 26 (``serve_bucketed``) and 27 (``serve_async``)
at a small size.
"""
from __future__ import annotations

import asyncio

import numpy as np
import pytest
import torch

from repro.core import GradientBoostedTreesLearner
from repro.core.dataspec import spec_to_dict
from repro.data.tabular import adult_like, train_test_split
from repro_torch import convert
from repro_torch.serving.faults import FakeClock
from repro_torch.serving.server import (
    AsyncForestServer,
    ForestServer,
    RequestShed,
)

CPU = "cpu"
FIELDS = ("feature", "threshold", "cat_mask", "left_child", "leaf_value",
          "n_nodes", "depth", "tree_class", "init_pred", "out_dim")


@pytest.fixture(scope="module")
def trained():
    """(reference GBT, the port's copy of it, request features)."""
    train, test = train_test_split(adult_like(900), 0.3, 1)
    gbt = GradientBoostedTreesLearner(label="income", num_trees=6).train(train)
    port = convert.model_from_arrays(
        "gbt", {k: getattr(gbt.forest, k) for k in FIELDS},
        spec_to_dict(gbt.spec), gbt.features, task=gbt.task.value,
        classes=gbt.classes, loss=gbt.loss.name)
    feats = {k: v for k, v in test.items() if k != "income"}
    return gbt, port, feats


def req_slice(feats, lo, n=8):
    return {k: v[lo:lo + n] for k, v in feats.items()}


def _fan_in(server, batches, flush_interval_s=0.001):
    async def run():
        async with AsyncForestServer(server,
                                     flush_interval_s=flush_interval_s) as a:
            return await asyncio.gather(*(a.predict(b) for b in batches),
                                        return_exceptions=True)
    return asyncio.run(run())


@pytest.mark.parametrize("engines", [None, ["bucketed"], ["leaf_path"]],
                         ids=["default_chain", "bucketed", "leaf_path"])
def test_async_front_end_micro_batches_and_sheds(trained, engines):
    gbt, port, feats = trained
    srv = ForestServer(port, buckets=(16, 64), max_queue_rows=40,
                       engines=engines, device=CPU)
    batches = [req_slice(feats, lo) for lo in range(0, 80, 8)]
    results = _fan_in(srv, batches)         # 10 x 8 rows > the queue cap
    ok = [r for r in results if isinstance(r, np.ndarray)]
    shed = [r for r in results if isinstance(r, RequestShed)]
    assert len(ok) == 5 and len(shed) == 5  # the cap admits exactly 40 rows
    for batch, r in zip(batches, results):
        if isinstance(r, np.ndarray):
            np.testing.assert_array_equal(r, gbt.predict(batch))
            np.testing.assert_array_equal(r, port.predict(batch, device=CPU))
    m = srv.metrics
    assert m.shed == 5 and m.completed == 5 and m.failed == 0
    head = (engines or ["ref"])[0]
    assert set(m.engine_dispatches) == {head}


def test_concurrent_requests_share_padded_dispatches(trained):
    """Requests submitted on one tick resolve in one dispatch."""
    _, port, feats = trained
    srv = ForestServer(port, buckets=(16, 64), device=CPU)
    batches = [req_slice(feats, lo, n) for lo, n in ((0, 3), (3, 5), (8, 1),
                                                    (9, 20))]
    results = _fan_in(srv, batches, flush_interval_s=0.01)
    for batch, r in zip(batches, results):
        np.testing.assert_array_equal(r, port.predict(batch, device=CPU))
    assert srv.metrics.dispatches == 1 and srv.metrics.rows_padded == 64 - 29


def test_a_dead_kernel_fails_every_pending_future(trained, monkeypatch):
    """A launch error is not served around: the dispatch's futures get the
    RuntimeError, and leaving the context re-raises it."""
    _, port, feats = trained
    clock = FakeClock()
    srv = ForestServer(port, device=CPU, clock=clock.now, sleep=clock.sleep)
    engine = srv._state(None).bundle(0).predictor.engine

    def failed_launch(X):
        raise RuntimeError("forest_infer_tiled launch failed: CUDA error 700")

    monkeypatch.setattr(engine, "per_tree", failed_launch)
    monkeypatch.setattr(engine, "fatal_errors", True)
    seen = {}

    async def run():
        a = AsyncForestServer(srv, flush_interval_s=0.001)
        with pytest.raises(RuntimeError, match="launch failed"):
            async with a:
                seen["results"] = await asyncio.gather(
                    *(a.predict(req_slice(feats, lo)) for lo in (0, 8)),
                    return_exceptions=True)
        return a
    a = asyncio.run(run())
    assert all(isinstance(r, RuntimeError) for r in seen["results"])
    assert a._futures == {} and srv.metrics.failed == 2


# --------------------------------------- chip_smoke's phases, rehearsed

def test_chip_smoke_serve_bucketed_phase_on_the_cpu():
    """``chip_smoke.serve_bucketed`` on the CPU with a 24-tree serving GBT
    and small rows: every engine and strategy equal to predict_naive, the
    oblique refusal, the budget gate of the deep forest."""
    import chip_smoke
    from repro_torch.core.gbt import GradientBoostedTreesLearner as PortGBT
    cpu = torch.device("cpu")
    data = adult_like(300, seed=11)
    oblique = PortGBT(label="income", num_trees=2, device="cpu",
                      split_axis="SPARSE_OBLIQUE").train(data)
    deep = chip_smoke.random_forest(4, 700, 9, 2, seed=4, cat_feats=(1,))
    cases = {"serving gbt": (chip_smoke.build_default_gbt(n_trees=24).forest,
                             chip_smoke.encoded_inputs(200, seed=3)),
             "deep": (deep, chip_smoke.hostile_rows(90, 9, 5, (1,))),
             **chip_smoke.single_zoo()}
    out = chip_smoke.serve_bucketed(cases, {"deep"}, oblique, cpu)
    assert out["cases"]["deep"]["leaf_path"] == "refused: budget"
    assert out["cases"]["serving gbt"]["strategies"]["leaf_path"] == [
        "leaf_path"] * len(out["cases"]["serving gbt"]["bucket_depths"])
    assert "Compatible engines" in out["oblique_refused"]


def test_chip_smoke_serve_async_phase_on_the_cpu():
    """``chip_smoke.serve_async`` on the CPU at a small size: the async
    fan-in with sheds, the warmed ladder, the bulk sweep and the pickled
    bucketed predictor, each equal to the host oracle."""
    import chip_smoke
    cpu = torch.device("cpu")
    model = chip_smoke.build_default_gbt(n_trees=24)
    out = chip_smoke.serve_async(model, cpu, n_requests=12, bulk_rows=3_000,
                                 chunk_rows=1_100)
    assert out["shed"] == out["expected_shed"] > 0
    assert out["completed"] == 12 - out["shed"]
    assert out["warmed"] == [32, 64, 128, 256, 512, 1024]
    assert out["bulk_dispatches"] == 3 and out["pickled_engine"] == "bucketed"
