"""The benchmark's mixed-column cell and its default-engine training cell,
held on the CPU at small sizes.

The program's ``Model.predict`` on a small rank1-shaped forest from
``bench/frozen_mixed.py`` (all three kinds of condition) agrees with the
plain reference, ``bench/reference_mixed.py``, within the cell's limit
and tree by tree exactly; the bfloat16 control and each planted fault
read over the limit; both new cells run through ``bench/harness.py`` and
come out correct; ``train_engine`` counts a training that did not run the
batched engine as failed; the work counts match a forest counted by
hand; the yardstick's new modules import neither the program nor JAX.
"""
from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from bench import frozen_mixed, harness, importcheck, reference_mixed, \
    workcount_mixed
from bench.generators import score_mixed, train_engine

CPU = "cpu"
CELL = "gbt_rank1_adult.score_bulk_mixed"
TRAIN = "gbt_higgs.train_batched"
SEED = 2 ** 31 + 11
SMALL = {
    CELL: {"params": {"rows": 2_048, "pool": 2},
           "forest": {"trees": 8, "depth": 4,
                      "splits_hist": [0] * 10 + [1] * 6}},
    TRAIN: {"rows": 5_000, "hparams": {"num_trees": 6},
            "params": {"pool": 1, "held_out_rows": 1_000}},
}
LIMIT = harness.load_json(harness.BENCH / "limits" / f"{CELL}.json")


def small_run(cell=CELL, seed=SEED, trace=False, over=None):
    return harness.make_run(harness.benchmark(), cell, seed, 0.5, trace,
                            CPU, over or SMALL[cell])


@pytest.fixture(scope="module")
def scored():
    """The small forest, one batch of 2,048 raw rows, the program's answers
    and per-tree outputs, and the reference's encoding of the rows."""
    run = small_run()
    model, arrays, spec = score_mixed.make_model(run)
    rows = frozen_mixed.adult_rows(run.config["data"], 2_048, SEED, 100,
                                   labels=False)
    pred = model.predictor(None, CPU)
    X = pred.encode(rows)
    X_ref, miss = reference_mixed.encode(rows, spec, model.features, CPU)
    return {"arrays": arrays, "rows": rows, "model": model,
            "got": model.predict(rows, device=CPU),
            "per_tree": pred.per_tree(X), "X": X, "X_ref": X_ref,
            "miss": miss}


@pytest.mark.parametrize("name", ["reference_mixed.py", "workcount_mixed.py",
                                  "frozen_mixed.py"])
def test_yardstick_modules_import_neither_program_nor_jax(name):
    names = importcheck.top_level_imports(harness.BENCH / name)
    assert not names & {"repro_torch", "repro", "jax", "jaxlib", "flax"}


def test_the_forest_holds_all_three_kinds_in_every_tree(scored):
    a = scored["arrays"]
    inner = a["left_child"] >= 0
    obl = inner & (a["feature"] == -2)
    cat = inner & ~obl & a["cat_mask"].any(-1)
    axis = inner & ~obl & ~cat
    for kind in (axis, obl, cat):
        assert kind.any(1).all()
    # every mask sends a present value each way, within its vocabulary
    spec = scored["model"].spec
    for t, n in zip(*np.nonzero(cat)):
        V = spec[scored["model"].features[a["feature"][t, n]]].vocab_size
        bits = [(a["cat_mask"][t, n, c // 32] >> (c % 32)) & 1
                for c in range(256)]
        assert not any(bits[V:])
        assert 0 < sum(bits[1:V]) < V - 1
    # oblique weights are +-1 / (max - min) of their columns, padded with
    # weight 0 on column 0
    w, f = a["obl_weights"][obl], a["obl_features"][obl]
    for wi, fi in zip(w, f):
        live = wi != 0
        assert live[:live.sum()].all() and (fi[~live] == 0).all()
        for wk, fk in zip(wi[live], fi[live]):
            c = spec[scored["model"].features[fk]]
            assert abs(abs(wk) - np.float32(1 / (c.max - c.min))) == 0


def test_axis_thresholds_lie_between_distinct_values(scored):
    a = scored["arrays"]
    feats = scored["model"].features
    ax = (a["left_child"] >= 0) & (a["feature"] >= 0) \
        & ~a["cat_mask"].any(-1)
    run = small_run()
    trained = frozen_mixed.adult_rows(run.config["data"], 32_561, SEED, 0)
    for t, n in zip(*np.nonzero(ax)):
        v = np.unique(trained[feats[a["feature"][t, n]]]
                      [:frozen_mixed.THRESHOLD_ROWS].astype(np.float32))
        thr = a["threshold"][t, n]
        i = np.searchsorted(v, thr)
        assert 0 < i < len(v) and v[i - 1] < thr <= v[i]


def test_program_agrees_with_the_reference(scored):
    want = reference_mixed.predict(scored["arrays"], scored["X_ref"],
                                   scored["miss"])
    gap = reference_mixed.widest_gap(scored["got"], want)
    assert gap <= LIMIT["pred_gap"]
    # tree by tree the leaves are the same: the oblique sums in the port's
    # documented order make every decision exact
    leaves, visits = reference_mixed.traverse(
        scored["arrays"], scored["X_ref"], scored["miss"])
    lv = scored["arrays"]["leaf_value"][..., 0]
    T = lv.shape[0]
    np.testing.assert_array_equal(
        scored["per_tree"][..., 0], lv[np.arange(T)[None, :], leaves.numpy()])
    assert (visits > 0).all()
    # each oblique visit reads 1 to P non-zero pairs
    P = scored["arrays"]["obl_weights"].shape[-1]
    assert visits[1] <= visits[3] <= P * visits[1]


def test_program_encoding_equals_the_reference_bit_for_bit(scored):
    np.testing.assert_array_equal(scored["X"].view(np.uint32),
                                  scored["X_ref"].numpy().view(np.uint32))
    # the missing cells are those the rows hold as None
    rows = scored["rows"]
    for j, name in enumerate(scored["model"].features):
        np.testing.assert_array_equal(
            scored["miss"][:, j].numpy(),
            np.array([v is None for v in rows[name]]))


@pytest.mark.parametrize("precision,fault", [
    ("bfloat16", None), *[("float64", f) for f in reference_mixed.FAULTS]])
def test_control_and_faults_read_over_the_limit(scored, precision, fault):
    want = reference_mixed.predict(scored["arrays"], scored["X_ref"],
                                   scored["miss"])
    bad = reference_mixed.predict(scored["arrays"], scored["X_ref"],
                                  scored["miss"], precision, fault)
    assert reference_mixed.widest_gap(bad.numpy(), want) > LIMIT["pred_gap"]


def test_planted_faults_change_one_node_nearest_a_root(scored):
    a = scored["arrays"]
    w = reference_mixed.planted(a, "weight")
    diff = np.argwhere(w["obl_weights"] != a["obl_weights"])
    assert len(diff) == 1 and a["obl_weights"][tuple(diff[0])] != 0
    m = reference_mixed.planted(a, "mask")
    diff = np.argwhere(m["cat_mask"] != a["cat_mask"])
    assert len(diff) == 1 and tuple(diff[0])[2] == 0
    assert (m["cat_mask"] ^ a["cat_mask"]).sum() == 2


def test_pairwise_follows_numpy_float32_sums():
    g = np.random.default_rng(0)
    for n in (1, 6, 7, 8, 13, 64, 129, 300):
        p = g.normal(size=(50, n)).astype(np.float32) \
            * np.float32(10.0) ** g.integers(-3, 4, size=(50, n))
        got = reference_mixed.pairwise(torch.from_numpy(p)).numpy()
        np.testing.assert_array_equal(got, p.sum(-1))


@pytest.mark.parametrize("cell", [CELL, TRAIN])
def test_cell_runs_through_the_harness(cell):
    run = small_run(cell, trace=True)
    out = harness.run_cell(run, time.perf_counter())
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["checks"]) == set(run.limits)


def test_mixed_cell_reads_its_new_metrics():
    b = harness.benchmark()
    run = small_run(trace=True)
    out = harness.run_cell(run, time.perf_counter(), b)
    m = out["metrics"]
    assert m["encode_objects_ms.score"]["value"] > 0
    assert 0 < m["mixed_score_mfu"]["value"] < 100
    # no device trace on the CPU: B2's roofline has no time to divide by
    assert "traverse_roofline.mixed" not in m


def test_batched_cell_reads_its_grower_metrics():
    out = harness.run_cell(small_run(TRAIN, trace=True), time.perf_counter())
    m = out["metrics"]
    for name in ("routing_ms.train", "leaf_stats_ms.train"):
        assert m[name]["value"] > 0, name
    # the device engine's level step and B1 are not on this path
    assert "level_step_ms.train" not in m and "train_mfu" not in m


def test_training_that_left_the_batched_engine_is_failed():
    # best-first growth cannot run on the device engine: each training
    # falls back to batched, which is not the engine the traffic names
    over = {**SMALL[TRAIN],
            "hparams": {"num_trees": 2, "growing_strategy":
                        "BEST_FIRST_GLOBAL"},
            "params": {**SMALL[TRAIN]["params"],
                       "hparams": {"growth_engine": "device"}}}
    run = small_run(TRAIN, over=over)
    state = train_engine.setup(run)
    out = train_engine.window(run, state)
    assert out["attempted"] >= 1 and out["failed"] == out["attempted"]
    assert out["notes"]["engine_ok"] == [False] * out["attempted"]


@pytest.mark.parametrize("logs,ok", [
    ({"growth_engine": "batched", "histogram_backend": "numpy"}, True),
    ({"growth_engine": "batched", "histogram_backend": "torch"}, False),
    ({"growth_engine": "device", "device_impl": "torch"}, False),
    ({"growth_engine": "batched", "histogram_backend": "numpy",
      "engine_fallback": "best-first growth"}, False),
])
def test_engine_check_reads_the_training_logs(logs, ok):
    run = train_engine.overlaid(small_run(TRAIN))
    assert run.config["hparams"]["growth_engine"] == "batched"
    assert train_engine.engine_ok(run, logs) is ok


def test_overlay_leaves_the_configuration_file_alone():
    run = small_run(TRAIN)
    assert run.config["hparams"]["growth_engine"] == "device"
    assert train_engine.overlaid(run).config["hparams"]["growth_engine"] \
        == "batched"


def test_work_counts_by_hand():
    # 2 trees held nodes: 5 + 3; one oblique node (P = 3, two non-zero
    # weights), one categorical
    work = {"features": 4, "nodes": 8, "oblique_nodes": 1,
            "oblique_pairs": 2, "categorical_nodes": 1, "obl_width": 3,
            "trees": 2, "out_dim": 1}
    # 10 rows: 40 axis, 7 oblique (14 non-zero pairs), 5 categorical visits
    visits = [40, 7, 5, 14]
    nb, ops = workcount_mixed.b2_call(10, visits, work)
    assert nb == 10 * 4 * 4 + 8 * 16 + 2 * 8 + 1 * 32 + 10 * 4
    assert ops == 40 + 5 + 2 * 14
    nb2, ops2 = workcount_mixed.scoring_call(10, visits, work)
    assert (nb2, ops2) == (nb + 10 * 4 * 4, ops + 40 + 10 * 2)
    rec = {"work": {**work, "rows": [10, 10], "visits": [visits] * 2}}
    from bench.workcount import least_s
    assert workcount_mixed.least_calls(rec, workcount_mixed.b2_call) == \
        2 * least_s(nb, ops)
    # a run that counted nothing of the mixed kinds reads no time
    assert workcount_mixed.least_calls({"work": {"rows": [1]}},
                                       workcount_mixed.b2_call) == 0.0


def test_dataspec_matches_what_the_port_infers():
    from repro_torch.core.dataspec import infer_dataspec, spec_to_dict
    data = small_run().config["data"]
    rows = frozen_mixed.adult_rows(data, 4_000, SEED, 0)
    want = spec_to_dict(infer_dataspec(rows))["columns"]
    got = frozen_mixed.spec_dict(rows, data)["columns"]
    for name in frozen_mixed.features(data):
        for key in ("semantic", "vocab", "counts", "n_missing"):
            assert got[name][key] == want[name][key], (name, key)
        for key in ("mean", "min", "max"):
            assert got[name][key] == pytest.approx(want[name][key]), name


def test_rows_keep_adults_widths_and_missing_counts():
    data = small_run().config["data"]
    rows = frozen_mixed.adult_rows(data, 32_561, SEED, 0)
    for name, lim in data["numerical"].items():
        assert rows[name].dtype == np.int64
        assert lim["min"] <= rows[name].min() <= rows[name].max() \
            <= lim["max"]
    for name, values in data["categorical"].items():
        col = rows[name]
        assert col.dtype == object
        assert {v for v in col if v is not None} <= set(values)
        assert all(type(v) is str for v in col if v is not None)
    for name, count in data["missing"].items():
        n = sum(v is None for v in rows[name])
        assert abs(n - count) < 5 * np.sqrt(count), name
    pos = (rows[data["label"]] == ">50K").mean()
    assert pos == pytest.approx(data["positive_share"], abs=1e-3)
    edu = dict(zip(rows["education"], rows["education_num"]))
    assert edu["Doctorate"] == 16 and edu["HS-grad"] == 9
