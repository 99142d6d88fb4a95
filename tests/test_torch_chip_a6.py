"""CPU rehearsals of chip_smoke's ROADMAP A6 phases (28-31: inspect_build,
metalearners, analyze, cli) at a small size.

On the CPU the phases run every check but the launch counts and the
device times: the typed-tree round trips of a trained GBT, RF and CART;
the RandomForestBuilder model against the host oracle; the analysis and
OOB reports of the default CPU engine against the bucketed engine; the
meta-learners run twice; the CLI subprocesses, whose "card" runs are CPU
runs here. Each phase must return without raising.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import chip_smoke as cs

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The CPU engines' small torch ops run on one thread: test workers
    share the host, and a thread pool per worker oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def small():
    """synth_higgs_like at 3,000 rows and its learners' held-out rows, with
    a GBT, an RF (out-of-bag bags recorded) and a CART tree trained on the
    CPU."""
    data = cs.higgs_like(3000)
    valid = cs.validation_rows(data)
    models = {"gbt": cs.train_default(data, "cpu", num_trees=8),
              "rf": cs.train_rf(data, "cpu", num_trees=4, max_depth=8),
              "cart": cs.train_cart(data, "cpu", max_depth=8)}
    return data, valid, models


def test_inspect_build_rehearsal(small):
    _, valid, models = small
    out = cs.inspect_build(models, valid, CPU)
    assert out["gbt"]["roundtrip_equal"] and out["rf"]["roundtrip_equal"]
    assert out["built"]["trees"] == cs.BUILT_TREES
    assert out["built"]["categorical_nodes"] > 0
    assert set(out["built"]["variants"]["variants"]) == {"tiled", "single"}


def test_built_model_equals_the_reference_builder():
    """The builder forest chip_smoke serves is what the JAX package builds
    from the same typed trees."""
    from repro.core import py_tree as ref_pt
    model = cs.built_forest_model(CPU, n_trees=6)
    trees = model.forest.to_trees()
    ref_trees = [ref_pt.Tree(root=_to_ref(t.root, ref_pt)) for t in trees]
    ref = ref_pt.forest_from_trees(ref_trees,
                                   feature_names=model.forest.feature_names,
                                   out_dim=2, tree_class="none")
    for k in ("feature", "threshold", "cat_mask", "left_child", "leaf_value",
              "n_nodes"):
        assert np.array_equal(getattr(model.forest, k), getattr(ref, k)), k


def _to_ref(node, ref_pt):
    import dataclasses
    if node.is_leaf:
        return ref_pt.Leaf(ref_pt.ProbabilityValue(node.value.probability))
    cond = getattr(ref_pt, type(node.condition).__name__)(
        **dataclasses.asdict(node.condition))
    return ref_pt.NonLeaf(condition=cond,
                          neg_child=_to_ref(node.neg_child, ref_pt),
                          pos_child=_to_ref(node.pos_child, ref_pt),
                          split_order=node.split_order)


def test_analyze_rehearsal(small):
    data, valid, models = small
    out = cs.analyze_phase(models["gbt"], models["rf"], data, valid, CPU)
    g = out["gbt"]
    assert g["replicas"] == 28 * cs.ANALYZE_REPS
    assert g["pdp_curves"] == 28 and 2 < g["pdp_grid"] <= 17
    assert g["dispatched_rows"] >= (1 + g["replicas"]) * g["rows"]
    assert g["b2_device_ms_summed"] is None
    assert out["rf_oob"]["equal_to_cpu"]


def test_metalearners_rehearsal():
    out, rf, data = cs.metalearner_phase(CPU, rows=1500)
    assert rf.bag_info["n_rows"] == len(data["label"]) == 1500
    assert rf.forest.n_trees == cs.META_RF_TREES
    assert rf.forest.depth <= cs.META_RF_DEPTH
    assert out["tuner"]["trials"] == 3
    assert len(out["selector"]["kept"]) + len(out["selector"]["removed"]) \
        == cs.SELECT_COLUMNS
    assert out["predictions_equal_cpu"]


def test_cli_rehearsal(tmp_path):
    out = cs.cli_phase(str(tmp_path), CPU, rows=1500)
    assert out["predict_csv_identical"]
    assert len(out["verbs"]) == 11
    assert out["trace_spans"]["train_trace"] > 0
