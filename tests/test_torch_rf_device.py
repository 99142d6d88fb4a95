"""The port's Random Forest on the device growth engine against the JAX
package's device engine.

The port runs on ``device="cpu"``: the level step in PyTorch, on the torch
path (the Adult-like data has categorical columns, so the fused kernel's
route is not taken, as on the card: ``_resolve_impl("auto", True, cuda)``
is "torch"); the reference runs its jnp level step on the CPU. Both see the
same raw columns and seed. Tolerances, the reference's own contracts
between its device and batched engines (tests/test_grower_device.py):
  * SQRT keyed sampling on classification (:91): structure identical, leaf
    values within 1e-5 (float32 sums in another order), predictions within
    1e-4;
  * regression (:104): >= 99.5% of each structure field, mean prediction
    difference below 5% of the mean |prediction| (moment scores tie more
    often in float32);
  * multiclass (:117): argmax agreement above 0.97;
  * fallback reasons (:130): the reference's.
"""
from __future__ import annotations

import numpy as np
import pytest

from repro.core import RandomForestLearner as RefRF
from repro.core.api import Task as RefTask
from repro.data.tabular import SUITE, adult_like, make_dataset, train_test_split
from repro_torch.core import Task
from repro_torch.core.rf import RandomForestLearner

STRUCT_KEYS = ("feature", "split_bin", "cat_mask", "left_child", "n_nodes")


def _struct_share(a, b) -> dict:
    return {k: float((getattr(a, k) == getattr(b, k)).mean())
            for k in STRUCT_KEYS}


@pytest.fixture(scope="module")
def adult():
    return train_test_split(adult_like(900), 0.3, 1)


def test_sqrt_sampling_equals_reference_device_engine(adult):
    train, test = adult
    kw = dict(label="income", num_trees=5, max_depth=7, compute_oob=False,
              growth_engine="device")
    ref = RefRF(**kw).train(train)
    got = RandomForestLearner(device="cpu", **kw).train(train)
    logs = got.training_logs
    assert (logs["growth_engine"], logs["device_impl"]) == ("device", "torch")
    for k in STRUCT_KEYS:
        np.testing.assert_array_equal(getattr(got.forest, k),
                                      getattr(ref.forest, k), err_msg=k)
    np.testing.assert_allclose(got.forest.leaf_value, ref.forest.leaf_value,
                               atol=1e-5)
    np.testing.assert_allclose(got.predict(test, engine="ref", device="cpu"),
                               ref.predict(test), atol=1e-4)


def test_regression_close_to_reference_device_engine():
    train, test = train_test_split(make_dataset(SUITE[7]), 0.3, SUITE[7].seed)
    kw = dict(label="label", num_trees=3, max_depth=6, compute_oob=False,
              growth_engine="device")
    ref = RefRF(task=RefTask.REGRESSION, **kw).train(train)
    got = RandomForestLearner(task=Task.REGRESSION, device="cpu",
                              **kw).train(train)
    share = _struct_share(got.forest, ref.forest)
    assert min(share.values()) >= 0.995, share
    pr, pg = ref.predict(test), got.predict(test, engine="ref", device="cpu")
    assert np.abs(pr - pg).mean() < 0.05 * max(1e-9, np.abs(pr).mean())


def test_multiclass_close_to_reference_device_engine():
    """11 classes: class stats with S = 12 > 3 switch categorical columns
    to the ONE_HOT scan, on both sides."""
    spec = SUITE[4]                                  # synth_vowel
    train, test = train_test_split(make_dataset(spec), 0.3, spec.seed)
    kw = dict(label="label", num_trees=4, max_depth=5, compute_oob=False,
              growth_engine="device")
    ref = RefRF(**kw).train(train)
    got = RandomForestLearner(device="cpu", **kw).train(train)
    pr, pg = ref.predict(test), got.predict(test, engine="ref", device="cpu")
    assert (pr.argmax(1) == pg.argmax(1)).mean() > 0.97


def test_device_fallback_reasons_equal_reference(adult):
    train, _ = adult
    kw = dict(label="income", num_trees=2, compute_oob=False,
              growth_engine="device", categorical_algorithm="RANDOM")
    ref = RefRF(**kw).train(train)
    got = RandomForestLearner(device="cpu", **kw).train(train)
    assert got.training_logs["growth_engine"] == "batched"
    assert "RANDOM" in got.training_logs["engine_fallback"]
    assert got.training_logs["engine_fallback"] == \
        ref.training_logs["engine_fallback"]
    assert got.training_logs["histogram_backend"] == "numpy"
    kw.update(categorical_algorithm="CART",
              growing_strategy="BEST_FIRST_GLOBAL")
    got = RandomForestLearner(device="cpu", **kw).train(train)
    assert got.training_logs["engine_fallback"] == \
        RefRF(**kw).train(train).training_logs["engine_fallback"]
    assert "BEST_FIRST" in got.training_logs["engine_fallback"]


def test_device_engine_blocks_are_execution_only(adult):
    """tree_parallelism pads the last block on the device engine too, and
    changes no tree."""
    train, _ = adult
    kw = dict(label="income", num_trees=5, max_depth=5, compute_oob=False,
              growth_engine="device", device="cpu")
    a = RandomForestLearner(tree_parallelism=2, **kw).train(train)
    b = RandomForestLearner(tree_parallelism=8, **kw).train(train)
    for k in STRUCT_KEYS + ("threshold",):
        np.testing.assert_array_equal(getattr(a.forest, k),
                                      getattr(b.forest, k), err_msg=k)
    np.testing.assert_allclose(a.forest.leaf_value, b.forest.leaf_value,
                               atol=1e-6)
