"""The Random Forest's winner-take-all head (``core/tree.py``
``aggregate_rf``, ``core/models.py`` ``_RfFinalize``) against the vote
written out with ``argmax``.

A forest whose leaves are all finite counts its votes by strict comparisons
of the class slices (``nan_free``); any other forest, and a call that does
not say, takes ``argmax``. Both must give the ``argmax`` form's output bit
for bit (``np.array_equal``), ties to the lowest class included; NaN leaves
are held to it on the ``argmax`` path only, where the first NaN along the
class axis wins. Without winner-take-all, the regression head and the uplift
head return the mean over trees.
"""
from __future__ import annotations

import copy
import dataclasses

import numpy as np
import pytest

from repro_torch.core.models import UpliftModel, _RfFinalize
from repro_torch.core.rf import RandomForestLearner
from repro_torch.core.tree import aggregate_rf
from repro_torch.data.tabular import SUITE, make_dataset


def argmax_vote(per_tree: np.ndarray) -> np.ndarray:
    """(N, T, C) -> (N, C): each tree's argmax class, a class's share."""
    votes = per_tree.argmax(-1)
    C = per_tree.shape[-1]
    out = np.zeros((per_tree.shape[0], C), np.float32)
    for c in range(C):
        out[:, c] = (votes == c).mean(axis=1)
    return out


def leaves(n, t, c, seed=0, dtype=np.float32):
    """Leaf distributions over c classes; c = 2 as the benchmark's RF
    makes them, (1 - p, p) with p uniform."""
    r = np.random.default_rng(seed)
    if c == 1:
        return r.random((n, t, 1)).astype(dtype)
    if c == 2:
        p = r.random((n, t), dtype=np.float32)
        return np.stack([1 - p, p], -1).astype(dtype)
    v = r.random((n, t, c)).astype(dtype)
    return v / v.sum(-1, keepdims=True)


def ties(c):
    """Rows with exact ties between classes: all-equal rows, pairs tied at
    the top, ties below the top, and coarse values that tie often."""
    v = leaves(40, 17, c, seed=c)
    v[:5] = 1.0 / c                        # every class equal
    v[5:10] = 0.0                          # all zero
    v[10:20, :, c - 1] = v[10:20, :, 0]    # the last class ties class 0
    v[20:30, :, 1] = v[20:30, :, 0] = 0.5  # a tie at the top
    v[30:] = np.round(v[30:] * 2) / 2      # values in {0, 0.5, 1}
    return v


def non_contiguous(c):
    # every other tree of a wider stack, and a class axis out of order
    v = leaves(64, 41, c + 1, seed=7)[:, ::2, ::-1][..., :c]
    assert not v.flags.c_contiguous
    return v


def with_nan(c, where):
    v = ties(c)
    r = np.random.default_rng(3)
    hit = r.random(v.shape[:2]) < 0.2
    for k in where:
        v[..., k][hit] = np.nan
        hit = np.roll(hit, 1, axis=1)
    return v


# name -> (per_tree, whether it holds a NaN)
CASES = {
    "c2": (leaves(300, 64, 2), False),
    "c3": (leaves(300, 64, 3), False),
    "c5": (leaves(300, 64, 5), False),
    "c2_ties": (ties(2), False),
    "c3_ties": (ties(3), False),
    "c5_ties": (ties(5), False),
    "c2_one_tree": (leaves(50, 1, 2), False),
    "c3_one_tree": (leaves(50, 1, 3), False),
    "c2_no_rows": (leaves(0, 9, 2), False),
    "c5_no_rows": (leaves(0, 9, 5), False),
    "c2_float64": (leaves(200, 33, 2, dtype=np.float64), False),
    "c3_float64": (leaves(200, 33, 3, dtype=np.float64), False),
    "c2_non_contiguous": (non_contiguous(2), False),
    "c3_non_contiguous": (non_contiguous(3), False),
    "c2_zero_probe": (np.zeros((1, 300, 2), np.float32), False),
    "c5_zero_probe": (np.zeros((1, 7, 5), np.float32), False),
    "c2_nan_class0": (with_nan(2, [0]), True),
    "c3_nan_later_class": (with_nan(3, [2]), True),
    "c5_nan_both": (with_nan(5, [0, 3]), True),
    "c2_nan_both": (with_nan(2, [0, 1]), True),
}
PARAMS = [pytest.param(name, flag, id=f"{name}-{'nan_free' if flag else 'argmax'}")
          for name, (_, has_nan) in CASES.items()
          for flag in ((False,) if has_nan else (False, True))]


@pytest.mark.parametrize("name,nan_free", PARAMS)
def test_vote_equals_argmax_form(name, nan_free):
    per_tree, has_nan = CASES[name]
    want = argmax_vote(per_tree)
    got = aggregate_rf(per_tree, True, nan_free)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.array_equal(got, want), name
    head = _RfFinalize(True, False, nan_free)
    assert np.array_equal(head(per_tree), want), name
    if has_nan:   # the argmax path is the one that reads NaN right
        assert not np.array_equal(argmax_vote(np.nan_to_num(per_tree)), want)


@pytest.fixture(scope="module")
def binary_rf():
    data = make_dataset(SUITE[1])
    model = RandomForestLearner(label="label", num_trees=4, max_depth=4,
                                device="cpu").train(data)
    return model, data


def test_compile_finalize_flags_non_finite_leaves(binary_rf):
    model, data = binary_rf
    assert model._compile_finalize() == _RfFinalize(True, False, True)
    want = argmax_vote(model._scores(data, device="cpu"))
    assert np.array_equal(model.predict(data, device="cpu"), want)
    for bad in (np.nan, np.inf):
        leaf_value = model.forest.leaf_value.copy()
        leaf_value[1, 0, 0] = bad      # a split node's slot: never read
        planted = copy.copy(model)
        planted.forest = dataclasses.replace(model.forest,
                                             leaf_value=leaf_value)
        assert planted._compile_finalize() == _RfFinalize(True, False, False)
    # a head pickled before the flag existed takes the argmax path
    state = dataclasses.asdict(_RfFinalize(True, False))
    del state["nan_free"]
    old = _RfFinalize.__new__(_RfFinalize)
    old.__dict__.update(state)
    per_tree = CASES["c2_nan_class0"][0]
    assert np.array_equal(old(per_tree), argmax_vote(per_tree))


@pytest.mark.parametrize("head,kind", [
    (_RfFinalize(False, False, True), "classification without winner-take-all"),
    (_RfFinalize(False, False, False), "classification without winner-take-all"),
    (_RfFinalize(False, True, True), "regression"),
    (_RfFinalize(False, True, False), "regression"),
    (None, "uplift"),
])
def test_mean_heads_unchanged(head, kind):
    if head is None:   # the uplift head captures nothing of its model
        head = UpliftModel.__new__(UpliftModel)._compile_finalize()
    c = 1 if head.regression else 3
    per_tree = leaves(100, 21, c, seed=5)
    want = per_tree.mean(axis=1)
    if head.regression:
        want = want[:, 0]
    got = head(per_tree)
    assert got.dtype == want.dtype and np.array_equal(got, want), kind
    assert np.array_equal(aggregate_rf(per_tree, False, True),
                          per_tree.mean(axis=1))
