"""``BatchEncoder``'s distinct path: a CATEGORICAL column of ``str`` (or
``numpy.str_``) and None, with at most half its rows distinct, is encoded
once per distinct object and the codes gathered.

Every case holds the port's encoder bit for bit (the float32 words) to two
oracles: the per-column object path every column took before
(``object_encode`` of ``test_torch_encoder_typed``) and the JAX package's
``repro.core.dataspec.BatchEncoder`` on the same spec. The cases cover
``str`` with None; missing tokens in other cases and with spaces;
out-of-vocabulary strings; numeric strings (the missing mask's numeric
branch); ``numpy.str_`` arrays and objects; lists; an all-None column;
columns mixing 1 / 1.0 / True / "1", float NaN, bytes or an unhashable
cell, which keep the per-cell path; and all-distinct strings, which the
guard sends down the per-cell path; each at 0, 1 and 65,536 rows. The
mixed cell's own batches (``bench/frozen_mixed.py``) on three seeds agree
too, and the counters ``engines/encode_distinct_cols`` and
``engines/encode_distinct_values`` read the columns and distinct objects
that took the distinct path, 0 where the fallback or the guard took over.
"""
from __future__ import annotations

import numpy as np
import pytest

from bench import frozen_mixed, harness
from repro_torch.core import dataspec as ds
from repro_torch.obs import trace
from test_torch_encoder_typed import assert_same_bits, encoders, \
    object_encode

ROWS = (0, 1, 65_536)
COLS = "engines/encode_distinct_cols"
VALUES = "engines/encode_distinct_values"
MIXED = harness.load_json(harness.BENCH / "configs"
                          / "gbt_rank1_adult.json")["data"]

VOCAB = ["red", "green", "blue", "1", "1.5", "-nan", "True", "None", "x y"]


def spec() -> ds.DataSpec:
    col = ds.Column(name="c", semantic=ds.Semantic.CATEGORICAL,
                    vocab=[ds.OOD] + VOCAB,
                    counts={v: 20 - i for i, v in enumerate(VOCAB)})
    return ds.DataSpec(columns={"c": col}, n_rows=100)


def draw(pool: list, n: int, seed: int) -> list:
    idx = np.random.default_rng(seed).integers(0, len(pool), n)
    return [pool[i] for i in idx]


def all_distinct(n: int, seed: int) -> np.ndarray:
    """n different strings, the vocabulary's among them."""
    vals = [f"v{i}" for i in np.random.default_rng(seed).permutation(n)]
    k = min(n, len(VOCAB))
    vals[:k] = VOCAB[:k]
    return np.array(vals, dtype=object)


# name -> (column of n rows from a seed, True where its objects are all
# str or None, so that the distinct path takes it past one row)
CASES = {
    "str_none": (lambda n, s: np.array(
        draw(["red", "green", "blue", None], n, s), dtype=object), True),
    "missing_tokens": (lambda n, s: np.array(draw(
        [" NA ", "Null", "?", "", "  ", "N/A", "nan", "NaN", "none",
         "None ", "None", "red", "na"], n, s), dtype=object), True),
    "out_of_vocabulary": (lambda n, s: np.array(draw(
        ["red", "purple", "Red", " red", "red ", ds.OOD, "violet", None,
         "x  y", "x y"], n, s), dtype=object), True),
    "numeric_strings": (lambda n, s: np.array(draw(
        ["1.5", "-nan", "nan", "1", "2", "inf", "-0", "1e3", None], n, s),
        dtype=object), True),
    "numpy_str_array": (lambda n, s: np.array(
        draw(["red", "blue", "NA", "x y", "1.5", "?"], n, s), dtype=str),
        True),
    "numpy_str_objects": (lambda n, s: np.array(
        [np.str_(v) for v in draw(["red", "green", "nan", "1"], n, s)],
        dtype=object), True),
    "list": (lambda n, s: draw(["green", None, "1.5", "Null", "zz"], n, s),
             True),
    "all_none": (lambda n, s: [None] * n, True),
    "mixed_types": (lambda n, s: np.array(draw(
        [1, 1.0, True, "1", float("nan"), None, "red", 1.5, "True"], n, s),
        dtype=object), False),
    "bytes": (lambda n, s: np.array(
        draw([b"red", "red", None], n, s), dtype=object), False),
    "unhashable": (lambda n, s: np.array(
        draw([{"a": 1}, "red", None, "blue"], n, s), dtype=object), False),
    "all_distinct": (all_distinct, False),
}


def distinct_objects(col) -> int:
    return len(dict.fromkeys(np.asarray(col, dtype=object).tolist()))


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_column_matches_both_oracles(case, rows):
    make, distinct = CASES[case]
    enc, ref = encoders(spec(), ["c"])
    batch = {"c": make(rows, rows + 3)}
    with trace.capture() as tr:
        got = enc.encode(batch)
    assert got.shape == (rows, 1)
    assert_same_bits(got, object_encode(enc, batch), ref.encode(batch))
    # one row is over half distinct; an empty column is neither over half
    # distinct nor of any object but str and None
    took = rows == 0 or (distinct and rows > 1)
    m = tr.metrics
    assert m.counter(COLS).value == int(took)
    assert m.counter(VALUES).value == \
        (distinct_objects(batch["c"]) if took else 0)


def test_guard_takes_half_distinct_columns_only():
    """A column with exactly half its rows distinct takes the distinct
    path; one more distinct value sends it down the per-cell path."""
    enc, ref = encoders(spec(), ["c"])
    half = [f"v{i}" for i in range(8)] * 2
    over = half[:15] + ["blue"]
    for col, took in ((half, 1), (over, 0)):
        batch = {"c": col}
        with trace.capture() as tr:
            got = enc.encode(batch)
        assert_same_bits(got, object_encode(enc, batch), ref.encode(batch))
        assert tr.metrics.counter(COLS).value == took
        assert tr.metrics.counter(VALUES).value == 8 * took


def mixed_encoders(seed: int):
    trained = frozen_mixed.adult_rows(MIXED, MIXED["rows_published"], seed, 0)
    spec = ds.spec_from_dict(frozen_mixed.spec_dict(trained, MIXED))
    return encoders(spec, frozen_mixed.features(MIXED))


@pytest.mark.parametrize("seed", [7, 41, 2**31 + 17])
def test_mixed_cell_batches_match_both_oracles(seed):
    enc, ref = mixed_encoders(seed)
    batch = frozen_mixed.adult_rows(MIXED, 65_536, seed, 100, labels=False)
    with trace.capture() as tr:
        got = enc.encode(batch)
    assert got.shape == (65_536, 14)
    assert_same_bits(got, object_encode(enc, batch), ref.encode(batch))
    cats = list(MIXED["categorical"])
    assert len(cats) == 8
    m = tr.metrics
    assert m.counter(COLS).value == 8
    assert m.counter(VALUES).value == sum(distinct_objects(batch[c])
                                          for c in cats)
    assert m.counter("engines/encode_object_cols").value == 8
    assert m.counter("engines/encode_typed_cols").value == 6


def test_mixed_cell_counters_per_call():
    """Each call counts its own columns: two calls count 16, and a call
    whose categorical columns come as lists counts the same."""
    enc, _ = mixed_encoders(5)
    batch = frozen_mixed.adult_rows(MIXED, 4_096, 5, 101, labels=False)
    lists = {k: v.tolist() if v.dtype == object else v
             for k, v in batch.items()}
    with trace.capture() as tr:
        a = enc.encode(batch)
        b = enc.encode(lists)
    assert tr.metrics.counter(COLS).value == 16
    per = sum(distinct_objects(batch[c]) for c in MIXED["categorical"])
    assert per <= 8 * 42                         # at most 41 values + None
    assert tr.metrics.counter(VALUES).value == 2 * per
    assert_same_bits(a, b, object_encode(enc, batch))
