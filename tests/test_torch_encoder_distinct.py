"""``BatchEncoder``'s CATEGORICAL object columns: a column of ``str`` (or
``numpy.str_``) and None is encoded once per distinct object and the codes
gathered; any other column cell by cell.

Every case holds the port's encoder bit for bit (the float32 words) to the
JAX package's two encoders on the same spec,
``repro.core.dataspec.BatchEncoder`` and ``raw_matrix(encode_dataset)``.
The cases cover ``str`` with None; missing tokens in other cases and with
spaces; out-of-vocabulary strings; numeric strings (the missing mask's
numeric branch); ``numpy.str_`` arrays and objects; lists; an all-None
column; columns mixing 1 / 1.0 / True / "1", float NaN, bytes or an
unhashable cell, which are masked cell by cell; and all-distinct strings;
each at 0, 1 and 65,536 rows. The mixed cell's own batches
(``bench/frozen_mixed.py``) on three seeds agree too, and each call opens
one ``engines/encode_objects`` span over its object columns. A string the
vocabulary repeats takes its first index, as in the reference's
``BatchEncoder``.
"""
from __future__ import annotations

import numpy as np
import pytest

from bench import frozen_mixed, harness
from repro_torch.core import dataspec as ds
from repro_torch.obs import trace
from test_torch_encoder_typed import SPAN, assert_same_bits, encoders, \
    reference_pair

ROWS = (0, 1, 65_536)
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


# name -> column of n rows from a seed
CASES = {
    "str_none": lambda n, s: np.array(
        draw(["red", "green", "blue", None], n, s), dtype=object),
    "missing_tokens": lambda n, s: np.array(draw(
        [" NA ", "Null", "?", "", "  ", "N/A", "nan", "NaN", "none",
         "None ", "None", "red", "na"], n, s), dtype=object),
    "out_of_vocabulary": lambda n, s: np.array(draw(
        ["red", "purple", "Red", " red", "red ", ds.OOD, "violet", None,
         "x  y", "x y"], n, s), dtype=object),
    "numeric_strings": lambda n, s: np.array(draw(
        ["1.5", "-nan", "nan", "1", "2", "inf", "-0", "1e3", None], n, s),
        dtype=object),
    "numpy_str_array": lambda n, s: np.array(
        draw(["red", "blue", "NA", "x y", "1.5", "?"], n, s), dtype=str),
    "numpy_str_objects": lambda n, s: np.array(
        [np.str_(v) for v in draw(["red", "green", "nan", "1"], n, s)],
        dtype=object),
    "list": lambda n, s: draw(["green", None, "1.5", "Null", "zz"], n, s),
    "all_none": lambda n, s: [None] * n,
    "mixed_types": lambda n, s: np.array(draw(
        [1, 1.0, True, "1", float("nan"), None, "red", 1.5, "True"], n, s),
        dtype=object),
    "bytes": lambda n, s: np.array(
        draw([b"red", "red", None], n, s), dtype=object),
    "unhashable": lambda n, s: np.array(
        draw([{"a": 1}, "red", None, "blue"], n, s), dtype=object),
    "all_distinct": all_distinct,
}


def distinct_objects(col) -> int:
    return len(dict.fromkeys(np.asarray(col, dtype=object).tolist()))


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_column_matches_both_oracles(case, rows):
    make = CASES[case]
    enc, ref = encoders(spec(), ["c"])
    batch = {"c": make(rows, rows + 3)}
    with trace.capture() as tr:
        got = enc.encode(batch)
    assert got.shape == (rows, 1)
    assert_same_bits(got, *reference_pair(ref, batch))
    assert [s.args for s in tr.find(SPAN)] == [{"rows": rows, "cols": 1}]


def test_repeated_vocabulary_string_takes_its_first_index():
    """Where a vocabulary repeats a string, the reference's two encoders
    disagree (``BatchEncoder`` takes the first index, ``encode_dataset``
    the last); the port's encoders both take the first."""
    col = ds.Column(name="c", semantic=ds.Semantic.CATEGORICAL,
                    vocab=[ds.OOD, "a", "b", "a"])
    enc, ref = encoders(ds.DataSpec(columns={"c": col}, n_rows=4), ["c"])
    batch = {"c": ["a", "b", None, "z", "a"]}
    want, ref_dataset = reference_pair(ref, batch)
    assert want.ravel().tolist() == [1, 2, 1, 0, 1]
    assert ref_dataset.ravel().tolist() == [3, 2, 1, 0, 3]
    dataset = ds.encode_dataset(batch, enc.spec)
    assert dataset.categorical["c"].tolist() == [1, 2, -1, 0, 1]
    assert_same_bits(enc.encode(batch), want)
    assert_same_bits(ds.raw_matrix(dataset, ["c"]), want)


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
    assert_same_bits(got, *reference_pair(ref, batch))
    assert len(MIXED["categorical"]) == 8
    assert [s.args for s in tr.find(SPAN)] == [{"rows": 65_536, "cols": 8}]


def test_mixed_cell_counters_per_call():
    """Each call opens its own ``engines/encode_objects`` span over its 8
    categorical columns, and a call whose categorical columns come as
    lists gives the same bits."""
    enc, ref = mixed_encoders(5)
    batch = frozen_mixed.adult_rows(MIXED, 4_096, 5, 101, labels=False)
    lists = {k: v.tolist() if v.dtype == object else v
             for k, v in batch.items()}
    with trace.capture() as tr:
        a = enc.encode(batch)
        b = enc.encode(lists)
    assert [s.args for s in tr.find(SPAN)] == [{"rows": 4_096, "cols": 8}] * 2
    per = sum(distinct_objects(batch[c]) for c in MIXED["categorical"])
    assert per <= 8 * 42                         # at most 41 values + None
    assert_same_bits(a, b, *reference_pair(ref, batch))
