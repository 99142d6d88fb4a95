"""One raw-column encoder: the port's ``BatchEncoder.encode``,
``raw_matrix(encode_dataset)`` and ``encode_dataset``'s own columns, held
bit for bit to the JAX package's ``BatchEncoder.encode``,
``raw_matrix(encode_dataset)`` and ``encode_dataset``.

The batches are every CATEGORICAL case of ``test_torch_encoder_distinct``
and every NUMERICAL dtype and shape of ``test_torch_encoder_typed``, at 0,
1 and 65,536 rows. ``encode_dataset``'s columns keep NaN and -1 for
missing, so they are compared before any fill.
"""
from __future__ import annotations

import numpy as np
import pytest

from repro.core import dataspec as ref_ds
from repro_torch.core import dataspec as ds
from test_torch_encoder_distinct import CASES
from test_torch_encoder_distinct import spec as categorical_spec
from test_torch_encoder_typed import ROWS, SHAPES, assert_same_bits, \
    encoders, numerical_spec, reference_pair, typed_column

DTYPES = ("float64", "float32", "float16", "int64", "int32", "uint8", "bool")


def categorical_batch(case: str, rows: int):
    return categorical_spec(), ["c"], {"c": CASES[case](rows, rows + 3)}


def numerical_batch(dtype: str, shape: str, rows: int):
    x = typed_column(dtype, rows, seed=rows + 1)
    y = typed_column("float64", rows, seed=rows + 2)
    if shape == "column":
        x, y = x.reshape(-1, 1), y.reshape(-1, 1)
    spec = numerical_spec(["x", "y"], [0.1234567891, -2.5e-3])
    return spec, ["x", "y"], {"x": x, "y": y}


BATCHES = {f"cat-{c}": (categorical_batch, (c,)) for c in sorted(CASES)} | {
    f"num-{d}-{s}": (numerical_batch, (d, s)) for d in DTYPES for s in SHAPES}


def assert_same_columns(got: dict, want: dict) -> None:
    assert list(got) == list(want)
    for name, v in want.items():
        assert got[name].dtype == v.dtype and got[name].shape == v.shape
        assert got[name].tobytes() == v.tobytes(), name


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("batch", sorted(BATCHES))
def test_encoders_match_the_reference_pair(batch, rows):
    make, args = BATCHES[batch]
    spec, features, raw = make(*args, rows)
    enc, ref = encoders(spec, features)
    dataset = ds.encode_dataset(raw, spec)
    ref_dataset = ref_ds.encode_dataset(raw, ref.spec)
    assert dataset.n_rows == ref_dataset.n_rows == rows
    assert_same_columns(dataset.numerical, ref_dataset.numerical)
    assert_same_columns(dataset.categorical, ref_dataset.categorical)
    got = enc.encode(raw)
    assert got.shape == (rows, len(features))
    assert_same_bits(got, *reference_pair(ref, raw))
    assert_same_bits(ds.raw_matrix(dataset, features), got)
    assert_same_bits(enc.encode(dataset), got)
