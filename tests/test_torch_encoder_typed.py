"""``BatchEncoder``'s typed path: NUMERICAL features whose columns are numpy
arrays of booleans, integers or floats are encoded in one vectorised pass.

Every case holds the port's encoder bit for bit (the float32 words, so
-0.0 and 0.0 differ) to the JAX package's two encoders on the same spec:
``repro.core.dataspec.BatchEncoder`` and ``raw_matrix(encode_dataset)``.
The cases cover each numeric dtype with NaN, infinities, -0.0 and values
whose float32 differs when cast straight from int64; (n,) and (n, 1)
columns; batches that mix typed columns with lists, object arrays,
strings and BOOLEAN and CATEGORICAL features; 0, 1 and 65,536 rows.
Ragged batches and missing features raise the reference's errors, and
only the columns off the typed path open an ``engines/encode_objects``
span, which counts them in ``cols``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from repro.core import dataspec as ref_ds
from repro.core.api import YdfError as RefYdfError
from repro.core.models import raw_matrix as ref_raw_matrix
from repro_torch.core import dataspec as ds
from repro_torch.core.api import YdfError
from repro_torch.obs import trace

ROWS = (0, 1, 65_536)
SHAPES = ("flat", "column")            # (n,) and (n, 1)
SPAN = "engines/encode_objects"

# the float32 of each differs when cast straight from int64 and when cast
# through float64 (double rounding), so they prove the path goes through
# float64 as the object path does
INT64_EDGES = [2**60 + 2**36 + 1, -(2**60 + 2**36 + 1), 2**53 + 1,
               2**63 - 1, -(2**63), 0]
FLOAT_EDGES = [np.nan, np.inf, -np.inf, -0.0, 0.0, 1e300, -1e300, 1e-46,
               3.4028235e38, 1.0000000596046448, np.nan]


def encoders(spec: ds.DataSpec, features: list[str]):
    """The port's encoder and the JAX package's, on the same spec."""
    ref_spec = ref_ds.spec_from_dict(ds.spec_to_dict(spec))
    return (ds.BatchEncoder(spec, features),
            ref_ds.BatchEncoder(ref_spec, features))


def reference_pair(ref: ref_ds.BatchEncoder, data) -> tuple:
    """The JAX package's two encodes of a batch's feature columns: its
    ``BatchEncoder`` and ``raw_matrix(encode_dataset)`` over the spec's
    feature columns."""
    spec = dataclasses.replace(
        ref.spec, columns={n: ref.spec[n] for n in ref.features})
    return (ref.encode(data),
            ref_raw_matrix(ref_ds.encode_dataset(data, spec), ref.features))


def span_cols(tr) -> list:
    """The ``cols`` arg of each ``engines/encode_objects`` span."""
    return [s.args["cols"] for s in tr.find(SPAN)]


def numerical_spec(names, means) -> ds.DataSpec:
    cols = {n: ds.Column(name=n, semantic=ds.Semantic.NUMERICAL, mean=m)
            for n, m in zip(names, means)}
    return ds.DataSpec(columns=cols, n_rows=100)


def typed_column(dtype: str, n: int, seed: int) -> np.ndarray:
    r = np.random.default_rng(seed)
    if dtype == "bool":
        return r.random(n) < 0.5
    if np.dtype(dtype).kind in "iu":
        info = np.iinfo(dtype)
        v = r.integers(info.min, info.max, n, dtype=dtype, endpoint=True)
        edges = [e for e in INT64_EDGES if info.min <= e <= info.max]
    else:
        v = (r.standard_normal(n) * 1e3).astype(dtype)
        v[r.random(n) < 0.05] = np.nan
        with np.errstate(over="ignore"):
            edges = np.array(FLOAT_EDGES).astype(dtype)
    k = min(n, len(edges))
    v[:k] = np.asarray(edges[:k], dtype=dtype)
    return v


def assert_same_bits(got: np.ndarray, *wants: np.ndarray) -> None:
    assert got.dtype == np.float32 and got.flags.c_contiguous
    assert not np.isnan(got).any()
    for want in wants:
        want = np.asarray(want)
        assert want.dtype == np.float32 and got.shape == want.shape
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("dtype", ["float64", "float32", "float16", "int64",
                                   "int32", "uint8", "bool"])
def test_typed_column_matches_both_oracles(dtype, rows, shape):
    spec = numerical_spec(["x", "y"], [0.1234567891, -2.5e-3])
    enc, ref = encoders(spec, ["x", "y"])
    x = typed_column(dtype, rows, seed=rows + 1)
    y = typed_column("float64", rows, seed=rows + 2)
    if shape == "column":
        x, y = x.reshape(-1, 1), y.reshape(-1, 1)
    batch = {"x": x, "y": y}
    with trace.capture() as tr:
        got = enc.encode(batch)
    assert got.shape == (rows, 2)
    assert_same_bits(got, *reference_pair(ref, batch))
    assert span_cols(tr) == []


def mixed_spec() -> ds.DataSpec:
    num = ds.Semantic.NUMERICAL
    cols = {n: ds.Column(name=n, semantic=num, mean=m) for n, m in
            [("a", 0.5), ("b", -7.25), ("c", 1.0 / 3.0), ("d", 2.0),
             ("g", -0.1), ("h", 9.0), ("i", 4.5), ("k", 1e-3)]}
    cols["e"] = ds.Column(name="e", semantic=ds.Semantic.CATEGORICAL,
                          vocab=[ds.OOD, "red", "green", "blue"],
                          counts={"red": 5, "green": 3, "blue": 2})
    cols["f"] = ds.Column(name="f", semantic=ds.Semantic.BOOLEAN,
                          vocab=[ds.OOD, "true"])
    cols["j"] = ds.Column(name="j", semantic=ds.Semantic.BOOLEAN)
    return ds.DataSpec(columns=cols, n_rows=10)


MIXED = list("abcdefghijk")
MIXED_OBJECTS = 7                      # all but a, b, g and k


def mixed_batch(n: int, seed: int) -> dict:
    r = np.random.default_rng(seed)
    pick = lambda opts: [opts[i] for i in r.integers(0, len(opts), n)]
    wide = typed_column("float64", 3 * n, seed).reshape(n, 3)
    return {
        "a": typed_column("float64", n, seed),
        "b": typed_column("int64", n, seed + 1).reshape(-1, 1),
        "c": pick([1.5, None, "nan", "3.25", -0.0, "", 7]),
        "d": np.array(pick([2.5, None, np.nan, -1e300, 4]), dtype=object),
        "e": pick(["red", "green", "blue", "purple", None, "NA"]),
        "f": r.random(n) < 0.5,                      # BOOLEAN: object path
        "g": typed_column("float32", n, seed + 2),
        "h": (r.standard_normal(n) + 1j).astype(np.complex128),
        "i": np.array(pick(["1.5", "nan", "-2", "x"]), dtype=str),
        "j": pick(["true", "false", None, "1", "0"]),
        "k": wide[:, 1],                             # a strided column
    }


@pytest.mark.parametrize("rows", ROWS)
def test_mixed_batch_matches_both_oracles(rows):
    enc, ref = encoders(mixed_spec(), MIXED)
    batch = mixed_batch(rows, seed=rows + 11)
    with trace.capture() as tr:
        got = enc.encode(batch)
    assert got.shape == (rows, len(MIXED))
    assert_same_bits(got, *reference_pair(ref, batch))
    assert [s.args for s in tr.find(SPAN)] == \
        [{"rows": rows, "cols": MIXED_OBJECTS}]


def ragged_batches() -> dict:
    n = 6
    ok = typed_column("float64", n, 1)
    return {
        "typed": {"x": ok, "y": ok[:-1], "z": ok},
        "typed_first_short": {"x": ok[:-2], "y": ok, "z": list(ok)},
        "list": {"x": ok, "y": ok, "z": list(ok) + [1.0]},
        "column_2d": {"x": ok, "y": np.tile(ok, 2).reshape(n, 2), "z": ok},
    }


@pytest.mark.parametrize("case", sorted(ragged_batches()))
def test_ragged_batch_raises_as_before(case):
    names = ["x", "y", "z"]
    enc, ref = encoders(numerical_spec(names, [0.0, 1.0, 2.0]), names)
    batch = ragged_batches()[case]
    with pytest.raises(YdfError) as got:
        enc.encode(batch)
    with pytest.raises(RefYdfError) as ref_got:
        ref.encode(batch)
    assert "rectangular" in str(got.value)
    assert str(got.value) == str(ref_got.value)


@pytest.mark.parametrize("kind", ["typed", "lists"])
def test_missing_feature_raises_as_before(kind):
    names = ["x", "y", "z"]
    enc, ref = encoders(numerical_spec(names, [0.0, 1.0, 2.0]), names)
    col = typed_column("float64", 4, 3)
    batch = {"x": col, "z": col} if kind == "typed" \
        else {"x": list(col), "z": list(col)}
    with pytest.raises(YdfError) as got:
        enc.encode(batch)
    with pytest.raises(RefYdfError) as ref_got:
        ref.encode(batch)
    assert "['y']" in str(got.value)
    assert str(got.value) == str(ref_got.value)


@pytest.mark.parametrize("rows", [1, 52, 300])
def test_counter_reads_typed_columns_per_call(rows):
    """Typed columns open no ``engines/encode_objects`` span; the same
    values as lists open one a call, of 28 columns."""
    names = [f"num_{j}" for j in range(28)]
    enc, ref = encoders(numerical_spec(names, np.linspace(-1, 1, 28)),
                        names)
    typed = {n: typed_column("float64", rows, j) for j, n in enumerate(names)}
    lists = {n: list(v) for n, v in typed.items()}
    with trace.capture() as tr:
        a = enc.encode(typed)
        b = enc.encode(typed)
    assert span_cols(tr) == []
    with trace.capture() as tr:
        c = enc.encode(lists)
    assert [s.args for s in tr.find(SPAN)] == [{"rows": rows, "cols": 28}]
    assert_same_bits(a, b, c, *reference_pair(ref, typed))
