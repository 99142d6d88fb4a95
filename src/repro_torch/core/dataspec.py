"""Data specification and the compiled request encoder (paper §3.4, §5.1).

The port's copy of the serving half of ``repro.core.dataspec``: the
``DataSpec`` a model was trained with (read from the JSON form that
``repro.core.dataspec.spec_to_dict`` writes, the same as ``dataspec.json``
in a saved model directory) and ``BatchEncoder``, which turns raw request
columns into the (N, F) float32 matrix the traversal engines consume:

  * numerical   -> float32, missing imputed with the column mean
  * categorical -> dictionary code (0 = out-of-dictionary), missing imputed
                   with the most frequent value (code 1)
  * boolean     -> {0, 1}, missing imputed with 1 when the column has a
                   dictionary, else 0

The encoding is host numpy, as in the reference: bit-identical codes are
what make the served predictions equal the reference's.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.api import YdfError

OOD = "<OOD>"


class Semantic(enum.Enum):
    NUMERICAL = "NUMERICAL"
    CATEGORICAL = "CATEGORICAL"
    BOOLEAN = "BOOLEAN"


@dataclass
class Column:
    name: str
    semantic: Semantic
    # categorical
    vocab: list[str] = field(default_factory=list)  # vocab[0] == OOD
    counts: dict[str, int] = field(default_factory=dict)
    # numerical
    mean: float = 0.0
    std: float = 0.0
    min: float = 0.0
    max: float = 0.0
    n_missing: int = 0
    manually_defined: bool = False

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)


@dataclass
class DataSpec:
    columns: dict[str, Column]
    n_rows: int

    def __getitem__(self, name: str) -> Column:
        return self.columns[name]


def spec_from_dict(raw: dict) -> DataSpec:
    """DataSpec from its JSON form (``dataspec.json``)."""
    cols = {}
    for name, c in raw["columns"].items():
        c = dict(c)
        c["semantic"] = Semantic(c["semantic"])
        cols[name] = Column(name=name,
                            **{k: v for k, v in c.items() if k != "name"})
    return DataSpec(columns=cols, n_rows=raw["n_rows"])


# ------------------------------------------------------ raw-value parsing

_MISSING_TOKENS = {"", "na", "n/a", "nan", "none", "null", "?"}
_MISSING_TOKEN_ARR = np.array(sorted(_MISSING_TOKENS))


def _is_missing(v) -> bool:
    if v is None:
        return True
    if isinstance(v, float) and np.isnan(v):
        return True
    return isinstance(v, str) and v.strip().lower() in _MISSING_TOKENS


def _try_float(v) -> float | None:
    try:
        return float(v)
    except (TypeError, ValueError):
        return None


def _missing_mask(vals: np.ndarray) -> np.ndarray:
    """Vectorized ``_is_missing`` over a raw object column.

    Numeric path: one bulk float conversion (numpy maps None -> NaN) and an
    isnan; NaN-parsing strings that are NOT missing tokens (e.g. "-nan") are
    re-checked cell-by-cell so the result matches ``_is_missing`` exactly.
    String path (bulk conversion fails): match the stripped, lowercased
    string forms against the missing tokens — str(None) is "none" and
    str(nan) is "nan", both tokens, so non-string missing cells still hit.
    """
    try:
        miss = np.isnan(vals.astype(np.float64))
    except (TypeError, ValueError):
        s = np.char.lower(np.char.strip(vals.astype(str)))
        return np.isin(s, _MISSING_TOKEN_ARR)
    if miss.any():
        for i in np.where(miss)[0]:
            v = vals[i]
            if v is None or isinstance(v, float):
                continue  # genuinely missing; skip the per-cell re-check
            if not _is_missing(v):
                miss[i] = False
    return miss


def _parse_numerical(vals: np.ndarray) -> np.ndarray:
    """Raw object column -> float32 with NaN for missing/unparsable."""
    try:
        return vals.astype(np.float64).astype(np.float32)
    except (TypeError, ValueError):
        out = np.full(len(vals), np.nan, np.float32)
        for i, v in enumerate(vals):
            if not _is_missing(v):
                f = _try_float(v)
                out[i] = np.nan if f is None else f
        return out


def _parse_boolean(vals: np.ndarray) -> np.ndarray:
    """Raw object column -> int32 {0, 1} with -1 for missing."""
    miss = _missing_mask(vals)
    s = np.char.lower(np.char.strip(vals.astype(str)))
    out = np.isin(s, ("1", "1.0", "true")).astype(np.int32)
    out[miss] = -1
    return out


# ------------------------------------------- compiled row encoding (§5.1)

class BatchEncoder:
    """Vectorized raw->code tables, compiled once per (spec, features).

      numerical   -> bulk float cast + the column's mean as imputation value
      boolean     -> truthy-string table, missing -> the fill value
      categorical -> sorted-vocab ``searchsorted`` table with the matching
                     code permutation; out-of-dictionary -> 0 (OOD), missing
                     -> most-frequent (code 1)

    ``encode`` needs only the feature columns (requests carry no label) and
    returns the (N, F) float32 matrix the reference's ``BatchEncoder``
    returns for the same columns.
    """

    def __init__(self, spec: DataSpec, features: list[str]):
        self.spec = spec
        self.features = list(features)
        self._plan: list[tuple] = []
        for name in self.features:
            col = spec[name]
            if col.semantic == Semantic.NUMERICAL:
                self._plan.append(("num", name, np.float32(col.mean), None, None))
            elif col.semantic == Semantic.BOOLEAN:
                fill = np.float32(1.0 if col.vocab_size > 1 else 0.0)
                self._plan.append(("bool", name, fill, None, None))
            else:
                vocab = np.asarray(col.vocab, dtype=str)
                order = np.argsort(vocab, kind="stable")
                fill = np.float32(1.0 if col.vocab_size > 1 else 0.0)
                self._plan.append(("cat", name, fill, vocab[order],
                                   order.astype(np.int32)))

    def encode(self, data) -> np.ndarray:
        """data: raw column mapping (feature columns suffice) ->
        (N, F) float32 matrix."""
        missing = [n for n in self.features if n not in data]
        if missing:
            raise YdfError(
                f"Feature column(s) {missing} are missing from the request "
                f"batch. The model requires: {self.features}.")
        first = np.asarray(data[self.features[0]], dtype=object).ravel() \
            if self.features else np.zeros(0, object)
        X = np.empty((len(first), len(self.features)), np.float32)
        for j, (kind, name, fill, sorted_vocab, codes) in enumerate(self._plan):
            vals = np.asarray(data[name], dtype=object).ravel()
            if len(vals) != len(first):
                raise YdfError(
                    f"Feature column {name!r} has {len(vals)} values but "
                    f"{self.features[0]!r} has {len(first)}; request batches "
                    "must be rectangular.")
            if kind == "num":
                v = _parse_numerical(vals)
                v[np.isnan(v)] = fill
            elif kind == "bool":
                v = _parse_boolean(vals).astype(np.float32)
                v[v < 0] = fill
            else:
                miss = _missing_mask(vals)
                s = vals.astype(str)
                pos = np.searchsorted(sorted_vocab, s)
                pos_c = np.minimum(pos, len(sorted_vocab) - 1)
                found = sorted_vocab[pos_c] == s
                v = np.where(found, codes[pos_c], 0).astype(np.float32)
                v[miss] = fill
            X[:, j] = v
        return X
