"""Data specification, dataset encoding and the compiled request encoder
(paper §3.4, §5.1), the port's copy of ``repro.core.dataspec``.

Training side: ``infer_dataspec`` infers column semantics and dictionaries
from raw columns, and ``encode_dataset`` / ``dataset_from_raw`` turn raw
columns into a ``VerticalDataset`` (float32 numericals with NaN for
missing, int32 dictionary codes with -1 for missing). Serving side: the
``DataSpec`` a model was trained with (also read from the JSON form that
``spec_to_dict`` writes, the same as ``dataspec.json`` in a saved model
directory) and ``BatchEncoder``, which turns raw request columns into the
(N, F) float32 matrix the traversal engines consume:

  * numerical   -> float32, missing imputed with the column mean
  * categorical -> dictionary code (0 = out-of-dictionary), missing imputed
                   with the most frequent value (code 1)
  * boolean     -> {0, 1}, missing imputed with 1 when the column has a
                   dictionary, else 0

The encoding is host numpy, as in the reference: bit-identical codes are
what make trained models and served predictions equal the reference's.
Training-time and serving-time encodes share ``_parse_numerical`` and
``_parse_boolean``, so they cannot drift apart.
"""
from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass, field
from typing import Any, Mapping

import numpy as np

from repro_torch.core.api import Task, YdfError

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

    def feature_names(self, label: str | None = None,
                      features: list[str] | None = None,
                      exclude: list[str] | tuple[str, ...] = ()) -> list[str]:
        """``exclude`` drops task side-channel columns (ranking group,
        uplift treatment) from the default feature set."""
        if features is not None:
            missing = [f for f in features if f not in self.columns]
            if missing:
                raise YdfError(
                    f"Input feature(s) {missing} not found in the dataset. "
                    f"Available columns: {sorted(self.columns)}.")
            return list(features)
        drop = {label, *exclude}
        return [c for c in self.columns if c not in drop]


def spec_to_dict(spec: DataSpec) -> dict:
    """The stable JSON form of a DataSpec (``dataspec.json``)."""
    out = {"n_rows": spec.n_rows, "columns": {}}
    for name, c in spec.columns.items():
        d = dataclasses.asdict(c)
        d["semantic"] = c.semantic.value
        out["columns"][name] = d
    return out


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


# ----------------------------------------------------------------- inference

def infer_dataspec(data: Mapping[str, Any], *,
                   semantics: Mapping[str, Semantic | str] | None = None,
                   max_vocab: int = 2048, min_vocab_frequency: int = 1) -> DataSpec:
    """Infer column semantics from raw columns (lists / object arrays).

    Heuristics: numeric dtypes -> NUMERICAL; strings -> CATEGORICAL
    (numeric-looking strings stay CATEGORICAL only if non-numeric values are
    present); bools / {0,1}-only numbers -> BOOLEAN. ``semantics``
    overrides win and are flagged ``manually-defined``.
    """
    semantics = dict(semantics or {})
    columns: dict[str, Column] = {}
    n_rows = None
    for name, raw in data.items():
        vals = np.asarray(raw, dtype=object).ravel()
        if n_rows is None:
            n_rows = len(vals)
        elif len(vals) != n_rows:
            raise YdfError(
                f"Column {name!r} has {len(vals)} values but previous columns "
                f"have {n_rows}. All columns must have the same length.")
        missing = _missing_mask(vals)
        present = vals[~missing]
        override = semantics.get(name)
        if override is not None:
            sem = Semantic(override) if not isinstance(override, Semantic) else override
        else:
            sem = _infer_semantic(present)
        col = Column(name=name, semantic=sem, n_missing=int(missing.sum()),
                     manually_defined=override is not None)
        if sem == Semantic.NUMERICAL:
            try:
                fs = present.astype(np.float64)
            except (TypeError, ValueError):
                bad = [v for v in present if _try_float(v) is None]
                raise YdfError(
                    f"Column {name!r} is NUMERICAL but contains non-numeric "
                    f"value(s) e.g. {bad[:3]}. Solutions: (1) declare the column "
                    f"CATEGORICAL via semantics={{{name!r}: 'CATEGORICAL'}}, or "
                    "(2) clean the values.")
            if fs.size:
                col.mean, col.std = float(fs.mean()), float(fs.std())
                col.min, col.max = float(fs.min()), float(fs.max())
        elif sem == Semantic.CATEGORICAL:
            uniq, cnt = np.unique(present.astype(str), return_counts=True)
            order = np.argsort(-cnt, kind="stable")
            vocab = [OOD]
            counts = {}
            for i in order:
                if cnt[i] >= min_vocab_frequency and len(vocab) < max_vocab:
                    vocab.append(str(uniq[i]))
                    counts[str(uniq[i])] = int(cnt[i])
            col.vocab = vocab
            col.counts = counts
        columns[name] = col
    return DataSpec(columns=columns, n_rows=n_rows or 0)


def _infer_semantic(present: np.ndarray) -> Semantic:
    if present.size == 0:
        return Semantic.NUMERICAL
    if all(isinstance(v, (bool, np.bool_)) for v in present[:100]):
        return Semantic.BOOLEAN
    try:
        floats = present.astype(np.float64)  # all-parseable or ValueError
    except (TypeError, ValueError):
        return Semantic.CATEGORICAL
    if np.isin(floats[:1000], (0.0, 1.0)).all():
        return Semantic.BOOLEAN
    return Semantic.NUMERICAL


# ----------------------------------------------------------------- encoding

@dataclass
class VerticalDataset:
    spec: DataSpec
    numerical: dict[str, np.ndarray]    # float32, NaN = missing
    categorical: dict[str, np.ndarray]  # int32, -1 = missing, 0 = OOD
    n_rows: int

    def column(self, name: str) -> np.ndarray:
        if name in self.numerical:
            return self.numerical[name]
        return self.categorical[name]


def encode_dataset(data: Mapping[str, Any], spec: DataSpec) -> VerticalDataset:
    numerical: dict[str, np.ndarray] = {}
    categorical: dict[str, np.ndarray] = {}
    n_rows = 0
    for name, col in spec.columns.items():
        if name not in data:
            raise YdfError(
                f"Column {name!r} of the dataspec is missing from the dataset. "
                "Solutions: (1) provide the column, or (2) re-infer the dataspec "
                "on this dataset.")
        vals = np.asarray(data[name], dtype=object).ravel()
        n_rows = len(vals)
        if col.semantic == Semantic.NUMERICAL:
            numerical[name] = _parse_numerical(vals)
        elif col.semantic == Semantic.BOOLEAN:
            categorical[name] = _parse_boolean(vals)
        else:
            lookup = {v: i for i, v in enumerate(col.vocab)}
            miss = _missing_mask(vals)
            uq, inv = np.unique(vals.astype(str), return_inverse=True)
            code_of = np.fromiter((lookup.get(u, 0) for u in uq),
                                  np.int32, len(uq))  # 0 = OOD
            out = code_of[inv.reshape(len(vals))]
            out[miss] = -1
            categorical[name] = out
    return VerticalDataset(spec=spec, numerical=numerical,
                           categorical=categorical, n_rows=n_rows)


def dataset_from_raw(data: Mapping[str, Any], **kw) -> VerticalDataset:
    return encode_dataset(data, infer_dataspec(data, **kw))


def check_classification_label(col: Column, task: Task) -> None:
    """The paper's §2.2 safety check: a classification label that looks like
    a regression target is refused with directions."""
    if col.semantic == Semantic.NUMERICAL:
        raise YdfError(
            f'The classification label column "{col.name}" is NUMERICAL '
            f"({col.mean:.4g} mean over a [{col.min:g}, {col.max:g}] range) and "
            "looks like a regression target. Solutions: (1) configure the "
            "training as a regression with task=REGRESSION, or (2) declare the "
            "label CATEGORICAL explicitly if the numbers are class ids.")
    n_classes = col.vocab_size - 1
    if n_classes > 0.5 * 10_000 and n_classes > 100:
        raise YdfError(
            f'The classification label column "{col.name}" has {n_classes} '
            "unique values and looks like a regression column. Solutions: (1) "
            "use task=REGRESSION, or (2) reduce the label cardinality.")


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
