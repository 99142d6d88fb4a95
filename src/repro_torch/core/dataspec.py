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
Training-time and serving-time encodes share one column parse
(``_columns`` then ``_parse``) and one fill rule (``_fill``, behind
``raw_matrix`` and ``BatchEncoder.encode``), so they cannot drift apart.
"""
from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass, field
from typing import Any, Mapping

import numpy as np

from repro_torch.core.api import Task, YdfError
from repro_torch.obs import trace

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

    # show_dataspec analogue (§4.1 artefacts)
    def report(self) -> str:
        by_sem: dict[str, list[Column]] = {}
        for c in self.columns.values():
            by_sem.setdefault(c.semantic.value, []).append(c)
        lines = [f"Number of records: {self.n_rows}",
                 f"Number of columns: {len(self.columns)}", ""]
        for sem, cols in sorted(by_sem.items()):
            pct = 100.0 * len(cols) / max(1, len(self.columns))
            lines.append(f"{sem}: {len(cols)} ({pct:.0f}%)")
            for c in sorted(cols, key=lambda c: c.name):
                if c.semantic == Semantic.NUMERICAL:
                    lines.append(
                        f'  "{c.name}" NUMERICAL mean:{c.mean:g} min:{c.min:g} '
                        f"max:{c.max:g} sd:{c.std:g} nas:{c.n_missing}")
                else:
                    top = max(c.counts, key=c.counts.get) if c.counts else "-"
                    lines.append(
                        f'  "{c.name}" {c.semantic.value} has-dict '
                        f"vocab-size:{c.vocab_size} most-frequent:{top!r} "
                        f"nas:{c.n_missing}"
                        + (" manually-defined" if c.manually_defined else ""))
        return "\n".join(lines)


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


_STR_KEYS = {str, np.str_, type(None)}


def _vocab_table(col: Column) -> tuple[np.ndarray, np.ndarray]:
    """A CATEGORICAL column's vocabulary, sorted, and each entry's code: a
    string the vocabulary repeats takes its first index. An empty
    vocabulary codes every value 0 (out-of-dictionary)."""
    vocab = np.asarray(col.vocab or [OOD], dtype=str)
    order = np.argsort(vocab, kind="stable")
    return vocab[order], order.astype(np.int32)


def _codes(vals: np.ndarray, table: tuple[np.ndarray, np.ndarray]
           ) -> np.ndarray:
    """Raw object column -> int32 dictionary codes (0 = out-of-dictionary)
    with -1 for missing, through ``_vocab_table``'s ``table``.

    A column whose objects are all ``str`` (or ``numpy.str_``) and None is
    factorised first: its distinct objects are masked and looked up once
    and the codes gathered (where no object repeats, the column is its own
    distinct objects, in order). Any other column is masked cell by cell
    on its own objects: 1, 1.0 and True hash as equal although their
    ``str`` forms differ, and in ``[numpy.float32("nan"), 1.0]`` the first
    cell is not missing as an object but is as the string "nan".
    """
    inv = None
    seq = vals.tolist()
    try:
        index = dict.fromkeys(seq)
    except TypeError:                    # an unhashable cell
        index = None
    if index is not None and len(index) < len(seq) \
            and set(map(type, index)) <= _STR_KEYS:
        keys = list(index)
        index = dict(zip(keys, range(len(keys))))
        inv = np.fromiter(map(index.__getitem__, seq), np.intp, len(seq))
        vals = np.array(keys, dtype=object)
    miss = _missing_mask(vals)
    s = vals.astype(str)
    sorted_vocab, codes = table
    pos = np.minimum(np.searchsorted(sorted_vocab, s), len(sorted_vocab) - 1)
    out = np.where(sorted_vocab[pos] == s, codes[pos], 0).astype(np.int32)
    out[miss] = -1
    return out if inv is None else out[inv]


def _columns(data: Mapping[str, Any], names: list[str],
             numerical: list[bool]) -> tuple[list[np.ndarray], list[int]]:
    """The raw columns ``names``, flat, and the indices of those left to
    ``_parse``: a NUMERICAL column (``numerical``) that is a numpy array of
    booleans, integers or floats takes the typed cast to float64 (as
    ``_parse_numerical`` goes); every other column becomes Python
    objects."""
    cols, rest = [], []
    for j, (name, num) in enumerate(zip(names, numerical)):
        raw = data[name]
        if num and isinstance(raw, np.ndarray) and raw.dtype.kind in "biuf":
            cols.append(np.asarray(raw, dtype=np.float64).ravel())
        else:
            cols.append(np.asarray(raw, dtype=object).ravel())
            rest.append(j)
    return cols, rest


def _parse(vals: np.ndarray, col: Column,
           table: tuple[np.ndarray, np.ndarray] | None = None) -> np.ndarray:
    """An object column from ``_columns`` -> float32 with NaN for missing
    (NUMERICAL) or int32 codes with -1 for missing (BOOLEAN; CATEGORICAL
    through ``table``, by default built from ``col``)."""
    if col.semantic == Semantic.NUMERICAL:
        return _parse_numerical(vals)
    if col.semantic == Semantic.BOOLEAN:
        return _parse_boolean(vals)
    return _codes(vals, _vocab_table(col) if table is None else table)


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

    def subset(self, idx: np.ndarray) -> "VerticalDataset":
        return VerticalDataset(
            spec=self.spec,
            numerical={k: v[idx] for k, v in self.numerical.items()},
            categorical={k: v[idx] for k, v in self.categorical.items()},
            n_rows=len(idx),
        )


def encode_dataset(data: Mapping[str, Any], spec: DataSpec) -> VerticalDataset:
    names, specs = list(spec.columns), list(spec.columns.values())
    for name in names:
        if name not in data:
            raise YdfError(
                f"Column {name!r} of the dataspec is missing from the dataset. "
                "Solutions: (1) provide the column, or (2) re-infer the dataspec "
                "on this dataset.")
    cols, rest = _columns(data, names,
                          [c.semantic == Semantic.NUMERICAL for c in specs])
    for j in rest:
        cols[j] = _parse(cols[j], specs[j])
    numerical, categorical = {}, {}
    for name, col, vals in zip(names, specs, cols):
        if col.semantic == Semantic.NUMERICAL:
            numerical[name] = vals.astype(np.float32, copy=False)
        else:
            categorical[name] = vals
    return VerticalDataset(spec=spec, numerical=numerical,
                           categorical=categorical,
                           n_rows=len(cols[-1]) if cols else 0)


def dataset_from_raw(data: Mapping[str, Any], **kw) -> VerticalDataset:
    return encode_dataset(data, infer_dataspec(data, **kw))


def _fill_rule(spec: DataSpec, features: list[str]) -> list[tuple]:
    """Where ``_fill`` writes each feature and what replaces a missing
    value: the NUMERICAL features' indices and means, NaN marking a missing
    value; the others' indices and code 1 (the most frequent, since
    dictionaries are frequency-ordered) where a column has a dictionary,
    else 0, a negative code marking a missing value."""
    num, codes = ([], [], np.isnan), ([], [], np.signbit)
    for j, name in enumerate(features):
        col = spec[name]
        if col.semantic == Semantic.NUMERICAL:
            group, fill = num, col.mean
        else:
            group, fill = codes, 1.0 if col.vocab_size > 1 else 0.0
        group[0].append(j)
        group[1].append(fill)
    return [(idx, np.array(fill, np.float32)[:, None], missing)
            for idx, fill, missing in (num, codes) if idx]


def _fill(cols: list[np.ndarray], rule: list[tuple], n: int) -> np.ndarray:
    """Parsed columns -> the (n, F) float32 matrix, missing values imputed
    by ``_fill_rule``'s ``rule``: the NUMERICAL columns, then the code
    columns, each cast into one (k, n) block, its missing values replaced
    in one masked copy and the block written to X transposed."""
    X = np.empty((n, len(cols)), np.float32)
    for idx, fill, missing in rule:
        block = np.empty((len(idx), n), np.float32)
        np.concatenate([cols[j] for j in idx], out=block.reshape(-1),
                       casting="unsafe")
        np.copyto(block, fill, where=missing(block))
        # a basic slice where one block holds every column: numpy fills X
        # through it far faster than through a list of column indices
        X[:, idx if len(idx) < len(cols) else slice(None)] = block.T
    return X


def raw_matrix(ds: VerticalDataset, features: list[str]) -> np.ndarray:
    """Raw-value matrix with GLOBAL imputation from the dataspec."""
    return _fill([ds.column(name) for name in features],
                 _fill_rule(ds.spec, features), ds.n_rows)


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


def label_values(model, dataset) -> np.ndarray:
    """0-based class indices (classification) or float targets (regression),
    aligned with ``Model.predict`` output columns."""
    if isinstance(dataset, VerticalDataset):
        y = dataset.column(model.label)
        if model.task == Task.CLASSIFICATION:
            if (y <= 0).any():
                raise YdfError(
                    f'Label column "{model.label}" contains missing or '
                    "out-of-dictionary values; evaluation requires labeled "
                    "examples. Solution: filter unlabeled rows first.")
            return (y - 1).astype(np.int32)  # vocab[0] is OOD
        return y.astype(np.float32)
    raw = np.asarray(dataset[model.label], dtype=object).ravel()
    if model.task == Task.CLASSIFICATION:
        lookup = {str(v): i for i, v in enumerate(model.classes)}
        try:
            return np.array([lookup[str(v)] for v in raw], np.int32)
        except KeyError as e:
            raise YdfError(
                f"Label value {e.args[0]!r} was not seen during training. "
                f"Training classes: {model.classes}.")
    return np.array([float(v) for v in raw], np.float32)


# ------------------------------------------- compiled row encoding (§5.1)

class BatchEncoder:
    """Raw request columns -> the (N, F) float32 matrix, with the column
    parse and the fill rule of ``raw_matrix(encode_dataset(...))``, their
    vocabulary tables and fills built once per (spec, features).

    ``encode`` needs only the feature columns (requests carry no label) and
    returns the (N, F) float32 matrix the reference's ``BatchEncoder``
    returns for the same columns.
    """

    def __init__(self, spec: DataSpec, features: list[str]):
        self.spec = spec
        self.features = list(features)
        self._specs = [spec[name] for name in self.features]
        self._numerical = [c.semantic == Semantic.NUMERICAL
                           for c in self._specs]
        self._tables = [_vocab_table(c) if c.semantic == Semantic.CATEGORICAL
                        else None for c in self._specs]
        self._rule = _fill_rule(spec, self.features)

    def encode(self, data) -> np.ndarray:
        """data: raw column mapping (feature columns suffice) or an
        already-encoded VerticalDataset (the meta-learners' folds) ->
        (N, F) float32 matrix.

        A NUMERICAL feature whose column is a numpy array of booleans,
        integers or floats takes the typed cast (``_columns``); every other
        column is parsed from Python objects inside an
        ``engines/encode_objects`` span (``cols``: how many). ``_fill``
        then writes X.
        """
        if isinstance(data, VerticalDataset):
            return raw_matrix(data, self.features)
        missing = [n for n in self.features if n not in data]
        if missing:
            raise YdfError(
                f"Feature column(s) {missing} are missing from the request "
                f"batch. The model requires: {self.features}.")
        cols, rest = _columns(data, self.features, self._numerical)
        n = len(cols[0]) if cols else 0
        for name, vals in zip(self.features, cols):
            if len(vals) != n:
                raise YdfError(
                    f"Feature column {name!r} has {len(vals)} values but "
                    f"{self.features[0]!r} has {n}; request batches must be "
                    "rectangular.")
        if rest:
            with trace.span("engines/encode_objects", rows=n,
                            cols=len(rest)):
                for j in rest:
                    cols[j] = _parse(cols[j], self._specs[j], self._tables[j])
        return _fill(cols, self._rule, n)
