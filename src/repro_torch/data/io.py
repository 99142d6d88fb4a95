"""Dataset readers and writers (paper §3.5 modules), the port's copy of
``repro.data.io``: format-prefixed paths in YDF's CLI style,
``read_dataset("csv:/tmp/train.csv")``. New formats register through
``register_format``. Host code: a dataset is a dict of numpy object
columns, ``None`` for a missing cell.
"""
from __future__ import annotations

import csv
from typing import Callable

import numpy as np

from repro_torch.core.api import YdfError

_READERS: dict[str, Callable] = {}
_WRITERS: dict[str, Callable] = {}


def register_format(name: str, reader: Callable, writer: Callable) -> None:
    _READERS[name] = reader
    _WRITERS[name] = writer


def _split(path: str) -> tuple[str, str]:
    if ":" not in path:
        raise YdfError(
            f"Dataset paths are format-prefixed, e.g. 'csv:{path}'. "
            f"Registered formats: {sorted(_READERS)}.")
    fmt, p = path.split(":", 1)
    if fmt not in _READERS:
        raise YdfError(f"Unknown dataset format {fmt!r}. "
                       f"Registered formats: {sorted(_READERS)}.")
    return fmt, p


def read_dataset(path: str) -> dict[str, np.ndarray]:
    fmt, p = _split(path)
    return _READERS[fmt](p)


def write_dataset(data: dict[str, np.ndarray], path: str) -> None:
    fmt, p = _split(path)
    _WRITERS[fmt](data, p)


# ----------------------------------------------------------------- csv

def _read_csv(path: str) -> dict[str, np.ndarray]:
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    if not rows:
        raise YdfError(f"CSV file {path!r} is empty.")
    header, body = rows[0], rows[1:]
    cols = {h: np.empty(len(body), dtype=object) for h in header}
    for i, row in enumerate(body):
        for h, v in zip(header, row):
            cols[h][i] = v if v != "" else None
    return cols


def _write_csv(data: dict[str, np.ndarray], path: str) -> None:
    names = list(data)
    n = len(next(iter(data.values()))) if data else 0
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(names)
        for i in range(n):
            w.writerow(["" if data[c][i] is None else data[c][i] for c in names])


register_format("csv", _read_csv, _write_csv)
