"""The work of B2 and of a whole scoring call on a forest with three kinds
of condition, counted from the inputs, and the least time of it
(``workcount.least_s``).

The count is of the work, not of an implementation, as in
``workcount.py``: each input byte read once, each final output byte
written once.

  * B2, one call: the encoded rows (rows x columns float32) read; each
    held node's 16-byte record (column, threshold or mask index, left
    child, and the leaf value when out_dim is 1; a leaf row of out_dim
    float32 besides when it is more), an oblique node's non-zero
    (column, weight) pairs (8 bytes a pair; the zero-weight padding up to
    the table's width P is an implementation's, not the function's) and a
    categorical node's mask (32 bytes) read; (rows, out_dim) float32
    written. Operations: one a visit of an axis-aligned or categorical
    node, 2 a non-zero pair of a visited oblique node (a product and an
    add); the visits by kind and the pairs visited come from the
    reference's traversal of the same rows.
  * A call end to end adds the raw columns read, 8 bytes a cell (an int64
    value, or the pointer numpy holds for a string), in place of the
    encoded rows, an operation per raw cell, and the sum of the trees'
    outputs, an add per (row, tree, output).
"""
from __future__ import annotations

RECORD_BYTES, MASK_BYTES, PAIR_BYTES = 16, 32, 8


def b2_call(rows: int, visits: list, work: dict) -> tuple:
    """(bytes, operations) of one traversal of ``rows`` rows whose visits
    are (axis-aligned, oblique, categorical, non-zero pairs of the oblique
    nodes visited); ``work`` holds the forest's ``features``, ``nodes``,
    ``oblique_pairs`` (the non-zero pairs its oblique nodes hold),
    ``categorical_nodes`` and ``out_dim``."""
    O = work["out_dim"]
    nbytes = (rows * work["features"] * 4
              + work["nodes"] * (RECORD_BYTES + (4 * O if O > 1 else 0))
              + work["oblique_pairs"] * PAIR_BYTES
              + work["categorical_nodes"] * MASK_BYTES
              + rows * O * 4)
    axis, _, categorical, pairs = visits
    return nbytes, axis + categorical + 2 * pairs


def scoring_call(rows: int, visits: list, work: dict) -> tuple:
    """(bytes, operations) of one call from raw columns to answers."""
    nb, no = b2_call(rows, visits, work)
    cells = rows * work["features"]
    return (nb + cells * 4,
            no + cells + rows * work["trees"] * work["out_dim"])


def least_calls(rec: dict, count) -> float:
    """Least seconds of the window's calls in ``rec["work"]`` by ``count``
    (``b2_call`` or ``scoring_call``), 0 where the run counted none."""
    from bench.workcount import least_s
    w = rec.get("work")
    if not w or "oblique_pairs" not in w:
        return 0.0
    return sum(least_s(*count(r, v, w)) for r, v in zip(w["rows"],
                                                         w["visits"]))
