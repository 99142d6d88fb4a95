"""The work of a kernel or a whole call, counted from the inputs, and the
least time the chip needs for it.

The count is of the work, not of an implementation: each input byte is
read once and each final output byte written once, whatever a kernel reads
again or keeps between its launches. So a fused or reordered kernel reads
the same count, and no share of a roofline can pass 100% unless the time
leaves out part of the work.

  * B1, split search, one call (one tree level): the candidate codes
    (rows x columns, 1 B each), the per-row stats (rows x S float32) and
    node ids (rows int32) read; (gain, column, bin) written per slot (12 B).
    Operations: an add per (row, column, stat) into the histograms, and a
    scan of each slot's (column, bin) positions at 10 operations each.
  * B2, traversal, one call: the encoded rows (rows x columns float32)
    and each held node's fields (column, threshold, left child: 12 B, and
    the leaf row, out_dim float32) read; (rows, out_dim) float32 written.
    Operations: a comparison per node visit (the reference's traversal of
    the same rows counts them) and an add per (row, tree, output).
  * A scoring call end to end adds the raw columns (rows x columns
    float64) read in place of the encoded rows, and an operation per raw
    value.
  * A training end to end: its raw columns read once, the B1 work of each
    level, and per tree a pass of 24 B and 10 operations a row (prediction,
    gradient and hessian).
"""
from __future__ import annotations

from bench.frozen import PEAK_BYTES_S, PEAK_FP32_S

B = 256                     # bins a column
SCAN_OPS = 10               # operations to score one split position


def least_s(nbytes: float, ops: float) -> float:
    """The least seconds one H100 needs: the larger of the bytes over its
    HBM bandwidth and the operations over its fp32 rate."""
    return max(nbytes / PEAK_BYTES_S, ops / PEAK_FP32_S)


def b1_level(rows: int, columns: int, stats: int, slots: int) -> tuple:
    """(bytes, operations) of one split-search call."""
    nbytes = rows * columns + rows * stats * 4 + rows * 4 + slots * 12
    ops = rows * columns * stats + slots * columns * B * SCAN_OPS
    return nbytes, ops


def tree_levels(depth: int, max_depth: int) -> list[int]:
    """Frontier width of each level step a tree of ``depth`` took on a
    complete level-wise growth: a step per level down to ``max_depth``,
    and one more that found no split where the tree stopped short."""
    return [2 ** d for d in range(min(depth + 1, max_depth))]


def training(rows: int, columns: int, stats: int, depths: list[int],
             max_depth: int) -> dict:
    """B1's (bytes, ops) and the whole training's (bytes, ops)."""
    b1_bytes = b1_ops = 0
    for d in depths:
        for w in tree_levels(d, max_depth):
            nb, no = b1_level(rows, columns, stats, w)
            b1_bytes += nb
            b1_ops += no
    n_trees = len(depths)
    whole_bytes = rows * columns * 8 + b1_bytes + n_trees * rows * 24
    whole_ops = b1_ops + n_trees * rows * 10
    return {"b1": (b1_bytes, b1_ops), "whole": (whole_bytes, whole_ops)}


def b2_call(rows: int, visits: int, columns: int, nodes: int, trees: int,
            out_dim: int) -> tuple:
    """(bytes, operations) of one traversal call."""
    nbytes = rows * columns * 4 + nodes * (12 + 4 * out_dim) \
        + rows * out_dim * 4
    ops = visits + rows * trees * out_dim
    return nbytes, ops


def scoring_call(rows: int, visits: int, columns: int, nodes: int,
                 trees: int, out_dim: int) -> tuple:
    """(bytes, operations) of one call from raw columns to answers."""
    nb, no = b2_call(rows, visits, columns, nodes, trees, out_dim)
    return nb + rows * columns * 4, no + rows * columns
