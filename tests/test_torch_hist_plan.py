"""Launch plans of the histogram kernels (kernels/histogram/plan.py).

The plans are computed on the host, so they are checked here without a
card: for S = 1 .. 300 and node (slot) counts up to 100,000, every plan
fits a block's shared memory on an H100 (232,448 bytes less the kernels'
static arrays), its grid is what the kernels decode, and its units cover
each (node, column, stat) the kernel reads exactly once: the chunks
partition the nodes and the stat groups partition the stats.
"""
from __future__ import annotations

import pytest

from repro_torch.kernels.histogram import plan as P

NODES = (1, 2, 7, 8, 32, 33, 512, 2048, 4095, 65_535, 70_000, 100_000)
STATIC_SMEM = 2048          # the kernels' static shared arrays, rounded up


def _partition(ranges, total):
    """The ranges, in order, tile [0, total) with no gap or overlap."""
    at = 0
    for lo, hi in ranges:
        assert lo == at and hi > lo, (ranges, total)
        at = hi
    assert at == total


def _common(pl, N, columns, n_nodes, units_per_chunk):
    assert pl.cluster in (1, 2, 4, 8)
    assert 1 <= pl.columns <= P.MAX_COLUMNS
    _partition([(c * pl.columns, min(columns, (c + 1) * pl.columns))
                for c in range(pl.n_colgroups)], columns)
    assert 0 < pl.smem <= P.SMEM_LIMIT - STATIC_SMEM
    assert pl.smem <= P.SMEM_BUDGET
    assert pl.blocks == pl.n_chunks * units_per_chunk * pl.cluster
    assert pl.blocks <= P.MAX_BLOCKS
    if pl.n_chunks <= 64:      # beyond, the bound below implies it
        _partition([(c * pl.slots, min(n_nodes, (c + 1) * pl.slots))
                    for c in range(pl.n_chunks)], n_nodes)
    assert pl.n_chunks * pl.slots >= n_nodes > (pl.n_chunks - 1) * pl.slots


@pytest.mark.parametrize("N", [1, 5_000, 100_000])
def test_histogram_plans_cover_every_cell_once(N):
    F = 28
    for S in range(1, 301):
        for n_nodes in NODES:
            pl = P.histogram_plan(N, F, S, n_nodes)
            assert 1 <= pl.group <= P.MAX_GROUP
            groups = [(g * pl.group, min(S, (g + 1) * pl.group))
                      for g in range(pl.n_groups)]
            _partition(groups, S)
            _common(pl, N, F, n_nodes, pl.n_colgroups * pl.n_groups)
            assert pl.smem == pl.slots * pl.columns * P.BINS * pl.group * 8


@pytest.mark.parametrize("kind", ["gh", "class", "moment"])
def test_fused_plans_cover_every_stat_the_score_reads(kind):
    N, kf = 100_000, 5
    for S in range(2, 301):
        for W in NODES:
            pl = P.fused_plan(N, kf, S, W, kind)
            # a group's stats and the count fit one group of the kernel
            assert 1 <= pl.group <= P.MAX_GROUP - 1
            groups = [(g * pl.group, min(S - 1, (g + 1) * pl.group))
                      for g in range(pl.n_groups)]
            if kind == "class":      # every class, once, in order
                _partition(groups, S - 1)
            else:                    # one group: stats 0, 1 (or the count)
                assert pl.n_groups == 1 and groups[0][0] == 0
                assert groups[0][1] >= min(2, S - 1)
            _common(pl, N, kf, W, pl.n_colgroups)


def test_plans_spread_narrow_levels_over_clusters():
    """The root level (one node, 90,000 rows, 28 columns) is 7 units of 4
    columns: its rows go to clusters of 8 blocks; a level with hundreds of
    units needs none; few rows keep a unit in one block."""
    assert P.histogram_plan(90_000, 28, 4, 1).cluster == 8
    assert P.histogram_plan(100_000, 28, 3, 2048).cluster == 1
    assert P.histogram_plan(100, 28, 4, 1).cluster == 1
    assert P.fused_plan(90_000, 28, 4, 1, "gh").cluster == 8


def test_plans_refuse_empty_shapes():
    for args in ((10, 0, 4, 1), (10, 3, 0, 1), (10, 3, 4, 0)):
        with pytest.raises(ValueError):
            P.histogram_plan(*args)
    for args in ((10, 0, 4, 1), (10, 3, 1, 1), (10, 3, 4, 0)):
        with pytest.raises(ValueError):
            P.fused_plan(*args, "gh")


def test_wrappers_refuse_counts_past_int32():
    """The wrappers take any node / slot count the kernels index in int32
    (the 65,535 grid-axis limit is gone) and refuse the rest."""
    import torch
    from repro_torch.kernels.histogram import fused, histogram
    codes = torch.zeros((4, 2), dtype=torch.uint8)
    stats = torch.ones((4, 3))
    node = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="n_slots"):
        fused.fused_split(codes, stats, node, 2 ** 31)
    with pytest.raises(ValueError, match="n_nodes"):
        histogram.histogram(codes, stats, node, 2 ** 31)
    out = histogram.histogram(codes, stats, node, 70_000, n_bins=1)
    assert out.shape == (70_000, 2, 1, 3) and float(out[0, 0, 0, 0]) == 4.0
