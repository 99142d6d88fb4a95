"""Launch plans of the histogram kernels (``csrc/histogram.cu``,
``csrc/fused_split.cu``), computed on the host and passed to the kernels.

Both kernels run a prep launch that sorts the active rows by node (or slot)
and then one accumulate block per *unit*: a chunk of consecutive nodes, a
group of up to ``MAX_COLUMNS`` columns and a group of stats. A unit's int64 histogram lives whole in the
block's shared memory, so the block writes its cells itself. Where a unit's
chunk holds many rows and there are few units, the rows of a unit are
split over the ``cluster`` blocks of a thread-block cluster, which add
their shared histograms through distributed shared memory.

The plan decides:
  * the stat groups: at most ``MAX_GROUP`` stats a unit, so that a slot's
    ``256 x group x 8`` bytes stay small whatever S is. The histogram's
    groups are independent. The split search keeps the count (the last
    stat) in every group beside at most ``MAX_GROUP - 1`` others, since
    every score divides by it; "gh" and "moment" read only stats 0, 1 and
    the count, so they have one group;
  * the columns of a unit: ``MAX_COLUMNS``, so that a block reads a row's
    node, permutation entry and fixed-point stats once for all of them;
    halved (to 2, then 1) while one slot would not fit ``SMEM_BUDGET`` or
    even clusters of 8 leave the grid below ``TARGET_BLOCKS`` (the root
    level: 28 units of one column, not 7);
  * the slots of a chunk: as many as ``SMEM_BUDGET`` holds, spread evenly
    over the chunks. 64 KB lets three blocks share an SM, which hides the
    latency of each block's short phases (zero, accumulate, write);
    ``benchmarks/torch_hist_budget.py`` times the budgets against each
    other on the card (PERF.md);
  * the cluster size: 1, 2, 4 or 8 blocks, doubled while the grid has
    fewer than ``TARGET_BLOCKS`` blocks and each block keeps at least
    ``MIN_CLUSTER_ROWS`` rows on average.
"""
from __future__ import annotations

from dataclasses import dataclass

BINS = 256                   # bins of a slot's histogram in shared memory
SMEM_BUDGET = 64 * 1024      # shared bytes a unit's histogram may take
SMEM_LIMIT = 232_448         # dynamic shared bytes a block may have on H100
MAX_GROUP = 16               # stats of a group
MAX_COLUMNS = 4              # columns of a unit
MAX_CLUSTER = 8              # the portable cluster size
TARGET_BLOCKS = 2 * 132      # two blocks per SM of an H100
MIN_CLUSTER_ROWS = 2048      # rows per block below which a cluster grows no more
MAX_BLOCKS = 2 ** 31 - 1     # the grid's x dimension


@dataclass(frozen=True)
class Plan:
    group: int          # stats per group (fused: non-count stats per group)
    n_groups: int
    columns: int        # columns per unit (the last unit's may be fewer)
    n_colgroups: int
    slots: int          # consecutive nodes (slots) per chunk
    n_chunks: int
    cluster: int        # blocks per unit
    smem: int           # dynamic shared bytes per block
    blocks: int         # n_chunks * n_colgroups * n_groups * cluster

    def kernel_args(self) -> tuple:
        """The plan as the kernels' C functions take it."""
        return (self.group, self.n_groups, self.columns, self.n_colgroups,
                self.slots, self.cluster, self.smem, self.blocks)


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _fit(N: int, F: int, n_nodes: int, n_groups: int,
         column_bytes: int) -> tuple:
    """(columns, n_colgroups, slots, n_chunks, cluster, smem, blocks) for
    units of ``n_groups`` stat groups whose slot takes ``column_bytes`` of
    shared memory per column."""
    columns = min(F, MAX_COLUMNS)
    while True:
        n_colgroups = _ceil(F, columns)
        fit = _chunks_and_cluster(N, n_colgroups, n_nodes, n_groups,
                                  columns * column_bytes)
        units = fit[1] * n_colgroups * n_groups
        fits = columns * column_bytes <= SMEM_BUDGET
        if columns == 1 or (fits and units * MAX_CLUSTER >= TARGET_BLOCKS):
            return (columns, n_colgroups) + fit
        columns //= 2


def _chunks_and_cluster(N: int, n_colgroups: int, n_nodes: int,
                        n_groups: int, slot_bytes: int) -> tuple:
    slots = max(1, min(n_nodes, SMEM_BUDGET // slot_bytes))
    n_chunks = _ceil(n_nodes, slots)
    slots = _ceil(n_nodes, n_chunks)          # even chunks
    units = n_chunks * n_colgroups * n_groups
    cluster = 1
    while (cluster < MAX_CLUSTER and units * cluster < TARGET_BLOCKS
           and N >= n_chunks * cluster * 2 * MIN_CLUSTER_ROWS):
        cluster *= 2
    blocks = units * cluster
    if blocks > MAX_BLOCKS:
        raise ValueError(f"{blocks} blocks exceed the grid's {MAX_BLOCKS}: "
                         f"N={N}, column groups={n_colgroups}, "
                         f"nodes={n_nodes}")
    return slots, n_chunks, cluster, slots * slot_bytes, blocks


def histogram_plan(N: int, F: int, S: int, n_nodes: int) -> Plan:
    """The plan of the histogram kernel: groups of at most MAX_GROUP
    stats, each (node chunk, column group, stat group) one unit."""
    if N < 0 or F < 1 or S < 1 or n_nodes < 1:
        raise ValueError(f"no plan for N={N}, F={F}, S={S}, n_nodes={n_nodes}")
    n_groups = _ceil(S, MAX_GROUP)
    group = _ceil(S, n_groups)
    return Plan(group, n_groups,
                *_fit(N, F, n_nodes, n_groups, BINS * group * 8))


def fused_plan(N: int, kf: int, S: int, W: int, kind: str) -> Plan:
    """The plan of the split-search kernel: each (slot chunk, column
    group) one unit, whose block walks the stat groups in order; a group holds at
    most MAX_GROUP - 1 stats beside the count. "class" scores every stat
    and keeps running entropy sums per (slot, bin) in shared memory;
    "gh" and "moment" need one group."""
    if N < 0 or kf < 1 or S < 2 or W < 1:
        raise ValueError(f"no plan for N={N}, kf={kf}, S={S}, W={W}")
    rest = S - 1
    if kind == "class":
        n_groups = _ceil(rest, MAX_GROUP - 1)
        group = _ceil(rest, n_groups)
        extra = BINS * 2 * 4 + 16         # running sums: left, right, parent
    else:
        n_groups, group = 1, min(rest, MAX_GROUP - 1)
        extra = 0
    return Plan(group, n_groups,
                *_fit(N, kf, W, 1, BINS * (group + 1) * 8 + extra))

