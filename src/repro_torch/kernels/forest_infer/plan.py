"""Launch plans of the traversal kernels (``csrc/forest_infer.cu``, B2, and
``csrc/forest_single.cu``, B4), computed on the host from shapes alone.

Both kernels run one block of ``THREADS`` threads per (group of trees,
chunk of example tiles). A block walks every (example, tree) pair of its
group for each example tile of its chunk: tiles ``c, c + chunks, ...``, so
the grid is persistent over the tiles and a group's tables are fetched
once per block, not once per tile. The plan decides:

  * the group: a packed block of ``TB`` trees for B2 (``pack_by_depth``
    fixed it); for B4 up to ``ceil(WRITE_FLOATS / O)`` consecutive trees,
    so a warp stores whole 32-byte sectors of an output row, and no more
    than fit ``STAGE_BUDGET`` when staged;
  * the variant: **staged** when the group's records and side tables
    (masks, oblique pairs) fit ``STAGE_BUDGET``, so that four blocks
    (32 warps) share an SM,
    else **global**: the same records read with 16-byte ``__ldg`` through
    L1 / L2. The walk is latency-bound, so occupancy decides: on the H100
    a Random Forest tree of 4,096 nodes (64 KB of records) staged by
    one-tree blocks was slower than four-tree blocks reading it from
    global memory (``chip_smoke.py``'s timings, PERF.md).
    A forced "staged" may take up to ``SMEM_LIMIT`` (dynamic shared
    memory past 48 KB is opted in by the kernel), a tree of ~14,500 nodes;
  * the example tile: about ``TILE_PAIRS`` (example, tree) pairs, so a
    thread walks a few pairs a tile; X is read through L1 in both
    variants;
  * the chunks: as many blocks as ``SMS`` SMs hold at the occupancy that
    the block's shared memory allows (one wave, not one more block), never
    more than the tiles; the tiles are halved (to ``MIN_TILE_ROWS``) while
    there are fewer than that.

``variant`` forces one way (the tests and ``chip_smoke.py`` hold both
against the plain version); forcing "staged" where it does not fit raises.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

THREADS = 256                 # threads of a block
SMS = 132                     # SMs of an H100
SMEM_LIMIT = 232_448          # dynamic shared bytes a block may have
SMEM_PER_SM = 233_472         # shared bytes of an SM
BLOCKS_PER_SM = 2048 // THREADS
STAGE_BUDGET = SMEM_PER_SM // 4 - 1024   # the plan's staged blocks: 4 an SM
TILE_PAIRS = 1024             # (example, tree) pairs of a tile
MIN_TILE_PAIRS = 2 * THREADS  # ... and the fewest a tile is cut to
MIN_TILE_ROWS, MAX_TILE_ROWS = 32, 1024
WRITE_FLOATS = 8              # one 32-byte sector of an output row
RECORD_BYTES, MASK_BYTES, PAIR_BYTES = 16, 32, 8
MAX_BLOCKS = 2 ** 31 - 1
VARIANTS = ("staged", "global")


@dataclass(frozen=True)
class Plan:
    variant: str      # "staged" or "global"
    group: int        # trees a block walks
    n_groups: int
    mask_cap: int     # masks a staged block holds (0 when global)
    rows: int         # examples of a tile (a power of 2)
    chunks: int       # blocks per group
    smem: int         # dynamic shared bytes per block
    blocks: int       # n_groups * chunks

    def kernel_args(self) -> tuple:
        """The plan as the kernels' C functions take it."""
        return (int(self.variant == "staged"), self.group, self.n_groups,
                self.mask_cap, self.rows, self.chunks, self.smem)


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def tile_rows(group: int) -> int:
    """Examples of a tile for a group of ``group`` trees: about
    ``TILE_PAIRS`` pairs, a power of 2 in [MIN_TILE_ROWS, MAX_TILE_ROWS]."""
    rows = MIN_TILE_ROWS
    while rows < MAX_TILE_ROWS and rows * group < TILE_PAIRS:
        rows *= 2
    return rows


def table_bytes(group: int, M: int, masks: int, pairs: int = 0) -> int:
    """Shared bytes of a staged group: its trees' records, (M + 1) apart
    (the skew that spreads their roots over the banks), its masks and its
    oblique nodes' (column, weight) pairs."""
    return (group * (M + 1) * RECORD_BYTES + masks * MASK_BYTES
            + pairs * PAIR_BYTES)


def _finish(N: int, variant: str, group: int, n_groups: int, masks: int,
            M: int, pairs: int = 0) -> Plan:
    rows = tile_rows(group)
    staged = variant == "staged"
    smem = table_bytes(group, M, masks, pairs) if staged else 0
    if smem > SMEM_LIMIT:
        raise ValueError(f"a staged block of {group} trees x {M} nodes, "
                         f"{masks} masks and {pairs} oblique pairs needs "
                         f"{smem} shared bytes, more than the {SMEM_LIMIT} a "
                         "block may have")
    resident = max(1, min(BLOCKS_PER_SM, SMEM_PER_SM // (smem + 1024)))
    want = max(1, SMS * resident // max(1, n_groups))
    floor = max(MIN_TILE_ROWS, MIN_TILE_PAIRS // group)
    while rows > floor and _ceil(N, rows) < want:
        rows //= 2               # smaller tiles where there are few
    tiles = max(1, _ceil(N, rows))
    chunks = min(tiles, want)
    blocks = n_groups * chunks
    if blocks > MAX_BLOCKS:
        raise ValueError(f"{blocks} blocks exceed the grid's {MAX_BLOCKS}")
    return Plan(variant, group, n_groups, masks if staged else 0, rows,
                chunks, smem, blocks)


def _pick(variant, fits: bool) -> str:
    if variant is None:
        return "staged" if fits else "global"
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; expected one of "
                         f"{VARIANTS}")
    return variant


@functools.lru_cache(maxsize=512)
def tiled_plan(N: int, B: int, TB: int, M: int, block_masks: int,
               variant: str | None = None, block_pairs: int = 0) -> Plan:
    """B2's plan: groups are the packed blocks (B of TB trees x M nodes,
    at most ``block_masks`` masks and ``block_pairs`` oblique pairs each)."""
    if N < 0 or B < 1 or TB < 1 or M < 1:
        raise ValueError(f"no plan for N={N}, B={B}, TB={TB}, M={M}")
    fits = table_bytes(TB, M, block_masks, block_pairs) <= STAGE_BUDGET
    return _finish(N, _pick(variant, fits), TB, B, block_masks, M,
                   block_pairs)


@functools.lru_cache(maxsize=512)
def single_plan(N: int, T: int, M: int, O: int, group_masks: tuple,
                variant: str | None = None,
                group_pairs: tuple | None = None) -> Plan:
    """B4's plan over T trees of M nodes and O outputs; ``group_masks[k-1]``
    and ``group_pairs[k-1]`` are the most masks and oblique pairs of any k
    consecutive trees (``layout.group_masks``, ``layout.group_obl``; no
    pairs when None)."""
    if N < 0 or T < 1 or M < 1 or O < 1:
        raise ValueError(f"no plan for N={N}, T={T}, M={M}, O={O}")
    pairs = group_pairs or (0,) * len(group_masks)
    want = max(1, min(T, _ceil(WRITE_FLOATS, O), len(group_masks)))
    fits = table_bytes(1, M, group_masks[0], pairs[0]) <= STAGE_BUDGET
    variant = _pick(variant, fits)
    group = want
    if variant == "staged":
        group = 1
        while (group < want and table_bytes(group + 1, M, group_masks[group],
                                            pairs[group]) <= STAGE_BUDGET):
            group += 1
    return _finish(N, variant, group, _ceil(T, group), group_masks[group - 1],
                   M, pairs[group - 1])
