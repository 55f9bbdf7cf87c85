"""Bin ladders and binning-range selection (OpSparse §4.3, §5.6, §5.7).

The paper fixes per-kernel hash-table sizes (Tables 1–2) and then chooses
*binning ranges* — the largest row size admitted to each kernel — as
``floor(nominal_table_size / multiplier)``.  Its experiments (§6.3.3) find
``sym 1.2x`` and ``num 2x`` best on average; we keep those as defaults and
sweep the same grid in ``benchmarks/bench_binning_ranges.py``.

TPU adaptation (DESIGN.md §5): the ladder geometry (×2 per rung) is kept,
but the envelope is the ~16 MiB/core VMEM instead of the V100's 96 KB
shared memory, so an extended ladder with much larger top rungs is also
provided (``vmem_extended=True``).  Rows too large even for the top rung
fall back to the ESC (HBM) accumulator — the analog of the paper's
global-memory hash kernels (kernel8 symbolic / kernel7 numeric).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple

# Paper Table 1 (symbolic): nominal sizes whose /1.2 floors reproduce the
# published ranges 26 / 426 / 853 / 1706 / 3413 / 6826 / 10240 exactly.
SYMBOLIC_NOMINAL = (32, 512, 1024, 2048, 4096, 8192, 12288, 24576)
# Actual allocated table sizes (Table 1; kernel6/7 shave entries for the
# shared nnz counter -> 12287 / 24575 on GPU; we keep pow2 on TPU, VMEM
# scratch does not share space with the counter).
# opslint: disable=KRN001 -- paper Table 1 sizes: the top rungs are 3*4096 /
# 3*8192 by design; the hash probe falls back to the mod path for them.
SYMBOLIC_TABLE_SIZES = (32, 512, 1024, 2048, 4096, 8192, 12288, 24576)

# Paper Table 2 (numeric): nominal pow2 sizes; allocated sizes are
# nominal-1 on GPU (room for shared_offset).  /2 floors reproduce the
# published ranges 16 / 128 / 256 / 512 / 1024 / 2048 / 4096 exactly.
NUMERIC_NOMINAL = (32, 256, 512, 1024, 2048, 4096, 8192)
# opslint: disable=KRN001 -- paper Table 2 GPU-shaved sizes (pow2 - 1, room
# for shared_offset); deliberately non-pow-2, served by the mod probe path.
NUMERIC_TABLE_SIZES = (31, 255, 511, 1023, 2047, 4095, 8191)

# VMEM-extended ladders (TPU): one grid step resident per core; the table
# plus streaming buffers must fit the usable-VMEM budget.  int32 keys ->
# 4 B/entry symbolic; key+f32 value -> 8 B/entry numeric.
VMEM_BUDGET_BYTES = 8 * 1024 * 1024  # usable slice of the ~16 MiB core VMEM
SYMBOLIC_NOMINAL_VMEM = SYMBOLIC_NOMINAL + (65536, 262144, 1048576)
NUMERIC_NOMINAL_VMEM = NUMERIC_NOMINAL + (32768, 131072, 524288)

# Row packing (multi-row VMEM tiles): the smallest int32 VMEM tile is
# (8, 128) = 1024 entries, so a rung whose table is smaller than that
# leaves most of the tile (and the VPU lanes striding it) idle when one
# grid step owns one row.  Low rungs therefore pack
# ``rows_per_block = PACK_TILE_ENTRIES // t_size`` rows per grid step as
# independent sub-tables inside one tile — rung occupancy scales with the
# tile instead of the row (the batched-by-row-class sizing of Liu &
# Vinter, and the paper's §5.6 utilization-vs-collision trade-off knob).
PACK_TILE_ENTRIES = 8 * 128


def rows_per_block_of(t_size: int) -> int:
    """Pow-2 sub-tables of size ``t_size`` packable into one VMEM tile.

    Kept a power of two so packed row-count buckets (pow-2 as well)
    always divide evenly into grid steps.
    """
    pack = 1
    while pack * 2 * t_size <= PACK_TILE_ENTRIES:
        pack *= 2
    return pack


@dataclasses.dataclass(frozen=True)
class BinLadder:
    """A bin ladder: per-rung table sizes + admitted row-size ranges.

    ``upper[i]`` is the largest row size (n_prod for symbolic, n_nz for
    numeric) admitted to rung ``i``; the last rung admits everything and is
    the fallback (global-memory-analog) rung.
    """

    table_sizes: Tuple[int, ...]   # per-rung accumulator table size
    upper: Tuple[int, ...]         # per-rung inclusive upper bound on row size
    multiplier: float              # the paper's range multiplier (1x/1.2x/...)
    # Pow-2 rows a packed kernel batches per grid step on each rung (1 on
    # rungs whose table already fills a VMEM tile).  Derived from
    # ``table_sizes`` when not given, so every construction site gets it.
    rows_per_block: Tuple[int, ...] = ()

    def __post_init__(self):
        if not self.rows_per_block:
            object.__setattr__(
                self, "rows_per_block",
                tuple(rows_per_block_of(t) for t in self.table_sizes))

    @property
    def num_bins(self) -> int:
        return len(self.table_sizes) + 1  # +1 fallback rung

    def fallback_threshold(self) -> int:
        """Rows strictly larger than this go to the fallback accumulator."""
        return self.upper[-1]


def make_ladder(nominal: Sequence[int], multiplier: float,
                table_sizes: Sequence[int] | None = None) -> BinLadder:
    upper = tuple(int(math.floor(s / multiplier)) for s in nominal)
    return BinLadder(
        table_sizes=tuple(table_sizes or nominal),
        upper=upper,
        multiplier=multiplier,
    )


def symbolic_ladder(multiplier: float = 1.2, *, vmem_extended: bool = False) -> BinLadder:
    nominal = SYMBOLIC_NOMINAL_VMEM if vmem_extended else SYMBOLIC_NOMINAL
    sizes = nominal if vmem_extended else SYMBOLIC_TABLE_SIZES
    return make_ladder(nominal, multiplier, sizes)


def numeric_ladder(multiplier: float = 2.0, *, vmem_extended: bool = False) -> BinLadder:
    nominal = NUMERIC_NOMINAL_VMEM if vmem_extended else NUMERIC_NOMINAL
    sizes = nominal if vmem_extended else NUMERIC_TABLE_SIZES
    return make_ladder(nominal, multiplier, sizes)


# The sweeps the paper runs in §6.3.3 (Figs 10 and 11).
SYMBOLIC_SWEEP = (1.0, 1.2, 1.5)
NUMERIC_SWEEP = (1.0, 1.5, 2.0, 3.0)
