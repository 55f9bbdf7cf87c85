"""The benchmark's matrices: a frozen copy of paper Table 3 and the
generator that draws a matrix with a Table-3 row's statistics.

The SuiteSparse matrices themselves are not in the checkout, so each
configuration is a synthetic matrix that matches its Table-3 row in
what the table states: the rows, the entries (rows x nnz/row, exactly),
the largest row, and the compression of A·A (n_prod / nnz(C)), the
number that sets how full the hash tables get and how much the epilogue
condenses.  ``table3_structure`` draws it:

  row sizes   a family's shape ("powerlaw": a Pareto(1.5) tail;
              "banded": normal with a spread of 15 % of the mean), scaled
              until the mean is the table's, clipped to [1, max], then
              nudged by one entry in as many rows as it takes to hit the
              table's entries exactly;
  columns     each row's columns drawn without repeats from a window of
              ``window`` x its size around the diagonal.  The window sets
              the compression: a narrow window makes neighbouring rows
              share columns, so their products land on the same entries
              of C.  Each configuration states the window that gives its
              Table-3 compression (``python3 -m opbench.calibrate``).

Host-side numpy, vectorised (a few seconds for a Table-3 row); the
structure is drawn from a fixed seed, ``zlib.crc32`` of the name, so every
run of a configuration has the same matrix.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class MatrixSpec:
    name: str
    rows: int
    avg_nnz: float          # paper's Nnz/row
    max_nnz: int            # paper's Max nnz/row
    dist: str               # banded | powerlaw | uniform
    large: bool = False     # paper's "large" group
    paper_cr: float = 0.0   # paper's compression ratio of A^2


# OpSparse (Du et al., IEEE Access 2022) Table 3: 19 "normal" and 7
# "large" SuiteSparse matrices, with the structural family of each analog.
TABLE3: Tuple[MatrixSpec, ...] = (
    MatrixSpec("m133-b3", 200200, 4.0, 4, "uniform", paper_cr=1.01),
    MatrixSpec("mac_econ_fwd500", 206500, 6.2, 44, "uniform", paper_cr=1.13),
    MatrixSpec("patents_main", 240547, 2.3, 206, "powerlaw", paper_cr=1.14),
    MatrixSpec("webbase-1M", 1000005, 3.1, 4700, "powerlaw", paper_cr=1.36),
    MatrixSpec("mc2depi", 525825, 4.0, 4, "uniform", paper_cr=1.60),
    MatrixSpec("scircuit", 170998, 5.6, 353, "powerlaw", paper_cr=1.66),
    MatrixSpec("mario002", 389874, 5.4, 7, "uniform", paper_cr=1.99),
    MatrixSpec("cage12", 130228, 15.6, 33, "banded", paper_cr=2.27),
    MatrixSpec("majorbasis", 160000, 10.9, 11, "banded", paper_cr=2.33),
    MatrixSpec("offshore", 259789, 16.3, 31, "banded", paper_cr=3.05),
    MatrixSpec("2cubes_sphere", 101492, 16.2, 31, "banded", paper_cr=3.06),
    MatrixSpec("poisson3Da", 13514, 26.1, 110, "banded", paper_cr=3.98),
    MatrixSpec("filter3D", 106437, 25.4, 112, "banded", paper_cr=4.26),
    MatrixSpec("mono_500Hz", 169410, 29.7, 719, "powerlaw", paper_cr=4.93),
    MatrixSpec("conf5_4-8x8-05", 49152, 39.0, 39, "banded", paper_cr=6.85),
    MatrixSpec("cant", 62451, 64.2, 78, "banded", paper_cr=15.45),
    MatrixSpec("consph", 83334, 72.1, 81, "banded", paper_cr=17.48),
    MatrixSpec("shipsec1", 140874, 55.5, 102, "banded", paper_cr=18.71),
    MatrixSpec("rma10", 46835, 50.7, 145, "banded", paper_cr=19.81),
    MatrixSpec("delaunay_n24", 16777216, 6.0, 26, "banded", True, 1.83),
    MatrixSpec("cage15", 5154859, 19.2, 47, "banded", True, 2.24),
    MatrixSpec("wb-edu", 9845725, 5.8, 3841, "powerlaw", True, 2.48),
    MatrixSpec("cop20k_A", 121192, 21.7, 81, "banded", True, 4.27),
    MatrixSpec("hood", 220542, 48.8, 77, "banded", True, 16.41),
    MatrixSpec("pwtk", 217918, 53.4, 180, "banded", True, 19.10),
    MatrixSpec("pdb1HYS", 36417, 119.3, 204, "banded", True, 28.34),
)

BY_NAME: Dict[str, MatrixSpec] = {m.name: m for m in TABLE3}


def structure_seed(name: str) -> int:
    return zlib.crc32(name.encode())


def row_sizes(rng: np.random.Generator, family: str, rows: int,
              avg: float, max_nnz: int) -> np.ndarray:
    """(rows,) int64 sizes in [1, max_nnz] summing to round(rows * avg)."""
    if family == "powerlaw":
        base = rng.pareto(1.5, size=rows) + 1.0
        def shaped(t):
            return t * base
    elif family == "banded":
        base = rng.standard_normal(rows) * (0.15 * avg)
        def shaped(t):
            return t + base
    else:
        raise ValueError(f"unknown row-size family {family!r}")

    def sizes_at(t):
        return np.clip(np.floor(shaped(t)), 1, max_nnz).astype(np.int64)

    target = int(round(rows * avg))
    lo, hi = 0.0, 4.0 * max_nnz
    for _ in range(100):                 # the mean rises with t
        mid = (lo + hi) / 2
        if sizes_at(mid).sum() < target:
            lo = mid
        else:
            hi = mid
    sizes = sizes_at(hi)
    extra = int(sizes.sum()) - target    # >= 0, a fraction of the rows
    if extra:
        room = np.flatnonzero((sizes > 1) & (sizes < max_nnz))
        sizes[rng.choice(room, size=extra, replace=False)] -= 1
    return sizes


def table3_structure(name: str, rows: int, avg: float, max_nnz: int,
                     family: str, window: float
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """``(rpt, col)`` (int32) of the rows x rows matrix with the Table-3
    row's statistics: ``round(rows * avg)`` entries, rows of 1 to
    ``max_nnz``, each row's columns drawn without repeats from the
    ``ceil(window * size)`` columns around its diagonal, sorted."""
    rng = np.random.default_rng(structure_seed(name))
    sizes = row_sizes(rng, family, rows, avg, max_nnz)
    width = np.minimum(rows, np.maximum(
        sizes, np.ceil(window * sizes).astype(np.int64)))
    lo = np.clip(np.arange(rows) - width // 2, 0, rows - width)
    starts = np.repeat(np.cumsum(width) - width, width)
    total = int(width.sum())
    row_of = np.repeat(np.arange(rows), width)
    offset = np.arange(total) - starts
    # Within each row's window a random order; its first ``size`` kept.
    keys = rng.random(total)
    order = np.lexsort((keys, row_of))
    kept = order[offset < np.repeat(sizes, width)]
    kept_rows = row_of[kept]
    cols = lo[kept_rows] + offset[kept]
    cols = cols[np.lexsort((cols, kept_rows))]
    rpt = np.zeros(rows + 1, np.int64)
    rpt[1:] = np.cumsum(sizes)
    return rpt.astype(np.int32), cols.astype(np.int32)
