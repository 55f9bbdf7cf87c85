"""Synthetic SuiteSparse-analog suite (paper Table 3) for the port.

The 26 benchmark matrices are synthesized to match Table 3's row counts,
mean/max nnz per row and structural family (banded FEM-like, power-law
web/circuit-like, uniform).  On the card the default is the original row
count; on the CPU it is 1/``DEFAULT_SCALE`` (1/``LARGE_SCALE`` for the
large group), so wall times stay in seconds.  Each analog is seeded with
``zlib.crc32`` of its name plus ``seed``: the same matrix in every process
(``hash()`` of a string is salted per process).
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import multiprocessing
import zlib
from typing import List, Optional

import torch

from repro_torch.core import CSR, random_csr, resolve_device


@dataclasses.dataclass(frozen=True)
class MatrixSpec:
    name: str
    rows: int
    avg_nnz: float          # paper's Nnz/row
    max_nnz: int            # paper's Max nnz/row
    dist: str               # banded | powerlaw | uniform
    large: bool = False     # paper's "large" group (cuSPARSE OOM group)
    paper_cr: float = 0.0   # paper's compression ratio of A^2


# Paper Table 3, 19 "normal" + 7 "large" matrices.
TABLE3: List[MatrixSpec] = [
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
]

BY_NAME = {m.name: m for m in TABLE3}
NORMAL = [m for m in TABLE3 if not m.large]
LARGE = [m for m in TABLE3 if m.large]

DEFAULT_SCALE = 32
LARGE_SCALE = 512


def default_scale(spec: MatrixSpec, device="cuda") -> int:
    """Full row count on the card; the reference's CPU cut elsewhere."""
    if resolve_device(device).type == "cuda":
        return 1
    return LARGE_SCALE if spec.large else DEFAULT_SCALE


def analog(spec: MatrixSpec, n: int, *, seed: int = 0,
           device="cuda") -> CSR:
    """The square n x n analog of ``spec`` (A for the A^2 bench)."""
    return random_csr(
        zlib.crc32(spec.name.encode()) + seed, n, n,
        avg_nnz_per_row=spec.avg_nnz,
        max_nnz_per_row=min(spec.max_nnz, n),
        distribution=spec.dist, device=device)


def rows_at(spec: MatrixSpec, scale: int) -> int:
    return max(spec.rows // scale, 256)


def generate(spec: MatrixSpec, *, scale: Optional[int] = None,
             seed: int = 0, device="cuda") -> CSR:
    """Square synthetic analog of one Table-3 matrix at 1/``scale`` of its
    rows (``default_scale`` when None)."""
    s = scale if scale is not None else default_scale(spec, device)
    return analog(spec, rows_at(spec, s), seed=seed, device=device)


# ---------------------------------------------------------------------------
# Generation in worker processes (the generator is a Python loop over
# rows, ~20 us a row on one core).
# ---------------------------------------------------------------------------

def _init_worker() -> None:
    torch.set_num_threads(1)


def pool(workers: int) -> concurrent.futures.ProcessPoolExecutor:
    """A pool of ``workers`` spawned processes for host-side generation
    (close it with ``shutdown`` or a ``with`` block)."""
    return concurrent.futures.ProcessPoolExecutor(
        workers, mp_context=multiprocessing.get_context("spawn"),
        initializer=_init_worker)


def host_arrays(spec: MatrixSpec, scale: int, seed: int = 0):
    """``(rpt, col, val, shape)`` of ``generate(spec, scale, seed)`` as
    numpy arrays, built on the host (a pool worker's job)."""
    A = generate(spec, scale=scale, seed=seed, device="cpu")
    return (*A.to_numpy(), A.shape)


def from_host(arrays, device="cuda") -> CSR:
    rpt, col, val, shape = arrays
    return CSR.from_numpy(rpt, col, val, shape, device=device)
