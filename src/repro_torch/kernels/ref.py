"""Plain PyTorch versions and dense oracles (tests and checks).

``binning_histogram_ref`` and ``bsr_spmm_ref`` are the plain versions of
the two kernels of the same names: their wrappers run them on CPU tensors,
and ``chip_smoke.py`` holds the CUDA kernels against them on the card.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core.csr import CSR


def spgemm_dense_ref(A: CSR, B: CSR) -> torch.Tensor:
    """Dense oracle for any SpGEMM path."""
    return A.to_dense() @ B.to_dense()


def row_nnz_from_support(A: CSR, B: CSR) -> np.ndarray:
    """Structural n_nz per row (counts symbolic support even where values
    cancel numerically, as the hash and ESC symbolic phases do)."""
    a = (A.to_dense() != 0).cpu().numpy().astype(np.int64)
    b = (B.to_dense() != 0).cpu().numpy().astype(np.int64)
    return ((a @ b) > 0).sum(axis=1).astype(np.int32)


def binning_histogram_ref(sizes: torch.Tensor, *, upper: Tuple[int, ...],
                          num_bins: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Binning pass 1: ``(bin_size (num_bins,) int32, max_size () int32)``.

    A row's rung is the count of bounds its size exceeds (sizes above
    ``upper[-1]`` land in rung ``len(upper)``); rungs at or past
    ``num_bins`` are not counted.  The max starts at 0, so an empty input
    gives 0.
    """
    sizes = sizes.to(torch.int32)
    bins = torch.zeros(sizes.shape, dtype=torch.int64, device=sizes.device)
    for u in upper:
        bins += sizes > u
    hist = torch.zeros(num_bins + 1, dtype=torch.int32, device=sizes.device)
    hist.scatter_add_(0, bins.clamp(max=num_bins),
                      torch.ones_like(sizes))
    mx = torch.zeros((), dtype=torch.int32, device=sizes.device)
    if sizes.numel():
        mx = sizes.max().clamp(min=0)
    return hist[:num_bins], mx


def bsr_spmm_ref(block_rows, block_cols, blocks, dense, *, nrows_blocks: int,
                 block_shape: Tuple[int, int]) -> torch.Tensor:
    """Block-CSR (COO-listed blocks) x dense: the counterpart of
    ``repro/kernels/ref.py::bsr_spmm_ref``.

    Each block's product is summed in float32 into its block row's stripe
    and the result is cast once to ``dense.dtype``, as the TPU kernel does.
    Block rows with no block come out zero; entries whose block row lies
    outside ``[0, nrows_blocks)`` add nothing.
    """
    bm, bk = block_shape
    n = dense.shape[1]
    keep = (block_rows >= 0) & (block_rows < nrows_blocks)
    rows = block_rows.long().masked_fill(~keep, 0)
    stripes = dense.reshape(-1, bk, n).float()[block_cols.long()]
    prods = torch.bmm(blocks.float(), stripes)
    prods = prods.masked_fill(~keep[:, None, None], 0.0)
    out = torch.zeros((nrows_blocks, bm, n), dtype=torch.float32,
                      device=dense.device)
    out.index_add_(0, rows, prods)
    return out.reshape(nrows_blocks * bm, n).to(dense.dtype)
