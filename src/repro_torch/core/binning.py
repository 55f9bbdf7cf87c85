"""Two-pass binning (OpSparse §5.1, Algorithms 1–3): global load balance.

The paper classifies rows by size (n_prod or n_nz) into bins and stores ALL
classified row ids in ONE length-M ``bins`` array plus tiny ``bin_size`` /
``bin_offset`` arrays: the minimum-metadata layout of Fig. 3.  Pass 1 is a
histogram, the offsets an exclusive sum, and pass 2 a stable counting-sort
scatter (``argsort(bin_of_row, stable)`` writes the row ids to their bin's
slice and keeps the in-bin row-id order).  The Alg-3 fast path is kept:
when ``max(sizes) <= upper[0]`` the ``bins`` array is the identity.

No step here syncs the host: the histogram is a ``scatter_add_`` into
``num_bins`` slots (``bincount`` on CUDA reads the max to size its output),
and the rung bounds are Python ints compared one at a time, so no host
list is copied to the device.  The steady state bins with ``bin_rows``
and keeps its single host sync for finalize.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from .binning_ranges import BinLadder


@dataclasses.dataclass(frozen=True)
class Binning:
    """Result of the two-pass binning: the paper's Fig. 3 metadata.

    bins:       (M,) int32 row ids grouped by bin (one array, min metadata).
    bin_size:   (NUM_BIN,) int32.
    bin_offset: (NUM_BIN,) int32 exclusive sum of bin_size.
    bin_of_row: (M,) int32 bin of each row.
    max_size:   () max row size (Alg 1's d_max_row_nnz).
    """

    bins: torch.Tensor
    bin_size: torch.Tensor
    bin_offset: torch.Tensor
    bin_of_row: torch.Tensor
    max_size: torch.Tensor

    @property
    def num_bins(self) -> int:
        return int(self.bin_size.shape[0])

    def rows_of_bin(self, b: int,
                    capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Row ids of bin ``b`` padded to ``capacity``; returns
        (row_ids, count).  Padded slots hold row id 0 (callers mask);
        ``count`` is a 0-d view of ``bin_size`` that stays on the device."""
        dev = self.bins.device
        lane = torch.arange(capacity, dtype=torch.int32, device=dev)
        valid = lane < self.bin_size[b]
        idx = (self.bin_offset[b] + lane).clamp(max=self.bins.shape[0] - 1)
        safe = idx.masked_fill(~valid, 0).long()
        return self.bins[safe].masked_fill(~valid, 0), self.bin_size[b]


def classify(sizes: torch.Tensor, upper: Tuple[int, ...]) -> torch.Tensor:
    """Bin index per row: the first rung whose upper bound admits the size.

    Counting the bounds below each size is ``searchsorted(upper, sizes,
    side="left")``, the paper's Alg-1 scan over ``r_range``.  Sizes above
    the last bound land in the fallback rung ``len(upper)``.
    """
    out = torch.zeros(sizes.shape, dtype=torch.int32, device=sizes.device)
    for u in upper:
        out += sizes > u
    return out


def bin_rows(sizes: torch.Tensor, *, upper: Tuple[int, ...],
             num_bins: int) -> Binning:
    """Both passes.  ``sizes`` is n_prod (symbolic) or n_nz (numeric).

    Pass 1 (Alg 1): histogram of bin ids -> bin_size; max of sizes.
    Offsets: exclusive sum.  Pass 2 (Alg 2): stable counting-sort scatter.
    """
    dev = sizes.device
    m = sizes.shape[0]
    bin_of_row = classify(sizes, upper)
    bin_size = torch.zeros(num_bins, dtype=torch.int32, device=dev)
    bin_size.scatter_add_(0, bin_of_row.long(), torch.ones_like(bin_of_row))
    bin_offset = torch.zeros_like(bin_size)
    bin_offset[1:] = torch.cumsum(bin_size, 0)[:-1]
    max_size = sizes.max() if m else torch.zeros((), dtype=sizes.dtype,
                                                 device=dev)
    bins = torch.argsort(bin_of_row, stable=True).to(torch.int32)
    return Binning(bins=bins, bin_size=bin_size, bin_offset=bin_offset,
                   bin_of_row=bin_of_row, max_size=max_size)


def bin_rows_identity(sizes: torch.Tensor, num_bins: int) -> Binning:
    """Alg 3 fast path: every row fits bin 0 -> bins is the identity."""
    dev = sizes.device
    m = sizes.shape[0]
    bin_size = torch.zeros(num_bins, dtype=torch.int32, device=dev)
    bin_size[0] = m
    bin_offset = torch.full((num_bins,), m, dtype=torch.int32, device=dev)
    bin_offset[0] = 0
    return Binning(
        bins=torch.arange(m, dtype=torch.int32, device=dev),
        bin_size=bin_size,
        bin_offset=bin_offset,
        bin_of_row=torch.zeros(m, dtype=torch.int32, device=dev),
        max_size=sizes.max() if m else torch.zeros((), dtype=sizes.dtype,
                                                   device=dev),
    )


def bin_rows_for_ladder(sizes: torch.Tensor, ladder: BinLadder,
                        *, allow_fast_path: bool = True) -> Binning:
    """Cold-path entry: host-checks the Alg-3 fast path, then bins.

    The host read of ``max(sizes)`` mirrors the paper: the binning kernel
    writes d_max_row_nnz and the HOST decides which second-pass kernel to
    launch.
    """
    if allow_fast_path:
        max_size = int(sizes.max()) if sizes.shape[0] else 0
        if max_size <= ladder.upper[0]:
            return bin_rows_identity(sizes, num_bins=ladder.num_bins)
    return bin_rows(sizes, upper=ladder.upper, num_bins=ladder.num_bins)
