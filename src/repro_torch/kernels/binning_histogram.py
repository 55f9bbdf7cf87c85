"""Binning pass 1 (OpSparse Alg. 1) as a hand-written CUDA kernel.

Replaces the Pallas TPU kernel ``binning_histogram`` of
``repro/kernels/binning_pallas.py``, with the same name and keywords: each
block of ``block`` rows classifies its row sizes against the rung bounds,
keeps a local histogram, adds it once into ``bin_size``, and folds its
rows' maximum into ``max_size``.  The kernel is in
``csrc/binning_histogram.cu``; its plain version is
:func:`repro_torch.kernels.ref.binning_histogram_ref`.

Like the reference, the port's engine bins with tensor ops
(``core/binning.bin_rows``); this function is its own entry point.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import build
from .ref import binning_histogram_ref

MAX_RUNGS = 16       # bounds the kernel's parameter struct holds
MAX_BINS = 32        # bins its shared-memory histogram holds


@functools.lru_cache(maxsize=64)
def _bounds(upper: Tuple[int, ...]):
    return (ctypes.c_int * max(len(upper), 1))(*upper)


def binning_histogram(sizes: torch.Tensor, *, upper: Tuple[int, ...],
                      num_bins: int, block: int = 1024,
                      interpret: Optional[bool] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pass 1 of the binning method -> ``(bin_size (num_bins,) int32,
    max_size () int32)``.

    ``sizes`` (m,) of any integer type is read as int32.  ``block`` is the
    rows each CTA owns.  ``interpret`` has no effect (it selects the
    reference's Pallas interpreter): CPU tensors run the plain version,
    CUDA tensors the kernel, which raises rather than fall back.
    """
    upper = tuple(int(u) for u in upper)
    if not sizes.is_cuda:
        return binning_histogram_ref(sizes, upper=upper, num_bins=num_bins)
    if sizes.dim() != 1:
        raise ValueError(f"sizes must be 1-D, got {tuple(sizes.shape)}")
    if len(upper) > MAX_RUNGS or not 1 <= num_bins <= MAX_BINS or block < 1:
        raise ValueError(f"the kernel takes at most {MAX_RUNGS} bounds, 1 to "
                         f"{MAX_BINS} bins and block >= 1; got "
                         f"{len(upper)} bounds, {num_bins} bins, "
                         f"block={block}")
    dev = sizes.device
    sizes = sizes.to(torch.int32).contiguous()
    hist = torch.zeros(num_bins, dtype=torch.int32, device=dev)
    mx = torch.zeros((), dtype=torch.int32, device=dev)
    m = sizes.shape[0]
    if m:
        with torch.cuda.device(dev):
            err = build.library("binning_histogram").binning_histogram(
                sizes.data_ptr(), m, block, _bounds(upper), len(upper),
                num_bins, hist.data_ptr(), mx.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
        build.check(err, "binning_histogram")
        binning_histogram.launches += 1
    return hist, mx


binning_histogram.launches = 0
