"""Binning pass 1 (OpSparse Alg. 1) as a hand-written CUDA kernel.

Replaces the Pallas TPU kernel ``binning_histogram`` of
``repro/kernels/binning_pallas.py``, with the same name and keywords: each
row's size is classified against the rung bounds, the rows of each rung
are counted into ``bin_size`` and the largest size into ``max_size``.
The kernel (``csrc/binning_histogram.cu``) counts in registers, per thread
and bound, the rows above it, on a grid the size of the card; its plain
version is :func:`repro_torch.kernels.ref.binning_histogram_ref`.

Pass 1 of ``core/workspace.bin_rows_into`` (the fused metadata buffer)
is this function, writing into the buffer's cells through ``out``; like
the reference, the engine's own binning is tensor ops
(``core/binning.bin_rows``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import build
from .ref import binning_histogram_ref

MAX_RUNGS = 16       # bounds the kernel's parameter struct holds
MAX_BINS = 32        # bins it counts


@functools.lru_cache(maxsize=64)
def _bounds(upper: Tuple[int, ...]):
    return (ctypes.c_int * max(len(upper), 1))(*upper)


def binning_histogram(sizes: torch.Tensor, *, upper: Tuple[int, ...],
                      num_bins: int, block: int = 1024,
                      interpret: Optional[bool] = None,
                      out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pass 1 of the binning method -> ``(bin_size (num_bins,) int32,
    max_size () int32)``.

    ``sizes`` (m,) of any integer type is read as int32; ``upper`` may
    come in any order.  ``block`` is the rows a CTA takes per step of its
    walk (no result depends on it).  ``interpret`` has no effect (it
    selects the reference's Pallas interpreter): CPU tensors run the plain
    version, CUDA tensors the kernel, which raises rather than fall back.
    ``out``, a ``(num_bins,)`` and a ``()`` int32 tensor on the device of
    ``sizes`` (the cells of a fused metadata buffer), receives the result
    in place and is returned.
    """
    upper = tuple(int(u) for u in upper)
    if out is not None:
        hist, mx = out
        if (hist.shape != (num_bins,) or mx.shape != ()
                or hist.dtype != torch.int32 or mx.dtype != torch.int32
                or not hist.is_contiguous()
                or hist.device != sizes.device or mx.device != sizes.device):
            raise ValueError(
                f"out must be a contiguous ({num_bins},) and a () int32 "
                f"tensor on {sizes.device}")
    if not sizes.is_cuda:
        want = binning_histogram_ref(sizes, upper=upper, num_bins=num_bins)
        if out is None:
            return want
        hist.copy_(want[0])
        mx.copy_(want[1])
        return hist, mx
    if sizes.dim() != 1:
        raise ValueError(f"sizes must be 1-D, got {tuple(sizes.shape)}")
    if len(upper) > MAX_RUNGS or not 1 <= num_bins <= MAX_BINS or block < 1:
        raise ValueError(f"the kernel takes at most {MAX_RUNGS} bounds, 1 to "
                         f"{MAX_BINS} bins and block >= 1; got "
                         f"{len(upper)} bounds, {num_bins} bins, "
                         f"block={block}")
    dev = sizes.device
    m = sizes.shape[0]
    if out is None:
        # One buffer, zeroed by the entry point: bin_size, then max_size.
        buf = torch.empty(num_bins + 1, dtype=torch.int32, device=dev)
        hist, mx = buf.narrow(0, 0, num_bins), buf.select(0, num_bins)
    if not m:
        hist.zero_()
        mx.zero_()
        return hist, mx
    # The host's part of a call is close to the kernel's time even at
    # delaunay_n24's 16.7M rows, so each step below takes the cheapest
    # call: no copy of int32 contiguous sizes, the raw stream handle, the
    # device entered only when it is not the current one.
    if sizes.dtype != torch.int32 or not sizes.is_contiguous():
        sizes = sizes.to(torch.int32).contiguous()
    args = (sizes.data_ptr(), m, block, _bounds(upper), len(upper), num_bins,
            hist.data_ptr(), mx.data_ptr(),
            torch._C._cuda_getCurrentRawStream(dev.index))
    entry = build.library("binning_histogram").binning_histogram
    if dev.index == torch.cuda.current_device():
        err = entry(*args)
    else:
        with torch.cuda.device(dev):
            err = entry(*args)
    build.check(err, "binning_histogram")
    binning_histogram.launches += 1
    return hist, mx


binning_histogram.launches = 0
