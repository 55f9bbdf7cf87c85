"""In-order segment sums: the ESC accumulator's value sums, as a
hand-written CUDA kernel.

The reference's ESC accumulator (``repro/core/esc.py``) sums each key's
products with a jnp scatter-add, one product at a time in order: no
Pallas kernel stands behind it.  ``torch.segment_reduce`` sums them on
the card in another order, so ``core/esc._compress`` calls
:func:`segment_sum`: on CUDA tensors the kernel of ``csrc/segment_sum.cu``
(one thread a segment, a rounded add per value, in order), on CPU tensors
the plain version :func:`segment_sum_plain`.  Either gives each segment
the left fold ((0 + v1) + v2) + ..., the reference's sum bit for bit.
"""
from __future__ import annotations

import torch

from . import build

# The kernel's value types, by its C entry point's code.
_DTYPES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2,
           torch.float16: 3}


def segment_sum_plain(vals: torch.Tensor, offsets: torch.Tensor, *,
                      n_real: int) -> torch.Tensor:
    """Plain version of :func:`segment_sum`: step s adds the s-th value of
    every segment still that long, so each segment is summed in order."""
    starts = offsets[:-1]
    lens = (offsets[1:] - starts).clone()
    lens[n_real:] = 0
    out = torch.zeros(lens.shape[0], dtype=vals.dtype, device=vals.device)
    last = max(vals.shape[0] - 1, 0)
    for s in range(int(lens.max()) if lens.numel() else 0):
        live = lens > s
        out = torch.where(live, out + vals[(starts + s).clamp(max=last)],
                          out)
    return out


def segment_sum(vals: torch.Tensor, offsets: torch.Tensor, *,
                n_real: int) -> torch.Tensor:
    """``out[k]`` = the in-order sum of ``vals[offsets[k]:offsets[k+1]]``
    for ``k < n_real``, and 0 for the segments past it (``offsets`` holds
    one entry more than ``out``; ``n_real`` is the caller's dump-slot
    cut).  CPU tensors run the plain version, CUDA tensors the kernel
    (float32, float64, bfloat16 or float16 values, int64 offsets), which
    raises rather than fall back."""
    if not vals.is_cuda:
        return segment_sum_plain(vals, offsets, n_real=n_real)
    if (vals.dtype not in _DTYPES or offsets.dtype != torch.int64
            or not vals.is_contiguous() or not offsets.is_contiguous()
            or offsets.device != vals.device or offsets.dim() != 1):
        raise ValueError(
            f"segment_sum takes contiguous values of one of "
            f"{tuple(_DTYPES)} and 1-D int64 offsets on one device; got {vals.dtype} on {vals.device} and "
            f"{offsets.dtype} {tuple(offsets.shape)} on {offsets.device}")
    dev = vals.device
    n_out = offsets.shape[0] - 1
    out = torch.empty(max(n_out, 0), dtype=vals.dtype, device=dev)
    with torch.cuda.device(dev):
        err = build.library("segment_sum").segment_sum(
            vals.data_ptr(), offsets.data_ptr(), min(int(n_real), n_out),
            n_out, out.data_ptr(), _DTYPES[vals.dtype],
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "segment_sum")
    segment_sum.launches += 1
    return out


segment_sum.launches = 0
