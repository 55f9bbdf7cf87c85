"""Scatters with a drop target: the port's dump-slot writes, as
hand-written CUDA kernels.

The port writes by index in a few places and sends every write it drops
to a dump slot at index ``limit`` (the epilogue's masked lanes, the
fallback's padding, the binning's and ESC's counts, the sharded merge).
torch's ``index_put_`` / ``index_add_`` make the dropped writes too, all
on one slot, and under ``torch.use_deterministic_algorithms(True)`` they
sort the indices and walk each run of equal ones with one thread: the
dump slot's run is hundreds of millions long on mono_500Hz.  None of these
writes needs an order: a kept target gets one value (or several equal
ones), and integer counts commute.  So the port calls
:func:`scatter_kept` and :func:`count_into` at those places: on CUDA
tensors the kernels of ``csrc/scatter.cu``, which skip the dropped
writes; on CPU tensors their plain versions.  Nothing is read from the
dump slot, so its content is left unspecified.
"""
from __future__ import annotations

import torch

from . import build


def _check(dst, index, src, sizes, what):
    if (dst.element_size() not in sizes or src.dtype != dst.dtype
            or index.dtype != torch.int64 or not dst.is_contiguous()
            or not src.is_contiguous() or not index.is_contiguous()
            or index.shape != src.shape
            or not (dst.device == index.device == src.device)):
        raise ValueError(
            f"{what} takes a contiguous dst and src of one dtype of "
            f"{sizes} bytes and a contiguous int64 index of src's shape, on "
            f"one device; got dst {dst.dtype} {tuple(dst.shape)} on "
            f"{dst.device}, index {index.dtype} {tuple(index.shape)}, src "
            f"{src.dtype} {tuple(src.shape)}")


def scatter_kept_plain(dst, index, src, *, limit: int):
    """Plain version of :func:`scatter_kept` (the dropped writes land in
    the dump slot)."""
    dst[index] = src
    return dst


def scatter_kept(dst, index, src, *, limit: int):
    """``dst[index[i]] = src[i]`` for every ``index[i] < limit``; the other
    writes are dropped.  Each kept target gets one value, or equal values.
    2-, 4- or 8-byte elements on the card.  CPU tensors run the plain
    version, CUDA tensors the kernel, which raises rather than fall back.
    Returns ``dst``."""
    if not dst.is_cuda:
        return scatter_kept_plain(dst, index, src, limit=limit)
    _check(dst, index, src, (2, 4, 8), "scatter_kept")
    dev = dst.device
    with torch.cuda.device(dev):
        err = build.library("scatter").scatter_kept(
            dst.data_ptr(), index.data_ptr(), src.data_ptr(), index.numel(),
            int(limit), dst.element_size(),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "scatter_kept")
    scatter_kept.launches += 1
    return dst


scatter_kept.launches = 0


def count_into_plain(dst, index, src, *, limit: int):
    """Plain version of :func:`count_into` (the dropped counts land in the
    dump slot)."""
    return dst.index_add_(0, index, src)


def count_into(dst, index, src, *, limit: int):
    """``dst[index[i]] += src[i]`` for every ``index[i] < limit`` (int32);
    the other counts are dropped.  CPU tensors run the plain version, CUDA
    tensors the kernel, which raises rather than fall back.  Returns
    ``dst``."""
    if not dst.is_cuda:
        return count_into_plain(dst, index, src, limit=limit)
    if dst.dtype != torch.int32:
        raise ValueError(f"count_into adds int32 counts, got {dst.dtype}")
    _check(dst, index, src, (4,), "count_into")
    dev = dst.device
    with torch.cuda.device(dev):
        err = build.library("scatter").count_into(
            dst.data_ptr(), index.data_ptr(), src.data_ptr(), index.numel(),
            int(limit), torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "count_into")
    count_into.launches += 1
    return dst


count_into.launches = 0
