"""Block-CSR sparse x dense product as a hand-written CUDA kernel.

Replaces the Pallas TPU kernel ``bsr_spmm`` of ``repro/kernels/bsr_spmm.py``
(same name and result; the reference's ``interpret`` switch of its
Pallas interpreter has no counterpart): blocks are COO-listed in block-row
order, ``blk_rows``/``blk_cols`` (nnzb,) int32 and ``blocks`` (nnzb, bm,
bk), and each block's product with its ``bk``-row stripe of ``dense`` is
summed in float32 into its block row's ``bm``-row stripe of the output.

The kernels (``csrc/bsr_spmm.cu``) take one CTA per (block row, row
slice, column tile) and walk the block row's blocks between row pointers
that this wrapper builds on the device from the sorted ``blk_rows``
(``torch.searchsorted``: no host read).  bfloat16 and float16 run on the
tensor cores (one kernel template, ``wgmma`` in the type's variant over a
ring of cp.async stages, 128 x 128 tiles, float32 sums); float32 on
the CUDA cores (8 x 8 sums a thread in 128 x 128 tiles over a ring of
cp.async stages).  Block rows with no block come out zero, where the TPU
kernel leaves them unwritten.  The plain version is
:func:`repro_torch.kernels.ref.bsr_spmm_ref`.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import build
from .ref import bsr_spmm_ref

_ENTRY = {torch.float32: "bsr_spmm_f32", torch.bfloat16: "bsr_spmm_bf16",
          torch.float16: "bsr_spmm_f16"}


def block_row_pointers(blk_rows: torch.Tensor,
                       n_block_rows: int) -> torch.Tensor:
    """(n_block_rows + 1,) int32: where each block row's blocks start in
    the sorted ``blk_rows`` (entries outside [0, n_block_rows) fall in no
    range)."""
    bounds = torch.arange(n_block_rows + 1, dtype=torch.int32,
                          device=blk_rows.device)
    return torch.searchsorted(blk_rows, bounds, out_int32=True)


def occupancy(dtype: torch.dtype, device=None) -> Tuple[int, int]:
    """(dynamic shared memory bytes per CTA, CTAs per SM) of the kernel of
    ``dtype`` (float32, bfloat16 or float16) on the card."""
    smem = torch.zeros(1, dtype=torch.int32)
    ctas = torch.zeros(1, dtype=torch.int32)
    entry = _ENTRY[dtype] + "_occupancy"
    with torch.cuda.device(device):
        build.check(getattr(build.library("bsr_spmm"), entry)(
            smem.data_ptr(), ctas.data_ptr()), entry)
    return int(smem[0]), int(ctas[0])


def bsr_spmm(blk_rows: torch.Tensor, blk_cols: torch.Tensor,
             blocks: torch.Tensor, dense: torch.Tensor, *,
             n_block_rows: int) -> torch.Tensor:
    """(BCSR blocks) @ dense -> (n_block_rows * bm, N) in ``dense.dtype``.

    ``blk_rows`` must be sorted (CSR block order); padding entries repeat
    the last row with a zero block.  ``dense`` is (K, N) with K a multiple
    of bk.  CPU tensors run the plain version, CUDA tensors (float32,
    bfloat16 or float16) the kernel, which raises rather than fall back.
    """
    nnzb, bm, bk = blocks.shape
    if dense.dim() != 2 or dense.shape[0] % bk:
        raise ValueError(f"dense {tuple(dense.shape)} is not (K, N) with K "
                         f"a multiple of bk={bk}")
    if not blocks.is_cuda:
        return bsr_spmm_ref(blk_rows, blk_cols, blocks, dense,
                            nrows_blocks=n_block_rows, block_shape=(bm, bk))
    dev = blocks.device
    for name, x in (("blk_rows", blk_rows), ("blk_cols", blk_cols)):
        if x.device != dev or x.dtype != torch.int32 or x.shape != (nnzb,):
            raise ValueError(f"{name}: expected ({nnzb},) int32 on {dev}, "
                             f"got {tuple(x.shape)} {x.dtype} on {x.device}")
    entry = _ENTRY.get(blocks.dtype)
    if entry is None or dense.dtype != blocks.dtype or dense.device != dev:
        raise ValueError(f"the kernel takes float32, bfloat16 or float16 "
                         f"blocks and "
                         f"dense of one type on {dev}; got {blocks.dtype} "
                         f"and {dense.dtype} on {dense.device}")
    n = dense.shape[1]
    out = torch.empty((n_block_rows * bm, n), dtype=dense.dtype, device=dev)
    if not out.numel():
        return out
    blk_rows = blk_rows.contiguous()
    ptr = block_row_pointers(blk_rows, n_block_rows)
    blk_cols, blocks, dense = (blk_cols.contiguous(), blocks.contiguous(),
                               dense.contiguous())
    with torch.cuda.device(dev):
        err = getattr(build.library("bsr_spmm"), entry)(
            ptr.data_ptr(), blk_cols.data_ptr(), blocks.data_ptr(),
            dense.data_ptr(), out.data_ptr(), n_block_rows, bm, bk, n,
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, entry)
    bsr_spmm.launches += 1
    bsr_spmm.launches_by_entry[entry] += 1
    return out


# Launches of all three kernels, and of each C entry point apart (by its
# name in _ENTRY).
bsr_spmm.launches = 0
bsr_spmm.launches_by_entry = dict.fromkeys(_ENTRY.values(), 0)
