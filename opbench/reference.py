"""The plain reference for C = A·A and the comparison that decides
``correct``.

The reference expands every product of a block of rows (each entry a_ik
of A times each entry of B's row k), keys it by (row, column), and sums
equal keys in float64: plain PyTorch on the operand's device, in blocks
of at most ``BLOCK_PRODUCTS`` products, so it fits beside what the
program left.  It takes A's CSR arrays as the benchmark made them and
imports nothing of the program.

The comparison of one product C (its ``rpt``, ``col`` and ``val`` as the
timed path returned them) with the reference gives:

  pattern_mismatch  rows whose size or columns differ from the
                    reference's, plus 1 if the reported totals differ
                    (exact: limit 0);
  val_err           the largest |c_ij - ref_ij| / (|A|·|A|)_ij over the
                    entries of rows whose pattern matches, the entry's
                    error against the scale every summation order shares.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import torch

BLOCK_PRODUCTS = 1 << 25


@dataclasses.dataclass
class RefBlock:
    """The reference's C over rows [r0, r1)."""
    r0: int
    r1: int
    sizes: torch.Tensor      # (r1 - r0,) int64 entries per row
    col: torch.Tensor        # int64, sorted within each row
    val: torch.Tensor        # float64 sums
    scale: torch.Tensor      # float64 sums of |a_ik b_kj|


def row_products(rpt: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    """(n,) int64 products per row of A·A (B = A): the sum of B's row
    sizes over each row's columns."""
    sizes = (rpt[1:] - rpt[:-1]).long()
    per_entry = sizes[col.long()]
    rows = torch.repeat_interleave(
        torch.arange(sizes.shape[0], device=col.device), sizes)
    out = torch.zeros_like(sizes)
    out.index_add_(0, rows, per_entry)
    return out


def row_blocks(nprod_rows: torch.Tensor,
               limit: int = BLOCK_PRODUCTS) -> List[Tuple[int, int]]:
    """Consecutive row ranges of at most ``limit`` products each (a
    single row above it gets a block of its own)."""
    ends = torch.cumsum(nprod_rows, 0).cpu().tolist()
    blocks, start, base = [], 0, 0
    for i, e in enumerate(ends):
        if e - base > limit and i > start:
            blocks.append((start, i))
            start, base = i, ends[i - 1]
    blocks.append((start, len(ends)))
    return blocks


def reference_block(rpt: torch.Tensor, col: torch.Tensor,
                    val: torch.Tensor, r0: int, r1: int) -> RefBlock:
    """A·A over rows [r0, r1) by expansion, sort and float64 sums."""
    dev = col.device
    n = rpt.shape[0] - 1
    e0, e1 = int(rpt[r0]), int(rpt[r1])
    sizes_b = (rpt[1:] - rpt[:-1]).long()
    k = col[e0:e1].long()
    a = val[e0:e1].double()
    a_rows = torch.repeat_interleave(
        torch.arange(r0, r1, device=dev), sizes_b[r0:r1])
    counts = sizes_b[k]
    src = torch.repeat_interleave(
        torch.arange(e1 - e0, device=dev), counts)
    first = torch.cumsum(counts, 0) - counts
    pos = torch.arange(src.shape[0], device=dev) - first[src]
    b_idx = rpt[k].long()[src] + pos
    del first, pos
    key = a_rows[src] * n + col[b_idx].long()
    prod = a[src] * val[b_idx].double()
    del src, b_idx
    uniq, inv = torch.unique(key, sorted=True, return_inverse=True)
    del key
    sums = torch.zeros(uniq.shape[0], dtype=torch.float64, device=dev)
    sums.index_add_(0, inv, prod)
    scale = torch.zeros_like(sums)
    scale.index_add_(0, inv, prod.abs())
    rows = uniq // n
    sizes = torch.bincount(rows - r0, minlength=r1 - r0)
    return RefBlock(r0, r1, sizes, uniq % n, sums, scale)


def reference_blocks(rpt, col, val):
    """The reference's C block by block (a generator: one block held)."""
    for r0, r1 in row_blocks(row_products(rpt, col)):
        yield reference_block(rpt, col, val, r0, r1)


@dataclasses.dataclass
class Check:
    """What one comparison found."""
    pattern_mismatch: int = 0
    val_err: float = 0.0

    def merge(self, other: "Check") -> "Check":
        errs = (self.val_err, other.val_err)
        worst = (float("nan") if any(math.isnan(e) for e in errs)
                 else max(errs))
        return Check(self.pattern_mismatch + other.pattern_mismatch, worst)


def compare_block(ref: RefBlock, c_rpt: torch.Tensor, c_col: torch.Tensor,
                  c_val: torch.Tensor) -> Check:
    """One reference block against the program's C (its full arrays)."""
    r0, r1 = ref.r0, ref.r1
    dev = ref.col.device
    c_sizes = (c_rpt[r0 + 1:r1 + 1] - c_rpt[r0:r1]).long()
    same_size = c_sizes == ref.sizes
    # The reference's entries, and where each sits in the program's C.
    rows = torch.repeat_interleave(torch.arange(r1 - r0, device=dev),
                                   ref.sizes)
    ref_first = torch.cumsum(ref.sizes, 0) - ref.sizes
    pos = c_rpt[r0:r1].long()[rows] + (
        torch.arange(rows.shape[0], device=dev) - ref_first[rows])
    live = same_size[rows]
    pos = torch.where(live, pos, torch.zeros_like(pos)).clamp(
        0, max(c_col.shape[0] - 1, 0))
    col_ok = (c_col[pos].long() == ref.col) | ~live
    row_ok = same_size.clone()
    bad_rows = rows[~col_ok]
    row_ok[bad_rows] = False
    mismatch = int((~row_ok).sum())
    good = row_ok[rows]
    err = ((c_val[pos].double() - ref.val).abs()
           / ref.scale.clamp(min=torch.finfo(torch.float64).tiny))
    err = torch.where(good, err, torch.zeros_like(err))
    return Check(mismatch, float(err.max()) if err.numel() else 0.0)


def compare(rpt, col, val, outputs, on_block=None) -> List[Check]:
    """Each of ``outputs`` (``(c_rpt, c_col, c_val, total_nnz)`` tuples)
    against the reference of A·A, computed once, block by block.
    ``on_block(ref)`` sees each reference block (the counts read C's
    row sizes from it)."""
    checks = [Check() for _ in outputs]
    n = rpt.shape[0] - 1
    ref_nnz = 0
    for ref in reference_blocks(rpt, col, val):
        ref_nnz += int(ref.sizes.sum())
        if on_block is not None:
            on_block(ref)
        for i, (c_rpt, c_col, c_val, _) in enumerate(outputs):
            if c_rpt.shape[0] != n + 1:
                continue
            checks[i] = checks[i].merge(compare_block(ref, c_rpt, c_col,
                                                      c_val))
    for i, (c_rpt, _, _, total_nnz) in enumerate(outputs):
        if c_rpt.shape[0] != n + 1:
            checks[i] = Check(n, float("inf"))
        elif int(c_rpt[-1]) != ref_nnz or int(total_nnz) != ref_nnz:
            checks[i].pattern_mismatch += 1
    return checks
