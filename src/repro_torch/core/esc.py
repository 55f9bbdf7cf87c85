"""ESC (expand–sort–compress) accumulator: the fallback rung and the oracle.

The paper's accumulator is a per-row shared-memory hash table; rows too big
for the largest table spill to a *global-memory* table (symbolic kernel8 /
numeric kernel7).  As in the reference package, the device-memory
accumulator here is a **sorted reduction**: expand every intermediate
product, sort by (row, col), and reduce duplicates.  It serves as the
``method="esc"`` accumulator, the fallback rung of the hash ladder, and an
oracle for the hash kernels.

Shapes are static: the expansion size is a caller-chosen bucket
``prod_capacity >= total_nprod``; padding products carry row id M / col id
N and sort to the end.  Duplicate values are reduced by a segment sum over
the sorted products (``torch.segment_reduce``): each output entry sums its
products in sorted order, so the result is the same on every run (CUDA
``index_add_`` on floats adds in a different order each run).
"""
from __future__ import annotations

import torch

from .analysis import nprod_per_entry
from .csr import CSR


def expand_products(A: CSR, B: CSR, *, prod_capacity: int,
                    with_values: bool = True):
    """Enumerate all intermediate products of C = A·B, row-major.

    Returns (rows, cols, vals, valid):
      rows/cols: (prod_capacity,) int32; padding = (M, N).
      vals:      (prod_capacity,) or None when ``with_values=False`` (the
                 symbolic phase skips the multiply, like the paper).
      valid:     (prod_capacity,) bool.

    Per-A-entry product counts -> exclusive offsets; product slot t finds
    its A entry by searchsorted and its B entry by ``t - offset[e]``.
    """
    m, n = A.nrows, B.ncols
    dev = A.device
    per_entry = nprod_per_entry(A, B)                        # (capA,)
    offsets = torch.zeros_like(per_entry)
    offsets[1:] = torch.cumsum(per_entry, 0)[:-1]
    total = per_entry.sum()

    t = torch.arange(prod_capacity, dtype=torch.int32, device=dev)
    valid = t < total
    # A entry owning product slot t: the last e with offsets[e] <= t.
    e = torch.searchsorted(offsets, t, right=True, out_int32=True) - 1
    e = e.clamp(0, max(A.capacity - 1, 0)).long()
    j = t - offsets[e]

    a_col = A.col[e].clamp(max=B.nrows - 1).long()
    b_idx = (B.rpt[a_col] + j).clamp(max=max(B.capacity - 1, 0)).long()

    rows = A.row_ids()[e].masked_fill(~valid, m)
    cols = B.col[b_idx].masked_fill(~valid, n)
    vals = None
    if with_values:
        vals = (A.val[e] * B.val[b_idx]).masked_fill(~valid, 0)
    return rows, cols, vals, valid


def _sort_products(rows, cols, vals):
    """Stable two-key (row, col) sort: a stable sort by col, then a stable
    sort by row (``lexsort``), the reference's order exactly."""
    by_col = torch.sort(cols, stable=True).indices
    by_row = torch.sort(rows[by_col], stable=True).indices
    order = by_col[by_row]
    return rows[order], cols[order], None if vals is None else vals[order]


def _is_new(rows, cols, m):
    """(is_new, is_real): first product of each (row, col) key, real rows."""
    is_new = torch.ones_like(rows, dtype=torch.bool)
    is_new[1:] = (rows[1:] != rows[:-1]) | (cols[1:] != cols[:-1])
    is_real = rows < m
    return is_new & is_real, is_real


def symbolic(A: CSR, B: CSR, *, prod_capacity: int) -> torch.Tensor:
    """Symbolic phase: (M+1,) int32 buffer with n_nz per row in [0:M]."""
    rows, cols, _, _ = expand_products(
        A, B, prod_capacity=prod_capacity, with_values=False)
    rows, cols, _ = _sort_products(rows, cols, None)
    is_new, _ = _is_new(rows, cols, A.nrows)
    buf = torch.zeros(A.nrows + 1, dtype=torch.int32, device=A.device)
    return buf.index_add_(0, rows.long(), is_new.to(torch.int32))


def _compress(rows, cols, vals, is_new, is_real, nnz_capacity: int):
    """Write each distinct (row, col) key's column and summed value to its
    output slot; keys past ``nnz_capacity`` are dropped."""
    dev = rows.device
    out_idx = torch.cumsum(is_new.to(torch.int32), 0) - 1
    # Sorted products: real keys first (slots non-decreasing), padding
    # last; both past-capacity keys and padding go to the dump slot.
    seg = torch.where(is_real, out_idx, nnz_capacity).clamp(max=nnz_capacity)
    col_out = torch.zeros(nnz_capacity + 1, dtype=torch.int32, device=dev)
    col_out[seg.long()] = cols.masked_fill(~is_real, 0)
    bounds = torch.arange(nnz_capacity + 2, dtype=seg.dtype, device=dev)
    offsets = torch.searchsorted(seg, bounds)
    val_out = torch.segment_reduce(vals, "sum", offsets=offsets, unsafe=True)
    return col_out[:nnz_capacity], val_out[:nnz_capacity]


def numeric(A: CSR, B: CSR, rpt: torch.Tensor, *, prod_capacity: int,
            nnz_capacity: int) -> CSR:
    """Numeric phase: fill C.col / C.val given the symbolic phase's ``rpt``.

    Rows come out sorted by column id (the global (row, col) sort gives the
    paper's per-row sort for free).
    """
    rows, cols, vals, _ = expand_products(
        A, B, prod_capacity=prod_capacity, with_values=True)
    rows, cols, vals = _sort_products(rows, cols, vals)
    is_new, is_real = _is_new(rows, cols, A.nrows)
    col, val = _compress(rows, cols, vals, is_new, is_real, nnz_capacity)
    return CSR(rpt=rpt, col=col, val=val, shape=(A.nrows, B.ncols))


def spgemm_fused(A: CSR, B: CSR, *, prod_capacity: int,
                 nnz_capacity: int) -> CSR:
    """One-pass ESC SpGEMM (expand once, derive rpt AND values)."""
    m = A.nrows
    rows, cols, vals, _ = expand_products(
        A, B, prod_capacity=prod_capacity, with_values=True)
    rows, cols, vals = _sort_products(rows, cols, vals)
    is_new, is_real = _is_new(rows, cols, m)
    nnz_buf = torch.zeros(m + 1, dtype=torch.int32, device=A.device)
    nnz_buf.index_add_(0, rows.long(), is_new.to(torch.int32))
    rpt = torch.zeros_like(nnz_buf)
    rpt[1:] = torch.cumsum(nnz_buf[:-1], 0)
    col, val = _compress(rows, cols, vals, is_new, is_real, nnz_capacity)
    return CSR(rpt=rpt, col=col, val=val, shape=(m, B.ncols))
