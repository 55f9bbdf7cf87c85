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
the sorted products (``kernels/segment_sum``), each key's products added
in order as the reference's scatter-add adds them, so the values are the
reference's bit for bit and the same on every run (CUDA ``index_add_`` on
floats adds in a different order each run, ``torch.segment_reduce`` in a
tree).

``workspace=(i32, val)`` hands the expansion its storage: an arena lease
(``core/workspace.Arena``) of at least ``2 * prod_capacity`` int32 cells
(row ids, then column ids) and ``prod_capacity`` value cells, written in
place.  The arrays are the ones the expansion makes without it, so no bit
of the result changes.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import scatter
from repro_torch.kernels.segment_sum import segment_sum

from .analysis import nprod_per_entry
from .csr import CSR


Workspace = Tuple[torch.Tensor, torch.Tensor]


def _check_workspace(out: Workspace, cap: int, dev: torch.device,
                     val_dtype: torch.dtype, with_values: bool) -> None:
    i32, val = out
    if (i32.dtype != torch.int32 or i32.dim() != 1 or i32.device != dev
            or not i32.is_contiguous() or i32.numel() < 2 * cap):
        raise ValueError(
            f"workspace int32 buffer must be a contiguous 1-D int32 tensor "
            f"of at least {2 * cap} cells on {dev}, got "
            f"{tuple(i32.shape)} {i32.dtype} on {i32.device}")
    if with_values and (val.dtype != val_dtype or val.dim() != 1
                        or val.device != dev or not val.is_contiguous()
                        or val.numel() < cap):
        raise ValueError(
            f"workspace value buffer must be a contiguous 1-D {val_dtype} "
            f"tensor of at least {cap} cells on {dev}, got "
            f"{tuple(val.shape)} {val.dtype} on {val.device}")


def expand_products(A: CSR, B: CSR, *, prod_capacity: int,
                    with_values: bool = True,
                    out: Optional[Workspace] = None):
    """Enumerate all intermediate products of C = A·B, row-major.

    Returns (rows, cols, vals, valid):
      rows/cols: (prod_capacity,) int32; padding = (M, N).
      vals:      (prod_capacity,) or None when ``with_values=False`` (the
                 symbolic phase skips the multiply, like the paper).
      valid:     (prod_capacity,) bool.

    Per-A-entry product counts -> exclusive offsets; product slot t finds
    its A entry by searchsorted and its B entry by ``t - offset[e]``.

    ``out=(i32, val)`` is the storage to write into instead of allocating:
    ``rows`` and ``cols`` are the first two ``prod_capacity`` slices of
    ``i32``, ``vals`` the first one of ``val`` (see the module notes).
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

    rows_out = cols_out = vals_out = None
    if out is not None:
        cap = prod_capacity
        _check_workspace(out, cap, dev,
                         torch.promote_types(A.val.dtype, B.val.dtype),
                         with_values)
        rows_out, cols_out = out[0][:cap], out[0][cap:2 * cap]
        vals_out = out[1][:cap]
    invalid = ~valid
    rows = torch.index_select(A.row_ids(), 0, e, out=rows_out)
    rows.masked_fill_(invalid, m)
    cols = torch.index_select(B.col, 0, b_idx, out=cols_out)
    cols.masked_fill_(invalid, n)
    vals = None
    if with_values:
        vals = torch.mul(A.val[e], B.val[b_idx], out=vals_out)
        vals.masked_fill_(invalid, 0)
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


def symbolic(A: CSR, B: CSR, *, prod_capacity: int,
             workspace: Optional[Workspace] = None) -> torch.Tensor:
    """Symbolic phase: (M+1,) int32 buffer with n_nz per row in [0:M]."""
    rows, cols, _, _ = expand_products(
        A, B, prod_capacity=prod_capacity, with_values=False, out=workspace)
    rows, cols, _ = _sort_products(rows, cols, None)
    is_new, _ = _is_new(rows, cols, A.nrows)
    buf = torch.zeros(A.nrows + 1, dtype=torch.int32, device=A.device)
    return scatter.count_into(buf, rows.long(), is_new.to(torch.int32),
                              limit=A.nrows)


def _compress(rows, cols, vals, is_new, is_real, nnz_capacity: int):
    """Write each distinct (row, col) key's column and summed value to its
    output slot; keys past ``nnz_capacity`` are dropped."""
    dev = rows.device
    out_idx = torch.cumsum(is_new.to(torch.int32), 0) - 1
    # Sorted products: real keys first (slots non-decreasing), padding
    # last; both past-capacity keys and padding go to the dump slot.
    seg = torch.where(is_real, out_idx, nnz_capacity).clamp(max=nnz_capacity)
    col_out = torch.zeros(nnz_capacity + 1, dtype=torch.int32, device=dev)
    scatter.scatter_kept(col_out, seg.long(), cols.masked_fill(~is_real, 0),
                         limit=nnz_capacity)
    bounds = torch.arange(nnz_capacity + 2, dtype=seg.dtype, device=dev)
    offsets = torch.searchsorted(seg, bounds)
    val_out = segment_sum(vals, offsets, n_real=nnz_capacity)
    return col_out[:nnz_capacity], val_out[:nnz_capacity]


def numeric(A: CSR, B: CSR, rpt: torch.Tensor, *, prod_capacity: int,
            nnz_capacity: int, workspace: Optional[Workspace] = None) -> CSR:
    """Numeric phase: fill C.col / C.val given the symbolic phase's ``rpt``.

    Rows come out sorted by column id (the global (row, col) sort gives the
    paper's per-row sort for free).
    """
    rows, cols, vals, _ = expand_products(
        A, B, prod_capacity=prod_capacity, with_values=True, out=workspace)
    rows, cols, vals = _sort_products(rows, cols, vals)
    is_new, is_real = _is_new(rows, cols, A.nrows)
    col, val = _compress(rows, cols, vals, is_new, is_real, nnz_capacity)
    return CSR(rpt=rpt, col=col, val=val, shape=(A.nrows, B.ncols))


def spgemm_fused(A: CSR, B: CSR, *, prod_capacity: int,
                 nnz_capacity: int,
                 workspace: Optional[Workspace] = None) -> CSR:
    """One-pass ESC SpGEMM (expand once, derive rpt AND values)."""
    m = A.nrows
    rows, cols, vals, _ = expand_products(
        A, B, prod_capacity=prod_capacity, with_values=True, out=workspace)
    rows, cols, vals = _sort_products(rows, cols, vals)
    is_new, is_real = _is_new(rows, cols, m)
    nnz_buf = torch.zeros(m + 1, dtype=torch.int32, device=A.device)
    scatter.count_into(nnz_buf, rows.long(), is_new.to(torch.int32),
                       limit=m)
    rpt = torch.zeros_like(nnz_buf)
    rpt[1:] = torch.cumsum(nnz_buf[:-1], 0)
    col, val = _compress(rows, cols, vals, is_new, is_real, nnz_capacity)
    return CSR(rpt=rpt, col=col, val=val, shape=(m, B.ncols))
