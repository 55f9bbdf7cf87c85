"""Setup-step analysis (OpSparse Fig. 2 step 1): n_prod per row, CR.

The paper computes ``n_prod`` per output row in the setup step and stores
it in the (reused) ``C.rpt`` array (§5.3).  ``n_prod[i] = sum_k |B_{k*}|``
over the column ids k of A's row i: a gather and a segment sum, no
multiply.  The sampling estimator of the reference waits for a later
slice.
"""
from __future__ import annotations

import torch

from .csr import CSR


def nprod_per_entry(A: CSR, B: CSR) -> torch.Tensor:
    """(capA,) int32: |B row| for each stored entry of A (0 for padding)."""
    b_sizes = B.nnz_per_row()
    safe_col = A.col.clamp(max=B.nrows - 1).long()
    return b_sizes[safe_col].masked_fill(~A.entry_mask(), 0)


def nprod_into_rpt(A: CSR, B: CSR) -> torch.Tensor:
    """(M+1,) int32 buffer with ``[0:M] = n_prod per row`` and ``[M] = 0``.

    The metadata-minimization trick of §5.3: the n_prod (and later n_nz)
    vectors live in the storage that becomes ``C.rpt``.  Each row's sum is
    a difference of the running sum of the per-entry counts at its row
    pointers: deterministic, no atomics, no host sync.
    """
    per_entry = nprod_per_entry(A, B)
    running = torch.zeros(A.capacity + 1, dtype=torch.int64,
                          device=A.device)
    running[1:] = torch.cumsum(per_entry, 0)
    rpt = A.rpt.long()
    buf = torch.zeros(A.nrows + 1, dtype=torch.int32, device=A.device)
    buf[:-1] = running[rpt[1:]] - running[rpt[:-1]]
    return buf


def total_nprod(A: CSR, B: CSR) -> torch.Tensor:
    """Total intermediate products of A·B (int64 device scalar)."""
    return nprod_per_entry(A, B).sum(dtype=torch.int64)


def compression_ratio(A: CSR, B: CSR, C: CSR) -> float:
    """Paper Eq. (3): total n_prod / nnz(C)."""
    npd = int(total_nprod(A, B))
    nnz = int(C.nnz())
    return npd / max(nnz, 1)


def exclusive_sum_in_place(buf: torch.Tensor) -> torch.Tensor:
    """(M+1,) counts buffer -> row pointers (the cub ExclusiveSum step).

    Returns a new int32 buffer: callers keep views of the counts (the
    numeric binning reads ``nnz_buf[:m]``), so writing over them would
    change what those views see.
    """
    out = torch.zeros_like(buf)
    out[1:] = torch.cumsum(buf[:-1], 0)
    return out
