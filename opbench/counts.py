"""Bytes and operations a product needs at least, counted from the
matrices the benchmark made, and the card's peaks they are held against.

Each input byte is counted read once and each output byte written once,
whatever a kernel reads again; operations are 2 a product (a multiply
and an add).  A CSR matrix of n rows and z entries is 4 (n + 1) bytes of
row pointers and z (4 + value bytes) of columns and values.  A least
time is the larger of bytes over the memory bandwidth and operations over
the peak rate of the operand's type; ``bound`` names the larger.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

# Published dense peaks of one H100 SXM at its 700 W limit (NVIDIA's data
# sheet): HBM3 bandwidth, and FLOP/s by type outside (float32) or inside
# (16-bit) the tensor cores.
PEAKS = {
    "H100": {"bytes_per_s": 3.35e12,
             "flops": {"float32": 67e12, "bfloat16": 989e12,
                       "float16": 989e12}},
}


def peaks_of(device_name: str) -> Optional[dict]:
    """The peaks of the card named ``device_name``, or None."""
    for key, peaks in PEAKS.items():
        if key in device_name:
            return peaks
    return None


@dataclasses.dataclass(frozen=True)
class Work:
    bytes: int
    flops: int

    def least_s(self, peaks: dict, dtype: str):
        """``(seconds, bound)``: the least time and what bounds it."""
        t_bytes = self.bytes / peaks["bytes_per_s"]
        t_ops = self.flops / peaks["flops"][dtype]
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "flops")


def csr_bytes(rows: int, nnz: int, value_bytes: int) -> int:
    return 4 * (rows + 1) + nnz * (4 + value_bytes)


def product_work(n: int, a_nnz: int, c_nnz: int, nprod: int,
                 value_bytes: int) -> Work:
    """The whole product C = A·B with B = A: A, B and C each once."""
    return Work(2 * csr_bytes(n, a_nnz, value_bytes)
                + csr_bytes(n, c_nnz, value_bytes), 2 * nprod)


def table_rows_work(rpt: torch.Tensor, col: torch.Tensor,
                    nprod_rows: torch.Tensor, c_sizes: torch.Tensor,
                    max_nprod: int, value_bytes: int) -> Work:
    """The hash-table work of A·A (B = A): the rows with 1 to
    ``max_nprod`` products.  Read: their row pointers and A entries, and
    the distinct B rows they reference (row pointers and entries).
    Written: their C entries and each row's size."""
    sizes = (rpt[1:] - rpt[:-1]).long()
    rows = (nprod_rows > 0) & (nprod_rows <= max_nprod)
    entry_row = torch.repeat_interleave(
        torch.arange(sizes.shape[0], device=col.device), sizes)
    cols = col.long()[rows[entry_row]]
    mark = torch.zeros_like(rows)
    mark[cols] = True
    n_rows = int(rows.sum())
    a_entries = int(sizes[rows].sum())
    b_rows = int(mark.sum())
    b_entries = int(sizes[mark].sum())
    c_entries = int(c_sizes[rows].sum())
    per = 4 + value_bytes
    read = 8 * n_rows + a_entries * per + 8 * b_rows + b_entries * per
    written = c_entries * per + 4 * n_rows
    return Work(read + written, 2 * int(nprod_rows[rows].sum()))
