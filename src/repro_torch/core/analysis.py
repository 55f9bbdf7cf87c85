"""Setup-step analysis (OpSparse Fig. 2 step 1): n_prod per row, CR.

The paper computes ``n_prod`` per output row in the setup step and stores
it in the (reused) ``C.rpt`` array (§5.3).  ``n_prod[i] = sum_k |B_{k*}|``
over the column ids k of A's row i: a gather and a segment sum, no
multiply.

The estimator behind ``plan_mode="estimate"`` (a copy of the reference's,
which is numpy already) replaces the full symbolic pass on cold plans:
n_prod per row is exact and cheap, so only the compression nnz_i/nprod_i
is sampled.  A small deterministic row sample is measured exactly (per-row
column union), the sampled ratios give a [r_lo, r_hi] band, and every
row's possible nnz range feeds a range histogram over the numeric ladder.
It runs on the host over one fetch of the operands' index arrays and
launches nothing on the device; its arithmetic is int64 numpy or Python
int, so products past 2^31 do not wrap.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
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


def row_flops(A: CSR, B: CSR) -> np.ndarray:
    """(M,) int64 HOST array: flop estimate per output row, 2 * n_prod
    (one multiply and one add per intermediate product).

    The load-balance weight of row-block sharding: splitting A by
    cumulative row flops rather than by row count keeps the shards of a
    skewed matrix even.  The doubling happens on the host in int64, since
    ``2 * nprod`` in int32 wraps.  This read is the partitioner's one
    cold-call host sync.
    """
    nprod = nprod_into_rpt(A, B)[:A.nrows].cpu().numpy()
    return 2 * nprod.astype(np.int64)


def compression_ratio(A: CSR, B: CSR, C: CSR) -> float:
    """Paper Eq. (3): total n_prod / nnz(C)."""
    npd = int(total_nprod(A, B))
    nnz = int(C.nnz())
    return npd / max(nnz, 1)


def exclusive_sum_in_place(
        buf: torch.Tensor) -> torch.Tensor:  # opslint: donates=buf
    """(M+1,) counts buffer -> row pointers (the cub ExclusiveSum step).

    Returns a new int32 buffer: callers keep views of the counts (the
    numeric binning reads ``nnz_buf[:m]``), so writing over them would
    change what those views see.  The buffer is donated all the same, as
    the reference donates it to XLA: a caller reads the row pointers from
    the result and never ``buf`` again (opslint's DON001 holds call sites
    to that), so the sum stays free to reuse the buffer.
    """
    out = torch.zeros_like(buf)
    out[1:] = torch.cumsum(buf[:-1], 0)
    return out



@dataclasses.dataclass(frozen=True)
class ResultEstimate:
    """Host-side sizing prediction for C = A·B, from n_prod + a row sample.

    Everything the engine needs to specialize a plan without the full
    symbolic pass.  ``sym_*`` fields are EXACT (n_prod is exact);
    ``num_*`` / ``total_nnz_high`` are conservative band-derived upper
    estimates whose misses the overflow grow-and-redo path corrects.
    """

    sym_counts: Tuple[int, ...]    # exact rows per sym rung (+fallback last)
    sym_fall_prod: int             # exact Σ n_prod over sym-fallback rows
    num_counts: Tuple[int, ...]    # band upper-count per num rung (+fallback)
    num_fall_prod: int             # band-high Σ n_prod over possible num-fallback rows
    total_nprod: int               # exact Σ n_prod (int64-safe python int)
    total_nnz_high: int            # band-high Σ nnz  (nnz-capacity sizing)
    r_lo: float                    # sampled compression-ratio band
    r_hi: float
    sampled_rows: int              # rows actually measured (nprod > 0)


def _classify_np(x: np.ndarray, upper: Tuple[int, ...]) -> np.ndarray:
    """Host mirror of ``binning.classify``: rung index per size, with
    sizes above ``upper[-1]`` landing on the fallback rung ``len(upper)``."""
    return np.searchsorted(np.asarray(upper, dtype=np.int64), x, side="left")


def sample_rows_for_estimate(nprod: np.ndarray, n_sample: int) -> np.ndarray:
    """Deterministic stratified sample of rows with ``nprod > 0``.

    Top-k heaviest rows (they dominate both flops and the nnz total, and
    the tail of the ratio distribution lives there) plus a stride across
    the remaining size-sorted rows so every size stratum is represented.
    Returns row ids, possibly fewer than ``n_sample`` (never more).
    """
    nonzero = np.flatnonzero(nprod > 0)
    if nonzero.size <= n_sample:
        return nonzero.astype(np.int64)
    order = nonzero[np.argsort(nprod[nonzero], kind="stable")][::-1]
    k = max(n_sample // 4, 1)
    rest = order[k:]
    n_strided = n_sample - k
    stride_idx = (np.arange(n_strided, dtype=np.int64)
                  * rest.size // n_strided)
    return np.concatenate([order[:k], rest[stride_idx]])


def host_index(M: CSR) -> Tuple[np.ndarray, np.ndarray]:
    """(rpt, col) int64 HOST copies of a CSR's index arrays (one fetch,
    values untouched)."""
    return (M.rpt.cpu().numpy().astype(np.int64),
            M.col.cpu().numpy().astype(np.int64))


def host_nprod(a_rpt: np.ndarray, a_col: np.ndarray,
               b_rpt: np.ndarray) -> np.ndarray:
    """(M,) int64 n_prod per row from host index arrays — the same
    quantity as ``nprod_into_rpt`` without compiling anything.

    Padding entries beyond ``a_rpt[-1]`` (and any out-of-range column)
    contribute 0, mirroring the device kernel's entry mask.  The per-row
    sum is a cumulative-sum difference at the row pointers, so the whole
    thing is three vectorized passes over the entry array.
    """
    nb = b_rpt.shape[0] - 1
    if nb <= 0:
        return np.zeros(a_rpt.shape[0] - 1, dtype=np.int64)
    b_len = b_rpt[1:] - b_rpt[:-1]
    in_range = (a_col >= 0) & (a_col < nb)
    contrib = np.where(in_range, b_len[np.clip(a_col, 0, nb - 1)], 0)
    cs = np.concatenate([np.zeros(1, np.int64),
                         np.cumsum(contrib, dtype=np.int64)])
    return cs[a_rpt[1:]] - cs[a_rpt[:-1]]


def measure_sample_nnz(rows: np.ndarray,
                       a_rpt: np.ndarray, a_col: np.ndarray,
                       b_rpt: np.ndarray, b_col: np.ndarray) -> np.ndarray:
    """EXACT structural nnz of the sampled C rows — host column union.

    The sample is tiny (<= ``est_sample_rows``), so per-row unions over
    the referenced B rows cost microseconds of numpy and launch nothing
    on the device.
    """
    nb = b_rpt.shape[0] - 1
    out = np.zeros(rows.size, dtype=np.int64)
    for i, r in enumerate(rows):
        ks = a_col[a_rpt[r]:a_rpt[r + 1]]
        ks = ks[(ks >= 0) & (ks < nb)]
        if ks.size == 0:
            continue
        cols = np.concatenate([b_col[b_rpt[k]:b_rpt[k + 1]] for k in ks])
        out[i] = np.unique(cols).size
    return out


def derive_estimate(nprod: np.ndarray,
                    sampled_rows: np.ndarray,
                    sampled_nnz: np.ndarray, *,
                    sym_upper: Tuple[int, ...],
                    num_upper: Tuple[int, ...],
                    ncols: int,
                    quantile: float = 0.9,
                    headroom: float = 1.5) -> ResultEstimate:
    """Pure host derivation: sampled ratios -> per-rung counts + totals.

    All math in int64 numpy / python int so near-2^31 products cannot
    wrap.

    The numeric-rung counts are a *range histogram*: each row's nnz can
    land anywhere in its band [ceil(nprod·r_lo), min(ceil(nprod·r_hi),
    nprod, ncols)], so the row counts toward EVERY rung the band
    intersects (a difference array keeps this O(M + rungs)).  Per-rung
    counts are therefore upper bounds — the right direction for pow-2
    bucket sizing — while rows whose band-high crosses the fallback
    threshold contribute their full n_prod to the fallback capacity.
    """
    nprod = np.asarray(nprod, dtype=np.int64)
    m = nprod.shape[0]
    total_nprod = int(np.sum(nprod, dtype=np.int64))

    # Exact symbolic side: binning is on n_prod, which we hold exactly.
    sym_bin = _classify_np(nprod, sym_upper)
    sym_counts = np.bincount(sym_bin, minlength=len(sym_upper) + 1)
    sym_fall_prod = int(np.sum(nprod[sym_bin == len(sym_upper)],
                               dtype=np.int64))

    # Ratio band from the sample (rows with nprod == 0 carry no signal
    # and are never sampled; an empty sample means an all-empty matrix).
    sampled_rows = np.asarray(sampled_rows, dtype=np.int64)
    sampled_nnz = np.asarray(sampled_nnz, dtype=np.int64)
    if sampled_rows.size:
        ratios = sampled_nnz / np.maximum(nprod[sampled_rows], 1)
        r_hi = float(min(np.quantile(ratios, quantile) * headroom, 1.0))
        r_hi = max(r_hi, float(np.max(ratios)) if ratios.size else 1.0)
        r_hi = min(r_hi, 1.0)
        r_lo = float(min(np.min(ratios) * 0.5, r_hi))
    else:
        r_lo, r_hi = 1.0, 1.0

    # Per-row nnz bands (nnz >= 1 whenever nprod >= 1; <= min(nprod, N)).
    pos = nprod > 0
    hi = np.minimum(np.minimum(
        np.ceil(nprod * r_hi).astype(np.int64), nprod), int(ncols))
    hi = np.where(pos, np.maximum(hi, 1), 0)
    lo = np.floor(nprod * r_lo).astype(np.int64)
    lo = np.where(pos, np.clip(lo, 1, hi), 0)
    total_nnz_high = int(np.sum(hi, dtype=np.int64))

    # Range histogram over the numeric ladder via a difference array.
    n_num = len(num_upper) + 1
    lo_bin = _classify_np(lo, num_upper)
    hi_bin = _classify_np(hi, num_upper)
    diff = np.zeros(n_num + 1, dtype=np.int64)
    np.add.at(diff, lo_bin, 1)
    np.add.at(diff, hi_bin + 1, -1)
    num_counts = np.cumsum(diff)[:n_num]
    num_fall_prod = int(np.sum(nprod[hi_bin == len(num_upper)],
                               dtype=np.int64))

    return ResultEstimate(
        sym_counts=tuple(int(c) for c in sym_counts),
        sym_fall_prod=sym_fall_prod,
        num_counts=tuple(int(c) for c in num_counts),
        num_fall_prod=num_fall_prod,
        total_nprod=total_nprod,
        total_nnz_high=total_nnz_high,
        r_lo=r_lo, r_hi=r_hi,
        sampled_rows=int(sampled_rows.size),
    )


def estimate_result(A: CSR, B: CSR, *,
                    sym_upper: Tuple[int, ...],
                    num_upper: Tuple[int, ...],
                    n_sample: int = 64,
                    quantile: float = 0.9,
                    headroom: float = 1.5,
                    nprod: np.ndarray | None = None) -> ResultEstimate:
    """Size C = A·B from n_prod + an exactly-measured row sample.

    One host fetch of each operand's index arrays, then pure numpy: no
    kernel runs, where the exact path runs the full symbolic pass over
    every intermediate product.
    """
    a_rpt, a_col = host_index(A)
    b_rpt, b_col = host_index(B)
    if nprod is None:
        nprod = host_nprod(a_rpt, a_col, b_rpt)
    rows = sample_rows_for_estimate(nprod, n_sample)
    nnz = measure_sample_nnz(rows, a_rpt, a_col, b_rpt, b_col)
    return derive_estimate(
        nprod, rows, nnz, sym_upper=sym_upper, num_upper=num_upper,
        ncols=B.ncols, quantile=quantile, headroom=headroom)
