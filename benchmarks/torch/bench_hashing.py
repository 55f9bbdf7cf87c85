"""Fig. 9 reproduction on the port: single-access vs multi-access hashing,
and the fused one-build pipeline against the two-pass total.

The paper's §5.2 claim: one hash-table transaction per probe iteration,
instead of nsparse/spECK's check-then-CAS, gives ~1.09-1.10x on the
symbolic and numeric steps (a V100).  The port's hash kernels implement
both disciplines and count table transactions per row (the
architecture-independent quantity); the symbolic step's time is reported
beside them.  On the CPU the counts are the plain versions', which are the
reference's exactly; on the card they are the CUDA kernels' (concurrent
inserts probe in another order, so only their invariants hold: at least
one access a product, single access below check-then-CAS).

The same counters measure the fused one-build pipeline (``fused_binned``,
row-packed) against the two-pass total: ``fused_access_reduction`` is
(symbolic + numeric) / fused on each probe discipline.

The reference's three ``CASES`` are built from its own ``PRNGKey(1)`` and
``PRNGKey(2)`` matrices (``repro_torch.core.csr.prng_key_seed``).
:func:`case` runs one pair, so a caller can hand it any matrix.

Run from the repo root:
  PYTHONPATH=src python -m benchmarks.torch.bench_hashing [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Tuple

import torch

from repro_torch.core import (bin_rows_for_ladder, esc, next_bucket,
                              nprod_into_rpt, numeric_ladder, random_csr,
                              resolve_device, symbolic_ladder)
from repro_torch.core.analysis import exclusive_sum_in_place
from repro_torch.core.csr import CSR, prng_key_seed
from repro_torch.kernels import spgemm_hash

from .common import timeit

CASES = [
    ("uniform-64x", 256, 2048, 6.0, "uniform"),
    ("powerlaw", 192, 1024, 8.0, "powerlaw"),
    ("banded-fem", 256, 2048, 12.0, "banded"),
]


def case_matrices(m: int, n: int, avg: float, dist: str,
                  device="cuda") -> Tuple[CSR, CSR]:
    """The reference's pair for one case: A (m x n) from PRNGKey(1), B
    (n x m) from PRNGKey(2)."""
    A = random_csr(prng_key_seed(1), m, n, avg_nnz_per_row=avg,
                   distribution=dist, device=device)
    B = random_csr(prng_key_seed(2), n, m, avg_nnz_per_row=avg,
                   distribution=dist, device=device)
    return A, B


def case(name: str, A: CSR, B: CSR) -> Tuple[str, Dict[str, float]]:
    """One row of the figure for C = A·B -> (the reference's row, its
    numbers)."""
    m = A.nrows
    nprod = nprod_into_rpt(A, B)[:m]
    lad = symbolic_ladder(1.2)
    bn = bin_rows_for_ladder(nprod, lad)

    def sym(single):
        nnz, acc = spgemm_hash.symbolic_binned(
            A, B, bn, lad, single_access=single, collect_accesses=True)
        return nnz, int(acc)

    (_, acc_s) = sym(True)
    (_, acc_m) = sym(False)
    t_s = timeit(lambda: sym(True)[0], reps=2)
    t_m = timeit(lambda: sym(False)[0], reps=2)

    # The numeric step.
    nnz_buf = esc.symbolic(A, B, prod_capacity=next_bucket(
        int(nprod.sum())))
    rpt = exclusive_sum_in_place(nnz_buf)
    nlad = numeric_ladder(2.0)
    nbn = bin_rows_for_ladder(nnz_buf[:m], nlad)
    cap = next_bucket(int(rpt[-1]))

    def num(single):
        _, acc = spgemm_hash.numeric_binned(
            A, B, rpt, nbn, nlad, nnz_capacity=cap, single_access=single,
            collect_accesses=True)
        return int(acc)

    nacc_s, nacc_m = num(True), num(False)

    # The fused one-build pipeline: one table build per row in place of
    # the symbolic + numeric double build, small rows packed per block
    # (packing changes occupancy, not probing).
    def fused(single):
        _, acc = spgemm_hash.fused_binned(
            A, B, bn, lad, nnz_capacity=cap, single_access=single,
            row_packing=True, collect_accesses=True)
        return int(acc)

    facc_s, facc_m = fused(True), fused(False)
    out = dict(sym_accesses_single=acc_s, sym_accesses_multi=acc_m,
               num_accesses_single=nacc_s, num_accesses_multi=nacc_m,
               fused_accesses_single=facc_s, fused_accesses_multi=facc_m,
               sym_us_single=t_s * 1e6, sym_us_multi=t_m * 1e6,
               n_prod=int(nprod.sum()))
    row = (f"bench_hashing/{name},{t_s*1e6:.0f},"
           f"sym_accesses_single={acc_s};sym_accesses_multi={acc_m};"
           f"sym_access_reduction={acc_m/max(acc_s,1):.3f}x;"
           f"num_accesses_single={nacc_s};num_accesses_multi={nacc_m};"
           f"num_access_reduction={nacc_m/max(nacc_s,1):.3f}x;"
           f"fused_accesses_single={facc_s};fused_accesses_multi={facc_m};"
           f"fused_access_reduction={(acc_s+nacc_s)/max(facc_s,1):.3f}x;"
           f"fused_access_reduction_multi="
           f"{(acc_m+nacc_m)/max(facc_m,1):.3f}x;"
           f"sym_time_speedup={t_m/max(t_s,1e-9):.2f}x")
    return row, out


def row_accesses(A: CSR, B: CSR, kind: str, single_access: bool = True):
    """Each row's accesses by one kernel -> (accesses, n_prod, built):
    (M,) int64, int64 and bool on A's device; ``built`` marks the rows of
    the bins the kernel was launched on (the others, the ESC fallback's,
    have 0 accesses).  ``kind``: symbolic_bin and fused_bin on the
    symbolic ladder by n_prod, numeric_bin on the numeric ladder by
    n_nz."""
    m = A.nrows
    nprod = nprod_into_rpt(A, B)[:m].long()
    if kind == "numeric_bin":
        sizes = esc.symbolic(A, B, prod_capacity=next_bucket(
            max(int(nprod.sum()), 1)))[:m]
        lad = numeric_ladder(2.0)
    else:
        sizes, lad = nprod, symbolic_ladder(1.2)
    bn = bin_rows_for_ladder(sizes, lad)
    buckets, _ = spgemm_hash.host_schedule(A, B, bn, lad)
    acc = torch.zeros(m, dtype=torch.int64, device=A.device)
    built = torch.zeros(m, dtype=torch.bool, device=A.device)
    for b, rows_cap in enumerate(buckets[:-1]):
        if not rows_cap:
            continue
        rows, count = bn.rows_of_bin(b, rows_cap)
        args = (rows, count.reshape(1), A.rpt, A.col, A.val, B.rpt, B.col,
                B.val)
        kw = dict(t_size=lad.table_sizes[b], rows_cap=rows_cap,
                  single_access=single_access)
        if kind == "symbolic_bin":
            _, a = spgemm_hash.symbolic_bin_call(
                rows, count.reshape(1), A.rpt, A.col, B.rpt, B.col, **kw)
        elif kind == "numeric_bin":
            _, _, a = spgemm_hash.numeric_bin_call(*args, **kw)
        else:
            _, _, _, a = spgemm_hash.fused_bin_call(*args, **kw)
        valid = torch.arange(rows_cap, device=A.device) < count
        acc[rows.long()[valid]] = a.long()[valid]
        built[rows.long()[valid]] = True
    return acc, nprod, built


def run(device="cuda") -> List[str]:
    dev = resolve_device(device)
    rows = []
    for name, m, n, avg, dist in CASES:
        A, B = case_matrices(m, n, avg, dist, device=dev)
        row, _ = case(name, A, B)
        rows.append(row)
        print(row, flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    run(ap.parse_args(argv).device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
