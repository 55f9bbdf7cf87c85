"""Figs. 10/11 reproduction on the port: the binning-range sweep.

The paper sweeps the symbolic range multipliers {1x, 1.2x, 1.5x} and the
numeric ones {1x, 1.5x, 2x, 3x} and finds sym 1.2x / num 2x best on
average: the collision rate against the occupancy of §4.3.  The port
sweeps the same grid and reports each pass's table transactions
(collision probes included) from its hash kernels, with the mean fill of
the tables used.  Fewer transactions at a higher multiplier are the
collision effect; larger tables are the occupancy cost (on the card:
fewer resident blocks per SM).  Each pass's wall time goes into the
numbers :func:`sweep` returns beside its row, which keeps the
reference's format.  On the CPU the counts are the reference's exactly;
on the card they are the CUDA kernels' (another probe order, the same
invariants).

The matrices are the reference's ``PRNGKey(5)`` / ``PRNGKey(6)`` pair;
:func:`sweep` runs any pair.

Run from the repo root:
  PYTHONPATH=src python -m benchmarks.torch.bench_binning_ranges \\
      [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Tuple

from repro_torch.core import (NUMERIC_SWEEP, SYMBOLIC_SWEEP,
                              bin_rows_for_ladder, esc, next_bucket,
                              nprod_into_rpt, numeric_ladder, random_csr,
                              resolve_device, symbolic_ladder)
from repro_torch.core.analysis import exclusive_sum_in_place
from repro_torch.core.csr import CSR, prng_key_seed
from repro_torch.kernels import spgemm_hash

from .common import timeit


def _occupancy(binning, ladder, sizes) -> float:
    """Mean fill fraction of the hash tables actually used."""
    sizes = sizes.double()
    bin_of = binning.bin_of_row
    occ = []
    for b, t in enumerate(ladder.table_sizes):
        members = sizes[bin_of == b]
        if members.numel():
            occ.append(float(members.mean()) / t)
    return sum(occ) / len(occ) if occ else 0.0


def matrices(device="cuda") -> Tuple[CSR, CSR]:
    """The reference's pair: A 256 x 1024 (PRNGKey(5)), B 1024 x 512
    (PRNGKey(6)), power-law rows."""
    A = random_csr(prng_key_seed(5), 256, 1024, avg_nnz_per_row=10.0,
                   distribution="powerlaw", device=device)
    B = random_csr(prng_key_seed(6), 1024, 512, avg_nnz_per_row=8.0,
                   distribution="powerlaw", device=device)
    return A, B


def sweep(A: CSR, B: CSR, *, name: str = "", reps: int = 2
          ) -> List[Tuple[str, Dict[str, float]]]:
    """Both sweeps on C = A·B -> one (the reference's row, its numbers)
    per multiplier; ``name`` (a matrix's) is added to each row's name."""
    out = []
    m = A.nrows
    tag = f"{name}/" if name else ""
    nprod = nprod_into_rpt(A, B)[:m]
    for mult in SYMBOLIC_SWEEP:
        lad = symbolic_ladder(mult)
        bn = bin_rows_for_ladder(nprod, lad)

        def sym():
            return spgemm_hash.symbolic_binned(
                A, B, bn, lad, single_access=True, collect_accesses=True)
        acc = int(sym()[1])
        occ = _occupancy(bn, lad, nprod)
        us = timeit(sym, reps=reps) * 1e6
        out.append((f"bench_binning_ranges/{tag}sym_{mult}x,{acc},"
                    f"accesses={acc};occupancy={occ:.3f}",
                    dict(step="symbolic", mult=mult, accesses=acc,
                         occupancy=occ, us=us)))

    nnz_buf = esc.symbolic(A, B, prod_capacity=next_bucket(int(nprod.sum())))
    rpt = exclusive_sum_in_place(nnz_buf)
    cap = next_bucket(int(rpt[-1]))
    for mult in NUMERIC_SWEEP:
        lad = numeric_ladder(mult)
        bn = bin_rows_for_ladder(nnz_buf[:m], lad)

        def num():
            return spgemm_hash.numeric_binned(
                A, B, rpt, bn, lad, nnz_capacity=cap, single_access=True,
                collect_accesses=True)
        acc = int(num()[1])
        occ = _occupancy(bn, lad, nnz_buf[:m])
        us = timeit(num, reps=reps) * 1e6
        out.append((f"bench_binning_ranges/{tag}num_{mult}x,{acc},"
                    f"accesses={acc};occupancy={occ:.3f}",
                    dict(step="numeric", mult=mult, accesses=acc,
                         occupancy=occ, us=us)))
    return out


def run(device="cuda") -> List[str]:
    A, B = matrices(resolve_device(device))
    rows = []
    for row, _ in sweep(A, B):
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
