"""Fig. 7/8 reproduction on the port: the binning's cost, fused two-pass
against a naive pass per bin.

The paper's claim: nsparse/spECK spend ~10 % of a SpGEMM binning
(global-memory atomics, one pass per bin); OpSparse's shared-memory
binning ~1.5 %.  The port's two forms:
  * fused  ``core.binning.bin_rows_for_ladder``: histogram, exclusive sum
           and one stable sort on the device (the paper's method; one host
           read, the Alg-3 fast-path check);
  * naive  one masked pass per bin after a host round trip (sizes copied
           to the host, ``nonzero`` per bin, a separate device allocation
           per bin): the baselines' many-kernel pattern.
Reported: each one's time, and binning as a percentage of a
``SpgemmConfig(timing=True)`` call (its ``symbolic_binning`` and
``numeric_binning`` steps over the sum of its steps).  The device is
synchronized before every clock read.

Matrices: the first 12 of Table 3's normal group (``matrices.NORMAL``), at
``scale`` (full rows on the card by default; the reference's 1/32 with
``--scale 32``).  :func:`case` runs one matrix.

Run from the repo root:
  PYTHONPATH=src python -m benchmarks.torch.bench_binning \\
      [--device cpu] [--scale S]
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import (SpgemmConfig, bin_rows_for_ladder,
                              nprod_into_rpt, resolve_device, spgemm,
                              symbolic_ladder)
from repro_torch.core.csr import CSR

from .common import timeit
from .matrices import NORMAL, generate


def naive_binning(sizes: torch.Tensor, ladder) -> List[torch.Tensor]:
    """One masked pass per bin after a host round trip (the baselines'
    pattern): the row ids of each bin, each in its own allocation."""
    out = []
    prev = -1
    bounds = list(ladder.upper) + [np.inf]
    sizes_np = sizes.cpu().numpy()           # host round trip
    for ub in bounds:
        members = np.nonzero((sizes_np > prev) & (sizes_np <= ub))[0]
        out.append(torch.as_tensor(members, device=sizes.device))
        prev = ub
    return out


def case(name: str, A: CSR) -> Tuple[str, Dict[str, float]]:
    """One row of the figure for C = A·A -> (the reference's row, its
    numbers)."""
    lad = symbolic_ladder(1.2)
    nprod = nprod_into_rpt(A, A)[:A.nrows]
    t_fused = timeit(lambda: bin_rows_for_ladder(nprod, lad).bins)
    t_naive = timeit(lambda: naive_binning(nprod, lad)[0])
    res = spgemm(A, A, SpgemmConfig(timing=True))
    total = sum(res.timings.values())
    bin_t = (res.timings.get("symbolic_binning", 0)
             + res.timings.get("numeric_binning", 0))
    pct = 100 * bin_t / max(total, 1e-9)
    row = (f"bench_binning/{name},{t_fused*1e6:.0f},"
           f"naive_us={t_naive*1e6:.0f};speedup={t_naive/t_fused:.1f}x;"
           f"binning_pct_of_total={pct:.1f}%")
    return row, dict(fused_us=t_fused * 1e6, naive_us=t_naive * 1e6,
                     binning_pct=pct, rows=A.nrows)


def run(device="cuda", scale: Optional[int] = None) -> List[str]:
    dev = resolve_device(device)
    rows = []
    for spec in NORMAL[:12]:
        row, _ = case(spec.name, generate(spec, scale=scale, device=dev))
        rows.append(row)
        print(row, flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scale", type=int, default=None,
                    help="row cut 1/S (default: full rows on the card, the "
                         "reference's 1/32 on the CPU)")
    args = ap.parse_args(argv)
    run(args.device, args.scale)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
