"""Benchmark harness of the port: one module per paper table or figure.

Prints ``name,us_per_call,derived`` CSV rows, as the reference's
``benchmarks/run.py`` does (each module's docstring names the paper
artifact it reproduces).  On the card the matrix benches run the full
Table-3 row counts by default, and with ``--reference-cut`` the
reference's own sizes (1/32 of the normal group's rows, 1/512 of the
large group's; on the CPU those are the default).  A bench that fails is
reported on stderr and the harness exits 1 after the others ran.

Run from the repo root:
  PYTHONPATH=src python -m benchmarks.torch.run [--only NAME] \\
      [--device cpu] [--reference-cut]
"""
from __future__ import annotations

import argparse
import sys
import traceback
from typing import Callable, Dict, List


def benches(device, reference_cut: bool = False
            ) -> Dict[str, Callable[[], object]]:
    """The six benches, by name, bound to ``device`` and the row cut."""
    from . import (bench_binning, bench_binning_ranges, bench_hashing,
                   bench_moe_dispatch, bench_overall, bench_overlap)
    from .matrices import DEFAULT_SCALE, LARGE, LARGE_SCALE, NORMAL

    normal = DEFAULT_SCALE if reference_cut else None

    def overall() -> List[dict]:
        groups = ([(NORMAL, DEFAULT_SCALE), (LARGE, LARGE_SCALE)]
                  if reference_cut else [(None, None)])
        rows = []
        for specs, s in groups:
            rows += bench_overall.run(specs, scale=s, device=device,
                                      log=lambda line: print(line,
                                                             flush=True))
        return rows

    return {
        "overall": overall,                                      # Fig 5/6
        "binning": lambda: bench_binning.run(device, normal),    # Fig 7/8
        "hashing": lambda: bench_hashing.run(device),            # Fig 9
        "binning_ranges": lambda: bench_binning_ranges.run(device),  # 10/11
        "overlap": lambda: bench_overlap.run(device, normal),    # §6.3.4/5
        "moe_dispatch": lambda: bench_moe_dispatch.run(device),  # beyond
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=None,
                    help="run a single bench module (e.g. 'overall')")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reference-cut", action="store_true",
                    help="the reference's sizes: 1/32 (normal group), "
                         "1/512 (large group)")
    args = ap.parse_args(argv)

    from repro_torch.core import resolve_device
    table = benches(resolve_device(args.device), args.reference_cut)
    if args.only:
        table = {args.only: table[args.only]}

    print("name,us_per_call,derived", flush=True)
    failures = 0
    for name, fn in table.items():
        try:
            fn()
        except Exception as e:
            failures += 1
            traceback.print_exc()
            print(f"{name},FAILED,{type(e).__name__}: {e}", file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
