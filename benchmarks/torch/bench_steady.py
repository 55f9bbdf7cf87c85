"""Steady-state ``spgemm`` time of one Table-3 analog on the card, and
two checkouts of the port compared in turns.

    python -m benchmarks.torch.bench_steady [--matrix mono_500Hz]
        [--method hash] [--calls 5] [--baseline DIR] [--report PATH]

Each measurement is a fresh process that imports ``repro_torch`` from one
tree's ``src/``, builds the analog A on the card (``random_csr`` seeded
with ``zlib.crc32`` of its name, as ``chip_smoke.py`` builds it), makes
one cold call of ``spgemm(A, A, SpgemmConfig(method=...))`` and then
``--calls`` steady calls, each ended by ``torch.cuda.synchronize()``.  It
uses only the port's public API (``random_csr``, ``spgemm``,
``SpgemmConfig``), so any checkout of the port can be measured.

Without ``--baseline`` it measures this checkout once.  With
``--baseline DIR`` (the root of another checkout, e.g. ``git archive`` of
a commit unpacked under the gitignored ``results/``) it measures the
baseline, this tree, this tree, the baseline, in that order, and prints
each tree's steady median.  Every line names the card and its power
limit as ``nvidia-smi`` gives them.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
import zlib
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def measure(src: str, name: str, rows: int, avg: float, max_nnz: int,
            dist: str, method: str, calls: int) -> dict:
    """One tree's cold and steady calls (run in a process of its own)."""
    import torch
    sys.path.insert(0, src)
    from repro_torch import SpgemmConfig, spgemm
    from repro_torch.core import random_csr
    if not torch.cuda.is_available():
        raise SystemExit("bench_steady: no CUDA device visible")
    A = random_csr(zlib.crc32(name.encode()), rows, rows,
                   avg_nnz_per_row=avg, max_nnz_per_row=max_nnz,
                   distribution=dist, device="cuda")
    cfg = SpgemmConfig(method=method)

    def call():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = spgemm(A, A, cfg)
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t0) * 1e3

    res, cold_ms = call()
    steady_ms = [call()[1] for _ in range(calls)]
    return dict(src=src, matrix=name, method=method, cold_ms=cold_ms,
                steady_ms=steady_ms,
                steady_median_ms=statistics.median(steady_ms),
                nnz=int(res.C.rpt[-1]), total_nprod=res.total_nprod,
                card=card())


def run_tree(root: Path, args, spec) -> dict:
    """:func:`measure` on ``root``'s ``src/`` in a fresh process."""
    shape = json.dumps([spec.name, spec.rows, spec.avg_nnz, spec.max_nnz,
                        spec.dist])
    argv = [sys.executable, str(Path(__file__).resolve()), "--child",
            str(root / "src"), shape, "--method", args.method, "--calls",
            str(args.calls)]
    # Nothing of this tree on the child's path: it imports root's port.
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(argv, capture_output=True, text=True, env=env,
                         timeout=args.timeout)
    if out.returncode != 0:
        raise SystemExit(f"bench_steady: {root} failed:\n{out.stderr}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--matrix", default="mono_500Hz")
    ap.add_argument("--method", choices=("esc", "hash"), default="hash")
    ap.add_argument("--calls", type=int, default=5)
    ap.add_argument("--baseline", type=Path, default=None,
                    help="root of another checkout, measured in turns")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds per measuring process")
    ap.add_argument("--report", type=Path, default=None)
    ap.add_argument("--child", nargs=2, default=None,
                    help=argparse.SUPPRESS)      # SRC, the analog as JSON
    args = ap.parse_args(argv)
    if args.child is not None:
        src, shape = args.child
        print(json.dumps(measure(src, *json.loads(shape), args.method,
                                 args.calls)))
        return 0
    sys.path.insert(0, str(ROOT))
    from benchmarks.torch.matrices import TABLE3
    spec = {s.name: s for s in TABLE3}.get(args.matrix)
    if spec is None:
        ap.error(f"no Table-3 analog named {args.matrix!r}")
    trees = [("this tree", ROOT)]
    if args.baseline is not None:
        base = ("baseline", args.baseline.resolve())
        trees = [base, trees[0], trees[0], base]
    runs = []
    for label, root in trees:
        r = dict(run_tree(root, args, spec), tree=label)
        runs.append(r)
        print(f"{label} ({r['src']}): {spec.name} {args.method} cold "
              f"{r['cold_ms']:.1f} ms, steady "
              f"{['%.1f' % x for x in r['steady_ms']]} ms, median "
              f"{r['steady_median_ms']:.1f} ms, nnz {r['nnz']} "
              f"[{r['card']}]", flush=True)
    medians = {}
    for label in dict.fromkeys(label for label, _ in trees):
        medians[label] = statistics.median(
            x for r in runs if r["tree"] == label for x in r["steady_ms"])
    print(json.dumps({"steady_median_ms": medians,
                      "nnz_equal": len({r["nnz"] for r in runs}) == 1,
                      "card": runs[0]["card"]}))
    if args.report is not None:
        args.report.parent.mkdir(parents=True, exist_ok=True)
        args.report.write_text(json.dumps(dict(runs=runs, medians=medians),
                                          indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
