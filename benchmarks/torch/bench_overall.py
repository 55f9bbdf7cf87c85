"""Fig. 5/6 reproduction on the port: overall SpGEMM GFLOPS on the Table-3
suite.

Contestants, each on C = A·A:
  * opsparse       ``spgemm(A, A, SpgemmConfig(method=M))``, the paper's
                   system with the method ``--method`` names (ESC by
                   default, as in the reference);
  * opsparse-fused ``SpgemmConfig(method=M, fuse_esc=True)``, the
                   single-expansion ESC variant (on the hash method only
                   the ESC fallback rung would see it: the hash steady
                   state is fused already);
  * torch.sparse   ``torch.sparse_csr_tensor(...) @`` itself, the vendor
                   library (cuSPARSE on the card).

Each is timed as in the paper (``common.timeit``: a warmup call, which is
the cold call for opsparse, then ``REPS`` calls).  A contestant that runs
out of device memory is reported as ``oom`` for that matrix: the
library's failure is a datapoint, as the paper's cuSPARSE baseline fails
on its large group.  Every C is held to the reference C: the pattern
exactly, the values within 1e-4·(|A|·|A|)_ij + 1e-6.  The reference is
torch.sparse's C (and |A|·|A|), or scipy's in float64 on the host when the
library runs out of memory.

Scale: the card runs every matrix at its full row count unless A·A would
have more than ``PROD_LIMIT`` products; then the rows are halved until it
has no more.  The cut is decided on the host from the generated analog's
total_nprod, before anything runs on the card.

Run from the repo root:
  PYTHONPATH=src python -m benchmarks.torch.bench_overall \\
      [--method esc] [--method hash] [--scale S] [--reps N] \\
      [--device cpu] [--jobs N] [--report PATH]
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time
import warnings
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import SpgemmConfig, resolve_device, spgemm
from repro_torch.core.analysis import total_nprod
from repro_torch.engine import default_arena, reset_default_engine

from .common import REPS, gflops, timeit
from .matrices import (TABLE3, MatrixSpec, analog, default_scale, from_host,
                       generate, pool, rows_at)

# The cut, fixed before any run: mono_500Hz's steady hash call peaked at
# 38.07 GiB with 267,477,116 products (NVIDIA H100 80GB HBM3, 700 W), and
# a product whose pipeline would need more than 60 of the card's 80 GB at
# that rate is cut.
MONO_NPROD = 267_477_116
MONO_PEAK_GIB = 38.07
BUDGET_GIB = 60.0
PROD_LIMIT = int(MONO_NPROD * BUDGET_GIB / MONO_PEAK_GIB)
# Rows of the analog whose n_prod per row predicts the first cut.
PROBE_ROWS = 1 << 15
VAL_RTOL, VAL_ATOL = 1e-4, 1e-6
GIB = float(1 << 30)


def fit_scale(spec: MatrixSpec, scale: int, limit: Optional[int]):
    """``(scale, n_prod, host arrays)``: the analog at the first of
    ``scale``, 2·scale, 4·scale, ... whose A·A has at most ``limit``
    products (host work: a pool worker's job).  A probe of
    ``PROBE_ROWS`` rows predicts the first cut, so a matrix far over the
    limit is not generated at every size on the way; the generated
    analog's own total decides."""
    s = scale
    if limit is not None:
        n_probe = min(rows_at(spec, s), PROBE_ROWS)
        P = analog(spec, n_probe, device="cpu")
        per_row = int(total_nprod(P, P)) / n_probe
        while rows_at(spec, s) > 256 and per_row * rows_at(spec, s) > limit:
            s *= 2
    while True:
        A = generate(spec, scale=s, device="cpu")
        npd = int(total_nprod(A, A))
        if limit is None or npd <= limit or rows_at(spec, s) <= 256:
            return s, npd, (*A.to_numpy(), A.shape)
        s *= 2


def _free() -> None:
    """Drop the shared engine's plans and the arena's parked leases, so the
    next contestant's peak holds only what it allocates."""
    reset_default_engine()
    default_arena().reclaim()
    gc.collect()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def _peak_gib(dev: torch.device) -> Optional[float]:
    if dev.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(dev) / GIB


def library_tensor(A, values=None) -> torch.Tensor:
    """A as a torch sparse CSR tensor (``values`` in place of A.val)."""
    nz = int(A.rpt[-1])
    val = A.val[:nz] if values is None else values
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # sparse CSR "beta" notices
        return torch.sparse_csr_tensor(A.rpt.long(), A.col[:nz].long(), val,
                                       size=A.shape, check_invariants=False)


def _sorted_rows(crow, col, n, *vals):
    """Entries of an n-column CSR ordered by (row, col) (cuSPARSE does not
    promise sorted columns)."""
    m = crow.numel() - 1
    rows = torch.repeat_interleave(
        torch.arange(m, device=crow.device), crow[1:] - crow[:-1])
    key = rows * n + col
    if col.numel() < 2 or bool((key[1:] > key[:-1]).all()):
        return (col, *vals)
    order = torch.argsort(key)
    return (col[order], *(v[order] for v in vals))


def _host_reference(crow, col, n, val, absval) -> Dict[str, np.ndarray]:
    col, val, absval = _sorted_rows(crow, col, n, val, absval)
    return dict(rpt=crow.to(torch.int32).cpu().numpy(),
                col=col.to(torch.int32).cpu().numpy(),
                val=val.cpu().numpy(), absval=absval.cpu().numpy())


def scipy_reference(A) -> Dict[str, np.ndarray]:
    """C and |A|·|A| in float64 on the host."""
    import scipy.sparse as sp
    rpt, col, val = A.to_numpy()
    nz = int(rpt[-1])
    S = sp.csr_matrix((val[:nz].astype(np.float64), col[:nz], rpt),
                      shape=A.shape)
    C, Cabs = S @ S, abs(S) @ abs(S)
    for M in (C, Cabs):
        M.sort_indices()
    if not (np.array_equal(C.indptr, Cabs.indptr)
            and np.array_equal(C.indices, Cabs.indices)):
        raise RuntimeError("scipy dropped an exact zero of C")
    return dict(rpt=C.indptr.astype(np.int32), col=C.indices.astype(np.int32),
                val=C.data, absval=Cabs.data)


def check_c(C, ref: Dict[str, np.ndarray]) -> Dict[str, object]:
    """C against the reference: pattern exact, values within tolerance
    (compared where C lies)."""
    dev = C.rpt.device
    nz = int(ref["rpt"][-1])
    rpt = torch.from_numpy(ref["rpt"]).to(dev)
    if not torch.equal(C.rpt, rpt):
        return dict(match=False, why="rpt differs")
    if not torch.equal(C.col[:nz], torch.from_numpy(ref["col"]).to(dev)):
        return dict(match=False, why="col differs")
    want = torch.from_numpy(ref["val"]).to(dev, torch.float64)
    scale = torch.from_numpy(ref["absval"]).to(dev, torch.float64)
    err = (C.val[:nz].to(torch.float64) - want).abs()
    worst = float((err / (VAL_RTOL * scale + VAL_ATOL)).max()) if nz else 0.0
    return dict(match=worst <= 1.0, max_abs_err=float(err.max()) if nz
                else 0.0, tol_share=worst,
                why=None if worst <= 1.0 else "values out of tolerance")


def _contestant(fn: Callable, dev: torch.device, reps: int):
    """``(seconds, peak GiB, last output)``, or ``("oom", None, None)``."""
    _free()
    out = {}

    def call():
        out["r"] = fn()

    try:
        t = timeit(call, reps=reps)
    except torch.cuda.OutOfMemoryError:
        out.clear()
        _free()
        return "oom", None, None
    return t, _peak_gib(dev), out["r"]


def run(specs: Optional[Sequence[MatrixSpec]] = None, *,
        methods: Sequence[str] = ("esc",), scale: Optional[int] = None,
        device="cuda", reps: int = REPS, jobs: int = 0,
        log: Callable[[str], None] = print) -> List[dict]:
    """One row per matrix and method (see the module docstring).  ``jobs``
    > 0 generates the analogs in that many worker processes while the
    device runs the earlier ones."""
    dev = resolve_device(device)
    specs = list(TABLE3 if specs is None else specs)
    todo = [(spec, scale or default_scale(spec, dev)) for spec in specs]
    rows: List[dict] = []
    ex = pool(jobs) if jobs > 0 else None
    try:
        futures = [ex.submit(fit_scale, spec, s, PROD_LIMIT)
                   for spec, s in todo] if ex else None
        for i, (spec, s0) in enumerate(todo):
            # The wait for the analog (and its copy to the device): with
            # workers, what generation still holds the card up.
            t_wait = time.perf_counter()
            s, npd, arrays = (futures[i].result() if ex
                              else fit_scale(spec, s0, PROD_LIMIT))
            A = from_host(arrays, dev)
            del arrays
            wait_s = time.perf_counter() - t_wait
            rows.extend(_bench_matrix(spec, A, s, npd, methods, dev, reps,
                                      wait_s, log))
            del A
            _free()
    finally:
        if ex is not None:
            ex.shutdown(cancel_futures=True)
    return rows


def _bench_matrix(spec, A, s, npd, methods, dev, reps, wait_s, log):
    T = library_tensor(A)
    t_lib, peak_lib, C_lib = _contestant(lambda: T @ T, dev, reps)
    if C_lib is not None:
        try:
            Tabs = library_tensor(A, A.val[:int(A.rpt[-1])].abs())
            absval = (Tabs @ Tabs).values()
            ref = _host_reference(C_lib.crow_indices(), C_lib.col_indices(),
                                  A.ncols, C_lib.values(), absval)
            ref_src = "torch.sparse"
            del Tabs, absval
        except torch.cuda.OutOfMemoryError:
            C_lib = None
    if C_lib is None:
        _free()
        ref, ref_src = scipy_reference(A), "scipy"
    del C_lib, T
    c_nnz = int(ref["rpt"][-1])
    out = []
    for method in methods:
        row = dict(matrix=spec.name, method=method, scale=s, rows=A.nrows,
                   nnz=int(A.rpt[-1]), n_prod=npd, c_nnz=c_nnz,
                   cr=npd / max(c_nnz, 1), paper_cr=spec.paper_cr,
                   reference=ref_src, wait_s=wait_s, device=str(dev))
        row["torch.sparse"] = dict(
            ms=t_lib if t_lib == "oom" else t_lib * 1e3,
            gflops=None if t_lib == "oom" else gflops(npd, t_lib),
            peak_gib=peak_lib)
        for name, cfg in (("opsparse", SpgemmConfig(method=method)),
                          ("opsparse-fused", SpgemmConfig(method=method,
                                                          fuse_esc=True))):
            t, peak, res = _contestant(lambda: spgemm(A, A, cfg), dev, reps)
            entry = dict(ms=t if t == "oom" else t * 1e3,
                         gflops=None if t == "oom" else gflops(npd, t),
                         peak_gib=peak)
            if res is not None:
                entry.update(check_c(res.C, ref))
                if t_lib != "oom":
                    entry["speedup_vs_sparse"] = t_lib / t
            row[name] = entry
            del res
        out.append(row)
        log(_line(row))
    return out


def _fmt(x, spec=".3f"):
    return x if isinstance(x, str) else ("-" if x is None
                                         else format(x, spec))


def _line(row) -> str:
    ours, fused, lib = (row[k] for k in ("opsparse", "opsparse-fused",
                                         "torch.sparse"))
    us = ours["ms"] if ours["ms"] == "oom" else f"{ours['ms'] * 1e3:.0f}"
    return (f"bench_overall/{row['matrix']}[{row['method']}],{us},"
            f"scale={row['scale']};rows={row['rows']};nnz={row['nnz']};"
            f"nprod={row['n_prod']};c_nnz={row['c_nnz']};"
            f"gflops={_fmt(ours['gflops'])};"
            f"fused_gflops={_fmt(fused['gflops'])};"
            f"sparse_gflops={_fmt(lib['gflops'])};"
            f"speedup_vs_sparse={_fmt(ours.get('speedup_vs_sparse'))}x;"
            f"peak_gib={_fmt(ours['peak_gib'], '.2f')};"
            f"match={ours.get('match')}/{fused.get('match')} "
            f"vs {row['reference']};"
            f"cr={row['cr']:.2f};paper_cr={row['paper_cr']}")


def markdown(rows: List[dict]) -> str:
    """The table PERF.md quotes: one line per matrix, each method's
    contestants side by side with torch.sparse."""
    methods = list(dict.fromkeys(r["method"] for r in rows))
    head = ["Matrix", "scale", "rows", "n_prod", "C nnz", "cr (paper)",
            "torch.sparse ms (GFLOPS)"]
    for m in methods:
        head += [f"{m} ms (GFLOPS)", f"{m}-fused ms", f"speedup {m}"]
    head += ["peak GiB " + " / ".join(methods + ["lib"]), "C matches"]
    lines = ["| " + " | ".join(head) + " |", "|" + " --- |" * len(head)]

    def cell(e):
        if e["ms"] == "oom":
            return "oom"
        return f"{e['ms']:.2f} ({e['gflops']:.2f})"

    by_matrix: Dict[str, Dict[str, dict]] = {}
    for r in rows:
        by_matrix.setdefault(r["matrix"], {})[r["method"]] = r
    for name, per in by_matrix.items():
        r = next(iter(per.values()))
        out = [name, str(r["scale"]), str(r["rows"]), str(r["n_prod"]),
               str(r["c_nnz"]), f"{r['cr']:.2f} ({r['paper_cr']})",
               cell(r["torch.sparse"])]
        peaks, matches = [], []
        for m in methods:
            if m not in per:
                out += ["-", "-", "-"]
                continue
            ours, fused = per[m]["opsparse"], per[m]["opsparse-fused"]
            fused_ms = fused["ms"]
            out += [cell(ours), fused_ms if fused_ms == "oom"
                    else f"{fused_ms:.2f}",
                    _fmt(ours.get("speedup_vs_sparse"), ".3f")]
            peaks.append(_fmt(ours["peak_gib"], ".2f"))
            ok = (ours.get("match"), fused.get("match"))
            matches.append("yes" if all(ok) else "NO" if False in ok
                           else "-")
        peaks.append(_fmt(r["torch.sparse"]["peak_gib"], ".2f"))
        out += [" / ".join(peaks),
                "/".join(matches) + f" vs {r['reference']}"]
        lines.append("| " + " | ".join(out) + " |")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--method", action="append", choices=("esc", "hash"),
                    help="accumulator method (repeat for both; default esc)")
    ap.add_argument("--scale", type=int, default=None,
                    help="row cut 1/S for every matrix (default: full rows "
                         "on the card, the reference's cut on the CPU)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=REPS)
    ap.add_argument("--jobs", type=int, default=max(1, (os.cpu_count() or 2)
                                                    - 1),
                    help="generator processes (0: generate inline)")
    ap.add_argument("--report", type=Path, default=None,
                    help="write every row as JSON here")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    card = None
    if dev.type == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        print(f"card: {card}; torch {torch.__version__} cuda "
              f"{torch.version.cuda}; product limit {PROD_LIMIT}",
              flush=True)
    t0 = time.perf_counter()
    rows = run(methods=tuple(args.method or ("esc",)),
               scale=args.scale, device=dev, reps=args.reps,
               jobs=args.jobs, log=lambda s: print(s, flush=True))
    print(markdown(rows))
    print(f"bench_overall: {len(rows)} rows in "
          f"{time.perf_counter() - t0:.0f} s on {card or dev}")
    if args.report is not None:
        args.report.parent.mkdir(parents=True, exist_ok=True)
        args.report.write_text(json.dumps(dict(
            card=card, device=str(dev), prod_limit=PROD_LIMIT, rows=rows),
            indent=1))
    bad = [(r["matrix"], r["method"]) for r in rows
           for k in ("opsparse", "opsparse-fused")
           if r[k].get("match") is False]
    if bad:
        print(f"bench_overall: C differs from the reference: {bad}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
