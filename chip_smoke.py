#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of OpSparse on one NVIDIA GPU and check it.

Run from the root of a checkout:  python3 chip_smoke.py [--report PATH]

Phases, in order; any failure exits non-zero:
  1. card and build: the card's name and power limit, then the three
     hash-table kernels built from src/repro_torch/kernels/csrc with nvcc.
  2. kernel phases: every kernel against its plain PyTorch version on the
     card, both probe disciplines, packed and unpacked, on a tiny ladder
     that populates every rung and the fallback rung, and on rows of the
     default ladders' top rungs.
  3. the slice: C = A·A through spgemm(method="hash") for the paper's
     Table-3 matrix mono_500Hz at its full row count (one cold call, then
     steady calls), with the launch counters read around it, the steady
     dispatch checked for host syncs, and C held against scipy.
  4. each kernel at the shapes the main path gave it: its time, its plain
     version's time on the same inputs (and agreement), and its bound.
  5. output: a "kernels" JSON line, the card line, and the result line.

Needs one card.  Exits 2 without printing a result when no card is visible
or when the port's sources are not beside this script.  ``--report PATH``
also writes every measured number (per rung, per phase) as JSON.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
import warnings
import zlib
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate (data sheet)
SOURCE = "src/repro_torch/kernels/csrc/spgemm_hash.cu"
REPLACES = {
    "symbolic_bin": "src/repro/kernels/spgemm_hash.py:191",
    "numeric_bin": "src/repro/kernels/spgemm_hash.py:309",
    "fused_bin": "src/repro/kernels/spgemm_hash.py:462",
}
# Paper Table 3, mono_500Hz: rows, nnz/row, max nnz/row, row-size shape.
MONO = dict(rows=169410, avg=29.7, max=719, dist="powerlaw")
VAL_RTOL = VAL_ATOL = 1e-5    # kernel vs plain: few products per entry
STEADY_CALLS = 5


class SmokeError(Exception):
    pass


def require(cond, msg):
    if not cond:
        raise SmokeError(msg)


def log(*args):
    print(*args, flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--report", type=Path, default=None,
                        help="write the full measurements as JSON here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        report = run()
    except SmokeError as exc:
        print(f"chip_smoke: FAIL: {exc}", file=sys.stderr)
        return 1
    if args.report is not None:
        args.report.parent.mkdir(parents=True, exist_ok=True)
        args.report.write_text(json.dumps(report, indent=1))
    log(report["card"])
    log(json.dumps({"kernels": report["kernels"]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# ---------------------------------------------------------------------------
# Kernel-versus-plain comparison.
# ---------------------------------------------------------------------------

def kernel_args(kind, A, B, rows, count):
    if kind == "symbolic_bin":
        return (rows, count, A.rpt, A.col, B.rpt, B.col)
    return (rows, count, A.rpt, A.col, A.val, B.rpt, B.col, B.val)


def run_bin(sh, kind, plain, A, B, rows, count, t_size, rows_cap, *,
            pack=1, single_access=True):
    """One bin through the kernel (plain=False) or its plain version;
    returns dict(nnz, cols, vals, acc) with tables where the kernel has
    them."""
    args = kernel_args(kind, A, B, rows, count)
    kw = dict(t_size=t_size, rows_cap=rows_cap, single_access=single_access)
    if kind != "numeric_bin":
        kw["pack"] = pack
    fn = {
        ("symbolic_bin", False): sh.symbolic_bin_call,
        ("symbolic_bin", True): sh.symbolic_bin_plain,
        ("numeric_bin", False): sh.numeric_bin_call,
        ("numeric_bin", True): sh.numeric_bin_plain,
        ("fused_bin", False): sh.fused_bin_call,
        ("fused_bin", True): sh.fused_bin_plain,
    }[(kind, plain)]
    out = fn(*args, **kw)
    if kind == "symbolic_bin":
        return dict(nnz=out[0], cols=None, vals=None, acc=out[1])
    if kind == "numeric_bin":
        cols, vals, acc = out
        return dict(nnz=(cols >= 0).sum(1).to(torch.int32), cols=cols,
                    vals=vals, acc=acc)
    return dict(nnz=out[0], cols=out[1], vals=out[2], acc=out[3])


def compare(what, k, p, nprod_rows, valid):
    """Kernel result k against plain result p; returns max |val err|."""
    require(torch.equal(k["nnz"], p["nnz"]), f"{what}: nnz differs")
    err = 0.0
    if k["cols"] is not None:
        kc, ko = torch.sort(k["cols"], dim=1)
        pc, po = torch.sort(p["cols"], dim=1)
        require(torch.equal(kc, pc), f"{what}: sorted columns differ")
        kv = k["vals"].gather(1, ko)
        pv = p["vals"].gather(1, po)
        used = pc >= 0
        diff = (kv - pv).abs().masked_fill(~used, 0)
        err = float(diff.max()) if diff.numel() else 0.0
        bad = diff > VAL_ATOL + VAL_RTOL * pv.abs()
        require(not bool(bad.any()),
                f"{what}: values differ by up to {err:.3e}")
    acc = k["acc"].long()
    require(bool((acc[valid] >= nprod_rows[valid]).all()),
            f"{what}: a row took fewer accesses than products")
    require(bool((acc[~valid] == 0).all()), f"{what}: padded row accessed")
    return err


def bin_inputs(binning, b, rows_cap, limit=None):
    rows, count = binning.rows_of_bin(b, rows_cap)
    n = int(count)
    if limit is not None:
        n = min(n, limit)
    count = torch.tensor([n], dtype=torch.int32, device=rows.device)
    valid = torch.arange(rows_cap, device=rows.device) < n
    return rows, count, valid


def check_bins(sh, A, B, binning, ladder, kinds, *, buckets,
               limit=None, packs=(False, True), label=""):
    """Every populated table rung: each kernel kind, both disciplines,
    packed and unpacked (where the kernel packs), against the plain
    version.  Returns {kind: max val err}."""
    from repro_torch.core import nprod_into_rpt
    nprod = nprod_into_rpt(A, B)
    errs = {k: 0.0 for k in kinds}
    for b, t_size in enumerate(ladder.table_sizes):
        rows_cap = buckets[b]
        if not rows_cap:
            continue
        rows, count, valid = bin_inputs(binning, b, rows_cap, limit)
        nprod_rows = nprod[rows.long()].long().masked_fill(~valid, 0)
        for kind in kinds:
            plain = run_bin(sh, kind, True, A, B, rows, count, t_size,
                            rows_cap)
            pack_opts = {1} if False in packs else set()
            if kind != "numeric_bin" and True in packs:
                pack_opts.add(min(ladder.rows_per_block[b], rows_cap))
            for pack in sorted(pack_opts):
                totals = {}
                for sa in (True, False):
                    k = run_bin(sh, kind, False, A, B, rows, count, t_size,
                                rows_cap, pack=pack, single_access=sa)
                    torch.cuda.synchronize()
                    what = (f"{label}{kind} rung {b} (t={t_size}, "
                            f"rows={int(count)}/{rows_cap}, pack={pack}, "
                            f"single_access={sa})")
                    errs[kind] = max(errs[kind], compare(
                        what, k, plain, nprod_rows, valid))
                    totals[sa] = int(k["acc"].long().sum())
                if int(plain["nnz"].long().sum()):
                    require(totals[True] < totals[False],
                            f"{label}{kind} rung {b} pack={pack}: single "
                            f"access took {totals[True]} accesses, "
                            f"check-then-CAS {totals[False]}")
    return errs


def compare_csr(what, C, D):
    """C (card) against D (plain path): rpt/col exact, val within tol."""
    nz = int(D.rpt[-1])
    require(torch.equal(C.rpt.cpu(), D.rpt.cpu()), f"{what}: rpt differs")
    require(torch.equal(C.col[:nz].cpu(), D.col[:nz].cpu()),
            f"{what}: col differs")
    cv, dv = C.val[:nz].cpu(), D.val[:nz].cpu()
    err = float((cv - dv).abs().max()) if nz else 0.0
    require(torch.allclose(cv, dv, rtol=VAL_RTOL, atol=VAL_ATOL),
            f"{what}: values differ by up to {err:.3e}")
    return err


# ---------------------------------------------------------------------------
# Phases.
# ---------------------------------------------------------------------------

def phase_tiny(sh, errs):
    """Tiny ladders force every rung plus the fallback rung."""
    from repro_torch.core import (CSR, bin_rows_for_ladder,
                                  exclusive_sum_in_place, make_ladder,
                                  nprod_into_rpt, random_csr)
    cpu = dict(device="cpu")
    A0 = random_csr(9, 96, 200, avg_nnz_per_row=10.0,
                    distribution="powerlaw", **cpu)
    B0 = random_csr(109, 200, 150, avg_nnz_per_row=8.0,
                    distribution="powerlaw", **cpu)
    A = CSR(A0.rpt.cuda(), A0.col.cuda(), A0.val.cuda(), A0.shape)
    B = CSR(B0.rpt.cuda(), B0.col.cuda(), B0.val.cuda(), B0.shape)
    sym = make_ladder((32, 64, 128), 1.2, (32, 64, 128))
    num = make_ladder((64, 128, 256), 2.0, (63, 127, 255))
    m = A.nrows

    bn0 = bin_rows_for_ladder(nprod_into_rpt(A0, B0)[:m], sym)
    bn = bin_rows_for_ladder(nprod_into_rpt(A, B)[:m], sym)
    sym_buckets, sym_fall = sh.host_schedule(A0, B0, bn0, sym,
                                             packs=sym.rows_per_block)
    require(all(sym_buckets), f"tiny ladder leaves a rung empty: "
            f"{sym_buckets}")
    e = check_bins(sh, A, B, bn, sym, ("symbolic_bin", "fused_bin"),
                   buckets=sym_buckets, label="tiny ")
    for k, v in e.items():
        errs[k] = max(errs[k], v)

    nnz0, _, _ = sh.symbolic_scheduled(A0, B0, bn0, sym,
                                       row_buckets=sym_buckets,
                                       fallback_prod_capacity=sym_fall)
    for packed in (False, True):
        nnz, _, _ = sh.symbolic_scheduled(A, B, bn, sym,
                                          row_buckets=sym_buckets,
                                          fallback_prod_capacity=sym_fall,
                                          row_packing=packed)
        require(torch.equal(nnz.cpu(), nnz0),
                f"tiny symbolic_scheduled (packed={packed}) nnz differs")
    nbn0 = bin_rows_for_ladder(nnz0[:m], num)
    nbn = bin_rows_for_ladder(nnz0[:m].cuda(), num)
    num_buckets, num_fall = sh.host_schedule(A0, B0, nbn0, num)
    require(all(num_buckets), f"tiny numeric ladder leaves a rung empty: "
            f"{num_buckets}")
    e = check_bins(sh, A, B, nbn, num, ("numeric_bin",),
                   buckets=num_buckets, label="tiny ")
    errs["numeric_bin"] = max(errs["numeric_bin"], e["numeric_bin"])

    rpt0 = exclusive_sum_in_place(nnz0)
    cap = int(rpt0[-1]) + 16
    C0, _, _ = sh.numeric_scheduled(A0, B0, rpt0, nbn0, num,
                                    row_buckets=num_buckets,
                                    nnz_capacity=cap,
                                    fallback_prod_capacity=num_fall)
    C, _, _ = sh.numeric_scheduled(A, B, rpt0.cuda(), nbn, num,
                                   row_buckets=num_buckets, nnz_capacity=cap,
                                   fallback_prod_capacity=num_fall)
    errs["numeric_bin"] = max(errs["numeric_bin"], compare_csr(
        "tiny numeric_scheduled", C, C0))
    F0, _, _, _ = sh.fused_scheduled(A0, B0, bn0, sym,
                                     row_buckets=sym_buckets,
                                     nnz_capacity=cap,
                                     fallback_prod_capacity=sym_fall)
    for packed in (False, True):
        F, _, _, _ = sh.fused_scheduled(A, B, bn, sym,
                                        row_buckets=sym_buckets,
                                        nnz_capacity=cap,
                                        fallback_prod_capacity=sym_fall,
                                        row_packing=packed)
        errs["fused_bin"] = max(errs["fused_bin"], compare_csr(
            f"tiny fused_scheduled (packed={packed})", F, F0))
    log("phase tiny ladders: every rung + fallback, both disciplines, "
        f"packed and unpacked, values within {VAL_ATOL} + {VAL_RTOL}*|v|: ok")


def mono_matrix():
    from repro_torch.core import random_csr
    return random_csr(zlib.crc32(b"mono_500Hz"), MONO["rows"], MONO["rows"],
                      avg_nnz_per_row=MONO["avg"],
                      max_nnz_per_row=MONO["max"],
                      distribution=MONO["dist"], device="cuda")


def phase_top_rungs(sh, A, sym_binning, num_binning, errs):
    """A few rows of each top rung of the default ladders."""
    from repro_torch.core import numeric_ladder, symbolic_ladder
    sym, num = symbolic_ladder(), numeric_ladder()
    top = 8

    def buckets(binning, ladder, first):
        sizes = binning.bin_size.tolist()
        return [top if b >= first and sizes[b] else 0
                for b in range(len(ladder.table_sizes))]

    sym_buckets = buckets(sym_binning, sym, 4)
    num_buckets = buckets(num_binning, num, 5)
    e = check_bins(sh, A, A, sym_binning, sym,
                   ("symbolic_bin", "fused_bin"), buckets=sym_buckets,
                   limit=top - 2, packs=(False,), label="top ")
    for k, v in e.items():
        errs[k] = max(errs[k], v)
    e = check_bins(sh, A, A, num_binning, num, ("numeric_bin",),
                   buckets=num_buckets, limit=top - 2, packs=(False,),
                   label="top ")
    errs["numeric_bin"] = max(errs["numeric_bin"], e["numeric_bin"])
    log(f"phase top rungs: sym rungs {[b for b, c in enumerate(sym_buckets) if c]}"
        f" num rungs {[b for b, c in enumerate(num_buckets) if c]}: ok")


def time_cuda(fn, reps):
    """Mean ms of fn() over reps launches (CUDA events), after one warm-up."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_host(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def bound_bytes(kind, A, B, rows, count, t_size, rows_cap):
    """Bytes the bin's work must move at least, and the bytes the kernel
    writes for the schedule's padding rows.

    The work is the bin's ``count`` valid rows: each input they need read
    once (the count, their row ids and A rows, the distinct B rows those
    reference) and each of their outputs written once (per-row nnz and
    accesses, and a t_size table per row where the kernel dumps tables).
    The bucket's rows past ``count`` are a cost of the schedule, returned
    apart and left out of the bound."""
    from repro_torch.core import gather_rows
    n = int(count)
    valid = torch.arange(rows_cap, device=rows.device) < n
    sub = gather_rows(A, rows, valid)
    a_entries = int(sub.nnz())
    mark = torch.zeros(B.nrows, dtype=torch.bool, device=rows.device)
    mark[sub.col[:a_entries].long()] = True
    b_rows = int(mark.sum())
    b_entries = int(B.nnz_per_row()[mark].sum())
    vb = 0 if kind == "symbolic_bin" else 4
    read = (4 + 4 * n + 8 * n + a_entries * (4 + vb) + 8 * b_rows
            + b_entries * (4 + vb))
    per_row = 4 * (1 if kind == "numeric_bin" else 2)
    if kind != "symbolic_bin":
        per_row += t_size * 8
    return read + n * per_row, (rows_cap - n) * per_row


def phase_main_shapes(sh, A, plan, result, errs):
    """Each kernel at the bins the main path ran: agreement with its plain
    version, its time, the plain time, and the bound."""
    from repro_torch.core import nprod_into_rpt
    sched = plan.hash_schedule
    nprod = nprod_into_rpt(A, A)
    jobs = {
        "symbolic_bin": (result.sym_binning, plan.sym_ladder,
                         sched.sym_row_buckets),
        "fused_bin": (result.sym_binning, plan.sym_ladder,
                      sched.sym_row_buckets),
        "numeric_bin": (result.num_binning, plan.num_ladder,
                        sched.num_row_buckets),
    }
    stats = {}
    for kind, (binning, ladder, buckets) in jobs.items():
        ms = plain_ms = 0.0
        nbytes = pad_bytes = 0
        rungs = []
        for b, t_size in enumerate(ladder.table_sizes):
            rows_cap = buckets[b]
            if not rows_cap:
                continue
            rows, count, valid = bin_inputs(binning, b, rows_cap)
            nprod_rows = nprod[rows.long()].long().masked_fill(~valid, 0)
            p, pms = time_host(lambda: run_bin(
                sh, kind, True, A, A, rows, count, t_size, rows_cap))
            k = run_bin(sh, kind, False, A, A, rows, count, t_size, rows_cap)
            torch.cuda.synchronize()
            errs[kind] = max(errs[kind], compare(
                f"main-shape {kind} rung {b} (t={t_size}, "
                f"rows={int(count)}/{rows_cap})", k, p, nprod_rows, valid))
            del p, k
            kms = time_cuda(lambda: run_bin(
                sh, kind, False, A, A, rows, count, t_size, rows_cap), 3)
            rb, pb = bound_bytes(kind, A, A, rows, count, t_size, rows_cap)
            ms += kms
            plain_ms += pms
            nbytes += rb
            pad_bytes += pb
            rungs.append(dict(rung=b, t_size=t_size, rows=int(count),
                              rows_cap=rows_cap, ms=kms, plain_ms=pms,
                              bytes=rb, pad_bytes=pb))
            torch.cuda.empty_cache()
        stats[kind] = dict(ms=ms, plain_ms=plain_ms, bytes=nbytes,
                           bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                           pad_bytes=pad_bytes,
                           pad_ms=pad_bytes / HBM_BYTES_PER_S * 1e3,
                           rungs=rungs)
        log(f"phase main shapes {kind}: {len(rungs)} rungs, kernel "
            f"{ms:.3f} ms, plain {plain_ms:.1f} ms, bound "
            f"{stats[kind]['bound_ms']:.3f} ms ({nbytes} B); padding rows "
            f"write {pad_bytes} B more ({stats[kind]['pad_ms']:.3f} ms at "
            f"the memory rate): ok")
    return stats


def scipy_check(A, C):
    """C = A·A against scipy: pattern of |A|·|A| exactly, values within
    1e-4·(|A|·|A|)_ij + 1e-6 of the float64 product."""
    import numpy as np
    import scipy.sparse as sp
    rpt, col, val = A.to_numpy()
    nz = int(rpt[-1])
    S = sp.csr_matrix((val[:nz].astype(np.float64), col[:nz], rpt),
                      shape=A.shape)
    P = abs(S) @ abs(S)
    P.sort_indices()
    R = S @ S
    cr, cc, cv = C.to_numpy()
    cnz = int(cr[-1])
    require(np.array_equal(cr.astype(np.int64), P.indptr.astype(np.int64)),
            "C.rpt differs from the pattern of |A|·|A|")
    require(np.array_equal(cc[:cnz].astype(np.int64),
                           P.indices.astype(np.int64)),
            "C.col differs from the pattern of |A|·|A|")
    Cp = sp.csr_matrix((cv[:cnz].astype(np.float64), cc[:cnz], cr),
                       shape=A.shape)
    D = abs(Cp - R)
    max_err = float(D.data.max()) if D.nnz else 0.0
    excess = D - 1e-4 * P
    worst = float(excess.data.max()) if excess.nnz else 0.0
    require(worst <= 1e-6, f"C values exceed the tolerance by {worst:.3e}")
    return dict(nnz=cnz, max_abs_err=max_err, worst_excess=worst)


def torch_sparse_ms(A):
    """A_csr @ A_csr through torch.sparse (cuSPARSE): the yardstick."""
    nz = int(A.nnz())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # sparse CSR "beta" notices
        At = torch.sparse_csr_tensor(A.rpt.long(), A.col[:nz].long(),
                                     A.val[:nz], size=A.shape)
    (At @ At)
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        _, ms = time_host(lambda: At @ At)
        times.append(ms)
    del At
    torch.cuda.empty_cache()
    return statistics.median(times)


def _device_us(evt, inclusive):
    """Device microseconds of a profiler entry, across torch versions."""
    names = (("device_time_total", "cuda_time_total") if inclusive else
             ("self_device_time_total", "self_cuda_time_total"))
    for name in names:
        value = getattr(evt, name, None)
        if value is not None:
            return float(value)
    return 0.0


RANGES = ("hash_fallback", "hash_epilogue")   # record_function ranges


def profile_steady(run_once):
    """One steady call under torch.profiler: device busy share of the wall
    time, the kernels with the most device time, the torch ops whose
    launches took the most device time, and the device time of each of the
    port's profiler ranges (all kernels launched inside them)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_once()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    # A range's own row is its span on the device timeline, not a kernel.
    kernels = [e for e in events if _device_us(e, False) > 0
               and not e.key.startswith("aten::") and e.key not in RANGES]
    busy_us = sum(_device_us(e, False) for e in kernels)
    top_kernels = sorted(kernels, key=lambda e: _device_us(e, False),
                         reverse=True)[:10]
    ops = [e for e in events if e.key.startswith("aten::")]
    top_ops = sorted(ops, key=lambda e: _device_us(e, True),
                     reverse=True)[:10]
    ranges = {name: 0.0 for name in RANGES}
    range_sorts = {name: 0.0 for name in RANGES}
    for e in prof.events():
        if e.name in ranges and e.device_type == DeviceType.CPU:
            ranges[e.name] += _device_us(e, True) / 1e3
            stack = list(e.cpu_children)
            while stack:
                c = stack.pop()
                if c.name == "aten::sort":
                    range_sorts[e.name] += _device_us(c, True) / 1e3
                else:
                    stack.extend(c.cpu_children)
    return dict(
        wall_ms=wall_us / 1e3, device_busy_ms=busy_us / 1e3,
        device_idle_share=max(0.0, 1 - busy_us / wall_us),
        top_kernels=[dict(name=e.key[:120], calls=e.count,
                          device_ms=_device_us(e, False) / 1e3)
                     for e in top_kernels],
        top_ops=[dict(name=e.key, calls=e.count,
                      device_ms=_device_us(e, True) / 1e3)
                 for e in top_ops],
        range_device_ms=ranges, range_sort_device_ms=range_sorts)


def run():
    import numpy as np
    from repro_torch import SpgemmConfig, spgemm
    from repro_torch.engine import default_engine, plan_key
    from repro_torch.kernels import build
    from repro_torch.kernels import spgemm_hash as sh

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    secs = build.build_all()
    log(f"build: {secs:.1f} s")
    for line in build.BUILD_LOG.get("spgemm_hash", "").splitlines():
        if "Used" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    errs = {k: 0.0 for k in REPLACES}
    phase_tiny(sh, errs)

    # ---- the slice: full-size mono_500Hz through spgemm(method="hash") --
    t0 = time.perf_counter()
    A = mono_matrix()
    log(f"mono_500Hz analog: {A.nrows} rows, nnz {int(A.nnz())}, "
        f"built in {time.perf_counter() - t0:.1f} s")
    cfg = SpgemmConfig(method="hash")
    engine = default_engine()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sh.reset_launches()
    res_cold, cold_ms = time_host(lambda: spgemm(A, A, cfg))
    cold_launches = {f.__name__.replace("_call", ""): f.launches
                     for f in sh.KERNELS}
    require(cold_launches["symbolic_bin"] > 0
            and cold_launches["numeric_bin"] > 0,
            f"cold call did not launch the two-pass kernels: "
            f"{cold_launches}")
    require(cold_launches["fused_bin"] == 0,
            f"cold call launched the fused kernel: {cold_launches}")
    steady_ms = []
    syncs = []
    res = None
    for i in range(STEADY_CALLS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                rec = engine.dispatch(A, A, cfg)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs += [str(w.message).splitlines()[0] for w in caught
                  if "called a synchronizing" in str(w.message)]
        res = engine.finalize(rec)
        torch.cuda.synchronize()
        steady_ms.append((time.perf_counter() - t1) * 1e3)
    launches = {f.__name__.replace("_call", ""): f.launches
                for f in sh.KERNELS}
    steady_launches = {k: launches[k] - cold_launches[k] for k in launches}
    peak = torch.cuda.max_memory_allocated()
    require(steady_launches["fused_bin"] > 0,
            f"steady calls did not launch the fused kernel: {launches}")
    require(steady_launches["symbolic_bin"] == 0
            and steady_launches["numeric_bin"] == 0,
            f"steady calls ran the two-pass kernels: {steady_launches}")
    entry = engine.cache.get(plan_key(A, A, cfg))
    require(entry.stats.hot_calls == STEADY_CALLS
            and entry.stats.steps_calls == 1,
            f"expected 1 cold + {STEADY_CALLS} steady calls: {entry.stats}")
    require(not syncs, f"steady dispatch synced the host {len(syncs)} "
            f"times: {sorted(set(syncs))}")
    log(f"slice: cold {cold_ms:.1f} ms, steady median "
        f"{statistics.median(steady_ms):.1f} ms {['%.1f' % x for x in steady_ms]},"
        f" peak {peak / 2**30:.2f} GiB, launches cold {cold_launches} "
        f"steady {steady_launches}, host syncs in steady dispatch: 0")
    log(f"schedule: {entry.plan.hash_schedule}, nnz bucket "
        f"{entry.plan.nnz_bucket}")

    prof = profile_steady(lambda: spgemm(A, A, cfg))
    log(f"profile of one steady call: wall {prof['wall_ms']:.1f} ms, "
        f"device busy {prof['device_busy_ms']:.1f} ms, idle share "
        f"{prof['device_idle_share']:.3f}")
    for e in prof["top_ops"][:6]:
        log(f"  {e['name']}: {e['device_ms']:.1f} ms device, "
            f"{e['calls']} calls")
    for name in RANGES:
        log(f"  range {name}: {prof['range_device_ms'][name]:.1f} ms device,"
            f" of it aten::sort {prof['range_sort_device_ms'][name]:.1f} ms")

    ref = scipy_check(A, res.C)
    cold_ref = compare_csr("cold vs steady C", res_cold.C, res.C)
    log(f"scipy check: nnz {ref['nnz']}, total_nprod {res.total_nprod}, "
        f"max |C - A·A| {ref['max_abs_err']:.3e}, cold-vs-steady max "
        f"{cold_ref:.3e}: ok")
    del res_cold
    torch.cuda.empty_cache()

    sparse_ms = torch_sparse_ms(A)
    log(f"torch.sparse A@A: {sparse_ms:.1f} ms")

    phase_top_rungs(sh, A, res.sym_binning, res.num_binning, errs)
    stats = phase_main_shapes(sh, A, entry.plan, res, errs)

    kernels = []
    for name in REPLACES:
        s = stats[name]
        kernels.append(dict(
            name=name, route="cuda", source=SOURCE,
            replaces=REPLACES[name], launches=launches[name],
            max_abs_err=errs[name], ms=s["ms"], plain_ms=s["plain_ms"],
            bound_ms=s["bound_ms"], bound_by="bytes", library_ms=None))
    return dict(
        card=card, kernels=kernels, build_s=secs,
        slice=dict(matrix="mono_500Hz", rows=A.nrows, nnz=int(A.nnz()),
                   total_nprod=res.total_nprod, total_nnz=res.total_nnz,
                   cold_ms=cold_ms, steady_ms=steady_ms,
                   steady_median_ms=statistics.median(steady_ms),
                   peak_bytes=peak, torch_sparse_ms=sparse_ms,
                   cold_launches=cold_launches,
                   steady_launches=steady_launches,
                   schedule=str(entry.plan.hash_schedule),
                   nnz_bucket=entry.plan.nnz_bucket, scipy=ref,
                   profile=prof),
        main_shapes=stats,
        numpy=np.__version__, torch=torch.__version__,
        cuda=torch.version.cuda)


if __name__ == "__main__":
    sys.exit(main())
