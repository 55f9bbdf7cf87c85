"""Ablation builds of the port's kernels, timed on the card.

Each variant is the kernel's source with one stage removed or changed,
compiled with the same ``nvcc`` flags into ``build/repro_torch/ablate/``
and called through the same C entry point.  A variant's output is not a
product: it only says what the removed stage costs.

    python -m repro_torch.kernels.ablate [--report PATH]

needs one card.  It builds the analog of mono_500Hz (paper Table 3, the
matrix ``chip_smoke.py`` drives) and times ``fused_bin`` at the steady
call's rungs for every variant in ``HASH_VARIANTS``, prints the SASS
opcodes of the hash kernels that touch memory, and times the bfloat16
``bsr_spmm`` at the layer shape of ``chip_smoke.py`` with the ring depths
of ``BSR_VARIANTS``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import zlib
from pathlib import Path
from typing import Callable, Dict

import numpy as np
import torch

from . import build

ABLATE_DIR = build.BUILD_DIR / "ablate"
# The steady call's symbolic-ladder buckets for the mono_500Hz analog.
MONO_BUCKETS = (0, 16384, 262144, 131072, 65536, 16384, 4096, 4096, 2048)

_INSERT = '''          accesses += insert<SINGLE_ACCESS, WITH_VALUES>(
              row_keys, row_vals, b_col[j], prod, t_size, pow2, guard,
              &inserted);'''
_CAS_HIT = '''      if (old == kEmpty || old == key) {
        if (old == kEmpty) *inserted += 1;
        if (WITH_VALUES) atomicAdd(&vals[h], prod);
        break;
      }
    } else {'''


def _replace(old: str, new: str) -> Callable[[str], str]:
    def edit(src: str) -> str:
        if old not in src:
            raise ValueError(f"ablation anchor not found: {old[:60]!r}")
        return src.replace(old, new)
    return edit


HASH_VARIANTS: Dict[str, Callable[[str], str]] = {
    "base": lambda src: src,
    # valid CTAs keep their tables in shared memory: no dump
    "no_dump": _replace("  if (col_out) {\n",
                        "  if (col_out && t_size < 0) {\n"),
    # valid CTAs fill and dump their tables, nothing else
    "fill_dump_only": _replace("  if (idx < n_valid) {",
                               "  if (idx < n_valid && t_size < 0) {"),
    # every load of the insert loop stays, no table access
    "loads_only": _replace(_INSERT, "          accesses += (b_col[j] ^ "
                                    "__float_as_int(prod)) & 1;"),
    # values added without atomics (wrong sums, same probes)
    "plain_value_add": _replace(
        "if (WITH_VALUES) atomicAdd(&vals[h], prod);",
        "if (WITH_VALUES) vals[h] += prod;"),
    # single access gives up after its first CAS: no probe chains
    "one_cas": _replace(_CAS_HIT, _CAS_HIT.replace(
        "        break;\n      }\n    } else {",
        "        break;\n      }\n      break;\n    } else {")),
}

BSR_VARIANTS: Dict[str, Callable[[str], str]] = {
    "3 stages, 2 CTAs/SM": lambda src: src,
    "2 stages, 2 CTAs/SM": _replace("constexpr int kStages = 3;",
                                    "constexpr int kStages = 2;"),
    "4 stages, 1 CTA/SM": lambda src: _replace(
        "__launch_bounds__(kTcThreads, 2)",
        "__launch_bounds__(kTcThreads, 1)")(_replace(
            "constexpr int kStages = 3;", "constexpr int kStages = 4;")(src)),
}


def build_variants(name: str, variants: Dict[str, Callable[[str], str]]
                   ) -> Dict[str, ctypes.CDLL]:
    """Compile every variant of ``csrc/<name>.cu`` (all ``nvcc`` runs at
    once) and bind its entry points as ``build`` binds the product's."""
    ABLATE_DIR.mkdir(parents=True, exist_ok=True)
    src = (build.CSRC / f"{name}.cu").read_text()
    procs = {}
    for i, (label, edit) in enumerate(variants.items()):
        cu = ABLATE_DIR / f"{name}_{i}.cu"
        so = ABLATE_DIR / f"lib{name}_{i}.so"
        cu.write_text(edit(src))
        procs[label] = (subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for label, (proc, so) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {label!r} of {name}.cu failed:\n{out}")
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in build.SIGNATURES[name].items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        libs[label] = lib
    return libs


def time_ms(fn: Callable[[], object], reps: int) -> float:
    """Mean ms of fn() over reps launches (CUDA events), after a warm-up."""
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


def sass_memory_ops(name: str) -> Dict[str, Dict[str, int]]:
    """Per kernel of the built ``csrc/<name>.cu``: how many SASS
    instructions of each memory or atomic opcode it holds."""
    return {kernel: {op: n for op, n in sorted(ops.items())
                     if op.startswith(("ATOM", "RED", "LDS", "STS", "LDG",
                                       "STG"))}
            for kernel, ops in build.sass_opcodes(name).items()}


def mono_rungs():
    """The mono_500Hz analog on the card and its fused rungs."""
    from repro_torch.core import (bin_rows, nprod_into_rpt, random_csr,
                                  symbolic_ladder)
    from . import spgemm_hash as sh
    A = random_csr(zlib.crc32(b"mono_500Hz"), 169410, 169410,
                   avg_nnz_per_row=29.7, max_nnz_per_row=719,
                   distribution="powerlaw", device="cuda")
    lad = symbolic_ladder()
    nprod = nprod_into_rpt(A, A)[:A.nrows]
    binning = bin_rows(nprod, upper=lad.upper, num_bins=lad.num_bins)
    return A, sh.fused_rungs(binning, lad, MONO_BUCKETS)


def ablate_fused() -> Dict[str, Dict]:
    """fused_bin of every hash variant at the steady call's rungs."""
    from . import spgemm_hash as sh
    libs = build_variants("spgemm_hash", HASH_VARIANTS)
    A, rungs = mono_rungs()
    stream = torch.cuda.current_stream().cuda_stream
    outs = {r.b: sh.fused_outputs(r.rows_cap, r.t_size, A.device)
            for r in rungs}

    def launch(lib, r):
        rows_per_cta, threads = sh.launch_geometry(r.t_size, r.pack)
        nnz, cols, vals, acc = outs[r.b]
        build.check(lib.fused_bin(
            r.rows.data_ptr(), r.count.data_ptr(), A.rpt.data_ptr(),
            A.col.data_ptr(), A.val.data_ptr(), A.rpt.data_ptr(),
            A.col.data_ptr(), A.val.data_ptr(), r.t_size, r.rows_cap,
            rows_per_cta, threads, 1, nnz.data_ptr(), cols.data_ptr(),
            vals.data_ptr(), acc.data_ptr(), stream), "fused_bin variant")

    result = {}
    for label, lib in libs.items():
        per = {r.b: time_ms(lambda: launch(lib, r), 3) for r in rungs}
        result[label] = dict(ms=sum(per.values()), rungs=per)
        print(f"fused_bin {label}: {sum(per.values()):.3f} ms; by rung "
              + ", ".join(f"{b}: {ms:.3f}" for b, ms in per.items()),
              flush=True)
    return result


def ablate_bsr() -> Dict[str, float]:
    """A bfloat16 layer of the shape chip_smoke.py times (8192 x 8192 in
    128 x 128 blocks, 10 % stored, N = 4096) with each ring depth."""
    from .bsr_spmm import block_row_pointers
    libs = build_variants("bsr_spmm", BSR_VARIANTS)
    nb, blk, n = 64, 128, 4096
    rng = np.random.default_rng(zlib.crc32(b"bsr_spmm ablation"))
    rows, cols = np.nonzero(rng.random((nb, nb)) < 0.1)
    g = torch.Generator(device="cuda").manual_seed(12)
    blocks = torch.randn((len(rows), blk, blk), generator=g,
                         device="cuda").to(torch.bfloat16)
    dense = torch.randn((nb * blk, n), generator=g,
                        device="cuda").to(torch.bfloat16)
    ptr = block_row_pointers(torch.from_numpy(rows.astype(np.int32)).cuda(),
                             nb)
    cols_t = torch.from_numpy(cols.astype(np.int32)).cuda()
    out = torch.empty((nb * blk, n), dtype=torch.bfloat16, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    result = {}
    for label, lib in libs.items():
        def launch():
            build.check(lib.bsr_spmm_bf16(
                ptr.data_ptr(), cols_t.data_ptr(), blocks.data_ptr(),
                dense.data_ptr(), out.data_ptr(), nb, blk, blk, n, stream),
                "bsr_spmm_bf16 variant")
        result[label] = time_ms(launch, 20)
        print(f"bsr_spmm bf16 {label}: {result[label]:.4f} ms "
              f"({len(rows)} blocks)", flush=True)
    return result


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--report", type=Path, default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("ablate: no CUDA device visible", file=sys.stderr)
        return 2
    build.build_all()
    sass = sass_memory_ops("spgemm_hash")
    for kernel, ops in sass.items():
        print(f"SASS {kernel}: {ops}", flush=True)
    report = dict(card=torch.cuda.get_device_name(0), sass=sass,
                  fused_bin=ablate_fused(), bsr_spmm_bf16=ablate_bsr())
    if args.report is not None:
        args.report.parent.mkdir(parents=True, exist_ok=True)
        args.report.write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
