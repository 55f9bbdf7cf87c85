"""Ablation builds of the port's kernels, timed on the card.

Each variant is the kernel's source with one stage removed or changed,
compiled with the same ``nvcc`` flags into ``build/repro_torch/ablate/``
and called through the same C entry point.  A variant's output is not a
product: it only says what the removed stage costs.

    python -m repro_torch.kernels.ablate [--report PATH] [--parts LIST]

needs one card.  It builds the analogs of mono_500Hz and scircuit (paper
Table 3, the matrices ``chip_smoke.py`` drives) and derives the rungs of
their exact-mode cold calls as the engine does.  Parts (``--parts``, a
subset of ``PARTS``):

- ``cold``: mono_500Hz's exact-mode cold call, three times on the product
  build and three on ``hash_rows_only`` (``numeric_bin`` on
  ``hash_rows_kernel``), each with a new engine, then once each under
  ``torch.profiler``: per ``StepTimer`` step, the host's dispatch time,
  the wait at the step's synchronize, and the device work of the step.
- ``fused``: ``fused_bin`` at mono_500Hz's symbolic rungs (those of the
  steady call) for every ``HASH_VARIANTS`` build.
- ``two_pass``: ``symbolic_bin`` and ``numeric_bin`` at mono_500Hz's
  cold-call rungs for the builds ``TWO_PASS_TIMED`` lists.
- ``pack``: ``numeric_bin`` at scircuit's cold-call numeric rungs (its
  rows fill the one-warp rungs t = 31 and 255) packed as the wrapper
  launches it, one row to a block, and on ``hash_rows_kernel``.
- ``bsr``: the bfloat16 ``bsr_spmm`` at the layer shape of
  ``chip_smoke.py`` with the ring depths of ``BSR_VARIANTS``.
- ``bsr_f32``: the float32 ``bsr_spmm`` on the layer of ``chip_smoke.py``
  (its 438 blocks) with the block rows in their own order or longest
  first, at 2 and 3 stages (``BSR_F32_VARIANTS``), in turns; what
  building that order costs per call; the SM clock and power draw while
  the product build runs.
- ``global``: the extended fused rung as the default ladders' fallback
  rung, a measurement only (the product keeps ESC there, as the reference
  does): mono_500Hz's fallback rows (the 864 rows past 20,480 products,
  in the engine's cold bucket) through ``fused_bin`` at t_size 65,536 on
  the cluster kernel (the wrapper's route) and on the global-memory kernel
  (its C entry point), and the cluster kernel with ``numeric_epilogue``
  after it, in turns with the ESC fallback rung on the same rows as
  ``fused_scheduled`` runs it (gather, ``esc.spgemm_fused`` at the plan's
  product bucket, scatter into C).  The two write equal rows of C.
- ``cluster``: each cluster rung of mono_500Hz's exact-mode cold call on
  the ``vmem_extended`` ladders (symbolic and fused 65,536, numeric
  32,768 and 131,072, in the engine's buckets) at every cluster size
  from the smallest that holds its table to 8, on each
  ``CLUSTER_VARIANTS`` build (no inserts, no dump, fill and dump only),
  in turns, with the clusters in flight at each size: what fill, inserts
  and dump cost, and the cluster size that ``spgemm_hash.CLUSTER_SIZES``
  takes.
- ``ordered``: the fixed-order ``fused_bin`` and ``numeric_bin`` (their
  ORDERED instances) at mono_500Hz's cold-call rungs on the default
  ladders and at its ``vmem_extended`` rungs past shared memory, on each
  ``ORDERED_VARIANTS`` build (the value pass cut after the keys, after
  making the products, after probing, after sorting them by owner) and,
  with ``--baseline DIR``, on DIR's build, in turns, DIR's tables held bit
  for bit to these, and which atomic kernel instances have DIR's SASS;
  and torch's fill of the wrappers' uninitialised outputs in that mode,
  timed apart.
- ``dtypes``: the 16-bit ``fused_bin`` at mono_500Hz's steady-call rungs
  and ``numeric_bin`` at its cold-call rungs, in bfloat16 and float16,
  on each ``DTYPE_VARIANTS`` build (no value add, keys only, fill and
  dump only) and, with ``--baseline DIR``, on DIR's builds, in turns, the
  float32 instances beside them; each 16-bit instance's registers, spill
  bytes and SASS opcodes; with ``--baseline``, DIR's fixed-order tables
  held bit for bit to these, whether every float32 instance has DIR's
  SASS, and the 16-bit ``fused_bin`` at t_size 32,768 in both trees.
- ``baseline`` (with ``--baseline DIR``, another checkout's root): the
  float32 ``bsr_spmm`` on that layer and ``binning_histogram`` on
  delaunay_n24's 16,777,216 sizes and on the first 169,410 of them
  (mono_500Hz's row count), built from DIR's sources and from these,
  timed in turns (DIR, these, these, DIR) through the same C entry
  points.  Not in the default parts.

It also prints the SASS opcodes of the hash kernels that touch memory.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
import time
import zlib
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from . import build

ABLATE_DIR = build.BUILD_DIR / "ablate"
MATRICES = {"mono_500Hz": (169410, 29.7, 719), "scircuit": (170998, 5.6, 353)}

_INSERT = '''          accesses += insert<SINGLE_ACCESS, WITH_VALUES && !ORDERED>(
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


# Edits of hash_rows_kernel (fused_bin, symbolic_bin).
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
                                    "__float_as_int(Ops::to_f(prod))) & 1;"),
    # values added without atomics (wrong sums, same probes)
    "plain_value_add": _replace(
        "if (WITH_VALUES) atomicAdd(&vals[h], prod);",
        "if (WITH_VALUES) vals[h] += prod;"),
    # single access gives up after its first CAS: no probe chains
    "one_cas": _replace(_CAS_HIT, _CAS_HIT.replace(
        "        break;\n      }\n    } else {",
        "        break;\n      }\n      break;\n    } else {")),
}

_NUMERIC_LAUNCH = """\
  return slot_dispatch<ORDERED, VT>(
      mod, single_access, rows, count, a_rpt, a_col,
      static_cast<const V*>(a_val), b_rpt, b_col,
      static_cast<const V*>(b_val), t_size, rows_cap, rows_per_cta,
      threads_per_row, col_out, static_cast<V*>(val_out), acc_out, stream);
"""
# Edits of slot_rows_kernel (numeric_bin).
SLOT_VARIANTS: Dict[str, Callable[[str], str]] = {
    "base": lambda src: src,
    # numeric_bin on hash_rows_kernel, one row to a block: the kernel it
    # ran before slot_rows_kernel, for a side-by-side time
    "hash_rows_only": _replace(_NUMERIC_LAUNCH, """\
  return dispatch<true, ORDERED, VT>(
      single_access, rows, count, a_rpt, a_col, static_cast<const V*>(a_val),
      b_rpt, b_col, static_cast<const V*>(b_val), t_size, rows_cap, 1,
      threads_per_row, nullptr, col_out, static_cast<V*>(val_out), acc_out,
      stream);
"""),
    # valid CTAs keep their tables in shared memory: no dump
    "no_dump": _replace("  dump_slots(col_out + base",
                        "  if (t_size < 0) dump_slots(col_out + base"),
    # valid CTAs fill and dump their tables, nothing else
    "fill_dump_only": _replace(
        "  if (local < rows_here && idx < n_valid) {",
        "  if (local < rows_here && idx < n_valid && t_size < 0) {"),
    # every load of the insert loop stays, no table access
    "loads_only": _replace("""\
          accesses += insert_slot<SINGLE_ACCESS, VT>(
              row_slots, b_col[j],
              ORDERED ? 0.0f : Ops::round(a * Ops::to_f(b_val[j])), t_size,
              pow2, mod, guard);
""", "          accesses += (b_col[j] ^ "
       "__float_as_int(a * Ops::to_f(b_val[j]))) & 1;\n"),
    # the 64-bit slot read and written without an atomic (wrong sums under
    # races, the same probes)
    "plain_value_add": _replace("""\
      const unsigned long long old = atomicCAS(
          &slots[h], seen, pack_slot<VT>(key, slot_val<VT>(seen) + prod));
""", """\
      const unsigned long long old = slots[h];
      const bool mine = slot_key(old) == kEmpty || slot_key(old) == key;
      if (mine) slots[h] = pack_slot<VT>(key, slot_val<VT>(old) + prod);
      seen = mine ? old : ~old;
"""),
    # every product gives up after its first pass: no probe chains
    "one_cas": _replace(
        "  while (probed < guard) {\n",
        "  for (int once = 0; once < 1 && probed < guard; ++once) {\n"),
    # the multiply-high floor mod replaced by an AND with the mask of the
    # next power of two, folded once into the table (t_size = 2^k - 1: only
    # slot 0 takes two hashes), which prices the mod alone
    "mod_as_and": _replace(
        "  const unsigned t1 = __umulhi(mod.magic, p);\n",
        "  int h = static_cast<int>(p & ((1u << (32 - __clz(t_size))) - 1u));"
        "\n  if (h >= t_size) h -= t_size;\n  return h;\n"
        "  const unsigned t1 = __umulhi(mod.magic, p);\n"),
}
# What the two-pass ablation times, by kernel: (variant set, variant).
# "unpacked" is the base build with numeric_bin at one row to a block.
TWO_PASS_TIMED = {
    "symbolic_bin": tuple(("hash", k) for k in (
        "base", "fill_dump_only", "loads_only", "one_cas")),
    "numeric_bin": (("slot", "base"), ("slot", "hash_rows_only"),
                    ("slot", "unpacked"),
                    *(("slot", k) for k in SLOT_VARIANTS
                      if k not in ("base", "hash_rows_only"))),
}
PACK_TIMED = (("slot", "base"), ("slot", "unpacked"),
              ("slot", "hash_rows_only"))

_CLUSTER_INSERT = """\
        accesses += cluster_insert<SINGLE_ACCESS, WITH_VALUES, VT>(
            table, rank_shift, b_col[j],
            WITH_VALUES && !ORDERED
                ? Val<VT>::round(entry_av()[e] * Val<VT>::to_f(b_val[j]))
                : 0.0f,
            t_size, &inserted);
"""
_CLUSTER_CHUNKS = "         g < chunks; g += warps) {\n"


# Edits of cluster_rows_kernel (the cluster rungs of all three wrappers).
CLUSTER_VARIANTS: Dict[str, Callable[[str], str]] = {
    "base": lambda src: src,
    # every load of the insert loop stays, no table access
    "no_inserts": _replace(_CLUSTER_INSERT, "        accesses += (b_col[j] ^ "
                           "__float_as_int(WITH_VALUES ? entry_av()[e] * "
                           "Val<VT>::to_f(b_val[j]) : 0.0f)) & 1;\n"),
    # each block keeps its slice in shared memory: no dump
    "no_dump": _replace("  if (WITH_VALUES) {\n    const long long off =",
                        "  if (WITH_VALUES && t_size < 0) {\n"
                        "    const long long off ="),
    # fill, the entry lists, the two cluster barriers and the dump
    "fill_dump_only": _replace(_CLUSTER_CHUNKS, _CLUSTER_CHUNKS.replace(
        "g < chunks;", "g < chunks && t_size < 0;")),
}

_ORDERED_MADE = ("  int made = 0;  // batches of this round made so far, by "
                 "every warp\n")
_OWNER_LOOP = ("  for (int q = 0; q < total; q += 32) {\n"
               "    const int t = q + lane;\n")
_STAGE_CALL = ("        stage_batch(stage, slot, prod, warp, warps, "
               "thread_index_now() % 32);\n")
_no_owner = _replace(_OWNER_LOOP, _OWNER_LOOP.replace(
    "q < total;", "q < total && warps < 0;"))
_stage_raw = _replace(_STAGE_CALL, "        stage[32 * warp + "
                      "thread_index_now() % 32] = make_int2(slot, "
                      "__float_as_int(prod));\n")

# Edits of the fixed-order value pass (ordered_values and what it calls),
# which every ORDERED instance runs: each keeps the stages before one cut.
ORDERED_VARIANTS: Dict[str, Callable[[str], str]] = {
    "base": lambda src: src,
    # the value pass returns at once: fill, keys and dump alone
    "keys_only": _replace(_ORDERED_MADE,
                          _ORDERED_MADE + "  if (a_lo >= 0) return;\n"),
    # every product made (window loads, its entry, b_col / b_val, the
    # rounded product) and staged where it lies: no probe, no owner's add
    "make_no_probe": lambda src: _no_owner(_stage_raw(_replace(
        "  return table.find(b_col[j]);\n}",
        "  return b_col[j] & 1023;\n}")(src))),
    # made and probed, staged where it lies: no owner's add
    "make": lambda src: _no_owner(_stage_raw(src)),
    # made, probed and sorted by owner: no owner's add
    "make_sort": _no_owner,
}

def _no_value_add(src: str) -> str:
    """Inserts that claim their key and add no value: hash_rows_kernel's
    ``insert`` (the 16-bit fused_bin of trees before the 64-bit slot) drops
    its atomicAdd on V, ``insert_slot`` writes the key beside the value it
    saw (no conversion, add or rounding)."""
    src = _replace("if (WITH_VALUES) atomicAdd(&vals[h], prod);", "")(src)
    for seen in ("seen", "cur"):
        src = _replace(f"pack_slot<VT>(key, slot_val<VT>({seen}) + prod)",
                       f"({seen} >> 32 << 32 | static_cast<unsigned>(key))"
                       )(src)
    return src


def _keys_only(src: str) -> str:
    """:func:`_no_value_add`, and no product made: B's values are not
    read."""
    src = _replace("Ops::from_f(WITH_VALUES ? a * Ops::to_f(b_val[j]) : "
                   "0.0f)", "Ops::from_f(0.0f)")(src)
    src = _replace("ORDERED ? 0.0f : Ops::round(a * Ops::to_f(b_val[j]))",
                   "0.0f")(src)
    return _no_value_add(src)


# Edits that price the stages of the 16-bit value kernels (part
# ``dtypes``), in both bodies a tree may run them on: hash_rows_kernel and
# slot_rows_kernel.  Their anchors are in this tree's source and in its
# parent's, so that ``--baseline`` prices the other tree's stages too.
DTYPE_VARIANTS: Dict[str, Callable[[str], str]] = {
    "base": lambda src: src,
    "no_value_add": _no_value_add,
    "keys_only": _keys_only,
    # valid CTAs fill and dump their tables, nothing else
    "fill_dump_only": lambda src: SLOT_VARIANTS["fill_dump_only"](
        HASH_VARIANTS["fill_dump_only"](src)),
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

# Edits of bsr_spmm_f32_kernel: the order of its block rows and its ring.
# Longest first reads the order that ablate_bsr_f32 passes after the row
# pointers (the grid holds n_block_rows * m_tiles * n_tiles CTAs).
_longest_first = _replace(
    "  const int r = slot / m_tiles;                 // block row",
    "  const int r = ptr[gridDim.x / (m_tiles * n_tiles) + 1 + slot / "
    "m_tiles];")
_three_stages = _replace("constexpr int kF32Stages = 2;",
                         "constexpr int kF32Stages = 3;")
BSR_F32_VARIANTS: Dict[str, Callable[[str], str]] = {
    "block-row order, 2 stages": lambda src: src,
    "longest first, 2 stages": _longest_first,
    "block-row order, 3 stages": _three_stages,
    "longest first, 3 stages": lambda src: _longest_first(_three_stages(src)),
}


def build_variants(name: str, variants: Dict[str, Callable[[str], str]],
                   csrc: Path = build.CSRC) -> Dict[str, ctypes.CDLL]:
    """Compile every variant of ``<csrc>/<name>.cu`` (all ``nvcc`` runs at
    once) and bind its entry points as ``build`` binds the product's."""
    ABLATE_DIR.mkdir(parents=True, exist_ok=True)
    src = (csrc / f"{name}.cu").read_text()
    tag = "" if csrc == build.CSRC else "_baseline"
    procs = {}
    for i, (label, edit) in enumerate(variants.items()):
        cu = ABLATE_DIR / f"{name}{tag}_{i}.cu"
        so = ABLATE_DIR / f"lib{name}{tag}_{i}.so"
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
        lib.ptxas = build.ptxas_lines(out)
        for fn, argtypes in build.SIGNATURES[name].items():
            if not hasattr(lib, fn):    # another checkout's source
                continue
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


def table3_matrix(name: str):
    """The analog of a Table-3 matrix (``MATRICES``) on the card, built as
    ``chip_smoke.py`` builds it."""
    from repro_torch.core import random_csr
    rows, avg, most = MATRICES[name]
    return random_csr(zlib.crc32(name.encode()), rows, rows,
                      avg_nnz_per_row=avg, max_nnz_per_row=most,
                      distribution="powerlaw", device="cuda")


def cold_schedule(name: str, A, *, vmem_extended: bool = False):
    """The rungs of A·A's exact-mode cold call: the symbolic ladder's
    (which the steady call's fused kernel also runs) and the numeric
    ladder's, bucketed with the engine's initial headroom as
    ``_execute_steps`` buckets them."""
    from repro_torch.core import (bin_rows_for_ladder, nprod_into_rpt,
                                  numeric_ladder, symbolic_ladder)
    from repro_torch.engine.autotune import AdaptivePolicy
    from . import spgemm_hash as sh
    headroom = AdaptivePolicy().headroom_init
    sym = symbolic_ladder(vmem_extended=vmem_extended)
    num = numeric_ladder(vmem_extended=vmem_extended)
    sym_bins = bin_rows_for_ladder(nprod_into_rpt(A, A)[:A.nrows], sym)
    sym_buckets, sym_fall = sh.host_schedule(A, A, sym_bins, sym,
                                             headroom=headroom)
    nnz, _, _ = sh.symbolic_scheduled(A, A, sym_bins, sym,
                                      row_buckets=sym_buckets,
                                      fallback_prod_capacity=sym_fall)
    num_bins = bin_rows_for_ladder(nnz[:A.nrows], num)
    num_buckets, _ = sh.host_schedule(A, A, num_bins, num,
                                      headroom=headroom)
    num_rows = num_bins.bin_size.tolist()
    print(f"{name} buckets: symbolic {sym_buckets}, numeric {num_buckets} "
          f"(valid rows {num_rows})", flush=True)
    return (sh.fused_rungs(sym_bins, sym, sym_buckets),
            sh.fused_rungs(num_bins, num, num_buckets))


def _time_rungs(what: str, label: str, rungs, launch) -> Dict:
    per = {r.b: time_ms(lambda: launch(r), 3) for r in rungs}
    print(f"{what} {label}: {sum(per.values()):.3f} ms; by rung "
          + ", ".join(f"{b}: {ms:.3f}" for b, ms in per.items()),
          flush=True)
    return dict(ms=sum(per.values()), rungs=per)


def ablate_fused(libs, A, rungs) -> Dict[str, Dict]:
    """fused_bin of every HASH_VARIANTS build at the steady call's rungs."""
    from . import spgemm_hash as sh
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

    return {label: _time_rungs("fused_bin", label, rungs,
                               lambda r, lib=libs["hash " + label]:
                               launch(lib, r))
            for label in HASH_VARIANTS}


def _two_pass_launchers(libs, A, sym_rungs, num_rungs):
    """(symbolic, numeric): launch one rung of A·A through the build of a
    (variant set, variant) pair, single access, into preallocated
    outputs."""
    from . import spgemm_hash as sh
    stream = torch.cuda.current_stream().cuda_stream
    dev = A.device
    outs = {r.b: (torch.empty(r.rows_cap, dtype=torch.int32, device=dev),
                  torch.empty(r.rows_cap, dtype=torch.int32, device=dev))
            for r in sym_rungs}
    tabs = {r.b: sh.fused_outputs(r.rows_cap, r.t_size, dev)[1:]
            for r in num_rungs}

    def symbolic(group, label, r):
        rows_per_cta, threads = sh.launch_geometry(r.t_size, r.pack)
        nnz, acc = outs[r.b]
        build.check(libs[f"{group} {label}"].symbolic_bin(
            r.rows.data_ptr(), r.count.data_ptr(), A.rpt.data_ptr(),
            A.col.data_ptr(), A.rpt.data_ptr(), A.col.data_ptr(), r.t_size,
            r.rows_cap, rows_per_cta, threads, 1, nnz.data_ptr(),
            acc.data_ptr(), stream), "symbolic_bin variant")

    def numeric(group, label, r):
        rows_per_cta, threads = sh.numeric_launch_geometry(r.t_size)
        if label == "unpacked":
            label, rows_per_cta = "base", 1
        cols, vals, acc = tabs[r.b]
        build.check(libs[f"{group} {label}"].numeric_bin(
            r.rows.data_ptr(), r.count.data_ptr(), A.rpt.data_ptr(),
            A.col.data_ptr(), A.val.data_ptr(), A.rpt.data_ptr(),
            A.col.data_ptr(), A.val.data_ptr(), r.t_size, r.rows_cap,
            rows_per_cta, threads, 1, *sh.hash_mod(r.t_size),
            cols.data_ptr(), vals.data_ptr(), acc.data_ptr(), stream),
            "numeric_bin variant")

    return symbolic, numeric


def ablate_two_pass(libs, A, sym_rungs, num_rungs) -> Dict[str, Dict]:
    """symbolic_bin and numeric_bin of the TWO_PASS_TIMED builds at the
    exact-mode cold call's rungs."""
    launchers = dict(zip(("symbolic_bin", "numeric_bin"),
                         _two_pass_launchers(libs, A, sym_rungs, num_rungs)))
    rungs = {"symbolic_bin": sym_rungs, "numeric_bin": num_rungs}
    return {kind: {f"{group}:{label}": _time_rungs(
        kind, f"{group}:{label}", rungs[kind],
        lambda r, g=group, v=label, k=kind: launchers[k](g, v, r))
        for group, label in TWO_PASS_TIMED[kind]} for kind in rungs}


def ablate_pack(libs) -> Dict[str, Dict]:
    """numeric_bin of the PACK_TIMED builds at scircuit's cold-call numeric
    rungs, whose rows fill the one-warp rungs."""
    S = table3_matrix("scircuit")
    sym_rungs, num_rungs = cold_schedule("scircuit", S)
    _, numeric = _two_pass_launchers(libs, S, [], num_rungs)
    return {f"{group}:{label}": _time_rungs(
        "scircuit numeric_bin", f"{group}:{label}", num_rungs,
        lambda r, g=group, v=label: numeric(g, v, r))
        for group, label in PACK_TIMED}


def _step_windows(trace: Dict) -> Dict[str, Dict]:
    """Per StepTimer step of a profiled cold call (its ``step_wait:<name>``
    ranges): the host's time from the end of the previous wait (the
    first: from the trace's first event) to the start of this one
    (dispatch), the wait, and the device work that
    started in that window (kernels, copies and fills: their summed time,
    their count and the three longest by name)."""
    events = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    waits = sorted((e for e in events if e.get("cat") == "user_annotation"
                    and e["name"].startswith("step_wait:")),
                   key=lambda e: e["ts"])
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy",
                                                     "gpu_memset")]
    out = {}
    lo = min(e["ts"] for e in events)
    for w in waits:
        end = w["ts"] + w["dur"]
        mine = [e for e in device if lo <= e["ts"] < end]
        by_name: Dict[str, float] = {}
        for e in mine:
            by_name[e["name"][:80]] = by_name.get(e["name"][:80], 0.0) \
                + e["dur"] / 1e3
        out[w["name"].split(":", 1)[1]] = dict(
            dispatch_ms=(w["ts"] - lo) / 1e3, wait_ms=w["dur"] / 1e3,
            device_ms=sum(e["dur"] for e in mine) / 1e3,
            device_ops=len(mine),
            top=sorted(by_name.items(), key=lambda kv: -kv[1])[:3])
        lo = end
    return out


def ablate_cold(libs, A, report_dir: Path) -> Dict[str, Dict]:
    """mono_500Hz's exact-mode cold call on the product build and on
    ``hash_rows_only``: three timed runs each, then one profiled."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import SpgemmConfig
    from repro_torch.engine import SpgemmEngine
    cfg = SpgemmConfig(method="hash", timing=True)
    product = build.library("spgemm_hash")
    result = {}
    try:
        for label in ("slot base", "slot hash_rows_only"):
            build._LIBS["spgemm_hash"] = (product if label == "slot base"
                                          else libs[label])
            runs = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = SpgemmEngine().execute(A, A, cfg)
                torch.cuda.synchronize()
                runs.append(dict(ms=(time.perf_counter() - t0) * 1e3,
                                 steps={k: v * 1e3
                                        for k, v in res.timings.items()}))
                del res
                torch.cuda.empty_cache()
                print(f"cold {label}: {runs[-1]['ms']:.1f} ms, steps "
                      + ", ".join(f"{k} {v:.1f}"
                                  for k, v in runs[-1]["steps"].items()),
                      flush=True)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                res = SpgemmEngine().execute(A, A, cfg)
                torch.cuda.synchronize()
            del res
            torch.cuda.empty_cache()
            path = report_dir / f"cold_trace_{label.split()[1]}.json"
            prof.export_chrome_trace(str(path))
            windows = _step_windows(json.loads(path.read_text()))
            for step, w in windows.items():
                print(f"cold {label} profiled {step}: dispatch "
                      f"{w['dispatch_ms']:.1f} ms, wait {w['wait_ms']:.1f} "
                      f"ms, device {w['device_ms']:.1f} ms in "
                      f"{w['device_ops']} ops, top "
                      + "; ".join(f"{n} {ms:.1f}" for n, ms in w["top"]),
                      flush=True)
            result[label] = dict(runs=runs, profiled=windows)
    finally:
        build._LIBS["spgemm_hash"] = product
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


def smoke_layer():
    """The block layout (rows, cols) of ``chip_smoke.py``'s 8192 x 8192
    layer: 64 x 64 blocks of 128 x 128, 10 % stored, drawn from its RNG
    after the masks of the four edge cases that come before it."""
    rng = np.random.default_rng(zlib.crc32(b"bsr_spmm"))
    for shape in ((6, 5), (4, 3), (3, 3), (4, 4)):
        rng.random(shape)
    return np.nonzero(rng.random((64, 64)) < 0.1)


def f32_layer():
    """chip_smoke.py's float32 layer on the card: (row pointers, block
    columns, blocks, dense, out, n_block_rows, block size, N)."""
    from .bsr_spmm import block_row_pointers
    nb, blk, n = 64, 128, 4096
    rows, cols = smoke_layer()
    g = torch.Generator(device="cuda").manual_seed(12)
    blocks = torch.randn((len(rows), blk, blk), generator=g, device="cuda")
    dense = torch.randn((nb * blk, n), generator=g, device="cuda")
    ptr = block_row_pointers(torch.from_numpy(rows.astype(np.int32)).cuda(),
                             nb)
    cols_t = torch.from_numpy(cols.astype(np.int32)).cuda()
    out = torch.empty((nb * blk, n), device="cuda")
    return ptr, cols_t, blocks, dense, out, nb, blk, n


def f32_launcher(lib, ptr, cols, blocks, dense, out, nb, blk, n):
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        build.check(lib.bsr_spmm_f32(
            ptr.data_ptr(), cols.data_ptr(), blocks.data_ptr(),
            dense.data_ptr(), out.data_ptr(), nb, blk, blk, n, stream),
            "bsr_spmm_f32 variant")
    return launch


def in_turns(launchers: Dict[str, Callable[[], None]], rounds: int,
             what: str, after: Callable[[str], None] = lambda label: None,
             reps: int = 20) -> Dict[str, Dict]:
    """time_ms of every launcher (``reps`` launches), ``rounds`` times in
    turns (forward, then backward); ``after(label)`` runs after each
    timing."""
    labels = list(launchers)
    times: Dict[str, list] = {label: [] for label in labels}
    for turn in range(rounds):
        for label in labels if turn % 2 == 0 else labels[::-1]:
            times[label].append(time_ms(launchers[label], reps))
            after(label)
    result = {}
    for label, ts in times.items():
        result[label] = dict(ms=sum(ts) / len(ts), runs=ts)
        print(f"{what} {label}: {result[label]['ms']:.4f} ms (runs "
              f"{', '.join(f'{t:.4f}' for t in ts)})", flush=True)
    return result


def ablate_bsr_f32(rounds: int = 3) -> Dict[str, Dict]:
    """The float32 layer of chip_smoke.py (N = 4096) with each
    BSR_F32_VARIANTS build, ``rounds`` times in turns (forward, then
    backward).  Every build gets the row pointers followed by the block
    rows longest first (ties by row); the block-row-order builds do not
    read the order."""
    libs = build_variants("bsr_spmm", BSR_F32_VARIANTS)
    rows_ptr, *rest = f32_layer()

    def with_order():
        order = torch.argsort(rows_ptr.diff(), descending=True, stable=True)
        return torch.cat([rows_ptr, order.to(torch.int32)])
    ptr = with_order()
    # what a wrapper would pay per call to build the order on the device
    order_ms = time_ms(with_order, 50)
    print(f"bsr_spmm f32 longest-first order, built per call: "
          f"{order_ms:.4f} ms", flush=True)
    out = rest[3]
    first = {}

    def same_result(label):
        first.setdefault("out", out.clone())
        if not torch.equal(out, first["out"]):
            raise RuntimeError(f"bsr_spmm f32 {label} differs")
    result = in_turns({label: f32_launcher(lib, ptr, *rest)
                       for label, lib in libs.items()}, rounds,
                      "bsr_spmm f32 (438 blocks)", same_result)
    result["order_ms"] = order_ms
    result["clocks"] = clocks_while(
        f32_launcher(libs[next(iter(libs))], ptr, *rest), 2000)
    return result


def clocks_while(launch: Callable[[], None], reps: int) -> Dict:
    """The SM clock, its maximum and the power draw (``nvidia-smi`` every
    200 ms) while ``launch`` runs reps times back to back: whether the
    card holds its clock under this load."""
    launch()
    torch.cuda.synchronize()
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "200"],
        stdout=subprocess.PIPE, text=True)
    try:
        time.sleep(0.5)
        t0 = time.perf_counter()
        for _ in range(reps):
            launch()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        smi.terminate()
    samples = [[float(x) for x in line.split(",")]
               for line in smi.communicate()[0].split("\n") if line.strip()]
    # the samples of the busy second half
    busy = samples[len(samples) // 2:-1] or samples
    out = dict(seconds=secs, sm_mhz=[s[0] for s in busy],
               max_sm_mhz=busy[0][1], watts=[s[2] for s in busy])
    print(f"clocks over {reps} launches ({secs:.2f} s): SM "
          f"{min(out['sm_mhz']):.0f}-{max(out['sm_mhz']):.0f} MHz of "
          f"{out['max_sm_mhz']:.0f}, {min(out['watts']):.1f}-"
          f"{max(out['watts']):.1f} W", flush=True)
    return out


def ablate_baseline(root: Path, rounds: int = 4) -> Dict[str, Dict]:
    """The float32 bsr_spmm layer and binning_histogram at delaunay_n24's
    row count, built from the checkout at ``root`` and from this one,
    timed in turns (root's first), each output held to this build's."""
    from repro_torch.core import symbolic_ladder
    csrc = root / "src" / "repro_torch" / "kernels" / "csrc"
    base = {"bsr_spmm": build_variants("bsr_spmm", {"x": lambda s: s},
                                       csrc)["x"],
            "binning_histogram": build_variants(
                "binning_histogram", {"x": lambda s: s}, csrc)["x"]}
    libs = {"baseline": base, "this tree": {
        name: build.library(name) for name in base}}
    layer = f32_layer()
    out = layer[4]
    want = {}

    def check(kind, label):
        got = (out if kind == "bsr" else hist).clone()
        if kind not in want:
            want[kind] = got
        elif not (torch.equal(got, want[kind]) if kind == "hist" else
                  torch.allclose(got, want[kind], rtol=1e-4, atol=1e-3)):
            raise RuntimeError(f"{kind} of the {label} build differs")
    result = {"bsr_spmm_f32": in_turns(
        {label: f32_launcher(lib["bsr_spmm"], *layer)
         for label, lib in libs.items()}, rounds,
        "bsr_spmm f32 (438 blocks)", lambda label: check("bsr", label))}
    del layer, out
    torch.cuda.empty_cache()

    rng = np.random.default_rng(zlib.crc32(b"delaunay_n24"))
    sizes = torch.from_numpy(rng.poisson(36.0, 16777216).astype(np.int32)
                             ).cuda()
    lad = symbolic_ladder()
    bounds = (ctypes.c_int * len(lad.upper))(*lad.upper)
    stream = torch.cuda.current_stream().cuda_stream
    hist = torch.zeros(lad.num_bins + 1, dtype=torch.int32, device="cuda")

    def hist_launcher(lib, m, caller_zeroes):
        # The baseline's entry point may leave the zeroing to its caller
        # (this tree's zeroes its outputs itself): time the same work.
        def launch():
            if caller_zeroes:
                hist.zero_()
            build.check(lib.binning_histogram(
                sizes.data_ptr(), m, 1024, bounds, len(lad.upper),
                lad.num_bins, hist.data_ptr(),
                hist[lad.num_bins:].data_ptr(), stream), "binning_histogram")
        return launch
    # delaunay_n24's rows, then mono_500Hz's row count (launch-bound)
    for m in (sizes.shape[0], MATRICES["mono_500Hz"][0]):
        want.pop("hist", None)
        result[f"binning_histogram {m} rows"] = in_turns(
            {label: hist_launcher(lib["binning_histogram"], m,
                                  label == "baseline")
             for label, lib in libs.items()}, rounds,
            f"binning_histogram ({m} rows, with its zeroing)",
            lambda label: check("hist", label))
    return result


def extended_outputs(kind: str, route: str, rung, device,
                     dtype: torch.dtype = torch.float32):
    """(nnz, accesses, col_tabs, val_tabs) of one rung's launch (values of
    ``dtype``), None where the route writes no such output."""
    n, t = rung.rows_cap, rung.t_size
    with_values = kind != "symbolic_bin"
    nnz = (torch.empty(n, dtype=torch.int32, device=device)
           if kind != "numeric_bin" else None)
    acc = torch.empty(n, dtype=torch.int32, device=device)
    cols = (torch.empty((n, t), dtype=torch.int32, device=device)
            if with_values or route == "global" else None)
    vals = (torch.empty((n, t), dtype=dtype, device=device)
            if with_values else None)
    return nnz, acc, cols, vals


def extended_launcher(lib, kind: str, route: str, A, rung, outs, *,
                      cluster: Optional[int] = None,
                      ordered: bool = False) -> Callable[[], None]:
    """A launch of one extended rung of A·A through ``lib``'s C entry point
    for ``route`` (``hash_bin_cluster`` at ``cluster`` blocks a row, or
    ``hash_bin_global``; their ``_ordered`` instances with ``ordered``)
    into ``outs`` (:func:`extended_outputs`), in the wrapper's geometry
    (one row a cluster or a block of its launch_geometry threads), single
    access, in A's value type."""
    from . import spgemm_hash as sh
    nnz, acc, cols, vals = outs
    with_values = kind != "symbolic_bin"
    value_type = sh.VALUE_TYPES[A.val.dtype] if with_values else ""
    threads = sh.launch_geometry(rung.t_size, 1)[1]
    stream = torch.cuda.current_stream().cuda_stream

    def ptr(x):
        return None if x is None else x.data_ptr()
    inputs = (rung.rows.data_ptr(), rung.count.data_ptr(), A.rpt.data_ptr(),
              A.col.data_ptr(), ptr(A.val if with_values else None),
              A.rpt.data_ptr(), A.col.data_ptr(),
              ptr(A.val if with_values else None), rung.t_size,
              rung.rows_cap)

    suffix = ("_ordered" if ordered else "") + value_type

    def launch():
        if route == "cluster":
            err = getattr(lib, "hash_bin_cluster" + suffix)(
                int(with_values), 1, *inputs, cluster,
                threads, ptr(nnz), ptr(cols), ptr(vals), acc.data_ptr(),
                stream)
        else:
            err = getattr(lib, "hash_bin_global" + suffix)(
                1, *inputs, threads, ptr(nnz),
                cols.data_ptr(), ptr(vals), acc.data_ptr(), stream)
        build.check(err, f"{kind} {route} launch")
    return launch


def extended_cluster_rungs(A):
    """The cluster rungs of A·A's exact-mode cold call on the
    ``vmem_extended`` ladders, by kernel: symbolic_bin and fused_bin take
    the symbolic ladder's, numeric_bin the numeric ladder's."""
    from . import spgemm_hash as sh
    sym_rungs, num_rungs = cold_schedule(
        "mono_500Hz (vmem_extended)", A, vmem_extended=True)
    out = {}
    for kind, rungs in (("symbolic_bin", sym_rungs),
                        ("fused_bin", sym_rungs),
                        ("numeric_bin", num_rungs)):
        out[kind] = [r for r in rungs if sh.rung_route(
            r.t_size, 1, kind != "symbolic_bin") == "cluster"]
    return out


def ablate_cluster(A, rounds: int = 2) -> Dict[str, Dict]:
    """Each cluster rung of A·A on the vmem_extended ladders (part
    ``cluster``) at every cluster size from the smallest that holds its
    table to 8, on the ``CLUSTER_VARIANTS`` builds, in turns; with the
    clusters in flight at each size."""
    from . import spgemm_hash as sh
    libs = build_variants("spgemm_hash", CLUSTER_VARIANTS)
    limit = sh._smem_limit(A.device)
    result = {}
    for kind, rungs in extended_cluster_rungs(A).items():
        with_values = kind != "symbolic_bin"
        for r in rungs:
            least = sh.smallest_cluster(r.t_size, with_values, limit)
            sizes = [c for c in (2, 4, 8) if c >= least]
            labels = [v for v in CLUSTER_VARIANTS
                      if with_values or v != "no_dump"]
            outs = extended_outputs(kind, "cluster", r, A.device)
            launchers = {
                f"C={c} {v}": extended_launcher(
                    libs[v], kind, "cluster", A, r, outs, cluster=c)
                for c in sizes for v in labels}
            what = (f"{kind} cluster rung t={r.t_size} "
                    f"({int(r.count)}/{r.rows_cap} rows)")
            timed = in_turns(launchers, rounds, what, reps=3)
            in_flight = {}
            for c in sizes:
                out = torch.zeros(1, dtype=torch.int32)
                build.check(libs["base"].hash_cluster_occupancy(
                    int(with_values), 1, r.t_size, c,
                    sh.launch_geometry(r.t_size, 1)[1], out.data_ptr()),
                    "hash_cluster_occupancy")
                in_flight[c] = int(out[0])
            print(f"{what}: clusters in flight by C {in_flight}",
                  flush=True)
            result[f"{kind} t={r.t_size}"] = dict(
                rows=int(r.count), rows_cap=r.rows_cap, smallest=least,
                chosen=sh.cluster_size(r.t_size, with_values, limit),
                clusters_in_flight=in_flight, times=timed)
            del launchers, outs
            torch.cuda.empty_cache()
    return result


def ablate_global(A, rounds: int = 3) -> Dict[str, Dict]:
    """The fused_bin rung at t_size 65,536 on the cluster kernel and on the
    global-memory kernel, against the ESC fallback rung, on the default
    symbolic ladder's fallback rows of A·A (part ``global``)."""
    from repro_torch import SpgemmConfig
    from repro_torch.core import (bin_rows_for_ladder, esc, gather_rows,
                                  nprod_into_rpt)
    from repro_torch.engine import SpgemmEngine, plan_key
    from . import spgemm_hash as sh
    cfg = SpgemmConfig(method="hash")
    engine = SpgemmEngine(cfg)
    C = engine.execute(A, A).C
    plan = engine.cache.get(plan_key(A, A, cfg)).plan
    sched = plan.hash_schedule
    lad = plan.sym_ladder
    binning = bin_rows_for_ladder(nprod_into_rpt(A, A)[:A.nrows], lad)
    cap, fall_cap = sched.sym_row_buckets[-1], sched.fall_prod_bucket
    rows, count = binning.rows_of_bin(len(lad.table_sizes), cap)
    count = count.reshape(1)
    m, rpt, nnz_cap = A.nrows, C.rpt, int(C.rpt[-1])
    t_size = 65536
    assert sh.rung_route(t_size, 1, True) == "cluster"
    rung = sh.FusedRung(len(lad.table_sizes), t_size, cap, 1, rows, count)
    lib = build.library("spgemm_hash")
    global_kernel = extended_launcher(
        lib, "fused_bin", "global", A, rung,
        extended_outputs("fused_bin", "global", rung, A.device))
    out = {label: (torch.zeros(nnz_cap + 1, dtype=torch.int32,
                               device=A.device),
                   torch.zeros(nnz_cap + 1, dtype=torch.float32,
                               device=A.device))
           for label in ("cluster", "esc")}

    def cluster_kernel():
        return sh.fused_bin_call(rows, count, A.rpt, A.col, A.val, A.rpt,
                                 A.col, A.val, t_size=t_size, rows_cap=cap)

    def cluster_rung():     # as fused_scheduled runs a table rung
        nnz, col_tabs, val_tabs, _ = cluster_kernel()
        nnz_buf = torch.zeros(m + 2, dtype=torch.int32, device=A.device)
        valid = torch.arange(cap, device=A.device) < count
        sh._scatter_nnz(nnz_buf, rows, valid, nnz, m)
        sh.numeric_epilogue(col_tabs, val_tabs, rows, count, rpt,
                            *out["cluster"], nnz_capacity=nnz_cap)

    def esc_rung():      # as fused_scheduled runs its fallback rung
        f_rows, valid = sh._fallback_rows(binning, lad, cap, m)
        sub = gather_rows(A, f_rows, valid)
        sh._fallback_sub_prod(A, A, f_rows, valid)
        subC = esc.spgemm_fused(sub, A, prod_capacity=fall_cap,
                                nnz_capacity=fall_cap)
        nnz_buf = torch.zeros(m + 2, dtype=torch.int32, device=A.device)
        sh._scatter_nnz(nnz_buf, f_rows, valid, subC.nnz_per_row(), m)
        sh.scatter_sub_rows(subC, f_rows, valid, rpt, *out["esc"],
                            nnz_capacity=nnz_cap)

    cluster_rung()
    esc_rung()
    torch.cuda.synchronize()
    (gc, gv), (ec, ev) = (out[k] for k in ("cluster", "esc"))
    # (the last entry is the dump slot of both scatters)
    assert torch.equal(gc[:nnz_cap], ec[:nnz_cap]), "columns differ"
    assert torch.allclose(gv[:nnz_cap], ev[:nnz_cap], rtol=1e-5,
                          atol=1e-5), "values differ"
    n = int(count[0])
    print(f"global: {n} fallback rows in a bucket of {cap}, ESC product "
          f"bucket {fall_cap}; the cluster rung and ESC write equal rows",
          flush=True)
    del C
    torch.cuda.empty_cache()
    result = in_turns({"fused_bin cluster kernel (t=65536)": cluster_kernel,
                       "fused_bin global kernel (t=65536)": global_kernel,
                       "cluster kernel + numeric_epilogue": cluster_rung,
                       "ESC fallback rung": esc_rung}, rounds,
                      "fallback rows", reps=3,
                      after=lambda label: torch.cuda.empty_cache())
    result.update(rows=n, rows_cap=cap, fall_prod_bucket=fall_cap)
    return result


def smem_launcher(lib, kind: str, A, rung, outs, *,
                  ordered: bool = True) -> Callable[[], None]:
    """A launch of one shared-memory rung of A·A through ``lib``'s C entry
    point of ``kind`` (``fused_bin`` or ``numeric_bin``; their fixed-order
    instance with ``ordered``) in A's value type into ``outs``
    (:func:`extended_outputs`), in the wrapper's geometry, single
    access."""
    from . import spgemm_hash as sh
    nnz, acc, cols, vals = outs
    t, cap = rung.t_size, rung.rows_cap
    stream = torch.cuda.current_stream().cuda_stream
    inputs = (rung.rows.data_ptr(), rung.count.data_ptr(), A.rpt.data_ptr(),
              A.col.data_ptr(), A.val.data_ptr(), A.rpt.data_ptr(),
              A.col.data_ptr(), A.val.data_ptr(), t, cap)
    entry = getattr(lib, sh.entry_point(kind, A.val.dtype, ordered))

    def launch():
        if kind == "numeric_bin":
            err = entry(
                *inputs, *sh.numeric_launch_geometry(t), 1, *sh.hash_mod(t),
                cols.data_ptr(), vals.data_ptr(), acc.data_ptr(), stream)
        else:
            err = entry(
                *inputs, *sh.launch_geometry(t, rung.pack), 1,
                nnz.data_ptr(), cols.data_ptr(), vals.data_ptr(),
                acc.data_ptr(), stream)
        build.check(err, f"{kind} launch")
    return launch


def sass_listing(path: str) -> Dict[str, List[str]]:
    """Per kernel of a built library, its SASS instructions as
    ``cuobjdump -sass`` prints them, without their addresses."""
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([exe, "-sass", path], capture_output=True,
                          text=True, check=True).stdout
    out: Dict[str, List[str]] = {}
    kernel = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            kernel = build.kernel_name(m.group(1))
            out[kernel] = []
            continue
        m = re.search(r"/\*[0-9a-f]{4}\*/\s+([^;]*;)", line)
        if kernel and m:
            out[kernel].append(m.group(1).strip())
    return out


# The ORDERED template argument of each hash body, by its name and number
# of arguments (another checkout's hash_rows_kernel may still carry it, as
# the third of four; this tree's ORDERED instance is its own kernel).
_ORDERED_ARG = {("hash_rows_kernel", 4): 2, ("slot_rows_kernel", 3): 1,
                ("global_rows_kernel", 4): 2, ("cluster_rows_kernel", 4): 2}


def _atomic_instance(kernel: str) -> Optional[str]:
    """A kernel instance's name without its ORDERED argument (as this
    tree's ``hash_rows_kernel`` names it), or None for an ORDERED one."""
    name, _, args = kernel.partition("<")
    if "ordered" in name:
        return None
    parts = args.rstrip(">").split(",") if args else []
    at = _ORDERED_ARG.get((name, len(parts)))
    if at is not None:
        if parts[at] != "0":
            return None
        if name == "hash_rows_kernel":
            del parts[at]
    return f"{name}<{','.join(parts)}>" if parts else name


def atomic_sass_equal(this: str, other: str) -> Dict[str, bool]:
    """Whether each atomic kernel instance of the library at ``this`` has
    the same SASS as in the one at ``other`` (another checkout's build of
    csrc/spgemm_hash.cu)."""
    mine, theirs = ({_atomic_instance(k): v
                     for k, v in sass_listing(path).items()}
                    for path in (this, other))
    return {k: theirs.get(k) == v for k, v in mine.items()
            if k is not None}


def _same_tables(what: str, outs, want: Optional[Dict], n: int) -> Dict:
    """The valid rows' sorted tables (and nnz) of ``outs``; raises unless
    they equal ``want``'s bit for bit."""
    nnz, _, cols, vals = outs
    c, order = torch.sort(cols[:n], dim=1)
    v = vals[:n].gather(1, order)
    got = dict(cols=c, bits=v.view(torch.int16 if v.element_size() == 2
                                   else torch.int32),
               nnz=None if nnz is None else nnz[:n].clone())
    if want is not None and not all(
            (x is None and y is None) or torch.equal(x, y)
            for x, y in ((got[k], want[k]) for k in got)):
        raise RuntimeError(f"{what}: the baseline's tables differ from "
                           f"this tree's")
    return got


def ablate_ordered(A, baseline: Optional[Path] = None,
                   rounds: int = 2) -> Dict[str, Dict]:
    """Part ``ordered``: the fixed-order fused_bin and numeric_bin at every
    rung of A·A's exact-mode cold call on the default ladders (the
    shared-memory route) and at the vmem_extended ladders' rungs past
    shared memory (cluster, global), through their C entry points, on the
    ORDERED_VARIANTS builds and, with ``baseline``, that checkout's build,
    in turns; the baseline's valid rows held bit for bit to this tree's.
    Also the time torch takes to fill the wrappers' uninitialised outputs
    of the shared-memory rungs in the fixed-order mode (what the wrapper's
    time adds to the kernel's)."""
    from . import spgemm_hash as sh
    libs = build_variants("spgemm_hash", ORDERED_VARIANTS)
    if baseline is not None:
        libs["baseline"] = build_variants(
            "spgemm_hash", {"x": lambda src: src},
            baseline / "src" / "repro_torch" / "kernels" / "csrc")["x"]
    sass = None
    if baseline is not None:
        sass = atomic_sass_equal(libs["base"]._name, libs["baseline"]._name)
        print(f"atomic kernel instances with the baseline's SASS: "
              f"{sum(sass.values())} of {len(sass)}"
              + "".join(f"; differs: {k}" for k, v in sass.items() if not v),
              flush=True)
    sym, num = cold_schedule("mono_500Hz", A)
    ext_sym, ext_num = cold_schedule("mono_500Hz (vmem_extended)", A,
                                     vmem_extended=True)
    limit = sh._smem_limit(A.device)
    jobs = [("fused_bin", r, "smem") for r in sym] + [
        ("numeric_bin", r, "smem") for r in num]
    for kind, rungs in (("fused_bin", ext_sym), ("numeric_bin", ext_num)):
        for r in rungs:
            rpc = (sh.numeric_launch_geometry(r.t_size)[0]
                   if kind == "numeric_bin" else 1)
            route = sh.hash_route(r.t_size, rpc, True, limit)
            if route != "smem":
                jobs.append((kind, r, route))
    result = {}
    for kind, r, route in jobs:
        outs = extended_outputs(kind, "smem", r, A.device)
        launchers = {
            label: (smem_launcher(lib, kind, A, r, outs) if route == "smem"
                    else extended_launcher(
                        lib, kind, route, A, r, outs, ordered=True,
                        cluster=sh.cluster_size(r.t_size, True, limit)))
            for label, lib in libs.items()}
        n = int(r.count[0])
        want = None
        for label in ("base", "baseline"):
            if label in launchers:
                launchers[label]()
                want = _same_tables(f"{kind} t={r.t_size}", outs, want, n)
        del want
        what = f"fixed-order {kind} t={r.t_size} ({route}, rows {n}/" \
            f"{r.rows_cap})"
        result[f"{kind} {r.t_size}"] = dict(
            route=route, rows=n, rows_cap=r.rows_cap,
            ms=in_turns(launchers, rounds, what, reps=3))
        del outs, launchers
        torch.cuda.empty_cache()
    totals = {}
    for key, rung in result.items():
        group = f"{key.split()[0]} {rung['route']}"
        for label, t in rung["ms"].items():
            totals.setdefault(group, {}).setdefault(label, 0.0)
            totals[group][label] += t["ms"]
    for group, by_label in totals.items():
        print(f"fixed-order {group}: " + ", ".join(
            f"{label} {ms:.3f} ms" for label, ms in by_label.items()),
            flush=True)

    fill = {}
    was = torch.are_deterministic_algorithms_enabled()
    for kind, rungs in (("fused_bin", sym), ("numeric_bin", num)):
        def alloc():
            for r in rungs:
                sh.fused_outputs(r.rows_cap, r.t_size, A.device)
        fill[kind] = {}
        for mode in (True, False):
            torch.use_deterministic_algorithms(mode)
            fill[kind]["filled" if mode else "not filled"] = time_ms(alloc,
                                                                     3)
        print(f"{kind} outputs of the shared-memory rungs: "
              f"{fill[kind]['filled']:.3f} ms filled in the fixed-order "
              f"mode, {fill[kind]['not filled']:.3f} ms not", flush=True)
    torch.use_deterministic_algorithms(was)
    return dict(rungs=result, totals=totals, fill=fill, atomic_sass=sass)


# The kernel bodies of csrc/spgemm_hash.cu; each instance's last template
# argument is its value type (0 float32, 1 bfloat16, 2 float16).
HASH_BODIES = ("hash_rows_kernel", "hash_rows_kernel_ordered",
               "slot_rows_kernel", "global_rows_kernel", "cluster_rows_kernel")
DTYPES = (torch.float32, torch.bfloat16, torch.float16)
# The rows of a 32,768-entry fused rung: n_prod past the default ladder's
# top rung (20,480) up to the ladder's load, 5/6 of the table.
T32K = 32768
T32K_PRODUCTS = (20480, T32K * 5 // 6)


def value_type_arg(kernel: str) -> Optional[int]:
    """The value type of a hash kernel instance (its last template
    argument), None for any other kernel."""
    name, _, args = kernel.partition("<")
    if name not in HASH_BODIES or not args:
        return None
    return int(args.rstrip(">").split(",")[-1])


def _opcodes(listing: List[str]) -> Dict[str, int]:
    """How many instructions of each opcode a SASS listing holds (the
    predicate dropped)."""
    out: Dict[str, int] = {}
    for ins in listing:
        op = re.sub(r"^@!?U?P\w+\s+", "", ins).split()[0].rstrip(";")
        out[op] = out.get(op, 0) + 1
    return out


def _with_dtype(A, dtype):
    from repro_torch.core import CSR
    return CSR(A.rpt, A.col, A.val.to(dtype), A.shape)


def ablate_dtypes(A, baseline: Optional[Path] = None,
                  rounds: int = 2) -> Dict[str, Dict]:
    """Part ``dtypes``: fused_bin at mono_500Hz's steady-call rungs and
    numeric_bin at its cold-call rungs in bfloat16 and float16, on each
    DTYPE_VARIANTS build (with ``baseline``, that checkout's builds too),
    in turns, the float32 instances' base builds beside them; through the
    C entry points.  Before the timing, with ``baseline``, each rung's
    fixed-order tables (and fused nnz) of the two base builds are held bit
    for bit to each other, and each float32 instance's SASS to the
    baseline's.  Prints each 16-bit instance's registers, spill bytes and
    SASS opcodes, and, with ``baseline``, fused_bin at t_size 32,768 on
    the rows such a rung takes (each tree's 16-bit launch on its own
    route; the baseline's on shared memory, as trees of 6-byte 16-bit
    entries ran it)."""
    from repro_torch.core import nprod_into_rpt
    from . import spgemm_hash as sh
    trees = {"": build_variants("spgemm_hash", DTYPE_VARIANTS)}
    if baseline is not None:
        trees["baseline "] = build_variants(
            "spgemm_hash", DTYPE_VARIANTS,
            baseline / "src" / "repro_torch" / "kernels" / "csrc")
    libs = {prefix + label: lib for prefix, built in trees.items()
            for label, lib in built.items()}
    report: Dict[str, Dict] = dict(ptxas={}, sass={})
    listings = {prefix: sass_listing(built["base"]._name)
                for prefix, built in trees.items()}
    for prefix, built in trees.items():
        tree = prefix.strip() or "this tree"
        lines = [x for x in built["base"].ptxas
                 if value_type_arg(x.split(":")[0]) in (1, 2)]
        report["ptxas"][tree] = lines
        report["sass"][tree] = {}
        for line in lines:
            print(f"{tree} ptxas {line}", flush=True)
        for kernel, listing in listings[prefix].items():
            if value_type_arg(kernel) not in (1, 2):
                continue
            ops = {op: k for op, k in sorted(_opcodes(listing).items())
                   if op.startswith(("ATOM", "RED", "LDS", "STS", "LDG",
                                     "STG", "LDL", "STL"))}
            report["sass"][tree][kernel] = ops
            print(f"{tree} SASS {kernel}: {ops}", flush=True)
    if baseline is not None:
        mine, theirs = listings[""], listings["baseline "]
        same = {k: theirs.get(k) == v for k, v in mine.items()
                if value_type_arg(k) == 0}
        report["float32_sass_equal"] = same
        print(f"float32 instances with the baseline's SASS: "
              f"{sum(same.values())} of {len(same)}"
              + "".join(f"; differs: {k}" for k, v in same.items() if not v),
              flush=True)

    sym, num = cold_schedule("mono_500Hz", A)
    report["rungs"] = {}
    for dtype in DTYPES:
        At = _with_dtype(A, dtype)
        key = str(dtype).removeprefix("torch.")
        labels = [k for k in libs if dtype != torch.float32
                  or k.endswith("base")]
        for kind, rungs in (("fused_bin", sym), ("numeric_bin", num)):
            outs = {r.b: extended_outputs(kind, "smem", r, A.device, dtype)
                    for r in rungs}
            if baseline is not None:
                for r in rungs:
                    want = None
                    for label in ("base", "baseline base"):
                        smem_launcher(libs[label], kind, At, r,
                                      outs[r.b])()
                        want = _same_tables(
                            f"fixed-order {kind} {key} t={r.t_size}",
                            outs[r.b], want, int(r.count[0]))
                print(f"fixed-order {kind} {key}: the baseline's tables "
                      f"equal these bit for bit on {len(rungs)} rungs",
                      flush=True)
            launchers = {label: [smem_launcher(libs[label], kind, At, r,
                                               outs[r.b], ordered=False)
                                 for r in rungs] for label in labels}
            per_rung = {label: {r.b: time_ms(launch, 3)
                                for r, launch in zip(rungs, launchers[label])}
                        for label in labels if label.endswith("base")}
            for label, per in per_rung.items():
                print(f"{kind} {key} {label} by rung: " + ", ".join(
                    f"t={r.t_size} {per[r.b]:.3f}" for r in rungs),
                    flush=True)
            timed = in_turns(
                {label: (lambda ls=ls: [launch() for launch in ls])
                 for label, ls in launchers.items()}, rounds,
                f"{kind} {key} ({len(rungs)} rungs)", reps=3)
            report["rungs"][f"{kind} {key}"] = dict(per_rung=per_rung,
                                                    ms=timed)
            del outs, launchers
            torch.cuda.empty_cache()

    if baseline is not None:
        nprod = nprod_into_rpt(A, A)[:A.nrows]
        lo, hi = T32K_PRODUCTS
        rows = ((nprod > lo) & (nprod <= hi)).nonzero().flatten()
        n = int(rows.numel())
        cap = sh.next_bucket(n, minimum=8)
        padded = torch.zeros(cap, dtype=torch.int32, device=A.device)
        padded[:n] = rows.to(torch.int32)
        rung = sh.FusedRung(0, T32K, cap, 1, padded, torch.tensor(
            [n], dtype=torch.int32, device=A.device))
        limit = sh._smem_limit(A.device)
        route = sh.hash_route(T32K, 1, True, limit)
        cluster = sh.cluster_size(T32K, True, limit)
        report["t32768"] = dict(rows=n, rows_cap=cap, route=route,
                                cluster=cluster)
        for dtype in DTYPES:
            At = _with_dtype(A, dtype)
            outs = extended_outputs("fused_bin", "smem", rung, A.device,
                                    dtype)
            launchers = {f"this tree ({route}, C={cluster})": extended_launcher(
                libs["base"], "fused_bin", route, At, rung, outs,
                cluster=cluster)}
            if dtype != torch.float32:
                launchers["baseline (smem)"] = smem_launcher(
                    libs["baseline base"], "fused_bin", At, rung, outs,
                    ordered=False)
            key = str(dtype).removeprefix("torch.")
            report["t32768"][key] = in_turns(
                launchers, rounds, f"fused_bin {key} t={T32K} ({n} rows)",
                reps=3)
            del outs
            torch.cuda.empty_cache()
    return report


PARTS = ("cold", "fused", "two_pass", "pack", "bsr", "bsr_f32", "global",
         "cluster", "ordered", "dtypes", "baseline")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--report", type=Path, default=None)
    parser.add_argument("--parts", default=",".join(PARTS[:-1]),
                        help="comma-separated subset of " + ",".join(PARTS))
    parser.add_argument("--baseline", type=Path, default=None,
                        help="root of another checkout (parts baseline, "
                        "ordered, dtypes)")
    args = parser.parse_args()
    parts = set(args.parts.split(","))
    if not parts <= set(PARTS):
        parser.error(f"--parts takes a subset of {','.join(PARTS)}")
    if ("baseline" in parts) and args.baseline is None:
        parser.error("part baseline needs --baseline")
    if args.baseline is not None and not parts & {"baseline", "ordered",
                                                  "dtypes"}:
        parser.error("--baseline goes with part baseline, ordered or dtypes")
    if not torch.cuda.is_available():
        print("ablate: no CUDA device visible", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    build.build_all()
    sass = sass_memory_ops("spgemm_hash")
    for kernel, ops in sass.items():
        print(f"SASS {kernel}: {ops}", flush=True)
    report = dict(card=card, sass=sass)
    report_dir = (args.report.parent if args.report is not None
                  else ABLATE_DIR)
    report_dir.mkdir(parents=True, exist_ok=True)
    if parts & {"cold", "fused", "two_pass", "pack"}:
        variants = {"hash " + k: v for k, v in HASH_VARIANTS.items()}
        variants.update({"slot " + k: v for k, v in SLOT_VARIANTS.items()
                         if k != "base"})
        libs = build_variants("spgemm_hash", variants)
        libs["slot base"] = libs["hash base"]
        if parts & {"cold", "fused", "two_pass"}:
            A = table3_matrix("mono_500Hz")
            if "cold" in parts:
                report["cold"] = ablate_cold(libs, A, report_dir)
            if parts & {"fused", "two_pass"}:
                sym_rungs, num_rungs = cold_schedule("mono_500Hz", A)
                if "fused" in parts:
                    report["fused_bin"] = ablate_fused(libs, A, sym_rungs)
                if "two_pass" in parts:
                    report.update(ablate_two_pass(libs, A, sym_rungs,
                                                  num_rungs))
                del sym_rungs, num_rungs
            del A
            torch.cuda.empty_cache()
        if "pack" in parts:
            report["pack"] = ablate_pack(libs)
            torch.cuda.empty_cache()
    if "global" in parts:
        report["global"] = ablate_global(table3_matrix("mono_500Hz"))
        torch.cuda.empty_cache()
    if "cluster" in parts:
        report["cluster"] = ablate_cluster(table3_matrix("mono_500Hz"))
        torch.cuda.empty_cache()
    if "ordered" in parts:
        report["ordered"] = ablate_ordered(table3_matrix("mono_500Hz"),
                                           args.baseline)
        torch.cuda.empty_cache()
    if "dtypes" in parts:
        report["dtypes"] = ablate_dtypes(table3_matrix("mono_500Hz"),
                                         args.baseline)
        torch.cuda.empty_cache()
    if "bsr" in parts:
        report["bsr_spmm_bf16"] = ablate_bsr()
    if "bsr_f32" in parts:
        report["bsr_spmm_f32"] = ablate_bsr_f32()
    if "baseline" in parts:
        report["baseline"] = ablate_baseline(args.baseline)
    if args.report is not None:
        args.report.write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
