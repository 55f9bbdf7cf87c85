#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of OpSparse on one NVIDIA GPU and check it.

Run from the root of a checkout:  python3 chip_smoke.py [--report PATH]

Phases, in order; any failure exits non-zero:
  1. card and build: the card's name and power limit, then every kernel
     source in src/repro_torch/kernels/csrc built with nvcc (one process
     each, all started together) and each kernel's ptxas line
     (registers, shared memory, spills); the float32 bsr_spmm kernel,
     binning_histogram and cluster_rows_kernel must spill nothing, and
     cluster_rows_kernel's SASS must reach its tables through
     distributed-shared-memory atomics (no device-memory atomic).
  2. hash kernels against their plain PyTorch versions on the card, both
     probe disciplines, packed and unpacked, on a tiny ladder that
     populates every rung and the fallback rung, and on rows of the
     default ladders' top rungs.  nnz and accesses are compared on every
     row (0 on padding rows), tables on the rows below the bin's count
     only: the kernels leave padding rows' tables unwritten.
  3. the first slice: C = A·A through spgemm(method="hash") for the
     paper's Table-3 matrix mono_500Hz at its full row count (one cold
     call, then steady calls), with the launch counters read around it,
     the cold call's per-step times (its StepTimer), the steady dispatch
     checked for host syncs, a profile of one steady call, and C held
     against scipy; torch.sparse as the yardstick.
  4. each hash kernel at the shapes the main path gave it, rung by rung:
     its time (the wrapper's launch alone; the numeric kernel's nnz for
     the comparison comes from the valid rows' tables, outside the
     timing), its CTAs per SM, its plain version's time on the same
     inputs (and agreement), its bound;
     then the steady call's fused rungs as the main path launches them
     (one side stream each) against the sum of their times alone and
     against one stream, each rung's CTAs per SM, and rung 2's geometry
     with count = 0 against every row valid.
  4b. spgemm(method="hash", vmem_extended=True) on mono_500Hz (one cold
     call, then steady calls), whose rows past the default ladders take
     the extended rungs (symbolic and fused 65,536, numeric 32,768 and
     131,072), all on the cluster kernel (cluster_rows_kernel, each row's
     table in a thread-block cluster's distributed shared memory): the
     launch counters read around it (launches_cluster of the three
     wrappers; no global-memory kernel launch), no ESC call, no fallback
     rung and no hash_fallback range, C equal to the default slice's C,
     its cold and steady ms, peak memory and a profiled steady call split
     into the cluster rung, the default rungs and the epilogue; then each
     cluster rung of that path timed alone against its plain version and
     its bound, with its cluster size and clusters in flight; then the
     extended ladders' top rungs, which mono_500Hz leaves empty, on rows
     that the ladders at multiplier TOP_RUNG_MULTIPLIER route there
     (symbolic 262,144 on the cluster kernel; symbolic and fused
     1,048,576, fused 262,144 and numeric 524,288 on the global-memory
     kernel): both kernels against their plain versions on a few rows;
     then the top-rung path, spgemm at that multiplier through the
     engine on TOP_RUNG_ROWS mono rows from each symbolic top rung times
     A (cold and steady; the global kernel launched from each wrapper, no
     ESC, C equal to those rows of the default C), the counts set to 0
     just before it, and each global rung of it timed alone at its
     buckets with its bound; then the default method, ESC (SpgemmConfig()), through an engine on
     the scircuit analog against scipy, cold and steady.
  5. binning_histogram through its own entry point on mono_500Hz's n_prod
     (symbolic ladder) and C's nnz per row (numeric ladder), equal to its
     plain version and to the slice's Binning objects; then timed at the
     row count of delaunay_n24 (16,777,216 rows) against
     torch.bincount(torch.bucketize(...)), with the kernel's time alone
     (its C entry point) and the wrapper's host cost per call beside the
     wrapper's time.
  6. bsr_spmm: the bfloat16 and float16 kernels' SASS must hold
     tensor-core MMA instructions and the float32 kernel's 16-byte shared
     loads (LDS.128, cuobjdump -sass); each kernel's CTAs per SM; edge
     cases against the plain version (empty block row, padding blocks,
     bm != bk, N not a multiple of the tile, several blocks per block
     row) in float32, bfloat16 and float16, then one block-sparse weight
     layer (M = K = 8192 in 128 x 128 blocks, 10 % stored, N = 4096) in
     the three types, timed against
     torch.sparse_bsr_tensor(...) @ dense; then blocks of 96 x 40 with N
     = 37 and block rows of 1 to 13 blocks.
  7. the request path: a fresh SpgemmEngine(telemetry=True) with
     plan_mode="estimate" takes mono_500Hz A·A twice and the scircuit
     analog A·A twice through submit and drain(window=2); each C is
     checked, the estimated cold calls must run the fused kernel and not
     the symbolic one, a steady dispatch must not sync the host, a
     prewarmed third signature (patents_main) must serve its first
     request hot, and a dumped plan cache loaded into a new engine must
     make that engine's first call hot; the engine's report, the drain's
     wall time and peak memory are printed.
  7b. the governed request path (workspace arena, memory governor, fault
     injection), with its own launch counts: bin_rows_into on
     mono_500Hz's n_prod (pass 1 on binning_histogram) equal to bin_rows;
     SpgemmEngine(SpgemmConfig(method="hash"), arena=Arena()) on
     mono_500Hz, one cold and STEADY_CALLS steady calls, each leasing the
     fallback expansion's storage from the arena (2 misses, then hits
     only; reserved bytes = the plan's lease; 0 B in use after each
     finalize; no host sync in a dispatch; C equal to the slice's), the
     steady pipeline with and without its lease in turns (time, peak);
     MemoryGovernor(cap_bytes=0): pressure, one forced trim of
     fall_prod_bucket, a spill to the two-pass steps path (symbolic_bin
     and numeric_bin launched, fused_bin not), then the trimmed plan's
     steady calls unbounded; a drain (window 2, then ordered) of 3 x
     mono_500Hz + 2 x scircuit under a one-lease cap with trim and spill
     off (arena peak <= cap, pressure met, every C checked); injected
     faults on scircuit (lease_denial in a drain, verify_overflow,
     executor_raise): ESC recovers bitwise, hash within tolerance.
  7c. row-block sharding, with its own launch counts, after the earlier
     phases' engines and leases are dropped: SpgemmEngine(SpgemmConfig(
     method="hash"), shards=N) on mono_500Hz for N = 2 and 4, one cold
     and STEADY_CALLS steady calls each, every C equal to the slice's (on
     the card: rpt/col exact, values within tolerance); the spec's
     bounds, each shard's share of row_flops (the largest at most total/N
     plus the largest row), the distinct sub-plans, each sub-plan's
     fall_prod_bucket and their sum beside the unsharded one, cold and
     steady ms, the shard_merge span and the merge timed alone on the
     card (CUDA events), each steady request's latency as the request
     histogram observes it (once the event after its merge has completed)
     between its time at return and its synchronized wall time, peak
     memory, launches per steady call; at N = 4
     one steady dispatch under torch's sync debug mode "error" (no host
     sync) and one profiled steady call; a drain (window 2) of 2 x
     mono_500Hz + 2 x scircuit on a shards=2 engine (4 sharded requests,
     0 shard grows, 4 request latencies, every C checked), its Chrome
     trace validated and its Prometheus text parsed line by line (the
     sharding counters and the arena gauges present); AUTO_SHARDS with
     the default policy (1 shard on one card, no fan-out) and with
     AdaptivePolicy(max_shards=4) (its decision and flop basis, C equal).
  7d. the multi-tenant service (repro_torch.serve.SpgemmService), with
     its own launch counts, after the earlier engines are dropped: a
     stream of 16 A_s·A_s products on the scircuit analogs of seeds
     crc32("scircuit") + s (one capacity bucket) over tenants alpha and
     beta, for SpgemmConfig(method="hash") and SpgemmConfig() (ESC), each
     request timed with a synchronize inside the clock: (1) clean, then
     under a seeded FaultPlan (lease denials at visits 5 and 6 and with p
     = 0.25, verify overflows with p = 0.15): no failed request, C equal
     to the clean run's (ESC bitwise; hash rpt/col exact, values within
     tolerance, the values not bitwise equal counted), chaos p99 <= max(5
     x clean p99, 0.5 s), faults injected; (6) /metrics and /healthz
     scraped over loopback, every per-tenant opsparse_service_* series
     and opsparse_engine_faults_injected_total present; (2) a poisoned
     request -> error with 0 retries, a 0.3 s stall under a 0.05 s
     deadline -> timeout with no value; (4) two tenant threads running the
     stream at once: every C equal to the single-thread one, 0 arena bytes
     in use, no exception.  Then on mono_500Hz: (3) a hash shards=2 tenant
     whose lease denials walk reclaim, shed_shards and spill_two_pass (the
     governor's own trim and spill off), C equal to the slice's; (5) a
     tenant calibrated on scircuit refuses mono_500Hz under a 0.1 s
     deadline before dispatching, then serves it (predicted beside
     measured latency); (7) a steady scircuit call through svc.call
     against engine.execute, medians of 20 in turns.  The hash stream of
     (1) again in the fixed-order mode (torch.use_deterministic_algorithms
     (True)): each chaos C bitwise equal to its clean twin.
  7e. the reference's engine gates (benchmarks/torch/bench_engine.py, the
     configurations of ENGINE_GATES) in process at 24 requests of 256 x
     256 x 256, 4 a row: every correctness gate must hold (the bitwise
     gates on hash in the fixed-order mode), every timing gate is printed
     with its threshold, PASS or MISS; output in
     chiprun_out/engine_gates.log.  Then the fixed-order kernels:
     fused_bin and numeric_bin (symbolic_bin too) on the tiny ladders and
     on 8 rows of every extended table size, tables bitwise equal to the
     plain versions' on the shared-memory, cluster and global routes; at
     the main path's rungs on mono_500Hz, each rung's time and
     FIXED_ORDER_ROWS rows bitwise; and spgemm(method="hash") on
     mono_500Hz in the mode (counts set to 0 just before): the cold call
     and two steady calls bitwise equal, steady ms with and without
     torch's fill of uninitialised memory beside the atomic kernels'.
  7f. 16-bit values (phase_dtypes): fused_bin and numeric_bin in bfloat16
     and float16 on every route (DTYPE_CASES: shared memory, cluster,
     global memory), both disciplines, against their plain versions on
     the card: fixed order bitwise, atomic within 3 n (u S + e); then
     scircuit and mono_500Hz A·A through spgemm(method="hash") in both
     types on a fresh engine (one cold and STEADY_CALLS steady calls, the
     counts set to 0 just before; C's pattern equal to torch.sparse's
     float32 product of the same 16-bit inputs, values within
     2 n (u S + e); times and peak GiB), each 16-bit kernel at scircuit's
     main shapes (time, plain version, bound), and the fused rungs of
     mono's steady call timed alone in each type.  bsr_spmm's float16
     layer runs in phase 6 beside the other two types.
  7g. the paper's figure benches (phase_figures): benchmarks.torch.run
     --reference-cut (all six benches, rows printed); Fig. 9's and Figs.
     10/11's per-case functions on the scircuit and mono_500Hz analogs,
     the CUDA kernels held to the figure's invariants (single access
     below check-then-CAS on each kernel, at least one access a product
     on every row of a launched bin, fused below symbolic + numeric);
     both examples in
     examples/torch on the card.
  7h. one olmoe-1b-7b MoE layer at its published width (phase_moe): 2,048
     tokens in one group at capacity factor 8, float32 (binning equal to
     dense, rtol 2e-2 / atol 2e-3) and bfloat16 (both, and the int8
     payload, against the exact expert mix in norm), each form timed.
  7i. the LM serving path (phase_lm; no TPU kernel behind it, so no
     kernel line): the ten architectures reduced, in float32 with TF32
     off, prefill and decode logits on the card equal to the port's CPU
     path (rtol 1e-3 / atol 1e-4; the encoder's prefill only); one
     olmoe-1b-7b block at full width over LM_BLOCK_TOKENS tokens, card
     against CPU alike; then olmoe-1b-7b at full width in bfloat16
     (Model.init on the card from a seeded torch.Generator) served by
     ServingEngine(max_batch=4, max_len=512): LM_REQUESTS requests of
     32-256 prompt tokens (numpy default_rng(0)), LM_NEW_TOKENS new
     tokens each, and one prompt of 600 tokens rejected structurally;
     request 0's tokens equal to a sequential greedy decode through
     prefill and decode_step (in slot 0 of a max_batch cache: the
     engine's shapes); at capacity factor 8 (= E / k) prefill(s) +
     decode(1) against prefill(s+1) within 2e-2 in norm; decode_step
     under torch.cuda.set_sync_debug_mode("error"); weights GiB, peak
     GiB above what earlier phases still hold, prefill ms, the median
     decode step with 4 active slots, tokens/s; the same serving again in
     this process and twice in a fresh one (lm_fresh), alternating, each
     giving the same tokens, each beside a fixed pure-Python loop's ms;
     then the same requests on quantize_params' int8 tree (bytes below
     0.6 x bfloat16's, finite logits, peak GiB, decode step ms, the
     correlation of request 0's prefill logits with bfloat16's, printed
     and not gated).
  8. output: a "kernels" JSON line (all five kernels; the cluster kernel
     once for each of the three hash wrappers, named <kernel>_cluster,
     its launches those of the extended phase; the global kernel once for
     each, <kernel>_global, its launches those of the top-rung path; the
     three hash wrappers' service_launches those of the service phase;
     fused_bin and numeric_bin carry their fixed-order variant as
     "fixed_order", its launches those of the fixed-order mono run;
     segment_sum, scatter_kept and count_into, their launches those of
     the slice phase, their times at the largest shape a steady mono
     call gives them; fused_bin and numeric_bin in bfloat16 and float16
     as <kernel>_bf16 / _f16, their launches those of scircuit's 16-bit
     product and their times at its main shapes; bsr_spmm (float32,
     with its bfloat16 layer) and bsr_spmm_f16, each its own type's
     launches in the layer's run, counted by C entry point),
     the card line, and the result line.

Needs one card.  Exits 2 without printing a result when no card is visible
or when the port's sources are not beside this script.  ``--report PATH``
also writes every measured number (per rung, per phase) as JSON.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import statistics
import subprocess
import sys
import time
import warnings
import zlib
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12            # CUDA cores
BF16_FLOPS = 989e12           # tensor cores
CSRC = "src/repro_torch/kernels/csrc/"
HASH_KERNELS = ("symbolic_bin", "numeric_bin", "fused_bin")
# The kernels of the vmem_extended rungs, one entry each for the three
# wrappers that launch them: the cluster kernel (their launches_cluster
# counts) and the global-memory kernel (launches_global).
CLUSTER_KERNELS = tuple(k + "_cluster" for k in HASH_KERNELS)
GLOBAL_KERNELS = tuple(k + "_global" for k in HASH_KERNELS)
# The value-building kernels in 16-bit values (phase_dtypes), named by
# their C entry points' suffix (spgemm_hash.VALUE_TYPES).
VALUE_KERNELS = tuple(k + sfx for sfx in ("_bf16", "_f16")
                      for k in ("fused_bin", "numeric_bin"))
ROUTE_SUFFIX = {"smem": "", "cluster": "_cluster", "global": "_global"}
SOURCES = {
    "symbolic_bin": CSRC + "spgemm_hash.cu",
    "numeric_bin": CSRC + "spgemm_hash.cu",
    "fused_bin": CSRC + "spgemm_hash.cu",
    "binning_histogram": CSRC + "binning_histogram.cu",
    "bsr_spmm": CSRC + "bsr_spmm.cu",
    **{k: CSRC + "spgemm_hash.cu" for k in CLUSTER_KERNELS + GLOBAL_KERNELS},
    **{k: CSRC + "spgemm_hash.cu" for k in VALUE_KERNELS},
    "bsr_spmm_f16": CSRC + "bsr_spmm.cu",
    "segment_sum": CSRC + "segment_sum.cu",
    "scatter_kept": CSRC + "scatter.cu",
    "count_into": CSRC + "scatter.cu",
}
# The kernels of the port's torch-op code (the ESC's in-order sum, the
# dump-slot writes); the reference's are jnp, with no Pallas kernel.
SCATTER_KERNELS = ("segment_sum", "scatter_kept", "count_into")
_HASH_TPU = {"symbolic_bin": "src/repro/kernels/spgemm_hash.py:191",
             "numeric_bin": "src/repro/kernels/spgemm_hash.py:309",
             "fused_bin": "src/repro/kernels/spgemm_hash.py:462"}
REPLACES = {
    **_HASH_TPU,
    "binning_histogram": "src/repro/kernels/binning_pallas.py:61",
    "bsr_spmm": "src/repro/kernels/bsr_spmm.py:32",
    **{k + "_cluster": v for k, v in _HASH_TPU.items()},
    **{k + "_global": v for k, v in _HASH_TPU.items()},
    # The 16-bit value types (phase_dtypes).
    **{k: _HASH_TPU[k.rsplit("_", 1)[0]] for k in VALUE_KERNELS},
    "bsr_spmm_f16": "src/repro/kernels/bsr_spmm.py:32",
    # The ESC accumulator's in-order sum and the dump-slot writes; the
    # reference's are jnp scatters (the lines named), with no Pallas
    # kernel behind them.
    "segment_sum": "src/repro/core/esc.py:151",
    "scatter_kept": "src/repro/kernels/spgemm_hash.py:534",
    "count_into": "src/repro/core/esc.py:95",
}
# Multiplier of the extended ladders that routes mono_500Hz rows to their
# top rungs (symbolic 262,144 / 1,048,576 by n_prod 94-374 / 375-1,497,
# numeric 524,288 by nnz 188-748), which the product's own ladders leave
# empty; the rows checked there stay short for the plain version's loop.
TOP_RUNG_MULTIPLIER = 700.0
# Rows taken from each of the two symbolic top rungs for the top-rung path:
# more than the 264 blocks the global-memory kernel keeps resident, and a
# 1,024-row bucket (with the engine's headroom) whose fused 1,048,576 rung
# writes 8 GiB of tables, twice that with the plain version beside it.
TOP_RUNG_ROWS = 512
TOP_STEADY_CALLS = 2
# Paper Table 3 (benchmarks/matrices.py): rows, nnz/row, max nnz/row,
# row-size shape.  Each analog is seeded with zlib.crc32 of its name.
MONO = dict(name="mono_500Hz", rows=169410, avg=29.7, max=719,
            dist="powerlaw")
SCIRCUIT = dict(name="scircuit", rows=170998, avg=5.6, max=353,
                dist="powerlaw")
PATENTS = dict(name="patents_main", rows=240547, avg=2.3, max=206,
               dist="powerlaw")
DELAUNAY_ROWS = 16777216      # delaunay_n24, the largest Table-3 matrix
DELAUNAY_AVG = 6.0
VAL_RTOL = VAL_ATOL = 1e-5    # kernel vs plain: few products per entry
# bsr_spmm at 8192 x 8192 x 4096: each output sums ~820 float32 products
# of magnitude ~1 in another order than cuBLAS does (partial sums ~30,
# rounding ~2e-6 per add); bfloat16 and float16 outputs may round to
# either side of one step (2^-7, 2^-10 relative).
BSR_TOL = {"float32": dict(rtol=1e-4, atol=1e-3),
           "bfloat16": dict(rtol=2 ** -7, atol=1e-2),
           "float16": dict(rtol=2 ** -10, atol=1e-2)}
STEADY_CALLS = 5
# The hash kernels' and bsr_spmm's 16-bit value types: the unit roundoff
# u that bounds their rounding (a product or sum rounded to the type lands
# within u of it, relatively).
UNIT_ROUNDOFF = {torch.bfloat16: 2.0 ** -8, torch.float16: 2.0 ** -11}
# The spacing of each 16-bit type's subnormals: a rounding lands within u
# of its value or within half this of it, whichever is more (float16's
# products of two values below ~8e-3 are subnormal).
SUBNORMAL_STEP = {torch.bfloat16: 2.0 ** -133, torch.float16: 2.0 ** -24}
# phase_dtypes' kernel cases, one per route of each 16-bit kernel:
# (kind, t_size, pack, valid rows): the shared-memory rungs (packed and
# not; numeric's mod-hashed sizes), fused 32,768 (shared memory in 16-bit
# values, a cluster in float32), and the cluster and global-memory rungs of
# the extended ladders.
DTYPE_CASES = (("fused_bin", 256, 1, 96), ("fused_bin", 256, 4, 96),
               ("fused_bin", 32768, 1, 8), ("fused_bin", 65536, 1, 8),
               ("fused_bin", 262144, 1, 8), ("numeric_bin", 255, 1, 96),
               ("numeric_bin", 1023, 1, 96), ("numeric_bin", 32768, 1, 8),
               ("numeric_bin", 131072, 1, 8), ("numeric_bin", 524288, 1, 8))
# phase_moe: one olmoe-1b-7b MoE layer at its published width, one group
# of MOE_TOKENS tokens, capacity factor E / k = 8 (no assignment dropped).
MOE_TOKENS = 2048
# phase_lm: olmoe-1b-7b served at full width (ServingEngine's slots and
# cache length, the request stream, one block's tokens for the float32
# card-against-CPU check and its tolerance).
LM_MAX_BATCH = 4
LM_MAX_LEN = 512
LM_REQUESTS = 8
LM_NEW_TOKENS = 16
LM_OVERSIZED = 600
LM_BLOCK_TOKENS = 64
LM_TOL = dict(rtol=1e-3, atol=1e-4)
LM_RATE_KEYS = ("tokens_per_s", "decode_ms_median", "prefill_ms", "peak_gib",
                "host_loop_ms")
# Kernels whose ptxas report must show no spill (source, kernel).
NO_SPILLS = (("bsr_spmm", "bsr_spmm_f32_kernel"),
             ("binning_histogram", "binning_histogram_kernel"),
             ("spgemm_hash", "cluster_rows_kernel"))


class SmokeError(Exception):
    pass


def require(cond, msg):
    if not cond:
        raise SmokeError(msg)


def fixed_order():
    """torch.use_deterministic_algorithms(True) inside (the hash wrappers'
    fixed-order kernels), the mode it found after: the bench's own."""
    from benchmarks.torch.bench_engine import fixed_order as mode
    return mode(True)


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
    t0 = time.perf_counter()
    try:
        report = run()
    except SmokeError as exc:
        print(f"chip_smoke: FAIL: {exc}", file=sys.stderr)
        return 1
    report["seconds"] = time.perf_counter() - t0
    log(f"chip_smoke: every phase passed in {report['seconds']:.0f} s")
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


def bin_call(sh, kind, plain, A, B, rows, count, t_size, rows_cap, *,
             pack=1, single_access=True):
    """One bin through the kernel wrapper (plain=False) or its plain
    version, outputs as the function returns them: what a kernel's time
    covers."""
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
    return fn(*args, **kw)


def run_bin(sh, kind, plain, A, B, rows, count, t_size, rows_cap, *,
            pack=1, single_access=True):
    """:func:`bin_call` -> dict(nnz, cols, vals, acc) with tables where the
    kernel has them.  The numeric kernel's nnz is derived here from the
    tables of the valid rows (0 on padding rows), outside any timing."""
    out = bin_call(sh, kind, plain, A, B, rows, count, t_size, rows_cap,
                   pack=pack, single_access=single_access)
    if kind == "symbolic_bin":
        return dict(nnz=out[0], cols=None, vals=None, acc=out[1])
    if kind == "numeric_bin":
        cols, vals, acc = out
        valid = torch.arange(rows_cap, device=cols.device) < count
        nnz = torch.zeros(rows_cap, dtype=torch.int32, device=cols.device)
        nnz[valid] = (cols[valid] >= 0).sum(1).to(torch.int32)
        return dict(nnz=nnz, cols=cols, vals=vals, acc=acc)
    return dict(nnz=out[0], cols=out[1], vals=out[2], acc=out[3])


def compare(what, k, p, nprod_rows, valid, *, bitwise=False, bound=None):
    """Kernel result k against plain result p; returns max |val err|.
    nnz and accesses on every row, tables on the valid rows only (the
    kernels leave the padding rows' tables unwritten); ``bitwise`` holds
    the values to the plain version's bits (the fixed-order kernels);
    ``bound`` (the valid rows' entries sorted by column, as
    :func:`order_bound` gives them) replaces VAL_ATOL + VAL_RTOL*|v|."""
    require(torch.equal(k["nnz"], p["nnz"]), f"{what}: nnz differs")
    err = 0.0
    if k["cols"] is not None:
        kc, ko = torch.sort(k["cols"][valid], dim=1)
        pc, po = torch.sort(p["cols"][valid], dim=1)
        require(torch.equal(kc, pc), f"{what}: sorted columns differ")
        kv = k["vals"][valid].gather(1, ko)
        pv = p["vals"][valid].gather(1, po)
        used = pc >= 0
        diff = (kv.float() - pv.float()).abs().masked_fill(~used, 0)
        err = float(diff.max()) if diff.numel() else 0.0
        if bitwise:
            bits = torch.int16 if kv.element_size() == 2 else torch.int32
            same = kv.view(bits) == pv.view(bits)
            require(bool((same | ~used).all()),
                    f"{what}: {int((~same & used).sum())} values not "
                    f"bitwise equal (up to {err:.3e} apart)")
        bad = diff > (VAL_ATOL + VAL_RTOL * pv.float().abs()
                      if bound is None else bound)
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
               limit=None, packs=(False, True), label="", by_route=False,
               bitwise=False):
    """Every populated table rung: each kernel kind, both disciplines,
    packed and unpacked (where the kernel packs), against the plain
    version.  Returns {kind: max val err}, or with ``by_route`` {kind +
    the suffix of the rung's route (ROUTE_SUFFIX): max val err}."""
    from repro_torch.core import nprod_into_rpt
    nprod = nprod_into_rpt(A, B)
    errs = {}
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
                    key = (kind + ROUTE_SUFFIX[route_of(sh, kind, t_size)]
                           if by_route else kind)
                    errs[key] = max(errs.get(key, 0.0), compare(
                        what, k, plain, nprod_rows, valid, bitwise=bitwise))
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

def phase_tiny(sh, errs, *, bitwise=False):
    """Tiny ladders force every rung plus the fallback rung.  ``bitwise``
    holds each kernel's tables to the plain version's bits (the fixed-order
    kernels, under torch.use_deterministic_algorithms(True))."""
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
    label = "tiny fixed-order " if bitwise else "tiny "
    e = check_bins(sh, A, B, bn, sym, ("symbolic_bin", "fused_bin"),
                   buckets=sym_buckets, label=label, bitwise=bitwise)
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
                   buckets=num_buckets, label=label, bitwise=bitwise)
    errs["numeric_bin"] = max(errs["numeric_bin"],
                              e.get("numeric_bin", 0.0))

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
    log(f"phase {label}ladders: every rung + fallback, both disciplines, "
        f"packed and unpacked, kernels' values "
        + ("bitwise equal to the plain versions'" if bitwise else
           f"within {VAL_ATOL} + {VAL_RTOL}*|v|")
        + "; the scheduled paths within tolerance: ok")
    return A, B


def table3_matrix(spec):
    """The analog of a Table-3 matrix at its full row count, on the card."""
    from repro_torch.core import random_csr
    t0 = time.perf_counter()
    M = random_csr(zlib.crc32(spec["name"].encode()), spec["rows"],
                   spec["rows"], avg_nnz_per_row=spec["avg"],
                   max_nnz_per_row=spec["max"], distribution=spec["dist"],
                   device="cuda")
    log(f"{spec['name']} analog: {M.nrows} rows, nnz {int(M.nnz())}, "
        f"built in {time.perf_counter() - t0:.1f} s")
    return M


def kernel_wrappers():
    """Every kernel wrapper of the port, by kernel name."""
    from repro_torch.kernels import spgemm_hash as sh
    from repro_torch.kernels.binning_histogram import binning_histogram
    from repro_torch.kernels.bsr_spmm import bsr_spmm
    from repro_torch.kernels.scatter import count_into, scatter_kept
    from repro_torch.kernels.segment_sum import segment_sum
    return {"symbolic_bin": sh.symbolic_bin_call,
            "numeric_bin": sh.numeric_bin_call,
            "fused_bin": sh.fused_bin_call,
            "binning_histogram": binning_histogram, "bsr_spmm": bsr_spmm,
            "segment_sum": segment_sum, "scatter_kept": scatter_kept,
            "count_into": count_into}


def reset_launches():
    for fn in kernel_wrappers().values():
        fn.launches = 0
        if hasattr(fn, "launches_global"):
            fn.launches_cluster = fn.launches_global = 0
        if hasattr(fn, "launches_by_entry"):
            fn.launches_by_entry = dict.fromkeys(fn.launches_by_entry, 0)


def read_launches():
    """Launches of every wrapper (all its kernels), of the hash wrappers'
    cluster and global-memory kernels apart (``<name>_cluster``,
    ``<name>_global``), and of each of bsr_spmm's C entry points apart
    (``bsr_spmm_f32``, ``_bf16``, ``_f16``)."""
    wrappers = kernel_wrappers()
    out = {name: fn.launches for name, fn in wrappers.items()}
    for name in HASH_KERNELS:
        out[name + "_cluster"] = wrappers[name].launches_cluster
        out[name + "_global"] = wrappers[name].launches_global
    out.update(wrappers["bsr_spmm"].launches_by_entry)
    return out


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
    errs["numeric_bin"] = max(errs["numeric_bin"],
                              e.get("numeric_bin", 0.0))
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
    vb = 0 if kind == "symbolic_bin" else A.val.element_size()
    read = (4 + 4 * n + 8 * n + a_entries * (4 + vb) + 8 * b_rows
            + b_entries * (4 + vb))
    per_row = 4 * (1 if kind == "numeric_bin" else 2)
    if kind != "symbolic_bin":
        per_row += t_size * (4 + vb)
    return read + n * per_row, (rows_cap - n) * per_row


def route_of(sh, kind, t_size, dtype=torch.float32):
    """The kernel the wrapper of ``kind`` launches on a rung of ``t_size``
    entries (in its own launch geometry, with values of ``dtype``):
    "smem", "cluster" or "global"."""
    rows_per_cta = (sh.numeric_launch_geometry(t_size)[0]
                    if kind == "numeric_bin" else 1)
    return sh.rung_route(t_size, rows_per_cta, kind != "symbolic_bin",
                         value_bytes=sh.table_value_bytes(kind, dtype))


def main_path_jobs(plan, result):
    """{kind: (binning, ladder, row buckets)} of the bins a call ran."""
    sched = plan.hash_schedule
    return {
        "symbolic_bin": (result.sym_binning, plan.sym_ladder,
                         sched.sym_row_buckets),
        "fused_bin": (result.sym_binning, plan.sym_ladder,
                      sched.sym_row_buckets),
        "numeric_bin": (result.num_binning, plan.num_ladder,
                        sched.num_row_buckets),
    }


def phase_main_shapes(sh, A, jobs, errs, *, B=None, route="smem",
                      limit=None, label="main shape"):
    """Each kernel at the given bins of A·B (B = A where not given;
    ``jobs``, as :func:`main_path_jobs` gives them; ``limit`` caps each
    bin's valid rows): agreement with its plain version, its time, the
    plain time, and the bound.  It takes the
    rungs of one ``route``; their results go under ``<kind>`` plus the
    route's ``ROUTE_SUFFIX`` in ``stats`` and ``errs``.  A rung's
    residency is its CTAs per SM, or on a cluster rung its clusters in
    flight on the card."""
    from repro_torch.core import nprod_into_rpt
    B = A if B is None else B
    nprod = nprod_into_rpt(A, B)
    dtype = A.val.dtype
    sums = entry_sums(A, B) if dtype in UNIT_ROUNDOFF else None
    stats = {}
    for kind, (binning, ladder, buckets) in jobs.items():
        name = (kind + (sh.VALUE_TYPES[dtype] if kind != "symbolic_bin"
                        else "") + ROUTE_SUFFIX[route])
        ms = plain_ms = 0.0
        nbytes = pad_bytes = 0
        rungs = []
        for b, t_size in enumerate(ladder.table_sizes):
            rows_cap = buckets[b]
            if not rows_cap or route_of(sh, kind, t_size, dtype) != route:
                continue
            rows, count, valid = bin_inputs(binning, b, rows_cap, limit)
            nprod_rows = nprod[rows.long()].long().masked_fill(~valid, 0)
            p, pms = time_host(lambda: run_bin(
                sh, kind, True, A, B, rows, count, t_size, rows_cap))
            k = run_bin(sh, kind, False, A, B, rows, count, t_size, rows_cap)
            torch.cuda.synchronize()
            bound = (order_bound(sums, dtype, rows, valid,
                                 p["cols"].shape[1])
                     if sums is not None and kind != "symbolic_bin"
                     else None)
            errs[name] = max(errs[name], compare(
                f"{label} {name} rung {b} (t={t_size}, "
                f"rows={int(count)}/{rows_cap})", k, p, nprod_rows, valid,
                bound=bound))
            del p, k
            # The wrapper's launch alone: no reduction over its tables.
            kms = time_cuda(lambda: bin_call(
                sh, kind, False, A, B, rows, count, t_size, rows_cap), 3)
            rb, pb = bound_bytes(kind, A, B, rows, count, t_size, rows_cap)
            ms += kms
            plain_ms += pms
            nbytes += rb
            pad_bytes += pb
            rung = dict(rung=b, t_size=t_size, rows=int(count),
                        rows_cap=rows_cap, ms=kms, plain_ms=pms, bytes=rb,
                        pad_bytes=pb)
            if route == "cluster":
                c = sh.cluster_size(t_size, kind != "symbolic_bin",
                                    sh._smem_limit(A.device))
                resident = sh.clusters_in_flight(t_size, kernel=kind,
                                                 dtype=dtype)
                rung.update(cluster=c, clusters_in_flight=resident)
                where = f"C={c}, {resident} clusters in flight"
            else:
                resident = sh.ctas_per_sm(t_size, kernel=kind, dtype=dtype)
                rung.update(ctas_per_sm=resident)
                where = f"{resident} CTAs/SM"
            rungs.append(rung)
            rb_ms = rb / HBM_BYTES_PER_S * 1e3
            log(f"  {name} rung {b} (t={t_size}, rows {int(count)}/"
                f"{rows_cap}, {where}): {kms:.3f} ms, bound "
                f"{rb_ms:.4f} ms ({rb_ms / kms:.1%} of it), plain "
                f"{pms:.1f} ms")
            torch.cuda.empty_cache()
        if not rungs:
            continue
        stats[name] = dict(ms=ms, plain_ms=plain_ms, bytes=nbytes,
                           bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                           pad_bytes=pad_bytes,
                           pad_ms=pad_bytes / HBM_BYTES_PER_S * 1e3,
                           rungs=rungs)
        stats[name]["bound_share"] = stats[name]["bound_ms"] / ms
        log(f"phase {label}s {name}: {len(rungs)} rungs, kernel "
            f"{ms:.3f} ms, plain {plain_ms:.1f} ms, bound "
            f"{stats[name]['bound_ms']:.3f} ms ({nbytes} B, "
            f"{stats[name]['bound_share']:.1%} of the kernel's time); "
            f"padding rows write {pad_bytes} B more "
            f"({stats[name]['pad_ms']:.3f} ms at the memory rate): ok")
    return stats


def phase_fused_streams(sh, A, plan, result):
    """The steady call's fused section: its table rungs as the main path
    launches them (one side stream each, largest tables first) against the
    same launches one after another on one stream and against the sum of
    each rung's time alone; each rung's CTAs per SM; and rung 2's geometry
    (t_size 1024) with count = 0 against every row valid."""
    cfg = plan.config
    sa = cfg.hash_single_access
    rungs = sh.fused_rungs(result.sym_binning, plan.sym_ladder,
                           plan.hash_schedule.sym_row_buckets,
                           row_packing=cfg.row_packing)

    def one(r, rows=None, count=None):
        return sh.fused_bin_call(
            r.rows if rows is None else rows,
            r.count if count is None else count, A.rpt, A.col, A.val,
            A.rpt, A.col, A.val, t_size=r.t_size, rows_cap=r.rows_cap,
            pack=r.pack, single_access=sa)

    per_rung = []
    for r in rungs:
        per_rung.append(dict(
            rung=r.b, t_size=r.t_size, rows=int(r.count), rows_cap=r.rows_cap,
            ms=time_cuda(lambda: one(r), 3),
            ctas_per_sm=sh.ctas_per_sm(r.t_size, r.pack, kernel="fused_bin",
                                       single_access=sa)))
        torch.cuda.empty_cache()
    sum_ms = sum(x["ms"] for x in per_rung)
    serial_ms = time_cuda(lambda: [one(r) for r in rungs], 3)
    torch.cuda.empty_cache()
    concurrent_ms = time_cuda(
        lambda: sh.launch_fused_rungs(A, A, rungs, single_access=sa), 3)
    torch.cuda.empty_cache()
    for x in per_rung:
        log(f"  fused rung {x['rung']} (t={x['t_size']}, rows "
            f"{x['rows']}/{x['rows_cap']}, {x['ctas_per_sm']} CTAs/SM): "
            f"{x['ms']:.3f} ms alone")
    log(f"phase fused streams: {len(rungs)} rungs, sum of times alone "
        f"{sum_ms:.3f} ms, one stream {serial_ms:.3f} ms, side streams "
        f"(the main path) {concurrent_ms:.3f} ms wall")

    r2 = [r for r in rungs if r.b == 2]
    require(len(r2) == 1, f"the schedule has no fused rung 2: {rungs}")
    r2 = r2[0]
    n = int(r2.count)
    reps = -(-r2.rows_cap // n)
    full_rows = r2.rows[:n].repeat(reps)[:r2.rows_cap].contiguous()
    full = torch.tensor([r2.rows_cap], dtype=torch.int32, device=A.device)
    zero = torch.zeros(1, dtype=torch.int32, device=A.device)
    nnz, _, _, acc = one(r2, full_rows, zero)
    torch.cuda.synchronize()
    require(not bool(nnz.any()) and not bool(acc.any()),
            "fused_bin with count = 0 wrote a non-zero nnz or access count")
    del nnz, acc
    full_ms = time_cuda(lambda: one(r2, full_rows, full), 3)
    zero_ms = time_cuda(lambda: one(r2, full_rows, zero), 10)
    torch.cuda.empty_cache()
    log(f"phase fused count = 0: rung 2 geometry (t={r2.t_size}, "
        f"{r2.rows_cap} rows): every row valid {full_ms:.3f} ms, count = 0 "
        f"{zero_ms:.4f} ms ({zero_ms / full_ms:.1%})")
    return dict(rungs=per_rung, sum_alone_ms=sum_ms, one_stream_ms=serial_ms,
                side_streams_ms=concurrent_ms,
                rung2=dict(t_size=r2.t_size, rows_cap=r2.rows_cap,
                           all_valid_ms=full_ms, count_zero_ms=zero_ms))


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
# The hash kernels' bodies in csrc/spgemm_hash.cu: the shared-memory rungs
# (hash_rows_kernel, slot_rows_kernel), the cluster and the global-memory
# ones.
HASH_BODIES = ("hash_rows_kernel", "slot_rows_kernel", "cluster_rows_kernel",
               "global_rows_kernel")


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
    groups = {name: sum(_device_us(e, False) for e in kernels
                        if name in e.key) / 1e3 for name in HASH_BODIES}
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
        range_device_ms=ranges, range_sort_device_ms=range_sorts,
        kernel_device_ms=groups,
        ranges_seen=sorted({e.name for e in prof.events()
                            if e.name in RANGES}))


def host_syncs(fn):
    """Run fn() with torch's sync debug mode on; returns (its result, the
    first line of every host-sync warning it raised)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, [str(w.message).splitlines()[0] for w in caught
                 if "called a synchronizing" in str(w.message)]


def phase_slice(A):
    """The first slice: cold + steady spgemm(method="hash") on A·A."""
    from repro_torch import SpgemmConfig, spgemm
    from repro_torch.engine import default_engine, plan_key
    cfg = SpgemmConfig(method="hash")
    engine = default_engine()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    res_cold, cold_ms = time_host(lambda: spgemm(A, A, cfg))
    cold_launches = read_launches()
    require(cold_launches["symbolic_bin"] > 0
            and cold_launches["numeric_bin"] > 0,
            f"cold call did not launch the two-pass kernels: "
            f"{cold_launches}")
    require(cold_launches["fused_bin"] == 0,
            f"cold call launched the fused kernel: {cold_launches}")
    require(not any(cold_launches[k]
                    for k in CLUSTER_KERNELS + GLOBAL_KERNELS),
            f"the default ladders launched an extended-rung kernel: "
            f"{cold_launches}")
    steady_ms = []
    syncs = []
    res = None
    for _ in range(STEADY_CALLS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        rec, caught = host_syncs(lambda: engine.dispatch(A, A, cfg))
        syncs += caught
        res = engine.finalize(rec)
        torch.cuda.synchronize()
        steady_ms.append((time.perf_counter() - t1) * 1e3)
    launches = read_launches()
    steady_launches = {k: launches[k] - cold_launches[k] for k in launches}
    peak = torch.cuda.max_memory_allocated()
    require(steady_launches["fused_bin"] > 0,
            f"steady calls did not launch the fused kernel: {launches}")
    require(all(launches[k] > 0 for k in SCATTER_KERNELS),
            f"the slice did not launch each of {SCATTER_KERNELS}: "
            f"{launches}")
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
        f"{entry.plan.nnz_bucket}, policy {entry.plan.policy}")
    # A cold call always runs the StepTimer of the steps path (each step
    # waits for the device), as SpgemmConfig(timing=True) would.
    cold_steps_ms = {k: v * 1e3 for k, v in res_cold.timings.items()}
    log("cold call steps: " + ", ".join(
        f"{k} {v:.1f} ms" for k, v in cold_steps_ms.items()))

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
    # The default engine's lease stays parked in the process-wide arena;
    # giving it back keeps later phases' peaks comparable with older runs.
    from repro_torch.engine import default_arena
    lease_bytes = default_arena().reclaim()
    log(f"slice: the default arena gave back its parked lease, "
        f"{lease_bytes} B")
    torch.cuda.empty_cache()
    sparse_ms = torch_sparse_ms(A)
    log(f"torch.sparse A@A: {sparse_ms:.1f} ms")
    return res, entry.plan, launches, dict(
        matrix=MONO["name"], rows=A.nrows, nnz=int(A.nnz()),
        total_nprod=res.total_nprod, total_nnz=res.total_nnz,
        cold_ms=cold_ms, cold_steps_ms=cold_steps_ms, steady_ms=steady_ms,
        steady_median_ms=statistics.median(steady_ms), peak_bytes=peak,
        torch_sparse_ms=sparse_ms, lease_bytes=lease_bytes,
        cold_launches=cold_launches,
        steady_launches=steady_launches,
        schedule=str(entry.plan.hash_schedule),
        nnz_bucket=entry.plan.nnz_bucket, scipy=ref, profile=prof)


class CountCalls:
    """Counts the calls of some functions of a module while in use (the
    module's attributes are replaced, so callers that look them up at call
    time are counted)."""

    def __init__(self, module, names):
        self.module, self.names = module, names
        self.calls = {name: 0 for name in names}

    def __enter__(self):
        self.saved = {name: getattr(self.module, name) for name in self.names}
        for name, fn in self.saved.items():
            def counted(*args, _fn=fn, _name=name, **kw):
                self.calls[_name] += 1
                return _fn(*args, **kw)
            setattr(self.module, name, counted)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.module, name, fn)


def phase_extended(A, C_default):
    """spgemm(method="hash", vmem_extended=True) on mono_500Hz, one cold
    call and STEADY_CALLS steady ones.  Its rows past the default ladders
    go to the extended rungs (symbolic and fused 65,536, numeric 32,768
    and 131,072), whose tables a thread-block cluster holds: they must run
    on the cluster kernel, never on the global-memory kernel, and the ESC
    fallback must not run.  C must equal the default slice's C."""
    from repro_torch import SpgemmConfig, spgemm
    from repro_torch.core import esc
    from repro_torch.engine import default_engine, plan_key
    cfg = SpgemmConfig(method="hash", vmem_extended=True)
    engine = default_engine()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    esc_fns = ("expand_products", "symbolic", "numeric", "spgemm_fused")
    reset_launches()
    with CountCalls(esc, esc_fns) as esc_calls:
        res_cold, cold_ms = time_host(lambda: spgemm(A, A, cfg))
        cold = read_launches()
        steady_ms = []
        syncs = []
        for _ in range(STEADY_CALLS):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            rec, caught = host_syncs(lambda: engine.dispatch(A, A, cfg))
            syncs += caught
            res = engine.finalize(rec)
            torch.cuda.synchronize()
            steady_ms.append((time.perf_counter() - t1) * 1e3)
        launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    steady = {k: launches[k] - cold[k] for k in launches}
    entry = engine.cache.get(plan_key(A, A, cfg))
    sched = entry.plan.hash_schedule
    log(f"extended: cold {cold_ms:.1f} ms, steady median "
        f"{statistics.median(steady_ms):.1f} ms "
        f"{['%.1f' % x for x in steady_ms]}, peak {peak / 2**30:.2f} GiB "
        f"({held / 2**30:.2f} GiB held before), launches cold {cold} "
        f"steady {steady}, ESC calls {esc_calls.calls}")
    log(f"extended schedule: {sched}")
    cold_steps_ms = {k: v * 1e3 for k, v in res_cold.timings.items()}
    log("extended cold call steps: " + ", ".join(
        f"{k} {v:.1f} ms" for k, v in cold_steps_ms.items()))
    require(not any(esc_calls.calls.values()),
            f"the extended ladders ran ESC: {esc_calls.calls}")
    require(not sched.sym_row_buckets[-1] and not sched.num_row_buckets[-1],
            f"the extended schedule holds a fallback rung: {sched}")
    require(cold["symbolic_bin_cluster"] > 0
            and cold["numeric_bin_cluster"] > 0 and cold["fused_bin"] == 0,
            f"the cold call did not run the two-pass cluster kernels: "
            f"{cold}")
    require(steady["fused_bin_cluster"] >= STEADY_CALLS
            and not steady["symbolic_bin"] and not steady["numeric_bin"],
            f"the steady calls did not run the fused cluster kernel in "
            f"each call: {steady}")
    require(not any(launches[k] for k in GLOBAL_KERNELS),
            f"mono_500Hz's extended path launched the global-memory "
            f"kernel: {launches}")
    require(entry.stats.hot_calls == STEADY_CALLS
            and entry.stats.steps_calls == 1,
            f"expected 1 cold + {STEADY_CALLS} steady calls: {entry.stats}")
    require(not syncs, f"extended steady dispatch synced the host "
            f"{len(syncs)} times: {sorted(set(syncs))}")
    err = compare_csr("extended C vs the default slice's C", res.C,
                      C_default)
    cold_err = compare_csr("extended cold C vs the default slice's C",
                           res_cold.C, C_default)
    log(f"extended C equals the default slice's C (rpt, col exactly; "
        f"values within {VAL_ATOL} + {VAL_RTOL}*|v|, max {err:.3e}, cold "
        f"{cold_err:.3e}): ok")
    del res_cold
    torch.cuda.empty_cache()

    prof = profile_steady(lambda: spgemm(A, A, cfg))
    groups = prof["kernel_device_ms"]
    log(f"extended profile of one steady call: wall {prof['wall_ms']:.1f} "
        f"ms, device busy {prof['device_busy_ms']:.1f} ms, idle share "
        f"{prof['device_idle_share']:.3f}; cluster rung "
        f"{groups['cluster_rows_kernel']:.2f} ms, global kernel "
        f"{groups['global_rows_kernel']:.2f} ms, default rungs "
        f"{groups['hash_rows_kernel']:.2f} ms, epilogue "
        f"{prof['range_device_ms']['hash_epilogue']:.1f} ms (of it "
        f"aten::sort {prof['range_sort_device_ms']['hash_epilogue']:.1f} "
        f"ms); ranges seen {prof['ranges_seen']}")
    for e in prof["top_ops"][:6]:
        log(f"  {e['name']}: {e['device_ms']:.1f} ms device, "
            f"{e['calls']} calls")
    require("hash_fallback" not in prof["ranges_seen"],
            "the extended steady call entered the hash_fallback range")
    require(groups["cluster_rows_kernel"] > 0
            and groups["global_rows_kernel"] == 0,
            f"the profile shows no cluster_rows_kernel time, or some "
            f"global_rows_kernel time: {groups}")
    return res, entry.plan, launches, dict(
        cold_ms=cold_ms, cold_steps_ms=cold_steps_ms, steady_ms=steady_ms,
        steady_median_ms=statistics.median(steady_ms), peak_bytes=peak,
        held_bytes=held, cold_launches=cold, steady_launches=steady,
        esc_calls=esc_calls.calls, schedule=str(sched),
        nnz_bucket=entry.plan.nnz_bucket, max_abs_err_vs_default=err,
        profile=prof)


def top_rung_rows(A, C_default, sym, num):
    """Row ids of A (int32, ascending) for the extended ladders' top rungs
    at TOP_RUNG_MULTIPLIER: the first TOP_RUNG_ROWS of the rows in each of
    the symbolic ladder's top two rungs (by n_prod) whose nnz keeps them
    off the numeric fallback; the numeric top rung takes those of them
    past the rung below (by nnz)."""
    from repro_torch.core import nprod_into_rpt
    nprod = nprod_into_rpt(A, A)[:A.nrows].long()
    keep = C_default.nnz_per_row().long() <= num.upper[-1]
    up = sym.upper
    ids = [torch.nonzero((nprod > lo) & (nprod <= hi) & keep).flatten()
           [:TOP_RUNG_ROWS] for lo, hi in ((up[-3], up[-2]),
                                            (up[-2], up[-1]))]
    return torch.cat(ids).sort().values.to(torch.int32)


def phase_extended_top(sh, A, C_default, errs):
    """The extended ladders' top rungs, which mono_500Hz leaves empty, at
    TOP_RUNG_MULTIPLIER (symbolic and fused 262,144 and 1,048,576 by
    n_prod, numeric 524,288 by nnz).  First both bodies against their
    plain versions on 6 of 8 rows of each rung, both disciplines (the
    cluster kernel on symbolic 262,144, the global-memory kernel on the
    rest).  Then the path: spgemm(method="hash", vmem_extended=True) at
    that multiplier through the engine on the mono rows of
    :func:`top_rung_rows` times A, one cold call and TOP_STEADY_CALLS
    steady ones, the counts set to 0 just before; each wrapper must launch
    the global-memory kernel, ESC must not run, and C must equal those
    rows of the default slice's C.  Last, each rung of that run that stays
    on the global-memory kernel timed alone at the run's buckets against
    its plain version and its bound.  Returns the path's launches, the
    global kernel's stats and the path's."""
    from repro_torch import SpgemmConfig, spgemm
    from repro_torch.core import (bin_rows_for_ladder, esc, gather_rows,
                                  nprod_into_rpt, numeric_ladder,
                                  symbolic_ladder)
    from repro_torch.engine import default_engine, plan_key
    sym = symbolic_ladder(TOP_RUNG_MULTIPLIER, vmem_extended=True)
    num = numeric_ladder(TOP_RUNG_MULTIPLIER, vmem_extended=True)
    sym_bins = bin_rows_for_ladder(nprod_into_rpt(A, A)[:A.nrows], sym)
    num_bins = bin_rows_for_ladder(C_default.nnz_per_row(), num)
    top = 8

    def buckets(binning, ladder, first):
        sizes = binning.bin_size.tolist()
        require(all(sizes[first:len(ladder.table_sizes)]),
                f"a top rung is empty at multiplier {TOP_RUNG_MULTIPLIER}: "
                f"{sizes}")
        return [top if b >= first else 0
                for b in range(len(ladder.table_sizes))]

    sym_buckets = buckets(sym_bins, sym, len(sym.table_sizes) - 2)
    num_buckets = buckets(num_bins, num, len(num.table_sizes) - 1)
    e = check_bins(sh, A, A, sym_bins, sym, ("symbolic_bin", "fused_bin"),
                   buckets=sym_buckets, limit=top - 2, packs=(False,),
                   label="extended top ", by_route=True)
    e.update(check_bins(sh, A, A, num_bins, num, ("numeric_bin",),
                        buckets=num_buckets, limit=top - 2, packs=(False,),
                        label="extended top ", by_route=True))
    for k, v in e.items():
        errs[k] = max(errs[k], v)
    log(f"phase extended top rungs: symbolic and fused t="
        f"{sym.table_sizes[-2:]}, numeric t={num.table_sizes[-1:]}, "
        f"6 of 8 rows valid, both disciplines, against the plain "
        f"versions: ok")

    ids = top_rung_rows(A, C_default, sym, num)
    every = torch.ones(ids.shape[0], dtype=torch.bool, device=ids.device)
    A_top = gather_rows(A, ids, every,
                        nnz_capacity=int(A.nnz_per_row()[ids.long()].sum()))
    D = gather_rows(C_default, ids, every, nnz_capacity=int(
        C_default.nnz_per_row()[ids.long()].sum()))
    cfg = SpgemmConfig(method="hash", vmem_extended=True,
                       sym_multiplier=TOP_RUNG_MULTIPLIER,
                       num_multiplier=TOP_RUNG_MULTIPLIER)
    engine = default_engine()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with CountCalls(esc, ("expand_products", "symbolic", "numeric",
                          "spgemm_fused")) as esc_calls:
        res_cold, cold_ms = time_host(lambda: spgemm(A_top, A, cfg))
        cold = read_launches()
        steady_ms = []
        for _ in range(TOP_STEADY_CALLS):
            res, ms = time_host(lambda: engine.finalize(
                engine.dispatch(A_top, A, cfg)))
            steady_ms.append(ms)
        launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    steady = {k: launches[k] - cold[k] for k in launches}
    plan = engine.cache.get(plan_key(A_top, A, cfg)).plan
    log(f"extended top-rung path: {A_top.nrows} mono rows x A at "
        f"multiplier {TOP_RUNG_MULTIPLIER}, cold {cold_ms:.1f} ms, steady "
        f"{['%.1f' % x for x in steady_ms]} ms, peak {peak / 2**30:.2f} "
        f"GiB, launches cold {cold} steady {steady}, ESC calls "
        f"{esc_calls.calls}; schedule {plan.hash_schedule}")
    require(not any(esc_calls.calls.values()),
            f"the top-rung path ran ESC: {esc_calls.calls}")
    require(cold["symbolic_bin_global"] > 0 and cold["numeric_bin_global"] > 0
            and steady["fused_bin_global"] >= TOP_STEADY_CALLS,
            f"the top-rung path did not launch the global-memory kernel "
            f"from each wrapper: cold {cold}, steady {steady}")
    err = compare_csr("top-rung path C vs the default slice's rows", res.C,
                      D)
    cold_err = compare_csr("top-rung path cold C vs the default slice's "
                           "rows", res_cold.C, D)
    log(f"top-rung path C equals the default slice's C on its rows (max "
        f"{err:.3e}, cold {cold_err:.3e}): ok")
    del res_cold, D
    torch.cuda.empty_cache()
    stats = phase_main_shapes(sh, A_top, main_path_jobs(plan, res), errs,
                              B=A, route="global",
                              label="extended top rung")
    path = dict(rows=A_top.nrows, cold_ms=cold_ms, steady_ms=steady_ms,
                peak_bytes=peak, cold_launches=cold, steady_launches=steady,
                schedule=str(plan.hash_schedule), max_abs_err=err)
    return launches, stats, path


def phase_esc(S):
    """The default method, ESC (SpgemmConfig()), through an engine on the
    scircuit analog: a cold call and two steady ones against scipy."""
    from repro_torch import SpgemmConfig
    from repro_torch.engine import SpgemmEngine, plan_key
    cfg = SpgemmConfig()
    engine = SpgemmEngine(cfg)
    reset_launches()
    times, checks = [], []
    for _ in range(3):
        res, ms = time_host(lambda: engine.execute(S, S))
        times.append(ms)
        checks.append(scipy_check(S, res.C))
        del res
    launches = read_launches()
    entry = engine.cache.get(plan_key(S, S, cfg))
    require(entry.stats.steps_calls == 1 and entry.stats.hot_calls == 2,
            f"ESC: expected 1 cold + 2 steady calls: {entry.stats}")
    require(not any(launches[k] for k in (*HASH_KERNELS, *CLUSTER_KERNELS,
                                          *GLOBAL_KERNELS)),
            f"ESC launched a hash kernel: {launches}")
    log(f"phase ESC (SpgemmConfig()) on scircuit through the engine: cold "
        f"{times[0]:.1f} ms, steady {times[1]:.1f} / {times[2]:.1f} ms, nnz "
        f"{checks[-1]['nnz']}, max |C - A·A| "
        f"{max(c['max_abs_err'] for c in checks):.3e}, each call equal to "
        f"scipy: ok")
    torch.cuda.empty_cache()
    return dict(matrix=SCIRCUIT["name"], cold_ms=times[0],
                steady_ms=times[1:], scipy=checks[-1])


def phase_binning(A, res, errs):
    """binning_histogram through its own entry point on the slice's sizes,
    then at delaunay_n24's row count."""
    import numpy as np
    from repro_torch.core import nprod_into_rpt, numeric_ladder, \
        symbolic_ladder
    from repro_torch.kernels.binning_histogram import binning_histogram
    from repro_torch.kernels.ref import binning_histogram_ref
    sym, num = symbolic_ladder(), numeric_ladder()
    nprod = nprod_into_rpt(A, A)[:A.nrows]
    nnz = res.C.nnz_per_row()
    jobs = (("n_prod / symbolic ladder", nprod, sym, res.sym_binning),
            ("nnz / numeric ladder", nnz, num, res.num_binning))
    reset_launches()
    outs = [binning_histogram(x, upper=lad.upper, num_bins=lad.num_bins)
            for _, x, lad, _ in jobs]
    torch.cuda.synchronize()
    launches = read_launches()["binning_histogram"]
    require(launches == len(jobs),
            f"binning_histogram launched {launches} times for {len(jobs)} "
            "calls")
    for (what, x, lad, binning), (hist, mx) in zip(jobs, outs):
        want_h, want_m = binning_histogram_ref(x, upper=lad.upper,
                                               num_bins=lad.num_bins)
        require(torch.equal(hist, want_h) and torch.equal(mx, want_m),
                f"binning_histogram ({what}) differs from its plain version")
        require(torch.equal(hist, binning.bin_size)
                and int(mx) == int(binning.max_size),
                f"binning_histogram ({what}) differs from the slice's "
                f"Binning: {hist.tolist()} / {int(mx)} vs "
                f"{binning.bin_size.tolist()} / {int(binning.max_size)}")
        log(f"phase binning_histogram on mono_500Hz {what}: bins "
            f"{hist.tolist()}, max {int(mx)}, equal to the plain version "
            f"and to the slice's Binning: ok")

    # Timing at delaunay_n24's row count: n_prod of a row of A·A with 6.0
    # nnz per row is about 36, drawn here as Poisson(36).
    rng = np.random.default_rng(zlib.crc32(b"delaunay_n24"))
    sizes = torch.from_numpy(rng.poisson(DELAUNAY_AVG ** 2, DELAUNAY_ROWS)
                             .astype(np.int32)).cuda()
    kw = dict(upper=sym.upper, num_bins=sym.num_bins)
    hist, mx = binning_histogram(sizes, **kw)
    want_h, want_m = binning_histogram_ref(sizes, **kw)
    require(torch.equal(hist, want_h) and torch.equal(mx, want_m),
            "binning_histogram at 16,777,216 rows differs from its plain "
            "version")
    bounds = torch.tensor(sym.upper, dtype=torch.int32, device="cuda")
    lib = torch.bincount(torch.bucketize(sizes, bounds),
                         minlength=sym.num_bins)
    require(torch.equal(lib.to(torch.int32), hist),
            "binning_histogram differs from bincount(bucketize(...))")
    ms = time_cuda(lambda: binning_histogram(sizes, **kw), 20)
    kernel_ms = histogram_kernel_ms(sizes, 20, **kw)
    # The wrapper's host cost per call, on 1,000 rows (the device idles).
    small = sizes[:1000]
    _, calls_ms = time_host(lambda: [binning_histogram(small, **kw)
                                     for _ in range(200)])
    host_us = calls_ms / 200 * 1e3
    plain_ms = time_cuda(lambda: binning_histogram_ref(sizes, **kw), 5)
    library_ms = time_cuda(lambda: torch.bincount(
        torch.bucketize(sizes, bounds), minlength=sym.num_bins), 5)
    nbytes = 4 * DELAUNAY_ROWS + 4 * (sym.num_bins + 1)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"phase binning_histogram at {DELAUNAY_ROWS} rows: wrapper "
        f"{ms:.4f} ms (the kernel alone {kernel_ms:.4f} ms; the wrapper's "
        f"host cost {host_us:.1f} us a call), "
        f"plain {plain_ms:.4f} ms, bincount(bucketize) {library_ms:.4f} ms "
        f"(two calls), bound {bound_ms:.4f} ms ({nbytes} B, "
        f"{bound_ms / ms:.1%} of the wrapper's time): ok")
    errs["binning_histogram"] = 0.0
    del sizes
    torch.cuda.empty_cache()
    return dict(launches=launches, ms=ms, kernel_ms=kernel_ms,
                host_us=host_us, plain_ms=plain_ms, library_ms=library_ms, library_calls=2,
                bound_ms=bound_ms, bound_by="bytes",
                bound_share=bound_ms / ms, bytes=nbytes, rows=DELAUNAY_ROWS)


def histogram_kernel_ms(sizes, reps, *, upper, num_bins):
    """Mean ms of the histogram kernel alone: its C entry point (one
    memset of the outputs, then the kernel) launched reps times back to
    back (CUDA events), without the wrapper's Python."""
    import ctypes
    from repro_torch.kernels import build
    lib = build.library("binning_histogram")
    out = torch.zeros(num_bins + 1, dtype=torch.int32, device=sizes.device)
    bounds = (ctypes.c_int * len(upper))(*upper)
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        build.check(lib.binning_histogram(
            sizes.data_ptr(), sizes.shape[0], 1024, bounds, len(upper),
            num_bins, out.data_ptr(), out[num_bins:].data_ptr(), stream),
            "binning_histogram")
    return time_cuda(launch, reps)


def _bsr_case(rng, nbr, nbc, bm, bk, density, *, every_row=True,
              empty_row=None, padding=0):
    """Random block layout (blk_rows, blk_cols) on the host: ``density``
    (one for all block rows, or one per block row) is the share of blocks
    stored; ``every_row`` stores a block in each block row but
    ``empty_row``; ``padding`` zero blocks repeat the last row."""
    import numpy as np
    mask = rng.random((nbr, nbc)) < np.reshape(density, (-1, 1))
    if every_row:
        mask[np.arange(nbr), np.arange(nbr) % nbc] = True
    if empty_row is not None:
        mask[empty_row] = False
    rows, cols = np.nonzero(mask)
    rows = np.concatenate([rows, np.full(padding, rows[-1])])
    cols = np.concatenate([cols, np.zeros(padding, np.int64)])
    return rows.astype(np.int32), cols.astype(np.int32), len(rows) - padding


def _bsr_tensors(rows, cols, n_real, bm, bk, k, n, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    blocks = torch.randn((len(rows), bm, bk), generator=g, device="cuda")
    blocks[n_real:] = 0          # padding entries carry zero blocks
    dense = torch.randn((k, n), generator=g, device="cuda")
    return (torch.from_numpy(rows).cuda(), torch.from_numpy(cols).cuda(),
            blocks.to(dtype), dense.to(dtype))


def _bsr_err(got, want, dtype_name, what):
    tol = BSR_TOL[dtype_name]
    g, w = got.float(), want.float()
    err = float((g - w).abs().max()) if g.numel() else 0.0
    require(torch.allclose(g, w, **tol),
            f"bsr_spmm {what} ({dtype_name}) differs from its plain version "
            f"by up to {err:.3e}")
    return err


def sass_counts(name):
    """Per kernel in the SASS of the built library of csrc/<name>.cu:
    its tensor-core MMA instructions (HGMMA: wgmma, HMMA: mma.sync) and
    its 16-byte shared loads (LDS.128)."""
    from repro_torch.kernels import build
    def count(ops, base, width=""):
        return sum(n for op, n in ops.items()
                   if op.split(".")[0] == base and width in op)
    return {kernel: {"HGMMA": count(ops, "HGMMA"), "HMMA": count(ops, "HMMA"),
                     "LDS.128": count(ops, "LDS", ".128")}
            for kernel, ops in build.sass_opcodes(name).items()}


def phase_cluster_sass():
    """The table atomics of cluster_rows_kernel in its SASS (cuobjdump):
    each instance must reach its table through generic ATOM / LD
    instructions on the shared window (distributed shared memory), with no
    device-memory atomic (ATOMG, REDG) and no CAS spin loop; the global
    kernel's are printed beside them."""
    from repro_torch.kernels import build
    ops = build.sass_opcodes("spgemm_hash")
    picked = {}
    for kernel, counts in ops.items():
        if kernel.split("<")[0] not in ("cluster_rows_kernel",
                                        "global_rows_kernel"):
            continue
        picked[kernel] = {op: n for op, n in sorted(counts.items())
                          if op.split(".")[0] in ("ATOM", "ATOMG", "ATOMS",
                                                  "RED", "REDG", "LD")}
        if kernel.startswith("cluster_rows_kernel"):
            require(any(op.startswith("ATOM.E.CAS") for op in counts)
                    and not any(op.startswith(("ATOMG", "REDG"))
                                or "SPIN" in op for op in counts),
                    f"{kernel}'s SASS holds no distributed-shared-memory "
                    f"CAS, or a device-memory atomic: {picked[kernel]}")
    # Both disciplines: keys only (float32 only), and with values and their
    # fixed-order instances in each of the three value types.
    require(sum(k.startswith("cluster_rows_kernel") for k in picked)
            == 2 + 3 * 4,
            f"the SASS lacks an instance of cluster_rows_kernel: "
            f"{sorted(picked)}")
    log(f"phase cluster SASS (cuobjdump): table atomics {picked}: ok")
    return picked


def phase_bsr(errs):
    """bsr_spmm: SASS check, edge cases, then one block-sparse weight
    layer."""
    import numpy as np
    from repro_torch.kernels.bsr_spmm import (block_row_pointers, bsr_spmm,
                                              occupancy)
    from repro_torch.kernels.ref import bsr_spmm_ref
    torch.backends.cuda.matmul.allow_tf32 = False    # plain in full fp32
    sass = sass_counts("bsr_spmm")
    for f16 in (0, 1):     # bsr_spmm_tc_kernel<F16>: bfloat16, float16
        tc = sass.get(f"bsr_spmm_tc_kernel<{f16}>", {})
        require(tc.get("HGMMA", 0) + tc.get("HMMA", 0) > 0,
                f"the {('bfloat16', 'float16')[f16]} kernel's SASS holds no "
                f"tensor-core MMA: {sass}")
    require(sass.get("bsr_spmm_f32_kernel", {}).get("LDS.128", 0) > 0,
            f"the float32 kernel's SASS holds no LDS.128: {sass}")
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16,
              "float16": torch.float16}
    occ = {name: occupancy(dt) for name, dt in dtypes.items()}
    log(f"phase bsr_spmm SASS (cuobjdump): {sass}; dynamic shared memory "
        f"and CTAs per SM: " + ", ".join(f"{name} {smem} B, {ctas}"
                                         for name, (smem, ctas) in occ.items())
        + ": ok")
    rng = np.random.default_rng(zlib.crc32(b"bsr_spmm"))
    err = {name: 0.0 for name in dtypes}

    def edge_case(what, nbr, nbc, bm, bk, n, empty, pad, density=0.5):
        rows, cols, n_real = _bsr_case(rng, nbr, nbc, bm, bk, density,
                                       empty_row=empty, padding=pad)
        for name, dt in dtypes.items():
            t = _bsr_tensors(rows, cols, n_real, bm, bk, nbc * bk, n, dt,
                             len(rows))
            got = bsr_spmm(*t, n_block_rows=nbr)
            want = bsr_spmm_ref(*t, nrows_blocks=nbr, block_shape=(bm, bk))
            torch.cuda.synchronize()
            err[name] = max(err[name], _bsr_err(got, want, name, what))
            if empty is not None:
                require(not bool(got[empty * bm:(empty + 1) * bm].any()),
                        f"bsr_spmm {what} ({name}): the empty block row is "
                        "not zero")
        log(f"phase bsr_spmm edge case {what}: {', '.join(dtypes)}: ok")

    cases = {  # nbr, nbc, bm, bk, n, empty_row, padding
        "empty block row + padding": (6, 5, 16, 16, 48, 2, 2),
        "bm != bk": (4, 3, 32, 8, 40, None, 0),
        "N not a multiple of the tile": (3, 3, 128, 128, 100, None, 1),
        "128 x 128, N = 4096": (4, 4, 128, 128, 4096, 0, 0),
    }
    for what, case in cases.items():
        edge_case(what, *case)

    # One block-sparse weight layer: 8192 x 8192 in 128 x 128 blocks (the
    # tile the TPU kernel was written around), 10 % of blocks stored,
    # times a dense 8192 x 4096 operand.
    nbr = nbc = 64
    bm = bk = 128
    n = 4096
    rows, cols, n_real = _bsr_case(rng, nbr, nbc, bm, bk, 0.1,
                                   every_row=False)
    nnzb = len(rows)
    inputs = {name: _bsr_tensors(rows, cols, n_real, bm, bk, nbc * bk, n,
                                 dt, 12)
              for name, dt in dtypes.items()}
    reset_launches()
    outs = {name: bsr_spmm(*t, n_block_rows=nbr)
            for name, t in inputs.items()}
    torch.cuda.synchronize()
    counts = read_launches()
    launches = {name: counts[entry] for name, entry in (
        ("float32", "bsr_spmm_f32"), ("bfloat16", "bsr_spmm_bf16"),
        ("float16", "bsr_spmm_f16"))}
    require(counts["bsr_spmm"] == len(dtypes)
            and all(n == 1 for n in launches.values()),
            f"bsr_spmm launched {counts['bsr_spmm']} times for "
            f"{len(dtypes)} calls, by type {launches}")
    stats = {}
    stripes = len(set(cols.tolist()))
    for name, t in inputs.items():
        want = bsr_spmm_ref(*t, nrows_blocks=nbr, block_shape=(bm, bk))
        e = _bsr_err(outs[name], want, name, "8192 x 8192 layer")
        err[name] = max(err[name], e)
        del want
        size = t[2].element_size()
        ptr64 = block_row_pointers(t[0], nbr).long()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")   # beta and tuning notices
            S = torch.sparse_bsr_tensor(ptr64, t[1].long(), t[2],
                                        size=(nbr * bm, nbc * bk))
            lib = S @ t[3]
            torch.cuda.synchronize()
            # The yardstick's own arithmetic is not held to a tolerance.
            lib_err = float((lib.float() - outs[name].float()).abs().max())
            library_ms = time_cuda(lambda: S @ t[3], 10)
        del lib, S
        ms = time_cuda(lambda: bsr_spmm(*t, n_block_rows=nbr), 10)
        plain_ms = time_cuda(lambda: bsr_spmm_ref(
            *t, nrows_blocks=nbr, block_shape=(bm, bk)), 3)
        flops = 2 * nnzb * bm * bk * n
        nbytes = (nnzb * (bm * bk * size + 8) + 4 * (nbr + 1)
                  + stripes * bk * n * size + nbr * bm * n * size)
        peak = FP32_FLOPS if name == "float32" else BF16_FLOPS
        ops_ms = flops / peak * 1e3
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        stats[name] = dict(
            ms=ms, plain_ms=plain_ms, library_ms=library_ms,
            bound_ms=max(ops_ms, bytes_ms),
            bound_by="operations" if ops_ms >= bytes_ms else "bytes",
            bound_share=max(ops_ms, bytes_ms) / ms,
            ops_ms=ops_ms, bytes_ms=bytes_ms, flops=flops, bytes=nbytes,
            max_abs_err=e, library_max_abs_err=lib_err,
            launches=launches[name],
            tflops=flops / ms / 1e9, smem_bytes=occ[name][0],
            ctas_per_sm=occ[name][1])
        log(f"phase bsr_spmm layer ({name}, {nnzb} blocks, {flops / 1e9:.1f}"
            f" GFLOP): kernel {ms:.3f} ms ({stats[name]['tflops']:.1f} "
            f"TFLOP/s), plain {plain_ms:.3f} ms, torch.sparse "
            f"{library_ms:.3f} ms, bound {stats[name]['bound_ms']:.3f} ms "
            f"by {stats[name]['bound_by']} (ops {ops_ms:.3f}, bytes "
            f"{bytes_ms:.3f}; {stats[name]['bound_share']:.1%} of it), max "
            f"|err| {e:.3e}: ok")
    del inputs, outs
    torch.cuda.empty_cache()
    # Drawn after the layer, so the layer's blocks stay those of earlier
    # runs: the bf16 kernel's K loop crosses blocks and wraps its ring.
    edge_case("64 x 64, several blocks per block row", 4, 8, 64, 64, 192,
              None, 1)
    edge_case("96 x 40 blocks, N = 37, rows of 1 to 13 blocks", 3, 13, 96,
              40, 37, None, 1, density=(0.0, 0.5, 1.0))
    errs["bsr_spmm"] = err["float32"]
    errs["bsr_spmm_f16"] = err["float16"]
    return dict(launches=launches, nnzb=nnzb, m=nbr * bm, k=nbc * bk, n=n,
                block=(bm, bk), edge_max_abs_err=err, sass=sass, **stats)


def phase_request_path(A, C_mono, S):
    """submit/drain with plan_mode="estimate", prewarm and dump/load."""
    import tempfile
    from repro_torch import SpgemmConfig
    from repro_torch.engine import SpgemmEngine, plan_key
    cfg = SpgemmConfig(method="hash", plan_mode="estimate")
    engine = SpgemmEngine(cfg, telemetry=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    uids = {"mono": [engine.submit(A, A) for _ in range(2)],
            "scircuit": [engine.submit(S, S) for _ in range(2)]}
    results = engine.drain(window=2)
    torch.cuda.synchronize()
    drain_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    launches = read_launches()
    st = engine.stats
    drain_stats = {name: getattr(st, name) for name in (
        "estimates", "estimate_hits", "estimate_misses", "capacity_grows",
        "overlapped", "reordered", "peak_inflight")}
    require(st.estimates == 2, f"expected 2 estimated plans: {st}")
    redone = st.estimate_misses + st.capacity_grows
    require(launches["fused_bin"] > 0,
            f"the drain did not launch the fused kernel: {launches}")
    if redone:
        log(f"request path: {st.estimate_misses} estimate misses, "
            f"{st.capacity_grows} capacity grows (redone on the steps path)")
    else:
        require(launches["symbolic_bin"] == 0
                and launches["numeric_bin"] == 0,
                f"estimated cold calls ran the sizing kernels without a "
                f"reported redo: {launches}")
    for uid in uids["mono"]:
        compare_csr(f"request {uid} (mono_500Hz) vs the slice's C",
                    results[uid].C, C_mono)
    s_ref = [scipy_check(S, results[uid].C) for uid in uids["scircuit"]]
    log(f"request path drain: 2 x mono_500Hz + 2 x scircuit at window 2: "
        f"wall {drain_ms:.1f} ms, peak {peak / 2**30:.2f} GiB "
        f"({base / 2**30:.2f} GiB held before), launches {launches}, "
        f"estimates {st.estimates} (hits {st.estimate_hits}, misses "
        f"{st.estimate_misses}), overlapped {st.overlapped}, reordered "
        f"{st.reordered}, peak in flight {st.peak_inflight}; C matches: ok")
    del results

    entry = engine.cache.peek(plan_key(A, A, cfg))
    rec, syncs = host_syncs(lambda: engine.dispatch(A, A))
    res = engine.finalize(rec)
    require(not syncs, f"steady dispatch of an estimated plan synced the "
            f"host {len(syncs)} times: {sorted(set(syncs))}")
    require(torch.equal(res.C.rpt, C_mono.rpt), "steady request C.rpt "
            "differs from the slice's")
    require(entry.stats.hot_calls == 3
            and entry.stats.steps_calls == entry.stats.capacity_grows,
            f"estimated mono plan: {entry.stats}")
    del res, rec
    log("request path steady dispatch: 0 host syncs: ok")

    P = table3_matrix(PATENTS)
    plan = engine.prewarm(P, P)
    require(plan.is_specialized and plan.policy.estimated,
            f"prewarm did not specialize: {plan}")
    res = engine.execute(P, P)
    pentry = engine.cache.peek(plan_key(P, P, cfg))
    require(pentry.stats.steps_calls == 0 and pentry.stats.hot_calls == 1,
            f"prewarmed plan's first request was not hot: {pentry.stats}")
    p_ref = scipy_check(P, res.C)
    log(f"request path prewarm (patents_main): first request hot, nnz "
        f"{p_ref['nnz']}: ok")
    del res

    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "plans.json")
        n_dumped = engine.cache.dump(path)
        fresh = SpgemmEngine(cfg, telemetry=True)
        n_loaded = fresh.cache.load(path)
    res = fresh.execute(S, S)
    sentry = fresh.cache.peek(plan_key(S, S, cfg))
    require(n_loaded == n_dumped == 3, f"dumped {n_dumped}, loaded "
            f"{n_loaded} plans")
    require(sentry.stats.steps_calls == 0 and sentry.stats.hot_calls == 1
            and fresh.stats.estimates == 0,
            f"loaded plan's first request was not hot: {sentry.stats}, "
            f"{fresh.stats.estimates} estimates")
    scipy_check(S, res.C)
    log(f"request path dump/load: {n_dumped} plans, first call of the new "
        f"engine hot: ok")
    report = engine.report()
    log("engine report:\n" + "\n".join("  " + line
                                        for line in report.splitlines()))
    return dict(drain_ms=drain_ms, peak_bytes=peak, held_bytes=base,
                window=2, launches=launches, drain_stats=drain_stats,
                scircuit=s_ref, patents=p_ref, report=report)


def _csr_bitwise(C, D):
    """Whether C and D carry the same CSR payload, bit for bit."""
    nz = int(D.rpt[-1])
    return (torch.equal(C.rpt, D.rpt) and torch.equal(C.col[:nz], D.col[:nz])
            and torch.equal(C.val[:nz].view(torch.int32),
                            D.val[:nz].view(torch.int32)))


def phase_governor(A, C_mono, S, slice_stats):
    """The workspace arena, the memory governor and fault injection on the
    request path: mono_500Hz's leased steady calls, the governor's ladder
    under a cap, the drain's backpressure and injected faults on scircuit."""
    from repro_torch import SpgemmConfig
    from repro_torch.core import bin_rows
    from repro_torch.core.analysis import nprod_into_rpt
    from repro_torch.core.faults import FaultPlan, FaultSpec, InjectedFault
    from repro_torch.core.workspace import (WorkspacePlan, bin_rows_into,
                                            default_arena)
    from repro_torch.engine import (Arena, MatrixSig, MemoryGovernor,
                                    SpgemmEngine, plan_key)
    cfg = SpgemmConfig(method="hash")
    default_arena().reclaim()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out = {}
    reset_launches()          # this path's counts, read at its end

    # -- 0. the fused metadata workspace at the slice's n_prod ----------------
    m = A.nrows
    lad = cfg.ladders()[0]
    nprod = nprod_into_rpt(A, A)[:m]
    wp = WorkspacePlan(m, lad.num_bins)
    buf = wp.alloc(A.device)
    before = read_launches()["binning_histogram"]
    bin_rows_into(nprod, buf, upper=lad.upper, num_bins=lad.num_bins, m=m)
    require(read_launches()["binning_histogram"] == before + 1,
            "bin_rows_into on the card did not launch binning_histogram")
    want = bin_rows(nprod, upper=lad.upper, num_bins=lad.num_bins)
    got = wp.views(buf)
    for name in ("bins", "bin_size", "bin_offset"):
        require(torch.equal(getattr(got, name).long(),
                            getattr(want, name).long()),
                f"bin_rows_into {name} differs from bin_rows")
    require(int(got.max_size) == int(want.max_size),
            "bin_rows_into max differs from bin_rows")
    log(f"governor: bin_rows_into on mono_500Hz's n_prod ({m} rows, one "
        f"{wp.size}-cell int32 buffer) equal to bin_rows, pass 1 on "
        f"binning_histogram: ok")
    del nprod, buf, want, got

    # -- 1. lease reuse -------------------------------------------------------
    arena = Arena()
    eng = SpgemmEngine(cfg, arena=arena)
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    _, cold_ms = time_host(lambda: eng.execute(A, A))
    cold_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    entry = eng.cache.peek(plan_key(A, A, cfg))
    spec = entry.plan.workspace_spec()
    require(arena.bytes_reserved == 0 and spec is not None,
            f"cold call leased, or the plan leases nothing: {spec}")
    fall = entry.plan.hash_schedule.fall_prod_bucket
    steady_ms, syncs = [], []
    res = None
    for i in range(STEADY_CALLS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        rec, caught = host_syncs(lambda: eng.dispatch(A, A))
        syncs += caught
        lease = rec.lease
        require(lease is not None and lease.i32.device == A.device
                and lease.val.device == A.device, f"steady call {i} holds "
                f"no lease on the operands' card: {lease}")
        res = eng.finalize(rec)
        torch.cuda.synchronize()
        steady_ms.append((time.perf_counter() - t1) * 1e3)
        require(arena.bytes_in_use == 0,
                f"{arena.bytes_in_use} B in use after finalize {i}")
        if i == 0:
            require((arena.lease_misses, arena.lease_hits) == (2, 0),
                    f"first steady call: {arena.lease_misses} misses, "
                    f"{arena.lease_hits} hits")
            compare_csr("first leased steady call vs the slice's C", res.C,
                        C_mono)
    peak = torch.cuda.max_memory_allocated()
    require((arena.lease_misses, arena.lease_hits)
            == (2, 2 * (STEADY_CALLS - 1)),
            f"lease reuse: {arena.lease_misses} misses, {arena.lease_hits} "
            f"hits after {STEADY_CALLS} steady calls")
    require(arena.bytes_reserved == spec.nbytes,
            f"arena reserves {arena.bytes_reserved} B, the plan's lease is "
            f"{spec.nbytes} B")
    require(not syncs, f"leased steady dispatch synced the host "
            f"{len(syncs)} times: {sorted(set(syncs))}")
    err = compare_csr("last leased steady call vs the slice's C", res.C,
                      C_mono)
    del res
    log(f"governor lease reuse (mono_500Hz, fall_prod_bucket {fall}): lease "
        f"{spec.nbytes} B ({spec.nbytes / 2**30:.2f} GiB), reserved "
        f"{arena.bytes_reserved} B, {arena.lease_misses} misses / "
        f"{arena.lease_hits} hits, 0 B in use after each finalize, 0 host "
        f"syncs; cold {cold_ms:.1f} ms, steady median "
        f"{statistics.median(steady_ms):.1f} ms "
        f"{['%.1f' % x for x in steady_ms]} (slice phase "
        f"{slice_stats['steady_median_ms']:.1f}); peak cold "
        f"{cold_peak / 2**30:.2f} GiB, steady {peak / 2**30:.2f} GiB (slice "
        f"phase, cold and steady: {slice_stats['peak_bytes'] / 2**30:.2f}; "
        f"{held / 2**30:.2f} held before, the slice's C among it); C equal, "
        f"values within {err:.3e}: ok")

    # The same steady pipeline with and without the lease as its storage,
    # in turns, the arena emptied before each run: the lease held for the
    # whole call against the expansion's arrays from torch's allocator for
    # the fallback rung alone.
    Ap = A.with_capacity(MatrixSig.of(A).cap_bucket)
    pipe = entry.executable
    ab = {"unleased": [], "leased": []}
    ab_peak = {"unleased": 0, "leased": 0}
    for order in (("unleased", "leased"), ("leased", "unleased"),
                  ("unleased", "leased")):
        for kind in order:
            arena.reclaim()
            lease = arena.acquire(spec, device=Ap.device) \
                if kind == "leased" else None
            ws = None if lease is None else (lease.i32, lease.val)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _, ms = time_host(lambda: pipe(Ap, Ap, ws))
            ab[kind].append(ms)
            ab_peak[kind] = max(ab_peak[kind],
                                torch.cuda.max_memory_allocated())
            if lease is not None:
                arena.release(lease)
    log(f"governor pipeline with vs without the lease (in turns, the arena "
        f"emptied before each run): "
        f"leased median {statistics.median(ab['leased']):.1f} ms "
        f"{['%.1f' % x for x in ab['leased']]}, peak "
        f"{ab_peak['leased'] / 2**30:.2f} GiB; unleased median "
        f"{statistics.median(ab['unleased']):.1f} ms "
        f"{['%.1f' % x for x in ab['unleased']]}, peak "
        f"{ab_peak['unleased'] / 2**30:.2f} GiB")
    out["lease"] = dict(
        fall_prod_bucket=fall, lease_bytes=spec.nbytes,
        bytes_reserved=arena.bytes_reserved, lease_hits=arena.lease_hits,
        lease_misses=arena.lease_misses, cold_ms=cold_ms,
        steady_ms=steady_ms, steady_median_ms=statistics.median(steady_ms),
        cold_peak_bytes=cold_peak, peak_bytes=peak, held_bytes=held,
        host_syncs=0,
        slice_steady_median_ms=slice_stats["steady_median_ms"],
        slice_peak_bytes=slice_stats["peak_bytes"],
        pipeline_leased_ms=ab["leased"], pipeline_unleased_ms=ab["unleased"],
        pipeline_leased_peak_bytes=ab_peak["leased"],
        pipeline_unleased_peak_bytes=ab_peak["unleased"])

    # -- 2. the ladder under a cap --------------------------------------------
    # A lease served from the free lists adds no bytes and passes any cap,
    # so park nothing: the cap must bind.
    arena.reclaim()
    eng.governor = MemoryGovernor(cap_bytes=0)
    before = read_launches()
    torch.cuda.reset_peak_memory_stats()
    res, spill_ms = time_host(lambda: eng.execute(A, A))
    spill_peak = torch.cuda.max_memory_allocated()
    spill_launches = {k: v - before[k] for k, v in read_launches().items()}
    st = eng.stats
    trimmed = entry.plan.hash_schedule.fall_prod_bucket
    tspec = entry.plan.workspace_spec()
    require(st.arena_pressure >= 1 and st.arena_trims == 1,
            f"cap 0: {st.arena_pressure} pressure events, "
            f"{st.arena_trims} trims")
    require(trimmed < fall, f"the forced trim kept fall_prod_bucket "
            f"{trimmed} (was {fall})")
    require(st.arena_spills >= 1, "the trimmed lease cannot fit under a cap "
            f"of 0 B, yet the call did not spill: {st}")
    require(spill_launches["symbolic_bin"] > 0
            and spill_launches["numeric_bin"] > 0
            and spill_launches["fused_bin"] == 0,
            f"the spilled call did not run the two-pass kernels alone: "
            f"{spill_launches}")
    err_spill = compare_csr("spilled call vs the slice's C", res.C, C_mono)
    del res
    log(f"governor ladder at cap 0: {st.arena_pressure} pressure, "
        f"{st.arena_trims} trim (fall_prod_bucket {fall} -> {trimmed}, "
        f"lease {spec.nbytes} -> {tspec.nbytes} B), {st.arena_spills} "
        f"spill to the two-pass steps path in {spill_ms:.1f} ms (peak "
        f"{spill_peak / 2**30:.2f} GiB), launches symbolic_bin "
        f"{spill_launches['symbolic_bin']}, numeric_bin "
        f"{spill_launches['numeric_bin']}; C equal: ok")

    eng.governor = MemoryGovernor()
    torch.cuda.reset_peak_memory_stats()
    grows = st.capacity_grows
    eng.execute(A, A)                      # rebuilds the trimmed pipeline
    trim_ms = []
    for _ in range(3):
        res, ms = time_host(lambda: eng.execute(A, A))
        trim_ms.append(ms)
    trim_peak = torch.cuda.max_memory_allocated()
    require(st.capacity_grows == grows,
            f"the trimmed schedule overflowed: {st.capacity_grows - grows} "
            f"grows")
    require(arena.bytes_reserved == tspec.nbytes,
            f"arena reserves {arena.bytes_reserved} B, the trimmed lease is "
            f"{tspec.nbytes} B")
    compare_csr("trimmed steady call vs the slice's C", res.C, C_mono)
    del res
    log(f"governor trimmed plan (fall_prod_bucket {trimmed}), unbounded: "
        f"steady median {statistics.median(trim_ms):.1f} ms "
        f"{['%.1f' % x for x in trim_ms]} against "
        f"{statistics.median(steady_ms):.1f} ms at {fall}, peak "
        f"{trim_peak / 2**30:.2f} GiB against {peak / 2**30:.2f}; C "
        f"equal: ok")
    out["ladder"] = dict(
        arena_pressure=st.arena_pressure, arena_trims=st.arena_trims,
        arena_spills=st.arena_spills, trimmed_fall_prod_bucket=trimmed,
        trimmed_lease_bytes=tspec.nbytes, spill_ms=spill_ms,
        spill_peak_bytes=spill_peak, spill_launches=spill_launches,
        spill_max_abs_err=err_spill, trimmed_steady_ms=trim_ms,
        trimmed_steady_median_ms=statistics.median(trim_ms),
        trimmed_peak_bytes=trim_peak)
    del eng, entry, pipe
    arena.reclaim()
    torch.cuda.empty_cache()

    # -- 3. drain backpressure under a one-lease cap --------------------------
    # Trim and spill are off: with them on, the spill takes the refused
    # dispatch to the steps path and the drain never backs off.
    cap = spec.nbytes
    arena = Arena()
    eng = SpgemmEngine(cfg, arena=arena, governor=MemoryGovernor(
        cap_bytes=cap, trim_under_pressure=False, spill_fused=False))
    drains = {}
    for ordered in (False, True):
        arena.reset_peak()
        pressure = eng.stats.arena_pressure
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        uids = {"mono": [eng.submit(A, A) for _ in range(3)],
                "scircuit": [eng.submit(S, S) for _ in range(2)]}
        results = eng.drain(window=2, drain_ordered=ordered)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        tpeak = torch.cuda.max_memory_allocated()
        label = "ordered" if ordered else "window 2"
        require(arena.peak_bytes <= cap, f"drain ({label}): arena peak "
                f"{arena.peak_bytes} B over the cap {cap} B")
        require(eng.stats.arena_pressure > pressure,
                f"drain ({label}) met no pressure")
        require(arena.bytes_in_use == 0, f"drain ({label}) left "
                f"{arena.bytes_in_use} B in use")
        for uid in uids["mono"]:
            compare_csr(f"drain ({label}) request {uid} vs the slice's C",
                        results[uid].C, C_mono)
        for uid in uids["scircuit"]:
            scipy_check(S, results[uid].C)
        del results
        drains[label] = dict(wall_ms=wall, peak_bytes=tpeak,
                             arena_peak_bytes=arena.peak_bytes,
                             pressure=eng.stats.arena_pressure - pressure)
        log(f"governor drain ({label}) of 3 x mono_500Hz + 2 x scircuit "
            f"under a one-lease cap ({cap} B): wall {wall:.1f} ms, torch "
            f"peak {tpeak / 2**30:.2f} GiB, arena peak {arena.peak_bytes} "
            f"B <= cap, {eng.stats.arena_pressure - pressure} pressure "
            f"events; every C equal (mono) / scipy (scircuit): ok")
    out["drain"] = dict(cap_bytes=cap, **drains)
    del eng
    arena.reclaim()
    torch.cuda.empty_cache()

    # -- 4. injected faults on scircuit ---------------------------------------
    faults = {}
    for method in ("esc", "hash"):
        fcfg = SpgemmConfig(method=method)
        clean = SpgemmEngine(fcfg, arena=Arena())
        clean.execute(S, S)
        ref = clean.execute(S, S)          # the fault-free steady result
        scipy_check(S, ref.C)

        def check(r, what):
            if method == "esc":
                require(_csr_bitwise(r.C, ref.C),
                        f"{what} on esc is not bitwise equal to the "
                        f"fault-free run")
                return True
            compare_csr(f"{what} on hash", r.C, ref.C)
            return _csr_bitwise(r.C, ref.C)

        f = {}
        if method == "esc":
            fp = FaultPlan([FaultSpec("lease_denial", at=(2, 3))])
            eng = SpgemmEngine(fcfg, arena=Arena(), faults=fp)
            eng.execute(S, S)
            eng.execute(S, S)              # lease_denial visit 0
            for _ in range(3):
                eng.submit(S, S)
            results = eng.drain()
            require(len(results) == 3 and eng.stats.faults_injected == 2
                    and fp.injected["lease_denial"] == 2,
                    f"lease_denial: {len(results)} results, "
                    f"{eng.stats.faults_injected} injected")
            f["lease_denial_bitwise"] = all(
                check(r, "lease_denial recovery") for r in results.values())
            f["lease_denial_pressure"] = eng.stats.arena_pressure
        fp = FaultPlan([FaultSpec("verify_overflow", at=(0,))])
        eng = SpgemmEngine(fcfg, arena=Arena(), faults=fp)
        eng.execute(S, S)
        grows = eng.stats.capacity_grows
        r1 = eng.execute(S, S)
        require(eng.stats.capacity_grows > grows
                and fp.injected["verify_overflow"] == 1,
                f"verify_overflow ({method}) did not redo: {eng.stats}")
        grows = eng.stats.capacity_grows
        r2 = eng.execute(S, S)
        require(eng.stats.capacity_grows == grows,
                f"the call after verify_overflow ({method}) was not clean")
        f["verify_overflow_bitwise"] = (check(r1, "verify_overflow redo")
                                        and check(r2, "the next call"))
        fp = FaultPlan([FaultSpec("executor_raise", at=(0,),
                                  message="poisoned")])
        eng = SpgemmEngine(fcfg, arena=Arena(), faults=fp)
        try:
            eng.execute(S, S)
            raised = None
        except InjectedFault as exc:
            raised = exc
        require(raised is not None and not raised.transient,
                f"executor_raise ({method}): {raised!r}")
        eng.execute(S, S)
        f["executor_raise_bitwise"] = check(eng.execute(S, S),
                                            "the request after executor_raise")
        faults[method] = f
        log(f"governor faults on scircuit ({method}): " + ", ".join(
            f"{k} {v}" for k, v in f.items()) + ("; recovered C bitwise "
            "equal to the fault-free run: ok" if method == "esc" else
            "; rpt/col exact, values within tolerance: ok"))
        del clean, eng, ref
    out["faults"] = faults
    launches = read_launches()
    require(all(launches[k] > 0 for k in ("fused_bin", "symbolic_bin",
                                          "numeric_bin",
                                          "binning_histogram")),
            f"the governed path did not launch every kernel of its own: "
            f"{launches}")
    out["launches"] = launches
    torch.cuda.empty_cache()
    return out


def compare_on_card(what, C, D):
    """C against D, both on the card: rpt/col exact, val within tol
    (compared where they lie: mono's C is 4 GiB)."""
    nz = int(D.rpt[-1])
    require(torch.equal(C.rpt, D.rpt), f"{what}: rpt differs")
    require(torch.equal(C.col[:nz], D.col[:nz]), f"{what}: col differs")
    cv, dv = C.val[:nz], D.val[:nz]
    err = float((cv - dv).abs().max()) if nz else 0.0
    require(torch.allclose(cv, dv, rtol=VAL_RTOL, atol=VAL_ATOL),
            f"{what}: values differ by up to {err:.3e}")
    return err


def dispatch_syncs_nothing(eng, A, what):
    """One steady dispatch under torch's sync debug mode "error" (any host
    sync raises), then its finalize outside it."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        rec = eng.dispatch(A, A)
    except RuntimeError as exc:
        raise SmokeError(f"{what}: the steady dispatch synced the host: "
                         f"{str(exc).splitlines()[0]}") from exc
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return eng.finalize(rec)


def check_prometheus(text, names):
    """Every sample line of ``text`` is ``name{labels} value`` under one
    ``# TYPE`` header of its metric; each of ``names`` has a sample."""
    typed, seen = set(), set()
    for line in text.strip().splitlines():
        if line.startswith("# TYPE "):
            parts = line.split()
            require(len(parts) == 4 and parts[2] not in typed
                    and parts[3] in ("counter", "gauge", "histogram"),
                    f"prometheus: bad TYPE line {line!r}")
            typed.add(parts[2])
            continue
        sample, _, value = line.rpartition(" ")
        try:
            float(value)
        except ValueError:
            raise SmokeError(f"prometheus: bad value in {line!r}")
        base = sample.split("{")[0]
        require(("{" not in sample or sample.endswith("}"))
                and any(base == n or base.startswith(n + "_")
                        for n in typed),
                f"prometheus: sample without its TYPE header: {line!r}")
        seen.add(base)
    missing = [n for n in names if n not in seen]
    require(not missing, f"prometheus: no sample of {missing}")
    return len(typed)


def shard_key(eng, A, s, n):
    """The plan key of shard s's sub-plan in a shards=n engine on A·A."""
    from repro_torch.engine import MatrixSig
    parent = eng.cache.peek((MatrixSig.of(A), MatrixSig.of(A),
                             dataclasses.replace(eng.config, shards=n)))
    spec = parent.plan.shard_spec
    sig = MatrixSig(spec.row_buckets[s], A.ncols, spec.cap_buckets[s],
                    MatrixSig.of(A).dtype)
    return (sig, MatrixSig.of(A), eng.config)


def phase_sharded(A, C_mono, S, unsharded_plan, slice_stats):
    """Row-block sharding on the one card: mono_500Hz at shards = 2 and
    4, a host-sync check, a sharded drain, AUTO_SHARDS, and the sharded
    engine's Chrome trace and Prometheus text."""
    import tempfile
    from repro_torch import SpgemmConfig
    from repro_torch.core.analysis import row_flops
    from repro_torch.engine import (AdaptivePolicy, Arena, MatrixSig,
                                    SpgemmEngine, default_arena,
                                    prometheus_text, reset_default_engine,
                                    validate_chrome_trace)
    cfg = SpgemmConfig(method="hash")
    # Earlier phases' engines and leases go; the slice's C stays (the
    # reference every sharded C is held to).  An engine in a reference
    # cycle frees its device memory only when the collector runs.
    reset_default_engine()
    default_arena().reclaim()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out = {}
    flops = row_flops(A, A)
    total_flops, max_row = int(flops.sum()), int(flops.max())
    unsharded_fall = unsharded_plan.hash_schedule.fall_prod_bucket
    per_call_unsharded = {
        k: slice_stats["steady_launches"][k] / STEADY_CALLS
        for k in ("fused_bin", "binning_histogram")}
    reset_launches()          # this path's counts, read at its end

    for n in (2, 4):
        arena = Arena()
        eng = SpgemmEngine(cfg, shards=n, arena=arena, telemetry=True)
        key = (MatrixSig.of(A), MatrixSig.of(A),
               SpgemmConfig(method="hash", shards=n))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        before = read_launches()
        res, cold_ms = time_host(lambda: eng.execute(A, A))
        cold_launches = {k: v - before[k] for k, v in read_launches().items()}
        err_cold = compare_on_card(f"shards={n} cold C vs the slice's C",
                                   res.C, C_mono)
        cap = res.C.capacity
        del res
        # Each shard's sub-plan as the cold call left it (the steady calls
        # may trim it: every shard's finalize is one admitted call of it).
        cold_buckets = [eng.cache.peek(shard_key(eng, A, s, n))
                        .plan.hash_schedule.fall_prod_bucket
                        for s in range(n)]
        steady_ms, return_ms, observed_ms = [], [], []
        hist = eng.telemetry.registry.get("opsparse_request_latency_seconds")
        eng.flush_latencies(wait=True)        # the cold request's
        before = read_launches()
        for _ in range(STEADY_CALLS):
            # The request-latency histogram observes a sharded request
            # once the event after its merge has completed: the latency
            # includes the merge, as the synchronized wall time does.
            seen, count = hist.sum, hist.count
            res, ret, ms = return_and_sync_ms(lambda: eng.execute(A, A))
            eng.flush_latencies()
            require(hist.count == count + 1,
                    f"shards={n}: the request histogram observed "
                    f"{hist.count - count} requests after a synchronize")
            steady_ms.append(ms)
            return_ms.append(ret)
            observed_ms.append((hist.sum - seen) * 1e3)
        launches = {k: v - before[k] for k, v in read_launches().items()}
        require(all(r < o <= w + 1.0 for r, o, w in
                    zip(return_ms, observed_ms, steady_ms)),
                f"shards={n}: observed request latencies {observed_ms} ms "
                f"do not lie between the return {return_ms} and the "
                f"synchronized wall time {steady_ms}")
        peak = torch.cuda.max_memory_allocated()
        err = compare_on_card(f"shards={n} steady C vs the slice's C",
                              res.C, C_mono)
        require(res.total_nnz == int(C_mono.rpt[-1]),
                f"shards={n}: total_nnz {res.total_nnz}")
        del res
        parent = eng.cache.peek(key)
        spec = parent.plan.shard_spec
        require(spec is not None and spec.n_shards == n,
                f"shards={n}: parent plan's spec {spec}")
        shares = [int(flops[spec.bounds[s]:spec.bounds[s + 1]].sum())
                  for s in range(n)]
        require(max(shares) <= total_flops / n + max_row,
                f"shards={n}: shard flops {shares} exceed total/N + the "
                f"largest row ({total_flops / n + max_row:.0f})")
        subs = {}
        for s in range(n):
            sub = eng.cache.peek(shard_key(eng, A, s, n))
            require(sub is not None and sub.plan.is_specialized,
                    f"shards={n}: shard {s} has no specialized sub-plan")
            subs[s] = sub
        distinct = {id(e): e for e in subs.values()}
        buckets = [subs[s].plan.hash_schedule.fall_prod_bucket
                   for s in range(n)]
        fused_per_call = launches["fused_bin"] / STEADY_CALLS
        require(launches["fused_bin"] > 0
                and cold_launches["symbolic_bin"] > 0
                and cold_launches["numeric_bin"] > 0,
                f"shards={n}: the sharded path did not launch its kernels: "
                f"cold {cold_launches}, steady {launches}")
        require(launches["symbolic_bin"] == 0 and launches["numeric_bin"] == 0,
                f"shards={n}: steady calls ran the two-pass kernels: "
                f"{launches}")
        spans = [s for s in eng.telemetry.finished_spans()
                 if s["name"] == "shard_merge"]
        merge_span_ms = [s["dur"] * 1e3 for s in spans]

        # The merge's device time: one more steady request whose shards
        # are finalized here, then the merge alone under CUDA events.
        rec = eng.dispatch(A, A)
        parts = tuple(eng.finalize(r).C for r in rec.shard_recs)
        merge = parent.executable
        merge_ms = time_cuda(lambda: merge(parts), 3)
        merged = merge(parts)
        compare_on_card(f"shards={n} merge alone vs the slice's C", merged,
                        C_mono)
        eng.telemetry.end_span(rec.span)
        del rec, parts, merged

        row = dict(
            bounds=list(spec.bounds), row_buckets=list(spec.row_buckets),
            cap_buckets=list(spec.cap_buckets), flop_shares=shares,
            flop_share_bound=total_flops / n + max_row,
            distinct_sub_plans=len(distinct),
            cold_fall_prod_buckets=cold_buckets,
            fall_prod_buckets=buckets, fall_prod_bucket_sum=sum(buckets),
            unsharded_fall_prod_bucket=unsharded_fall,
            schedule_trims=eng.stats.schedule_trims,
            sub_plan_schedules=sorted({str(e.plan.hash_schedule)
                                       for e in distinct.values()}),
            sub_plan_nnz_buckets=[subs[s].plan.nnz_bucket
                                  for s in range(n)],
            merged_capacity=cap, cold_ms=cold_ms, steady_ms=steady_ms,
            steady_median_ms=statistics.median(steady_ms),
            merge_span_ms=merge_span_ms, merge_device_ms=merge_ms,
            return_ms=return_ms, observed_latency_ms=observed_ms,
            peak_bytes=peak, held_bytes=held, cold_launches=cold_launches,
            steady_launches=launches,
            fused_bin_per_steady_call=fused_per_call,
            binning_histogram_per_steady_call=(
                launches["binning_histogram"] / STEADY_CALLS),
            unsharded_per_steady_call=per_call_unsharded,
            capacity_grows=eng.stats.capacity_grows,
            shard_grows=eng.stats.shard_grows,
            max_abs_err=max(err, err_cold))
        log(f"sharded mono_500Hz shards={n}: bounds {spec.bounds}, row "
            f"buckets {spec.row_buckets}, cap buckets {spec.cap_buckets}; "
            f"flop shares {[round(x / total_flops, 4) for x in shares]} "
            f"(largest {max(shares)} <= total/N + largest row "
            f"{total_flops / n + max_row:.0f}); {len(distinct)} distinct "
            f"sub-plan(s); fall_prod_bucket per shard after the cold call "
            f"{cold_buckets}, sum {sum(cold_buckets)}, after the steady "
            f"calls {buckets}, sum {sum(buckets)} ({eng.stats.schedule_trims}"
            f" schedule trims; unsharded {unsharded_fall}); merged capacity "
            f"{cap}; sub-plan schedule(s) {row['sub_plan_schedules']}")
        log(f"  cold {cold_ms:.1f} ms, steady median "
            f"{statistics.median(steady_ms):.1f} ms "
            f"{['%.1f' % x for x in steady_ms]} (unsharded "
            f"{slice_stats['steady_median_ms']:.1f}, cold "
            f"{slice_stats['cold_ms']:.1f}); request latency observed "
            f"{['%.1f' % x for x in observed_ms]} ms (return "
            f"{['%.1f' % x for x in return_ms]}, synchronized "
            f"{['%.1f' % x for x in steady_ms]}); shard_merge span "
            f"{['%.2f' % x for x in merge_span_ms]} ms (host), the merge "
            f"on the card {merge_ms:.2f} ms; peak {peak / 2**30:.2f} GiB "
            f"({held / 2**30:.2f} held before, the slice's C among it); "
            f"launches per steady call fused_bin {fused_per_call:g} "
            f"(unsharded {per_call_unsharded['fused_bin']:g}), "
            f"binning_histogram {row['binning_histogram_per_steady_call']:g}"
            f"; cold launches {cold_launches}; C equal, values within "
            f"{row['max_abs_err']:.3e}: ok")
        out[f"shards_{n}"] = row
        if n == 4:
            res = dispatch_syncs_nothing(eng, A, "shards=4")
            compare_on_card("shards=4 sync-checked call vs the slice's C",
                            res.C, C_mono)
            del res
            prof = profile_steady(lambda: eng.execute(A, A))
            log(f"  profile of one shards=4 steady call: wall "
                f"{prof['wall_ms']:.1f} ms, device busy "
                f"{prof['device_busy_ms']:.1f} ms, idle share "
                f"{prof['device_idle_share']:.3f}, ranges " + ", ".join(
                    f"{k} {v:.1f} ms" for k, v in
                    prof["range_device_ms"].items()))
            out["shards_4"]["profile"] = prof
            log("  shards=4 steady dispatch under sync debug mode "
                "'error': 0 host syncs: ok")
        del eng, parent, subs, distinct
        arena.reclaim()
        torch.cuda.empty_cache()

    # -- a drain of 2 x mono + 2 x scircuit on a shards=2 engine --------------
    eng = SpgemmEngine(cfg, shards=2, arena=Arena(), telemetry=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    uids = {"mono": [eng.submit(A, A) for _ in range(2)],
            "scircuit": [eng.submit(S, S) for _ in range(2)]}
    results = eng.drain(window=2)
    torch.cuda.synchronize()
    drain_ms = (time.perf_counter() - t0) * 1e3
    dpeak = torch.cuda.max_memory_allocated()
    eng.flush_latencies()        # the merges are done: observe them
    for uid in uids["mono"]:
        compare_on_card(f"sharded drain request {uid} vs the slice's C",
                        results[uid].C, C_mono)
    s_ref = [scipy_check(S, results[uid].C) for uid in uids["scircuit"]]
    del results
    st = eng.stats
    hist = eng.telemetry.registry.get("opsparse_request_latency_seconds")
    require(st.sharded_requests == 4 and st.shard_grows == 0
            and st.requests == 4 and hist.count == 4,
            f"sharded drain: {st.sharded_requests} sharded requests, "
            f"{st.shard_grows} shard grows, {st.requests} requests, "
            f"{hist.count} request latencies")
    log(f"sharded drain (shards=2, window 2) of 2 x mono_500Hz + 2 x "
        f"scircuit: wall {drain_ms:.1f} ms, peak {dpeak / 2**30:.2f} GiB; "
        f"4 sharded requests, 0 shard grows, 4 request latencies; C equal "
        f"(mono) / scipy (scircuit): ok")

    # -- telemetry of the sharded engine --------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "sharded_trace.json"
        payload = eng.telemetry.export_chrome_trace(path)
        n_events = validate_chrome_trace(path)
    names = {e["name"] for e in payload["traceEvents"]}
    require({"partition", "shard", "verify_slices", "shard_merge"} <= names,
            f"sharded trace lacks sharding spans: {sorted(names)}")
    text = prometheus_text(eng)
    n_types = check_prometheus(text, (
        "opsparse_engine_sharded_requests_total",
        "opsparse_engine_shard_grows_total",
        "opsparse_engine_auto_requests_total",
        "opsparse_engine_policy_revisions_total",
        "opsparse_arena_bytes_in_use", "opsparse_arena_bytes_reserved",
        "opsparse_arena_peak_bytes", "opsparse_plan_calls_total"))
    require("opsparse_engine_sharded_requests_total 4" in text,
            "prometheus: the sharded counter is not 4")
    log(f"sharded telemetry: Chrome trace of {n_events} events validates "
        f"(partition, shard, verify_slices, shard_merge spans); Prometheus "
        f"text of {len(text.splitlines())} lines under {n_types} TYPE "
        f"headers parses, with the sharding counters and the arena gauges: "
        f"ok")
    out["drain"] = dict(wall_ms=drain_ms, peak_bytes=dpeak, scircuit=s_ref,
                        trace_events=n_events,
                        prometheus_lines=len(text.splitlines()))
    del eng
    torch.cuda.empty_cache()

    # -- AUTO_SHARDS ----------------------------------------------------------
    auto = {}
    for label, policy in (("default", AdaptivePolicy()),
                          ("max_shards=4", AdaptivePolicy(max_shards=4))):
        eng = SpgemmEngine(cfg, shards="auto", policy=policy, arena=Arena())
        res, cold_ms = time_host(lambda: eng.execute(A, A))
        del res
        res, steady_ms = time_host(lambda: eng.execute(A, A))
        err = compare_on_card(f"AUTO ({label}) C vs the slice's C", res.C,
                              C_mono)
        del res
        akey = (MatrixSig.of(A), MatrixSig.of(A),
                SpgemmConfig(method="hash", shards=0))
        state = eng.cache.peek(akey).plan.policy
        st = eng.stats
        if label == "default":
            require(state.shard_decision == 1 and st.sharded_requests == 0,
                    f"AUTO on one card chose {state.shard_decision} shards "
                    f"({st.sharded_requests} sharded requests)")
        else:
            require(state.shard_decision > 1
                    and st.sharded_requests == st.auto_requests == 2,
                    f"AUTO (max_shards=4) chose {state.shard_decision}, "
                    f"{st.sharded_requests} sharded of {st.auto_requests}")
        auto[label] = dict(decision=state.shard_decision,
                           basis_flops=state.shard_basis,
                           devices=torch.cuda.device_count(),
                           sharded_requests=st.sharded_requests,
                           auto_requests=st.auto_requests, cold_ms=cold_ms,
                           steady_ms=steady_ms, max_abs_err=err)
        log(f"AUTO_SHARDS ({label} policy): decision "
            f"{state.shard_decision} from {state.shard_basis} flops on "
            f"{torch.cuda.device_count()} card(s), {st.sharded_requests} of "
            f"{st.auto_requests} requests sharded; cold {cold_ms:.1f} ms, "
            f"steady {steady_ms:.1f} ms; C equal: ok")
        del eng
        torch.cuda.empty_cache()
    out["auto"] = auto
    launches = read_launches()
    require(all(launches[k] > 0 for k in ("fused_bin", "symbolic_bin",
                                          "numeric_bin")),
            f"the sharded path did not launch every kernel of its own: "
            f"{launches}")
    out["launches"] = launches
    log(f"phase sharded launches: {launches}")
    return out


# ---------------------------------------------------------------------------
# The multi-tenant service (repro_torch.serve).
# ---------------------------------------------------------------------------

SERVICE_REQUESTS = 16
# The chaos stream's FaultPlan seed.  On the hash method the scircuit
# analogs lease nothing (no fallback rows), so only verify_overflow draws
# from the plan's coin; seed 0's first 14 draws all miss p = 0.15 and the
# gate would be inert, seed 1's hit 4 times.
SERVICE_SEED = 1


def service_stream(S):
    """A_s·A_s for the scircuit analogs of seeds crc32("scircuit") + s,
    s < SERVICE_REQUESTS (s = 0 is S), padded to one capacity bucket;
    built on the host in worker processes."""
    from benchmarks.torch.matrices import BY_NAME, from_host, host_arrays, pool
    from repro_torch.core import next_bucket
    spec = BY_NAME[SCIRCUIT["name"]]
    t0 = time.perf_counter()
    with pool(min(SERVICE_REQUESTS - 1, 7)) as ex:
        futures = [ex.submit(host_arrays, spec, 1, s)
                   for s in range(1, SERVICE_REQUESTS)]
        mats = [S] + [from_host(f.result(), "cuda") for f in futures]
    cap = next_bucket(max(M.capacity for M in mats))
    stream = [(M.with_capacity(cap), M.with_capacity(cap)) for M in mats]
    log(f"service stream: {len(stream)} scircuit analogs (seeds crc32 + "
        f"0..{SERVICE_REQUESTS - 1}), nnz {min(int(M.nnz()) for M in mats)}"
        f"..{max(int(M.nnz()) for M in mats)}, padded to capacity {cap}, "
        f"built in {time.perf_counter() - t0:.1f} s")
    return stream


def return_and_sync_ms(fn):
    """(fn(), ms when fn returns, ms after a synchronize): what the host
    clock reads with and without the device work still in flight."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    t_ret = time.perf_counter()
    torch.cuda.synchronize()
    return out, (t_ret - t0) * 1e3, (time.perf_counter() - t0) * 1e3


def _p99(lats):
    return sorted(lats)[min(len(lats) - 1, int(0.99 * len(lats)))]


def _values_differing(C, D):
    nz = int(D.rpt[-1])
    return int((C.val[:nz] != D.val[:nz]).sum())


def chaos_plan(seed):
    """The reference's chaos FaultPlan (bench_engine.py's serve gate)."""
    from repro_torch.core.faults import FaultPlan, FaultSpec
    return FaultPlan([
        FaultSpec(site="lease_denial", at=(5, 6)),
        FaultSpec(site="lease_denial", probability=0.25),
        FaultSpec(site="verify_overflow", probability=0.15),
    ], seed=seed)


def service_fixed_order(run_service, cfg, default_lats):
    """The hash service stream, clean and under chaos, in the fixed-order
    mode (torch.use_deterministic_algorithms(True)): every chaos C bitwise
    equal to its clean twin, and the mode's cost per request beside the
    default mode's clean run."""
    with fixed_order():
        _, clean, clean_lats = run_service(cfg)
        plan = chaos_plan(SERVICE_SEED)
        svc, chaos, chaos_lats = run_service(cfg, plan)
        svc.close()
    require(all(r.ok for r in clean + chaos),
            f"fixed-order service stream: {[r.status for r in chaos]}")
    for i, (r, c) in enumerate(zip(chaos, clean)):
        require(_csr_bitwise(r.value.C, c.value.C),
                f"fixed-order chaos request {i}: C not bitwise equal to "
                f"its clean twin")
    require(plan.total_injected > 0, "fixed-order chaos: no fault injected")
    out = dict(clean_ms=[x * 1e3 for x in clean_lats],
               chaos_ms=[x * 1e3 for x in chaos_lats],
               injected=plan.snapshot()["injected"],
               median_ms=statistics.median(clean_lats) * 1e3,
               default_median_ms=statistics.median(default_lats) * 1e3)
    log(f"service 1 (hash, fixed order): {len(clean)} requests, clean and "
        f"under chaos ({plan.total_injected} faults injected), every chaos "
        f"C bitwise equal to its clean twin; median request "
        f"{out['median_ms']:.2f} ms vs {out['default_median_ms']:.2f} ms "
        f"in the default mode (the first request is the cold call): ok")
    return out


def phase_service(A, C_mono, S):
    """The SpGEMM service on the card (the reference's serve gate at full
    size): a 16-request scircuit stream over two tenants, clean and under
    chaos, for the hash method and ESC; structured failures; every service
    rung on mono_500Hz; two tenant threads at once; deadline admission of
    a mono_500Hz request; /metrics over loopback; the service's own cost
    beside engine.execute."""
    import threading
    import urllib.request
    from repro_torch import SpgemmConfig
    from repro_torch.core.faults import FaultPlan, FaultSpec
    from repro_torch.engine import (Arena, MemoryGovernor, default_arena,
                                    reset_default_engine)
    from repro_torch.serve import SpgemmService
    reset_default_engine()
    default_arena().reclaim()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out = {}
    stream = service_stream(S)
    tenants = ("alpha", "beta")
    assign = [tenants[i % 2] for i in range(len(stream))]
    reset_launches()          # this path's counts, read at its end

    def run_service(cfg, faults=None):
        svc = SpgemmService(cfg, arena=Arena(), faults=faults,
                            backoff_base_s=1e-3, backoff_cap_s=0.05)
        outs, lats = [], []
        for (X, Y), ten in zip(stream, assign):
            t0 = time.perf_counter()
            r = svc.call(X, Y, tenant=ten, deadline_s=60.0)
            torch.cuda.synchronize()        # C's writes inside the clock
            lats.append(time.perf_counter() - t0)
            outs.append(r)
        return svc, outs, lats

    for method in ("hash", "esc"):
        cfg = SpgemmConfig(method=method)
        res = {}
        bitwise = method == "esc"

        def same(r, ref, what):
            if bitwise:
                require(_csr_bitwise(r.value.C, ref.value.C),
                        f"{what} ({method}): C not bitwise equal")
                return 0
            compare_on_card(f"{what} ({method})", r.value.C, ref.value.C)
            return _values_differing(r.value.C, ref.value.C)

        # -- 1. clean stream, then the chaos stream ---------------------------
        svc_clean, clean, clean_lats = run_service(cfg)
        require(all(r.ok for r in clean),
                f"clean stream ({method}): {[r.status for r in clean]}")
        scipy_check(stream[0][0], clean[0].value.C)
        svc_clean.close()
        plan = chaos_plan(SERVICE_SEED)
        svc, chaos, chaos_lats = run_service(cfg, plan)
        failed = [i for i, r in enumerate(chaos) if not r.ok]
        require(not failed, f"chaos stream ({method}): failed requests "
                f"{failed}: {[chaos[i].error for i in failed]}")
        differing = sum(same(r, c, f"chaos request {i} vs clean")
                        for i, (r, c) in enumerate(zip(chaos, clean)))
        injected = plan.total_injected
        p99_clean, p99_chaos = _p99(clean_lats), _p99(chaos_lats)
        bound = max(5.0 * p99_clean, 0.5)
        require(p99_chaos <= bound, f"chaos p99 ({method}) {p99_chaos:.3f} s "
                f"over its bound {bound:.3f} s")
        require(injected > 0, f"chaos stream ({method}): no fault injected")
        res["stream"] = dict(
            injected=plan.snapshot()["injected"],
            retries=sum(r.retries for r in chaos),
            survived=sum(r.faults_survived for r in chaos),
            clean_ms=[x * 1e3 for x in clean_lats],
            chaos_ms=[x * 1e3 for x in chaos_lats],
            p99_clean_ms=p99_clean * 1e3, p99_chaos_ms=p99_chaos * 1e3,
            values_differing=differing)
        log(f"service 1 ({method}): {len(stream)} requests over "
            f"{len(tenants)} tenants, 0 failed; {injected} faults injected "
            f"({plan.snapshot()['injected']}), {res['stream']['retries']} "
            f"retries, {res['stream']['survived']} survived; chaos vs clean "
            + ("bitwise" if bitwise else "rpt/col exact, values within "
               f"tolerance, {differing} values not bitwise equal")
            + f"; p99 {p99_chaos * 1e3:.1f} ms chaos vs {p99_clean * 1e3:.1f} "
            f"ms clean (bound {bound * 1e3:.0f} ms): ok")
        if method == "hash":
            res["fixed_order"] = service_fixed_order(run_service, cfg,
                                                     clean_lats)

        # -- 6. /metrics over loopback (the chaos service) --------------------
        server = svc.serve_http()
        try:
            body = urllib.request.urlopen(server.url,
                                          timeout=10).read().decode()
            health = urllib.request.urlopen(
                server.url.replace("/metrics", "/healthz"),
                timeout=10).read()
        finally:
            svc.close()
        series = [f'{name}{{tenant="{t}"}}' for t in tenants for name in (
            "opsparse_service_requests_total",
            "opsparse_service_retries_total",
            "opsparse_service_timeouts_total",
            "opsparse_service_sheds_total",
            "opsparse_service_spills_total",
            "opsparse_service_rejected_total",
            "opsparse_service_errors_total",
            "opsparse_service_faults_survived_total",
            "opsparse_engine_faults_injected_total")]
        missing = [s for s in series if s + " " not in body]
        require(health == b"ok\n" and not missing,
                f"/metrics ({method}): health {health!r}, missing {missing}")
        n_types = check_prometheus(body, ["opsparse_service_tenants"])
        res["scrape"] = dict(bytes=len(body), metrics=n_types)
        log(f"service 6 ({method}): GET {server.url}: {len(body)} B, "
            f"{n_types} metrics, every per-tenant opsparse_service_* series "
            f"and opsparse_engine_faults_injected_total present; /healthz "
            f"ok")
        del svc, chaos

        # -- 2. structured failures -------------------------------------------
        X0, Y0 = stream[0]
        svc_p = SpgemmService(cfg, arena=Arena(), faults=FaultPlan(
            [FaultSpec(site="executor_raise", at=(0,),
                       message="poisoned")]))
        r_p = svc_p.call(X0, Y0, tenant="alpha")
        require(r_p.status == "error" and r_p.retries == 0
                and "poisoned" in r_p.error,
                f"poisoned request ({method}): {r_p}")
        slow = FaultPlan([FaultSpec(site="slow_dispatch", at=(1,),
                                    delay_s=0.3)])
        svc_s = SpgemmService(cfg, arena=Arena(), faults=slow)
        svc_s.call(X0, Y0, tenant="alpha")       # warm: latency history
        r_s = svc_s.call(X0, Y0, tenant="alpha", deadline_s=0.05)
        require(r_s.status == "timeout" and r_s.value is None,
                f"stalled request ({method}): {r_s.status}")
        res["structured"] = dict(poison=r_p.status, poison_retries=r_p.retries,
                                 slow=r_s.status, slow_error=r_s.error,
                                 stalls=slow.injected["slow_dispatch"])
        log(f"service 2 ({method}): poisoned request -> {r_p.status} after "
            f"{r_p.retries} retries; 0.3 s stall under a 0.05 s deadline -> "
            f"{r_s.status} with no value ({r_s.error}; "
            f"{slow.injected['slow_dispatch']} stall injected): ok")
        del svc_p, svc_s

        # -- 4. two tenant threads at once ------------------------------------
        svc_t = SpgemmService(cfg, arena=Arena())
        got = {t: [] for t in tenants}
        errors = []

        def tenant_loop(t):
            try:
                for X, Y in stream:
                    r = svc_t.call(X, Y, tenant=t)
                    got[t].append(r)
            except Exception as exc:  # noqa: BLE001 — reported below
                errors.append(f"{t}: {type(exc).__name__}: {exc}")

        threads = [threading.Thread(target=tenant_loop, args=(t,))
                   for t in tenants]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        require(not errors and not any(th.is_alive() for th in threads),
                f"tenant threads ({method}): {errors}")
        require(all(len(got[t]) == len(stream) and all(r.ok for r in got[t])
                    for t in tenants),
                f"tenant threads ({method}): "
                f"{ {t: [r.status for r in got[t]] for t in tenants} }")
        differing_t = sum(same(r, c, f"thread {t} request {i}")
                          for t in tenants
                          for i, (r, c) in enumerate(zip(got[t], clean)))
        in_use = svc_t.arena.bytes_in_use
        require(in_use == 0, f"tenant threads ({method}): {in_use} B of the "
                f"arena still in use")
        serial = sum(clean_lats) * 1e3
        res["threads"] = dict(wall_ms=wall, values_differing=differing_t,
                              clean_stream_ms=serial,
                              lease_hits=svc_t.arena.lease_hits,
                              lease_misses=svc_t.arena.lease_misses)
        log(f"service 4 ({method}): 2 tenant threads x {len(stream)} "
            f"requests in {wall:.1f} ms (the clean stream, {len(stream)} "
            f"requests in one thread: {serial:.1f} ms), every C equal to "
            f"the single-thread "
            + ("one bitwise" if bitwise else f"one ({differing_t} values not "
               "bitwise equal)")
            + f", arena 0 B in use ({svc_t.arena.lease_hits} lease hits, "
            f"{svc_t.arena.lease_misses} misses), no exception: ok")
        del svc_t, got, clean
        gc.collect()
        torch.cuda.empty_cache()
        out[method] = res

    cfg = SpgemmConfig(method="hash")
    X0, Y0 = stream[0]
    # -- 3. every service rung on mono_500Hz ------------------------------
    # The governor's own trim and spill would absorb a denial inside the
    # engine; off, a denied lease reaches the service's ladder.
    gov = MemoryGovernor(trim_under_pressure=False, spill_fused=False)
    cfg2 = SpgemmConfig(method="hash", shards=2)

    def rung_service(faults):
        svc = SpgemmService(cfg2, arena=Arena(), governor=gov,
                            faults=faults, backoff_base_s=1e-3)
        for c in (cfg2, cfg):                # cold, then steady, each
            for _ in range(2):
                r = svc.call(A, A, tenant="delta", config=c)
                require(r.ok, f"rung warm-up {c}: {r.status} {r.error}")
        return svc

    probe = FaultPlan([FaultSpec(site="lease_denial", at=())])
    svc = rung_service(probe)
    v0 = probe.visits["lease_denial"]
    # What latency reads on a sharded call: the merge is enqueued after
    # the shards' finalize reads, so it may run past the return.
    _, sharded_ret, sharded_sync = return_and_sync_ms(
        lambda: svc.call(A, A, tenant="delta"))
    log(f"service latency, hash shards=2 steady on mono_500Hz: "
        f"{sharded_ret:.1f} ms at return, {sharded_sync:.1f} ms after a "
        f"synchronize")
    del svc
    gc.collect()
    plan = FaultPlan([FaultSpec(site="lease_denial",
                                at=tuple(range(v0, v0 + 16)))])
    svc = rung_service(plan)
    r, ms = time_host(lambda: svc.call(A, A, tenant="delta"))
    require(r.ok and r.degraded == "spill_two_pass",
            f"service ladder: {r.status} degraded {r.degraded} ({r.error})")
    err = compare_on_card("spill_two_pass C vs the slice's C", r.value.C,
                          C_mono)
    text = svc.prometheus_text()
    counters = {name: int(float(line.rpartition(" ")[2]))
                for line in text.splitlines()
                for name in ("opsparse_service_sheds_total",
                             "opsparse_service_spills_total",
                             "opsparse_service_retries_total")
                if line.startswith(name + '{tenant="delta"}')}
    require(counters.get("opsparse_service_sheds_total") == 1
            and counters.get("opsparse_service_spills_total") == 1,
            f"service ladder counters: {counters}")
    out["rungs"] = dict(visits_before=v0, retries=r.retries,
                        sharded_return_ms=sharded_ret,
                        sharded_sync_ms=sharded_sync,
                        faults_survived=r.faults_survived, ms=ms,
                        counters=counters, max_abs_err=err)
    log(f"service 3: hash shards=2 on mono_500Hz, lease denials from "
        f"visit {v0}: ok after {r.retries} retries through reclaim, "
        f"shed_shards, spill_two_pass ({r.faults_survived} faults "
        f"survived, {ms:.1f} ms), counters {counters}; C equal to the "
        f"slice's (max |diff| {err:.3e}): ok")
    del svc, r
    gc.collect()
    torch.cuda.empty_cache()

    # -- 5. deadline admission at scale ------------------------------------
    svc = SpgemmService(cfg, arena=Arena())
    calib, calib_ms = time_host(lambda: svc.call(X0, Y0, tenant="gamma"))
    require(calib.ok, f"gamma calibration: {calib.status}")
    eng = svc.engine("gamma")
    s_per_flop = svc._tenants["gamma"].cold_s_per_flop
    mono_flops = svc._flops(A, A)
    predicted = s_per_flop * mono_flops
    requests = eng.stats.requests
    t0 = time.perf_counter()
    r = svc.call(A, A, tenant="gamma", deadline_s=0.1)
    reject_ms = (time.perf_counter() - t0) * 1e3
    require(r.status == "timeout" and "predicted" in (r.error or "")
            and eng.stats.requests == requests,
            f"mono under a 0.1 s deadline: {r.status} ({r.error}), "
            f"{eng.stats.requests - requests} requests dispatched")
    r, measured_ms = time_host(lambda: svc.call(A, A, tenant="gamma"))
    require(r.ok, f"mono with no deadline: {r.status} ({r.error})")
    compare_on_card("gamma's mono C vs the slice's C", r.value.C, C_mono)
    del r
    r, steady_ret, steady_sync = return_and_sync_ms(
        lambda: svc.call(A, A, tenant="gamma"))
    log(f"service latency, hash steady on mono_500Hz: {steady_ret:.1f} ms "
        f"at return, {steady_sync:.1f} ms after a synchronize")
    out["deadline"] = dict(steady_return_ms=steady_ret,
                           steady_sync_ms=steady_sync,
                           cold_s_per_flop=s_per_flop, mono_flops=mono_flops,
                           predicted_ms=predicted * 1e3,
                           measured_ms=measured_ms, reject_ms=reject_ms,
                           calibration_ms=calib_ms)
    log(f"service 5: gamma calibrated on scircuit ({calib_ms:.1f} ms, "
        f"{s_per_flop:.3e} s/flop); mono_500Hz under a 0.1 s deadline -> "
        f"timeout in {reject_ms:.1f} ms with no dispatch, with none -> ok; "
        f"predicted {predicted * 1e3:.1f} ms ({mono_flops} flops) vs "
        f"measured cold {measured_ms:.1f} ms: ok")
    del svc, eng, r
    gc.collect()
    torch.cuda.empty_cache()

    # -- 7. the service's own cost -------------------------------------------
    svc = SpgemmService(cfg, arena=Arena())
    eng = svc.engine("alpha")
    for _ in range(2):                       # cold, then steady
        svc.call(X0, Y0, tenant="alpha")
    via_svc, via_eng = [], []
    for _ in range(20):                      # in turns
        _, ms = time_host(lambda: svc.call(X0, Y0, tenant="alpha"))
        via_svc.append(ms)
        _, ms = time_host(lambda: eng.execute(X0, Y0))
        via_eng.append(ms)
    med_svc, med_eng = statistics.median(via_svc), statistics.median(via_eng)
    out["cost"] = dict(service_ms=via_svc, engine_ms=via_eng,
                       service_median_ms=med_svc, engine_median_ms=med_eng)
    log(f"service 7: steady scircuit call, median of 20: svc.call "
        f"{med_svc:.3f} ms, engine.execute {med_eng:.3f} ms "
        f"(service layer {med_svc - med_eng:+.3f} ms)")
    del svc, eng
    launches = read_launches()
    require(all(launches[k] > 0 for k in ("fused_bin", "symbolic_bin",
                                          "numeric_bin")),
            f"the service path did not launch every kernel of its own: "
            f"{launches}")
    out["launches"] = launches
    log(f"phase service launches: {launches}")
    del stream
    gc.collect()
    torch.cuda.empty_cache()
    return out


# The reference's CI configurations of bench_engine.py (scripts/ci.sh), on
# the port at the reference's default stream (24 requests, 256 x 256 x
# 256, 4 a row), and the hash twins of its ESC gates (not --arena: hash
# plans of this stream lease nothing, and the gate, like the reference's,
# needs every plan to lease).  The hash serve gate takes SERVICE_SEED for
# the same reason.
ENGINE_GATES = (
    ("esc", []),
    ("hash", ["--method", "hash"]),
    ("hash adaptive", ["--method", "hash", "--adaptive"]),
    ("hash fused", ["--method", "hash", "--fused"]),
    ("esc shards 2", ["--shards", "2"]),
    ("esc arena", ["--arena"]),
    ("hash estimate", ["--estimate", "--method", "hash"]),
    ("esc estimate", ["--estimate"]),
    ("esc shards 2 traced", ["--shards", "2", "--trace", "TRACE"]),
    ("esc serve", ["--serve"]),
    ("hash serve", ["--serve", "--method", "hash", "--seed",
                    str(SERVICE_SEED)]),
)
# The vmem_extended table sizes of the two wrappers that build values:
# fused_bin 65,536 (cluster), 262,144 and 1,048,576 (global); numeric_bin
# 32,768 and 131,072 (cluster), 524,288 (global).
FIXED_ORDER_EXTENDED = {"fused_bin": (65536, 262144, 1048576),
                        "numeric_bin": (32768, 131072, 524288)}
FIXED_ORDER_ROWS = 16          # rows of a mono rung held bit for bit


def engine_gates():
    """Every configuration of ENGINE_GATES through bench_engine.run, in
    process on the card; its output goes to chiprun_out/engine_gates.log.
    Correctness gates must hold; timing gates are printed with their
    thresholds."""
    import io
    from benchmarks.torch import bench_engine
    outdir = ROOT / "chiprun_out"
    outdir.mkdir(exist_ok=True)
    traj = outdir / "bench_engine_torch.json"
    traj.unlink(missing_ok=True)     # the adaptive gate reads this run's
    out = {}
    with open(outdir / "engine_gates.log", "w") as logf:
        for name, argv in ENGINE_GATES:
            argv = [str(outdir / "engine_gates_trace.json") if a == "TRACE"
                    else a for a in argv]
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                res = bench_engine.run(["--device", "cuda", "--json",
                                        str(traj)] + argv)
            secs = time.perf_counter() - t0
            logf.write(f"==== {name}: {' '.join(argv)}\n{buf.getvalue()}\n")
            bad = [k for k, v in res["correctness"].items() if not v]
            require(not bad, f"engine gate {name}: {bad} failed "
                    f"(chiprun_out/engine_gates.log)")
            timing = "; ".join(
                f"{k} {v['value']:.4g} (target {v['target']}) "
                f"{'PASS' if v['ok'] else 'MISS'}"
                for k, v in res["timing"].items())
            modes = ", ".join(f"{k}: {v}" for k, v in res["modes"].items())
            log(f"  engine gate {name} ({secs:.1f} s): correctness "
                f"{', '.join(res['correctness'])}: ok"
                + (f"; modes {modes}" if modes else "")
                + (f"; timing {timing}" if timing else ""))
            out[name] = dict(argv=argv, seconds=secs,
                             correctness=res["correctness"],
                             timing=res["timing"], modes=res["modes"],
                             entry=res["entry"])
    return out


def fixed_order_kernels(sh, errs):
    """The fixed-order kernels against their plain versions, bit for bit:
    phase_tiny's ladders (the shared-memory route), then FIXED_ORDER_ROWS'
    eight heaviest rows of that pair on every extended table size (the
    cluster and global routes)."""
    from repro_torch.core import nprod_into_rpt
    with fixed_order():
        A, B = phase_tiny(sh, errs, bitwise=True)
        nprod = nprod_into_rpt(A, B)[:A.nrows]
        rows = torch.argsort(nprod, descending=True)[:8].to(torch.int32)
        count = torch.tensor([8], dtype=torch.int32, device=A.device)
        valid = torch.ones(8, dtype=torch.bool, device=A.device)
        routes = {}
        for kind, sizes in FIXED_ORDER_EXTENDED.items():
            for t_size in sizes:
                before = getattr(sh, kind + "_call").launches_ordered
                k = run_bin(sh, kind, False, A, B, rows, count, t_size, 8)
                torch.cuda.synchronize()
                require(getattr(sh, kind + "_call").launches_ordered
                        == before + 1, f"{kind} t={t_size}: no fixed-order "
                        f"launch")
                p = run_bin(sh, kind, True, A, B, rows, count, t_size, 8)
                route = route_of(sh, kind, t_size)
                errs[kind] = max(errs[kind], compare(
                    f"fixed-order {kind} t={t_size} ({route})", k, p,
                    nprod[rows.long()].long(), valid, bitwise=True))
                routes.setdefault(kind, set()).add(route)
                del k, p
    for kind, seen in routes.items():
        require(seen == {"cluster", "global"},
                f"fixed-order {kind}: extended routes {seen}")
    log("phase fixed-order kernels: fused_bin and numeric_bin on the "
        "shared-memory, cluster and global routes, tables bitwise equal to "
        "the plain versions': ok")
    return {k: sorted(v | {"smem"}) for k, v in routes.items()}


def fixed_order_main_shapes(sh, A, jobs, atomic):
    """The fixed-order fused_bin and numeric_bin at the rungs the main path
    gave the atomic kernels (``jobs``): each rung's time at its full bin
    (CUDA events, the wrapper's launch alone), and FIXED_ORDER_ROWS of its
    rows bitwise against the plain version.  The bound and the plain
    version are the atomic kernels' (the same work)."""
    from repro_torch.core import nprod_into_rpt
    nprod = nprod_into_rpt(A, A)
    out = {}
    with fixed_order():
        for kind in ("fused_bin", "numeric_bin"):
            binning, ladder, buckets = jobs[kind]
            ms, rungs = 0.0, []
            for b, t_size in enumerate(ladder.table_sizes):
                rows_cap = buckets[b]
                if not rows_cap or route_of(sh, kind, t_size) != "smem":
                    continue
                rows, count, valid = bin_inputs(binning, b, rows_cap)
                kms = time_cuda(lambda: bin_call(
                    sh, kind, False, A, A, rows, count, t_size, rows_cap), 3)
                lrows, lcount, lvalid = bin_inputs(binning, b, rows_cap,
                                                   FIXED_ORDER_ROWS)
                k = run_bin(sh, kind, False, A, A, lrows, lcount, t_size,
                            rows_cap)
                p = run_bin(sh, kind, True, A, A, lrows, lcount, t_size,
                            rows_cap)
                compare(f"fixed-order main shape {kind} rung {b}", k, p,
                        nprod[lrows.long()].long().masked_fill(~lvalid, 0),
                        lvalid, bitwise=True)
                del k, p
                ms += kms
                rungs.append(dict(rung=b, t_size=t_size, rows=int(count),
                                  rows_cap=rows_cap, ms=kms))
                log(f"  fixed-order {kind} rung {b} (t={t_size}, rows "
                    f"{int(count)}/{rows_cap}): {kms:.3f} ms (atomic "
                    f"{next(r['ms'] for r in atomic[kind]['rungs'] if r['rung'] == b):.3f}"
                    f" ms); {FIXED_ORDER_ROWS} rows bitwise: ok")
                torch.cuda.empty_cache()
            out[kind] = dict(ms=ms, rungs=rungs,
                             atomic_ms=atomic[kind]["ms"],
                             plain_ms=atomic[kind]["plain_ms"],
                             bound_ms=atomic[kind]["bound_ms"],
                             bound_share=atomic[kind]["bound_ms"] / ms)
            log(f"phase fixed-order main shapes {kind}: {len(rungs)} rungs, "
                f"{ms:.3f} ms against the atomic kernel's "
                f"{atomic[kind]['ms']:.3f} ms, bound "
                f"{atomic[kind]['bound_ms']:.3f} ms: ok")
    return out


def capture_largest(owner, name, call):
    """The arguments of the call of ``owner.<name>`` with the largest
    second argument in ``call()`` (the function is patched on ``owner``
    for the call)."""
    real, seen = getattr(owner, name), []

    def spy(*args, **kw):
        if not seen or args[1].numel() > seen[0][1].numel():
            seen[:] = [args, kw]
        return real(*args, **kw)
    # The wrapper counts its launches on the function its module's global
    # names, which is the spy while it is patched there.
    spy.launches = real.launches
    setattr(owner, name, spy)
    try:
        call()
    finally:
        setattr(owner, name, real)
        if real.__module__ == owner.__name__:
            real.launches = spy.launches
    require(seen, f"no {name} launch in a fixed-order steady call")
    return seen[0], seen[1]


def order_kernel_at_main_shape(name, args, kw):
    """One of the kernels of the port's torch-op code (segment_sum,
    scatter_kept, count_into) at the largest shape a steady mono_500Hz
    call gave it, outside the fixed-order mode: bitwise against its plain
    version, its time, the plain version's, the torch call it replaces
    (the library yardstick) and its bound (the bytes the function needs:
    every index, each kept value or addend read once, each output written
    once)."""
    from repro_torch.kernels import scatter, segment_sum as ss
    if name == "segment_sum":
        (vals, offsets), n_real = args, kw["n_real"]
        n_out = offsets.shape[0] - 1
        kernel = timed = lambda: ss.segment_sum(vals, offsets, n_real=n_real)
        plain = lambda: ss.segment_sum_plain(vals, offsets, n_real=n_real)
        library = lambda: torch.segment_reduce(vals, "sum", offsets=offsets,
                                               unsafe=True)
        cut = n_real
        nbytes = 4 * int(offsets[n_real]) + 8 * (n_real + 1) + 4 * n_out
        shape = f"{int(offsets[n_real])} products in {n_real} segments"
    else:
        (dst, index, src), limit = args, kw["limit"]
        fn = getattr(scatter, name)
        plain_fn = getattr(scatter, name + "_plain")
        fresh = (lambda: dst.clone()) if name == "scatter_kept" else (
            lambda: torch.zeros_like(dst))
        kernel = lambda: fn(fresh(), index, src, limit=limit)
        plain = lambda: plain_fn(fresh(), index, src, limit=limit)
        # Timed in place: a repeated write of the same values, or counts
        # added again, costs what the first did.
        timed = lambda: fn(dst, index, src, limit=limit)
        library = lambda: plain_fn(dst, index, src, limit=limit)
        cut = limit
        kept = int((index < limit).sum())
        out_bytes = 4 * (kept if name == "scatter_kept" else limit)
        nbytes = 8 * index.numel() + 4 * kept + out_bytes
        shape = f"{index.numel()} writes, {kept} kept below {limit}"
    got = kernel()
    want, plain_ms = time_host(plain)
    require(torch.equal(got[:cut].view(torch.int32),
                        want[:cut].view(torch.int32)),
            f"{name} at the main shape: not bitwise equal to the plain "
            f"version")
    del got, want
    ms = time_cuda(timed, 3)
    library_ms = time_cuda(library, 3)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"  {name} at the main shape ({shape}): {ms:.3f} ms, bound "
        f"{bound_ms:.3f} ms ({bound_ms / ms:.1%}), plain {plain_ms:.1f} "
        f"ms, the torch call {library_ms:.3f} ms; bitwise equal to the "
        f"plain version: ok")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by="bytes", bytes=nbytes,
                bound_share=bound_ms / ms)


def fixed_order_mono(sh, A, C_mono):
    """spgemm(method="hash") on mono_500Hz in the fixed-order mode, the
    counts set to 0 just before and read just after: the cold call and two
    steady calls give bitwise-equal C (equal to the atomic slice's within
    tolerance); the steady ms with torch's fill of uninitialised memory on
    and off, beside the atomic kernels' steady calls on the same engine."""
    import torch.utils.deterministic as tud
    from repro_torch import SpgemmConfig
    from repro_torch.engine import Arena, SpgemmEngine
    cfg = SpgemmConfig(method="hash")
    eng = SpgemmEngine(cfg, arena=Arena())
    eng.execute(A, A)                                    # atomic cold
    atomic_ms = [time_host(lambda: eng.execute(A, A))[1] for _ in range(2)]
    eng.arena.reclaim()
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    fns = (sh.symbolic_bin_call, sh.numeric_bin_call, sh.fused_bin_call)
    reset_launches()
    for fn in fns:
        fn.launches_ordered = 0
    eng = SpgemmEngine(cfg, arena=Arena())
    with fixed_order():
        res, cold_ms = time_host(lambda: eng.execute(A, A))
        C_cold = res.C
        steady_ms = []
        for i in range(2):
            res, ms = time_host(lambda: eng.execute(A, A))
            steady_ms.append(ms)
            require(_csr_bitwise(res.C, C_cold),
                    f"fixed-order mono steady call {i}: C not bitwise equal "
                    f"to the cold call's")
        del res
        from repro_torch.core import esc
        from repro_torch.kernels import scatter
        captured = {}

        def steady():
            captured["segment_sum"] = capture_largest(
                esc, "segment_sum", lambda: eng.execute(A, A))
        captured["scatter_kept"] = capture_largest(scatter, "scatter_kept",
                                                   steady)
        captured["count_into"] = capture_largest(
            scatter, "count_into", lambda: eng.execute(A, A))
        ordered = {fn.__name__.removesuffix("_call"): fn.launches_ordered
                   for fn in fns}
        launches = read_launches()
        require(all(launches[k] > 0 for k in SCATTER_KERNELS),
                f"fixed-order mono: one of {SCATTER_KERNELS} never ran: "
                f"{launches}")
        err = compare_on_card("fixed-order mono C vs the atomic slice's",
                              C_cold, C_mono)
        was_fill = tud.fill_uninitialized_memory
        tud.fill_uninitialized_memory = False
        try:
            nofill_ms = []
            for _ in range(2):
                res, ms = time_host(lambda: eng.execute(A, A))
                nofill_ms.append(ms)
                require(_csr_bitwise(res.C, C_cold),
                        "fixed-order mono steady call without the fill: C "
                        "not bitwise equal to the cold call's")
                del res
        finally:
            tud.fill_uninitialized_memory = was_fill
    require(ordered["fused_bin"] > 0 and ordered["numeric_bin"] > 0
            and ordered["fused_bin"] == launches["fused_bin"]
            and ordered["numeric_bin"] == launches["numeric_bin"],
            f"fixed-order mono: launches {launches}, fixed-order {ordered}")
    eng.arena.reclaim()
    del eng, C_cold
    gc.collect()
    torch.cuda.empty_cache()
    out = dict(cold_ms=cold_ms, steady_ms=steady_ms,
               steady_nofill_ms=nofill_ms, atomic_steady_ms=atomic_ms,
               launches=launches, launches_ordered=ordered,
               max_abs_err_vs_atomic=err,
               kernels={k: order_kernel_at_main_shape(k, *captured[k])
                        for k in SCATTER_KERNELS})
    log(f"phase fixed-order mono_500Hz: cold {cold_ms:.1f} ms, steady "
        f"{['%.1f' % x for x in steady_ms]} ms with torch's fill of "
        f"uninitialised memory, {['%.1f' % x for x in nofill_ms]} ms "
        f"without, atomic kernels {['%.1f' % x for x in atomic_ms]} ms on "
        f"the same card; cold and steady C bitwise equal (atomic C within "
        f"{err:.3e}); launches {ordered} fixed-order of {launches}: ok")
    return out


def phase_engine_gates(sh, A, C_mono, jobs, atomic_stats, errs):
    """The reference's engine gates on the card, and the fixed-order mode:
    its kernels bitwise on every route, at the main path's rungs, and on
    mono_500Hz end to end."""
    from repro_torch.engine import default_arena, reset_default_engine
    reset_default_engine()
    default_arena().reclaim()
    gc.collect()
    torch.cuda.empty_cache()
    out = dict(gates=engine_gates())
    out["kernel_routes"] = fixed_order_kernels(sh, errs)
    out["main_shapes"] = fixed_order_main_shapes(sh, A, jobs, atomic_stats)
    out["mono"] = fixed_order_mono(sh, A, C_mono)
    return out


# ---------------------------------------------------------------------------
# 16-bit values, the paper's figure benches, the MoE layer.
# ---------------------------------------------------------------------------

def _with_values(M, val):
    from repro_torch.core import CSR
    return CSR(M.rpt, M.col, val, M.shape)


def entry_sums(A, B):
    """For each entry of A·B, sorted by (row, col): the absolute sum S of
    its products (torch.sparse's float32 |A|·|B|, within float32's
    rounding) and their number n (ones·ones, exact) -> (crow, col, S,
    n)."""
    _, cols, S = sparse_product(A, B, lambda v: v.float().abs())
    crow, cols_n, n = sparse_product(A, B, lambda v: torch.ones_like(
        v, dtype=torch.float32))
    require(torch.equal(cols, cols_n), "torch.sparse's |A|·|B| pattern "
            "differs from its ones·ones")
    return crow, cols, S, n


def order_bound(sums, dtype, rows, valid, width):
    """For each table entry of the valid rows (``width`` entries a row,
    sorted by column, the empty ones first): 3 n (u S + e), the most that
    two summation orders of the entry's n products (absolute sum S) can
    differ by when each product and sum is rounded to ``dtype`` (unit
    roundoff u, subnormal step e).  ``sums``: :func:`entry_sums` of the
    product."""
    crow, _, S, n = sums
    r = rows.long()[valid]
    start, nnz = crow[r], crow[r + 1] - crow[r]
    j = torch.arange(width, device=S.device) - (width - nnz)[:, None]
    used = j >= 0
    at = (start[:, None] + j).masked_fill(~used, 0)
    bound = 3 * n[at] * (UNIT_ROUNDOFF[dtype] * S[at] * (1 + 1e-5)
                         + SUBNORMAL_STEP[dtype])
    return bound.masked_fill(~used, 0)


def dtype_kernel_routes(sh, errs):
    """Each 16-bit kernel on every route (DTYPE_CASES), both disciplines,
    atomic and fixed-order, against its plain version on the card: a 96 x
    96 power-law pair in the type, its heaviest rows and 8 padding rows.
    Fixed order: tables bitwise equal; atomic: within order_bound."""
    from repro_torch.core import nprod_into_rpt, random_csr
    seen = {}
    for dtype in UNIT_ROUNDOFF:
        A, B = (random_csr(seed, 96, 96, avg_nnz_per_row=avg,
                           distribution="powerlaw", dtype=dtype,
                           device="cuda")
                for seed, avg in ((3, 5.0), (103, 4.0)))
        nprod = nprod_into_rpt(A, B)[:96]
        heavy = torch.argsort(nprod, descending=True, stable=True)
        sums = entry_sums(A, B)
        for kind, t_size, pack, n in DTYPE_CASES:
            name = kind + sh.VALUE_TYPES[dtype]
            rows_cap = n + 8
            rows = torch.zeros(rows_cap, dtype=torch.int32, device="cuda")
            rows[:n] = heavy[:n].to(torch.int32)
            count = torch.tensor([n], dtype=torch.int32, device="cuda")
            valid = torch.arange(rows_cap, device="cuda") < n
            nprod_rows = nprod[rows.long()].long().masked_fill(~valid, 0)
            plain = run_bin(sh, kind, True, A, B, rows, count, t_size,
                            rows_cap)
            bound = order_bound(sums, dtype, rows, valid,
                                plain["cols"].shape[1])
            route = route_of(sh, kind, t_size, dtype)
            seen.setdefault(name, set()).add(route)
            totals = {}
            for ordered in (False, True):
                for sa in (True, False):
                    what = (f"{name} t={t_size} pack={pack} ({route}, "
                            f"single_access={sa}, "
                            f"{'fixed order' if ordered else 'atomic'})")
                    with (fixed_order() if ordered
                          else contextlib.nullcontext()):
                        k = run_bin(sh, kind, False, A, B, rows, count,
                                    t_size, rows_cap, pack=pack,
                                    single_access=sa)
                        torch.cuda.synchronize()
                    require(k["vals"].dtype == dtype,
                            f"{what}: tables in {k['vals'].dtype}")
                    e = compare(what, k, plain, nprod_rows, valid,
                                bitwise=ordered, bound=bound)
                    if not ordered:
                        errs[name] = max(errs[name], e)
                    totals[sa] = int(k["acc"].long().sum())
                require(totals[True] < totals[False],
                        f"{name} t={t_size}: single access took "
                        f"{totals[True]} accesses, check-then-CAS "
                        f"{totals[False]}")
    for name, routes in seen.items():
        require(routes == {"smem", "cluster", "global"},
                f"{name}: routes {routes}")
    log("phase dtypes kernels: fused_bin and numeric_bin in bfloat16 and "
        "float16 on the shared-memory, cluster and global routes, both "
        "disciplines: fixed order bitwise equal to the plain versions, "
        "atomic within 3 n (u S + e): ok")
    return {name: sorted(r) for name, r in seen.items()}


def sparse_product(A, B, f):
    """torch.sparse's float32 product of A and B with values f(val), its
    rows sorted by column -> (crow, col, val)."""
    from benchmarks.torch.bench_overall import _sorted_rows, library_tensor
    TA, TB = (library_tensor(M, f(M.val[:int(M.rpt[-1])])) for M in (A, B))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        R = TA @ TB
    crow = R.crow_indices()
    col, val = _sorted_rows(crow, R.col_indices(), B.ncols, R.values())
    return crow, col, val


def dtype_product(name, M, dtype):
    """spgemm(method="hash") on M·M with M's values in ``dtype``, on a
    fresh engine: one cold call and STEADY_CALLS steady calls, the counts
    set to 0 just before; C's pattern equal to torch.sparse's float32
    pattern of the same 16-bit inputs, values within 2 n (u S + e) of its
    float32 values (n products of absolute sum S into the entry, unit
    roundoff u, subnormal step e: each of the n products and n - 1 sums
    rounds by at most u S + e / 2; the factor 2 covers the float32
    reference's own rounding and second-order terms).  -> (stats,
    launches, plan, result)."""
    from repro_torch import SpgemmConfig
    from repro_torch.engine import SpgemmEngine, plan_key
    A = _with_values(M, M.val.to(dtype))
    cfg = SpgemmConfig(method="hash")
    engine = SpgemmEngine(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    res, cold_ms = time_host(lambda: engine.execute(A, A))
    steady = []
    for _ in range(STEADY_CALLS):
        del res
        res, ms = time_host(lambda: engine.execute(A, A))
        steady.append(ms)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    entry = engine.cache.get(plan_key(A, A, cfg))
    require(entry.stats.steps_calls == 1
            and entry.stats.hot_calls == STEADY_CALLS,
            f"{name} {dtype}: expected 1 cold + {STEADY_CALLS} steady calls:"
            f" {entry.stats}")
    require(launches["fused_bin"] > 0 and launches["numeric_bin"] > 0,
            f"{name} {dtype}: the hash kernels were not launched: "
            f"{launches}")
    C = res.C
    require(C.val.dtype == dtype, f"{name}: C in {C.val.dtype}")
    crow, col, absval, count = entry_sums(A, A)
    crow_v, col_v, val = sparse_product(A, A, lambda v: v.float())
    require(torch.equal(crow, crow_v) and torch.equal(col, col_v),
            "torch.sparse's |A|·|A| pattern differs from its A·A")
    nz = int(crow[-1])
    require(torch.equal(C.rpt.long(), crow.long()),
            f"{name} {dtype}: C.rpt differs from torch.sparse's")
    require(torch.equal(C.col[:nz].long(), col.long()),
            f"{name} {dtype}: C.col differs from torch.sparse's")
    err = (C.val[:nz].float() - val).abs()
    bound = 2 * count * (UNIT_ROUNDOFF[dtype] * absval * (1 + 1e-5)
                         + SUBNORMAL_STEP[dtype])
    share = float((err / bound).max()) if nz else 0.0
    require(share <= 1.0, f"{name} {dtype}: values exceed 2 n (u S + e) by "
            f"{share:.3f}x")
    stats = dict(matrix=name, dtype=str(dtype).removeprefix("torch."),
                 cold_ms=cold_ms, steady_ms=steady,
                 steady_median_ms=statistics.median(steady),
                 peak_gib=peak / 2 ** 30, nnz=nz,
                 max_abs_err=float(err.max()) if nz else 0.0,
                 bound_share=share, launches=launches)
    log(f"phase dtypes {name} A·A in {stats['dtype']}: cold {cold_ms:.1f} "
        f"ms, steady median {stats['steady_median_ms']:.1f} ms "
        f"{['%.1f' % x for x in steady]}, peak {stats['peak_gib']:.2f} GiB, "
        f"nnz {nz}, max |C - A·A| {stats['max_abs_err']:.3e} "
        f"({share:.1%} of 2 n (u S + e)), pattern equal to torch.sparse's, "
        f"launches {launches}: ok")
    del val, absval, count, col, crow, col_v, crow_v
    plan = entry.plan
    del engine, entry
    torch.cuda.empty_cache()
    return stats, launches, plan, res


def mono_fused_rungs_ms(sh, A, plan, res):
    """The steady call's fused rungs on A·A timed alone, rung by rung (CUDA
    events), with their byte bound (valid rows): the fused section of a
    steady call in A's value type."""
    binning, ladder, buckets = main_path_jobs(plan, res)["fused_bin"]
    ms = nbytes = 0.0
    for b, t_size in enumerate(ladder.table_sizes):
        rows_cap = buckets[b]
        if not rows_cap:
            continue
        rows, count, _ = bin_inputs(binning, b, rows_cap)
        ms += time_cuda(lambda: bin_call(sh, "fused_bin", False, A, A, rows,
                                         count, t_size, rows_cap), 3)
        nbytes += bound_bytes("fused_bin", A, A, rows, count, t_size,
                              rows_cap)[0]
    return ms, nbytes / HBM_BYTES_PER_S * 1e3


def phase_dtypes(sh, A, S, errs, slice_stats):
    """16-bit values (bfloat16, float16) in the hash kernels: every route
    against the plain versions; scircuit and mono_500Hz A·A through
    spgemm(method="hash") in both types (C against torch.sparse's float32
    product of the same inputs); each 16-bit kernel at scircuit's main
    shapes (its time, the plain version's, the bound); the fused section
    of mono's steady call in each type.  bsr_spmm's float16 layer runs in
    phase_bsr beside the other two types."""
    t0 = time.perf_counter()
    out = dict(routes=dtype_kernel_routes(sh, errs), products={},
               mono_fused={})
    stats = {}
    for dtype in UNIT_ROUNDOFF:
        sfx = sh.VALUE_TYPES[dtype]
        s_stats, s_launches, plan, res = dtype_product(SCIRCUIT["name"], S,
                                                       dtype)
        S16 = _with_values(S, S.val.to(dtype))
        jobs = {k: v for k, v in main_path_jobs(plan, res).items()
                if k != "symbolic_bin"}
        shapes = phase_main_shapes(sh, S16, jobs, errs,
                                   label=f"{dtype} scircuit main shape")
        for kind in ("fused_bin", "numeric_bin"):
            stats[kind + sfx] = dict(shapes[kind + sfx],
                                     launches=s_launches[kind],
                                     library_ms=None, bound_by="bytes",
                                     matrix=SCIRCUIT["name"])
        del res, S16
        m_stats, _, plan, res = dtype_product(MONO["name"], A, dtype)
        A16 = _with_values(A, A.val.to(dtype))
        fused_ms, fused_bound = mono_fused_rungs_ms(sh, A16, plan, res)
        del res, A16
        torch.cuda.empty_cache()
        key = str(dtype).removeprefix("torch.")
        out["products"][key] = dict(scircuit=s_stats, mono=m_stats)
        out["mono_fused"][key] = dict(ms=fused_ms, bound_ms=fused_bound)
        log(f"phase dtypes mono_500Hz {key}: steady median "
            f"{m_stats['steady_median_ms']:.1f} ms against float32's "
            f"{slice_stats['steady_median_ms']:.1f} ms (slice phase); the "
            f"fused rungs alone {fused_ms:.3f} ms per steady call, bound "
            f"{fused_bound:.3f} ms ({fused_bound / fused_ms:.1%})")
    out["seconds"] = time.perf_counter() - t0
    log(f"phase dtypes: {out['seconds']:.1f} s")
    return out, stats


def phase_figures(A, S):
    """The paper's figure benches on the card: benchmarks.torch.run at the
    reference's sizes (every bench, rows printed); then Fig. 9's and Figs.
    10/11's per-case functions on the scircuit and mono_500Hz analogs,
    holding the CUDA kernels to the figure's invariants (single access
    below check-then-CAS on every kernel, at least one access a product
    on every row, fused below symbolic + numeric); then both spgemm
    examples on the card."""
    import io
    from benchmarks.torch import bench_binning_ranges, bench_hashing, run
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = run.main(["--reference-cut"])
    rows = buf.getvalue().splitlines()
    for row in rows:
        log(f"  {row}")
    require(rc == 0, "benchmarks.torch.run failed")
    names = {r.split(",")[0].split("/")[0] for r in rows[1:]}
    require(names == {"bench_overall", "bench_binning", "bench_hashing",
                      "bench_binning_ranges", "bench_overlap",
                      "bench_moe_dispatch"},
            f"benchmarks.torch.run printed rows of {sorted(names)}")
    harness_s = time.perf_counter() - t0
    out = dict(run_rows=rows, harness_s=harness_s, hashing={},
               ranges={})
    for name, M in ((SCIRCUIT["name"], S), (MONO["name"], A)):
        row, n = bench_hashing.case(name, M, M)
        log(f"  {row}")
        for step in ("sym", "num", "fused"):
            require(n[f"{step}_accesses_single"]
                    < n[f"{step}_accesses_multi"],
                    f"Fig. 9 {name} {step}: single access "
                    f"{n[f'{step}_accesses_single']} not below "
                    f"check-then-CAS {n[f'{step}_accesses_multi']}")
        for sa in ("single", "multi"):
            require(n[f"fused_accesses_{sa}"] < n[f"sym_accesses_{sa}"]
                    + n[f"num_accesses_{sa}"],
                    f"Fig. 9 {name}: fused accesses not below symbolic + "
                    f"numeric ({sa})")
        for kind in ("symbolic_bin", "numeric_bin", "fused_bin"):
            for sa in (True, False):
                acc, nprod, built = bench_hashing.row_accesses(M, M, kind,
                                                               sa)
                require(bool(built.any())
                        and bool((acc[built] >= nprod[built]).all()),
                        f"Fig. 9 {name} {kind} (single_access={sa}): a row "
                        f"of a launched bin took fewer accesses than "
                        f"products")
        sweep = bench_binning_ranges.sweep(M, M, name=name)
        for r, _ in sweep:
            log(f"  {r}")
        out["hashing"][name] = dict(row=row, **n)
        out["ranges"][name] = [dict(row=r, **v) for r, v in sweep]
        torch.cuda.empty_cache()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    for script, last in (("quickstart.py", "dense-oracle check: OK"),
                         ("graph_analytics.py", "sharded hop: nnz=")):
        t1 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, str(ROOT / "examples" / "torch" / script)],
            capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
        require(proc.returncode == 0 and last in proc.stdout,
                f"examples/torch/{script} failed: {proc.stderr[-2000:]}")
        log(f"  examples/torch/{script} on the card: "
            f"{time.perf_counter() - t1:.1f} s, last line "
            f"{proc.stdout.strip().splitlines()[-1]!r}")
    out["seconds"] = time.perf_counter() - t0
    log(f"phase figures: benchmarks.torch.run {harness_s:.1f} s, all "
        f"{out['seconds']:.1f} s: Fig. 9 invariants hold on the CUDA "
        f"kernels: ok")
    return out


def moe_oracle(layer, x):
    """The exact weighted expert mix of one group (nothing dropped), expert
    by expert in float32 from the layer's weights, with the router as the
    layer runs it."""
    from repro_torch.models import moe as M
    p, cfg = layer.params(), layer.cfg
    x_flat = x.reshape(-1, x.shape[-1])
    weights, experts, _ = M.route(p, x_flat, cfg)
    xf = x_flat.float()
    out = torch.zeros_like(xf)
    for e in range(cfg.num_experts):
        tok, slot = torch.nonzero(experts == e, as_tuple=True)
        if not tok.numel():
            continue
        h = xf[tok]
        g = h @ p["w_gate"][e].float()
        y = ((g * torch.sigmoid(g)) * (h @ p["w_up"][e].float())) \
            @ p["w_down"][e].float()
        out.index_add_(0, tok, weights[tok, slot][:, None] * y)
    return out.reshape(x.shape)


def _rel(y, ref):
    """||y - ref|| / ||ref|| (Frobenius)."""
    return float((y.float() - ref).norm() / ref.norm())


def phase_moe():
    """One olmoe-1b-7b MoE layer at its published width (d_model 2048, 64
    experts, top-8, d_ff 1024), one group (B = 1) of MOE_TOKENS tokens at
    capacity factor 8 (= E / k: nothing dropped), weights and tokens from
    seeded torch.Generators.  In float32 the binning dispatch equals the
    dense one within rtol 2e-2 / atol 2e-3, entry by entry
    (tests/test_property.py:99's check).  In bfloat16, the model's type,
    the two dispatches round at other places (the binning form adds a
    token's 8 weighted contributions in bfloat16, the dense one in float32)
    and an expert's output is itself a sum of 1,024 rounded terms, so an
    entry whose terms cancel differs by more than any rtol of it; there
    both, and the int8 payload, are held to the exact weighted expert mix
    (moe_oracle) in norm: ||y - mix|| / ||mix|| <= 2e-2 (int8: 4e-2, its
    payload rounding each activation to 1/254 of its token's largest), and
    the binning form to the dense one alike.  Binning, dense and the int8
    payload are timed (CUDA events) with their peak memory."""
    from repro_torch.configs import get_arch
    from repro_torch.models import MoE
    from repro_torch.models import moe as M
    t0 = time.perf_counter()
    base = get_arch("olmoe-1b-7b").replace(moe_capacity_factor=8.0)
    require(base.num_experts / base.experts_per_token == 8.0,
            f"olmoe-1b-7b: E / k = {base.num_experts}/"
            f"{base.experts_per_token}")
    out = dict(d_model=base.d_model, experts=base.num_experts,
               top_k=base.experts_per_token, d_ff=base.d_ff,
               tokens=MOE_TOKENS)
    gen = torch.Generator(device="cuda")
    for dtype_name in ("float32", "bfloat16"):
        cfg = base.replace(dtype=dtype_name)
        q = cfg.replace(moe_dispatch_dtype="int8")
        dt = torch.bfloat16 if dtype_name == "bfloat16" else torch.float32
        layer = MoE(cfg, generator=gen.manual_seed(0), device="cuda")
        x = torch.randn((1, MOE_TOKENS, cfg.d_model), generator=gen,
                        device="cuda").to(dt)
        with torch.inference_mode():
            binned, aux = layer(x)
            dense, aux_d = layer.dense_dispatch(x)
            quant, _ = M.moe(layer.params(), x, q)
            ref = moe_oracle(layer, x)
            torch.cuda.synchronize()
            b32, d32 = binned.float(), dense.float()
            stats = dict(aux=float(aux), aux_dense=float(aux_d),
                         max_abs_diff=float((b32 - d32).abs().max()),
                         max_abs=float(d32.abs().max()),
                         rel_binning=_rel(b32, ref), rel_dense=_rel(d32, ref),
                         rel_int8=_rel(quant, ref),
                         rel_binning_dense=_rel(b32, d32))
            if dt == torch.float32:
                bad = (b32 - d32).abs() > 2e-3 + 2e-2 * d32.abs()
                require(not bool(bad.any()),
                        f"MoE float32: binning and dense dispatch differ "
                        f"on {int(bad.sum())} entries (up to "
                        f"{stats['max_abs_diff']:.3e})")
            for key, lim in (("rel_binning", 2e-2), ("rel_dense", 2e-2),
                             ("rel_binning_dense", 2e-2),
                             ("rel_int8", 4e-2)):
                require(stats[key] <= lim, f"MoE {dtype_name}: {key} "
                        f"{stats[key]:.3e} > {lim}")
            del ref, quant, b32, d32
            stats["binning_ms"] = time_cuda(lambda: layer(x), 5)
            stats["dense_ms"] = time_cuda(lambda: layer.dense_dispatch(x), 5)
            stats["int8_ms"] = time_cuda(lambda: M.moe(layer.params(), x, q),
                                         5)
            for form, fn in (("binning", lambda: layer(x)),
                             ("dense", lambda: layer.dense_dispatch(x))):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                fn()
                torch.cuda.synchronize()
                stats[f"{form}_peak_gib"] = (torch.cuda.max_memory_allocated()
                                             / 2 ** 30)
        out[dtype_name] = stats
        log(f"phase moe {dtype_name}: binning {stats['binning_ms']:.3f} ms "
            f"(peak {stats['binning_peak_gib']:.2f} GiB), dense "
            f"{stats['dense_ms']:.3f} ms (peak {stats['dense_peak_gib']:.2f}"
            f" GiB), int8 payload {stats['int8_ms']:.3f} ms; against the "
            f"exact mix ||y - mix|| / ||mix||: binning "
            f"{stats['rel_binning']:.2e}, dense {stats['rel_dense']:.2e}, "
            f"int8 {stats['rel_int8']:.2e}; max |binning - dense| "
            f"{stats['max_abs_diff']:.3e} of |out| <= {stats['max_abs']:.1f}"
            f": ok")
        del layer, x, binned, dense
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    log(f"phase moe: {out['seconds']:.1f} s")
    return out


def _lm_close(what, got, want):
    """got (card) against want (CPU) within LM_TOL; the max |diff|."""
    got = got.float().cpu()
    want = want.float()
    bad = (got - want).abs() > LM_TOL["atol"] + LM_TOL["rtol"] * want.abs()
    err = float((got - want).abs().max())
    require(not bool(bad.any()), f"{what}: card and CPU differ on "
            f"{int(bad.sum())} of {bad.numel()} entries (max {err:.3e})")
    return err


def lm_reduced_parity():
    """The ten architectures reduced, in float32: prefill (and, but for
    the encoder, one decode step) on the card against the CPU."""
    from repro_torch.configs import ARCHS, get_arch
    from repro_torch.models.model import Model
    from repro_torch.models.param import tree_map
    errs = {}
    for arch in sorted(ARCHS):
        cfg = get_arch(arch).reduced().replace(dtype="float32")
        model = Model(cfg)
        params = model.init(torch.Generator().manual_seed(0), "cpu")
        dparams = tree_map(lambda t: t.to("cuda"), params)
        g = torch.Generator().manual_seed(1)
        if cfg.is_encoder:
            feats = torch.randn((2, 16, cfg.d_model), generator=g)
            want, _ = model.prefill(params, {"features": feats})
            got, _ = model.prefill(dparams, {"features": feats.to("cuda")})
            errs[arch] = dict(prefill=_lm_close(f"{arch} prefill", got,
                                                want))
            continue
        toks = torch.randint(0, cfg.vocab_size, (2, 17), generator=g)
        extra = ({"vision": torch.randn((2, cfg.vision_tokens, cfg.d_model),
                                        generator=g)}
                 if cfg.family == "vlm" else {})
        dextra = {k: v.to("cuda") for k, v in extra.items()}
        want, caches = model.prefill(params, {"tokens": toks[:, :16],
                                              **extra}, kv_cache_len=20)
        got, dcaches = model.prefill(
            dparams, {"tokens": toks[:, :16].to("cuda"), **dextra},
            kv_cache_len=20)
        e_pre = _lm_close(f"{arch} prefill", got, want)
        want, _ = model.decode_step(params, toks[:, 16:], caches, 16)
        got, _ = model.decode_step(dparams, toks[:, 16:].to("cuda"),
                                   dcaches,
                                   torch.full((2,), 16, device="cuda"))
        errs[arch] = dict(prefill=e_pre, decode=_lm_close(
            f"{arch} decode", got, want))
    return errs


def lm_block_parity():
    """One olmoe-1b-7b block at its published width in float32 (weights
    from a seeded CPU generator), LM_BLOCK_TOKENS tokens, card against
    CPU."""
    from repro_torch.configs import get_arch
    from repro_torch.models import model as MM
    from repro_torch.models.param import init_params, tree_map
    cfg = get_arch("olmoe-1b-7b").replace(dtype="float32")
    model = MM.Model(cfg)
    p = init_params(MM._block_specs(cfg), torch.Generator().manual_seed(2),
                    "cpu")
    x = torch.randn((1, LM_BLOCK_TOKENS, cfg.d_model),
                    generator=torch.Generator().manual_seed(3))
    pos = torch.arange(LM_BLOCK_TOKENS)[None]
    with torch.inference_mode():
        want, _, _ = model._block(p, x, positions=pos, causal=True)
        got, _, _ = model._block(tree_map(lambda t: t.to("cuda"), p),
                                 x.to("cuda"), positions=pos.to("cuda"),
                                 causal=True)
    return _lm_close("olmoe-1b-7b block (float32)", got, want)


def _tree_gib(tree):
    from repro_torch.models.param import tree_leaves
    return sum(t.numel() * t.element_size()
               for t in tree_leaves(tree)) / 2 ** 30


def lm_requests(vocab):
    """LM_REQUESTS prompts of 32-256 tokens and the oversized one
    (numpy default_rng(0))."""
    import numpy as np
    rng = np.random.default_rng(0)
    lens = rng.integers(32, 257, LM_REQUESTS)
    prompts = [rng.integers(0, vocab, int(n)).astype(np.int32)
               for n in lens]
    return prompts, rng.integers(0, vocab, LM_OVERSIZED).astype(np.int32)


def host_loop_ms():
    """Wall ms of a fixed pure-Python loop: the host's speed just then,
    read around each LM serving run (the decode step is host-bound), so
    that a slower run can be told from a slower host."""
    t0 = time.perf_counter()
    total = 0
    for i in range(1_000_000):
        total += i
    return (time.perf_counter() - t0) * 1e3


def lm_serve(model, params, prompts, oversized, held):
    """One ServingEngine run over the requests (the oversized one in the
    middle of the queue) after a warm-up engine's short run; the results,
    wall seconds, the spans' times and the peak GiB above ``held``, the
    bytes allocated when the phase began (earlier phases' tensors)."""
    import numpy as np
    from repro_torch.serve import Request, ServingEngine
    warm = ServingEngine(model, params, max_batch=LM_MAX_BATCH,
                         max_len=LM_MAX_LEN)
    for uid in range(LM_MAX_BATCH):
        warm.submit(Request(uid=uid, prompt=prompts[uid][:32],
                            max_new_tokens=3))
    warm.run()
    del warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng = ServingEngine(model, params, max_batch=LM_MAX_BATCH,
                        max_len=LM_MAX_LEN, telemetry=True)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=LM_NEW_TOKENS)
            for i, p in enumerate(prompts)]
    bad = Request(uid=len(prompts), prompt=oversized)
    for r in reqs[:len(reqs) // 2] + [bad] + reqs[len(reqs) // 2:]:
        eng.submit(r)
    host = host_loop_ms()
    t0 = time.perf_counter()
    results = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    host = (host + host_loop_ms()) / 2
    peak = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
    require(sorted(results) == list(range(len(prompts) + 1)),
            f"LM serve: results for {sorted(results)}")
    require(all(len(results[r.uid]) == LM_NEW_TOKENS and r.error is None
                for r in reqs), "LM serve: a request was not served with "
            f"{LM_NEW_TOKENS} tokens: {[len(results[r.uid]) for r in reqs]}")
    require(results[bad.uid] == [] and bad.error is not None
            and "max_len" in bad.error,
            f"LM serve: the {LM_OVERSIZED}-token prompt was not rejected "
            f"structurally ({bad.error!r})")
    spans = eng.telemetry.events.snapshot()
    prefill = [e["dur"] * 1e3 for e in spans if e["name"] == "serve.prefill"]
    decode4 = [e["dur"] * 1e3 for e in spans
               if e["name"] == "serve.decode_step"
               and e["attrs"]["active_slots"] == LM_MAX_BATCH]
    tokens = sum(len(v) for v in results.values())
    require(len(prefill) == len(prompts) and decode4,
            f"LM serve: {len(prefill)} prefill spans, {len(decode4)} decode "
            "steps with every slot active")
    return dict(results=results, wall_s=wall, peak_gib=peak, tokens=tokens,
                host_loop_ms=host,
                tokens_per_s=tokens / wall,
                prefill_ms=float(np.mean(prefill)),
                prefill_ms_each=prefill,
                decode_ms_median=float(statistics.median(decode4)),
                decode_steps_4_active=len(decode4),
                rejected=bad.error)


def lm_fresh_serve():
    """Run in a new process by lm_fresh: olmoe-1b-7b in bfloat16 served
    as phase_lm serves it (the same seeds and requests); one JSON line of
    its numbers and tokens on stdout."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_arch
    from repro_torch.models.model import Model
    model = Model(get_arch("olmoe-1b-7b"))
    held = torch.cuda.memory_allocated()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    r = lm_serve(model, params, *lm_requests(model.cfg.vocab_size), held)
    print(json.dumps({k: r[k] for k in LM_RATE_KEYS + ("results",)}))


def lm_fresh():
    """lm_fresh_serve in a new Python process (the same card, nothing of
    this process's earlier phases): its numbers and tokens."""
    proc = subprocess.run(
        [sys.executable, "-c",
         "import chip_smoke; chip_smoke.lm_fresh_serve()"], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    require(proc.returncode == 0, "LM: the fresh serving process failed: "
            f"{proc.stderr[-2000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    out["results"] = {int(k): v for k, v in out["results"].items()}
    return out


def lm_sequential(model, params, prompt, n_new, batch):
    """Greedy decode of one prompt through prefill and decode_step, the
    prompt in slot 0 of a ``batch``-slot cache (the other slots hold
    zeros), as the engine would run it alone."""
    from repro_torch.models.param import tree_leaves
    with torch.inference_mode():
        caches = model.init_caches(batch, LM_MAX_LEN, device="cuda")
        tokens = torch.from_numpy(prompt.astype("int64"))[None].to("cuda")
        logits, one = model.prefill(params, {"tokens": tokens},
                                    kv_cache_len=LM_MAX_LEN)
        for d, s in zip(tree_leaves(caches), tree_leaves(one)):
            d.narrow(1, 0, 1).copy_(s)     # slot 0 (axis 1: after layers)
        out = [int(torch.argmax(logits[0, -1]))]
        pos = len(prompt)
        for _ in range(n_new - 1):
            tok = torch.zeros((batch, 1), dtype=torch.int64, device="cuda")
            tok[0, 0] = out[-1]
            p = torch.zeros(batch, dtype=torch.int64, device="cuda")
            p[0] = pos
            lg, caches = model.decode_step(params, tok, caches, p)
            out.append(int(torch.argmax(lg[0, -1])))
            pos += 1
    return out


def lm_decode_syncs(model, params):
    """One decode step on the card under sync debug mode "error" (after a
    warm-up step): None if it made no host sync, else the error."""
    with torch.inference_mode():
        caches = model.init_caches(LM_MAX_BATCH, LM_MAX_LEN,
                                   device="cuda")
        tok = torch.zeros((LM_MAX_BATCH, 1), dtype=torch.int64,
                          device="cuda")
        pos = torch.arange(LM_MAX_BATCH, device="cuda") + 7
        model.decode_step(params, tok, caches, pos)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            model.decode_step(params, tok, caches, pos)
        except RuntimeError as exc:
            return str(exc)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    return None


def lm_profile_decode(model, params):
    """One decode step with every slot active (positions ~100) under
    torch.profiler (profile_steady): wall and device busy ms, idle share,
    the torch ops with the most device time."""
    with torch.inference_mode():
        caches = model.init_caches(LM_MAX_BATCH, LM_MAX_LEN,
                                   device="cuda")
        tok = torch.zeros((LM_MAX_BATCH, 1), dtype=torch.int64,
                          device="cuda")
        pos = torch.arange(LM_MAX_BATCH, device="cuda") + 100
        model.decode_step(params, tok, caches, pos)
        prof = profile_steady(
            lambda: model.decode_step(params, tok, caches, pos))
    log(f"phase lm decode step profiled: wall {prof['wall_ms']:.2f} ms, "
        f"device busy {prof['device_busy_ms']:.2f} ms (idle share "
        f"{prof['device_idle_share']:.3f}); top ops: " + ", ".join(
            f"{o['name']} {o['device_ms']:.2f} ms x{o['calls']}"
            for o in prof["top_ops"][:5]))
    return prof


def phase_lm(card):
    """The LM serving path: see phase 7i of the module docstring."""
    import numpy as np
    from repro_torch.configs import get_arch
    from repro_torch.models.model import Model
    from repro_torch.models.quant import quantize_params
    t0 = time.perf_counter()
    held = torch.cuda.memory_allocated()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        reduced = lm_reduced_parity()
        block_err = lm_block_parity()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    log(f"phase lm: ten reduced archs (float32) card == CPU within rtol "
        f"{LM_TOL['rtol']} / atol {LM_TOL['atol']} (max |diff| "
        f"{max(max(v.values()) for v in reduced.values()):.2e}); olmoe-1b-7b"
        f" block at full width over {LM_BLOCK_TOKENS} tokens max |diff| "
        f"{block_err:.2e}: ok")
    out = dict(reduced=reduced, block_max_abs_err=block_err, card=card,
               held_gib=held / 2 ** 30)

    cfg = get_arch("olmoe-1b-7b")
    model = Model(cfg)
    torch.cuda.synchronize()
    t_init = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t_init
    out["weights_gib"] = _tree_gib(params)
    prompts, oversized = lm_requests(cfg.vocab_size)
    bf16 = lm_serve(model, params, prompts, oversized, held)
    # The step is the host's launches, so its time follows the host's
    # speed: the same serving in this process and in a fresh one,
    # alternating, tells this script's state from the host's drift.
    runs = [bf16, lm_fresh(), lm_serve(model, params, prompts, oversized,
                                       held), lm_fresh()]
    require(all(r["results"] == bf16["results"] for r in runs),
            "LM: a repeat or a fresh process served other tokens")
    bf16["alternating"] = [dict({k: r[k] for k in LM_RATE_KEYS},
                                process="this" if i % 2 == 0 else "fresh")
                           for i, r in enumerate(runs)]
    seq = lm_sequential(model, params, prompts[0], LM_NEW_TOKENS,
                        LM_MAX_BATCH)
    require(seq == bf16["results"][0], f"LM: request 0's engine tokens "
            f"{bf16['results'][0]} != sequential greedy {seq}")
    alone = lm_sequential(model, params, prompts[0], LM_NEW_TOKENS, 1)
    bf16["batch1_tokens_agreeing"] = sum(
        a == b for a, b in zip(alone, seq))

    m8 = Model(cfg.replace(moe_capacity_factor=8.0))
    require(cfg.num_experts / cfg.experts_per_token == 8.0, "E / k != 8")
    with torch.inference_mode():
        toks = torch.from_numpy(prompts[0].astype("int64"))[None].to("cuda")
        s = toks.shape[1] - 1
        full, _ = m8.prefill(params, {"tokens": toks}, kv_cache_len=s + 1)
        _, caches = m8.prefill(params, {"tokens": toks[:, :s]},
                               kv_cache_len=s + 1)
        step, _ = m8.decode_step(params, toks[:, s:], caches, s)
        rel = _rel(step.float(), full.float())
        lg_bf16, _ = model.prefill(params, {"tokens": toks})
        lg_bf16 = lg_bf16.float().cpu()
    require(rel <= 2e-2, f"LM: prefill({s}) + decode(1) against "
            f"prefill({s + 1}) at capacity 8: {rel:.3e} > 2e-2")
    bf16["decode_consistency_rel"] = rel
    sync_err = lm_decode_syncs(model, params)
    require(sync_err is None, f"LM: decode_step synced with the host: "
            f"{sync_err}")
    log(f"phase lm olmoe-1b-7b bfloat16 ({card}): weights "
        f"{out['weights_gib']:.2f} GiB, peak {bf16['peak_gib']:.2f} GiB "
        f"above the {out['held_gib']:.2f} GiB earlier phases hold; "
        f"prefill {bf16['prefill_ms']:.2f} ms a request "
        f"(prompts {min(map(len, prompts))}-{max(map(len, prompts))}); "
        f"decode step {bf16['decode_ms_median']:.2f} ms median with "
        f"{LM_MAX_BATCH} active slots ({bf16['decode_steps_4_active']} "
        f"steps); {bf16['tokens']} tokens in {bf16['wall_s']:.2f} s = "
        f"{bf16['tokens_per_s']:.1f} tokens/s; request 0 == sequential "
        f"greedy (batch 1: {bf16['batch1_tokens_agreeing']}/"
        f"{LM_NEW_TOKENS} agree); prefill+decode vs prefill {rel:.2e}; "
        f"decode_step syncs nothing; {LM_OVERSIZED}-token prompt "
        f"rejected: ok")

    log("phase lm olmoe-1b-7b bfloat16 served in this process and in a "
        "fresh one, alternating (tokens/s, decode step ms median, prefill "
        "ms, peak GiB, the host's loop ms): " + "; ".join(
            f"{r['process']} {r['tokens_per_s']:.1f}, "
            f"{r['decode_ms_median']:.2f}, {r['prefill_ms']:.2f}, "
            f"{r['peak_gib']:.2f}, {r['host_loop_ms']:.2f}"
            for r in bf16["alternating"])
        + "; the same tokens each time: ok")
    bf16["decode_profile"] = lm_profile_decode(model, params)

    bf16_gib = out["weights_gib"]
    qparams = quantize_params(params)
    out["int8_weights_gib"] = _tree_gib(qparams)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    require(out["int8_weights_gib"] < 0.6 * bf16_gib,
            f"LM int8: {out['int8_weights_gib']:.2f} GiB not below 0.6 x "
            f"{bf16_gib:.2f}")
    int8 = lm_serve(model, qparams, prompts, oversized, held)
    with torch.inference_mode():
        lg_q, qcaches = model.prefill(qparams, {"tokens": toks},
                                      kv_cache_len=LM_MAX_LEN)
        lg_d, _ = model.decode_step(qparams, toks[:, :1], qcaches, s + 1)
    require(bool(torch.isfinite(lg_q.float()).all())
            and bool(torch.isfinite(lg_d.float()).all()),
            "LM int8: non-finite logits")
    int8["decode_profile"] = lm_profile_decode(model, qparams)
    int8["corr_prefill_logits"] = float(np.corrcoef(
        lg_bf16.reshape(-1).numpy(),
        lg_q.float().cpu().reshape(-1).numpy())[0, 1])
    int8["tokens_equal_bf16"] = sum(
        int8["results"][i] == bf16["results"][i] for i in range(len(prompts)))
    log(f"phase lm olmoe-1b-7b int8 weights ({card}): "
        f"{out['int8_weights_gib']:.2f} GiB (bfloat16 {bf16_gib:.2f}), peak "
        f"{int8['peak_gib']:.2f} GiB; prefill {int8['prefill_ms']:.2f} ms; "
        f"decode step {int8['decode_ms_median']:.2f} ms median with "
        f"{LM_MAX_BATCH} active slots; {int8['tokens_per_s']:.1f} tokens/s;"
        f" correlation of request 0's prefill logits with bfloat16's "
        f"{int8['corr_prefill_logits']:.4f} (not gated); "
        f"{int8['tokens_equal_bf16']}/{len(prompts)} requests' tokens equal"
        f" bfloat16's: ok")
    for d in (bf16, int8):
        d["results"] = {k: list(v) for k, v in d["results"].items()}
    out.update(bfloat16=bf16, int8=int8)
    del qparams, qcaches
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    log(f"phase lm: {out['seconds']:.1f} s")
    return out


def run():
    import numpy as np
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
    ptxas = {name: build.ptxas_report(name) for name in build.SIGNATURES}
    for name, lines in ptxas.items():
        for line in lines:
            log(f"  ptxas {name}.cu {line}")
    for name, kernel in NO_SPILLS:    # every instance of a template
        lines = [x for x in ptxas[name]
                 if x.split(":")[0].split("<")[0] == kernel]
        require(lines and all("0 bytes spill stores, 0 bytes spill loads"
                              in x for x in lines),
                f"{kernel} spills (or has no ptxas line): {lines}")
    log("ptxas: " + ", ".join(k for _, k in NO_SPILLS) + " spill nothing: ok")

    errs = {k: 0.0 for k in REPLACES}
    fixed_errs = {k: 0.0 for k in REPLACES}   # bitwise: stays 0.0
    cluster_sass = phase_cluster_sass()
    phase_tiny(sh, errs)
    A = table3_matrix(MONO)
    res, plan, launches, slice_stats = phase_slice(A)
    phase_top_rungs(sh, A, res.sym_binning, res.num_binning, errs)
    stats = phase_main_shapes(sh, A, main_path_jobs(plan, res), errs)
    stats["fused_bin"]["streams"] = phase_fused_streams(sh, A, plan, res)
    for name in HASH_KERNELS:
        stats[name].update(launches=launches[name], library_ms=None,
                           bound_by="bytes")
    t_ext = time.perf_counter()
    ext_res, ext_plan, ext_launches, ext_stats = phase_extended(A, res.C)
    stats.update(phase_main_shapes(sh, A, main_path_jobs(ext_plan, ext_res),
                                   errs, route="cluster"))
    del ext_res
    torch.cuda.empty_cache()
    for name in CLUSTER_KERNELS:
        stats[name].update(launches=ext_launches[name], library_ms=None,
                           bound_by="bytes")
    top_launches, top_stats, top_path = phase_extended_top(sh, A, res.C,
                                                           errs)
    stats.update(top_stats)
    for name in GLOBAL_KERNELS:
        stats[name].update(launches=top_launches[name], library_ms=None,
                           bound_by="bytes")
    S = table3_matrix(SCIRCUIT)
    esc_stats = phase_esc(S)
    log(f"phases extended, extended top rungs and ESC: "
        f"{time.perf_counter() - t_ext:.1f} s")
    stats["binning_histogram"] = phase_binning(A, res, errs)
    stats["bsr_spmm"] = phase_bsr(errs)
    request = phase_request_path(A, res.C, S)
    t_gov = time.perf_counter()
    governor = phase_governor(A, res.C, S, slice_stats)
    log(f"phase governor: {time.perf_counter() - t_gov:.1f} s")
    t_shard = time.perf_counter()
    sharded = phase_sharded(A, res.C, S, plan, slice_stats)
    log(f"phase sharded: {time.perf_counter() - t_shard:.1f} s")
    t_svc = time.perf_counter()
    service = phase_service(A, res.C, S)
    log(f"phase service: {time.perf_counter() - t_svc:.1f} s")
    t_gates = time.perf_counter()
    gates = phase_engine_gates(sh, A, res.C, main_path_jobs(plan, res),
                               stats, fixed_errs)
    log(f"phase engine gates: {time.perf_counter() - t_gates:.1f} s")
    for name in SCATTER_KERNELS:
        stats[name] = dict(gates["mono"]["kernels"][name],
                           launches=launches[name])
    dtypes, dtype_stats = phase_dtypes(sh, A, S, errs, slice_stats)
    stats.update(dtype_stats)
    stats["bsr_spmm_f16"] = stats["bsr_spmm"]["float16"]
    figures = phase_figures(A, S)
    moe = phase_moe()
    lm = phase_lm(card)

    kernels = []
    for name in REPLACES:
        s = stats[name]
        entry = dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=REPLACES[name], max_abs_err=errs[name])
        top = s["float32"] if name == "bsr_spmm" else s
        entry.update({k: top[k] for k in ("launches", "ms", "plain_ms",
                                          "bound_ms", "bound_by",
                                          "library_ms")})
        if name in HASH_KERNELS:
            entry.update(service_launches=service["launches"][name])
        if name in gates["main_shapes"]:
            fo = gates["main_shapes"][name]
            entry["fixed_order"] = dict(
                launches=gates["mono"]["launches_ordered"][name],
                max_abs_err=fixed_errs[name], ms=fo["ms"],
                plain_ms=fo["plain_ms"], bound_ms=fo["bound_ms"],
                bound_by="bytes", library_ms=None,
                routes=gates["kernel_routes"][name])
        if name in CLUSTER_KERNELS + GLOBAL_KERNELS:
            entry.update(bound_share=s["bound_share"])
        if name in VALUE_KERNELS:
            entry.update(bound_share=s["bound_share"], matrix=s["matrix"],
                         routes=dtypes["routes"][name])
        if name == "bsr_spmm_f16":
            entry.update(dtype="float16", bound_share=s["bound_share"],
                         ctas_per_sm=s["ctas_per_sm"])
        if name == "binning_histogram":
            entry.update(library_calls=s["library_calls"],
                         kernel_ms=s["kernel_ms"], host_us=s["host_us"],
                         bound_share=s["bound_share"])
        if name == "bsr_spmm":
            entry.update(dtype="float32", bound_share=top["bound_share"],
                         ctas_per_sm=top["ctas_per_sm"])
            entry["bfloat16"] = {k: s["bfloat16"][k] for k in (
                "launches", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "max_abs_err")}
        kernels.append(entry)
    return dict(
        card=card, kernels=kernels, build_s=secs, ptxas=ptxas,
        cluster_sass=cluster_sass,
        slice=slice_stats, extended=ext_stats, extended_top=top_path,
        esc=esc_stats,
        main_shapes=stats, request_path=request, governor=governor,
        sharded=sharded, service=service, engine_gates=gates,
        dtypes=dtypes, figures=figures, moe=moe, lm=lm,
        numpy=np.__version__, torch=torch.__version__,
        cuda=torch.version.cuda)


if __name__ == "__main__":
    sys.exit(main())
