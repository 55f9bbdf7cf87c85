"""Plan-cached SpGEMM executor: the engine behind ``spgemm()``.

Two execution paths for the OpSparse two-phase flow (paper Fig. 2):

``_execute_steps``
    The host-orchestrated six-step pipeline (setup, sym-bin, symbolic,
    alloc, num-bin, numeric).  It serves cold calls (capacity buckets and
    hash launch schedule still unknown), ``timing`` runs and overflow
    redos, and it syncs the host where the paper does.

``_build_hot_executable`` / ``_build_hash_executable`` /
``_build_fused_hash_executable``
    The steady-state pipelines, one per specialized plan.  With the
    product/nnz buckets and (for the hash method) the per-rung bin-count
    buckets of the :class:`~repro_torch.engine.plan.HashSchedule` learned,
    nothing is left for the host to decide mid-flight: the pipeline is
    dispatched without reading the device, and finalize makes ONE host
    read that verifies the buckets (growing them and redoing the call via
    the steps path on overflow).

The :class:`SpgemmEngine` also carries the reference's request path:
``submit``/``drain`` stream requests grouped by plan signature through a
bounded window of dispatches in flight, finalizing them in completion
order (a CUDA event recorded at the end of each dispatch says when its
device work is done); ``prewarm`` specializes a plan ahead of traffic;
``plan_mode="estimate"`` specializes cold plans from the sampling
estimator (``core/analysis.estimate_result``) instead of the full
symbolic pass; the hash headroom is learned per plan
(``engine/autotune``); ``EngineStats``, spans and ``report()`` come from
``engine/stats`` and ``engine/telemetry``.

Each steady-state dispatch leases its product-expansion storage from the
workspace arena (``core/workspace.Arena``, shared process-wide by default)
and returns it at finalize, after the host read.  A
:class:`~repro_torch.engine.autotune.MemoryGovernor` caps the arena's
bytes; under the cap the dispatch walks the reference's ladder (reclaim,
forced schedule trim, fused->two-pass spill, ``ArenaPressureError``), and
``drain`` answers the last rung with backpressure.  A
:class:`~repro_torch.core.faults.FaultPlan` injects lease denials, verify
overflows, dispatch errors and stalls at the reference's sites.

``shards=N`` fans a request out into N flop-balanced row blocks of A
(``engine/partition``): each shard is an ordinary sub-dispatch on a
pow-2-bucketed slice signature (shards with the same buckets share one
sub-plan), and a merge concatenates the shards' CSRs on the device.
``shards="auto"`` lets the adaptive policy (``engine/autotune``) choose N
per plan from the flop estimate and revise it from finalize telemetry.

A request's latency ends when its C is complete on the device.  An
unsharded request's is complete when finalize returns (its one host read
waited for it).  A sharded request's merge is still in flight then: on
the card its result carries the merge's :class:`Completion`, and its
latency is observed once the event after the merge has completed, at the
engine's next finalize, drain or ``report()``, or at
:meth:`SpgemmEngine.flush_latencies`; the dispatch path never waits.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Tuple, Union

import torch

from repro_torch.core import esc
from repro_torch.core.analysis import (estimate_result,
                                       exclusive_sum_in_place,
                                       nprod_into_rpt, row_flops)
from repro_torch.core.binning import bin_rows, bin_rows_for_ladder
from repro_torch.core.csr import CSR
from repro_torch.core.faults import FaultPlan, InjectedFault, resolve_faults
from repro_torch.core.spgemm import (AUTO_SHARDS, Completion, SpgemmConfig,
                                     SpgemmResult)
from repro_torch.core.workspace import (Arena, ArenaPressureError, Lease,
                                        default_arena, next_bucket)
from repro_torch.kernels import scatter, spgemm_hash

from . import autotune, stats as stats_mod
from .autotune import AdaptivePolicy, MemoryGovernor, PolicyState
from .cache import CacheEntry, PlanCache
from .partition import (ShardSpec, data_axis_devices, plan_shards,
                        shard_devices)
from .plan import HashSchedule, MatrixSig, SpgemmPlan, plan as make_plan
from .stats import EngineStats
from .telemetry import (NULL, Span, Telemetry, profiler_range,
                        resolve_telemetry)

# Capacity buckets (product expansion / C storage) get a smaller margin: it
# only moves the pow-2 bucket when the observed total sits in the top fifth
# of one, where same-signature jitter would otherwise flip buckets.
_CAPACITY_HEADROOM = 1.25


def _sync(value: torch.Tensor) -> None:
    if value.is_cuda:
        torch.cuda.synchronize(value.device)


def host_read(tel: Telemetry, stats: Optional[EngineStats], name: str, *,
              uid: Optional[int] = None, range_name: Optional[str] = None):
    """The ``with``-span of one wait of the host on the device: a span
    marked ``sync=True`` (so a profiler range, traced or not), counted in
    the engine's ``host_syncs``."""
    if stats is not None:
        stats.host_syncs += 1
    return tel.span(name, uid=uid, range_name=range_name, sync=True)


class StepTimer:
    """Per-step wall clock of the steps path (waits only when enabled),
    and the span of each of its host reads (:meth:`read`).

    Each measured step is a span nested under the tracer's current
    ``with``-span (``cold_steps``), recorded when the tracer is enabled:
    the steps path waits for the device at each step anyway.  Under
    ``torch.profiler`` each wait is a range ``step_wait:<step>``.  Every
    wait and read is counted in ``stats.host_syncs``.
    """

    def __init__(self, enabled: bool, tracer: Optional[Telemetry] = None,
                 uid: Optional[int] = None,
                 stats: Optional[EngineStats] = None):
        self.tracer = tracer if tracer is not None else NULL
        self.enabled = enabled or self.tracer.enabled
        self.uid = uid
        self.stats = stats
        self.timings: Dict[str, float] = {}

    def read(self, name: str, range_name: Optional[str] = None):
        """The span of one host read (:func:`host_read`)."""
        return host_read(self.tracer, self.stats, name, uid=self.uid,
                         range_name=range_name)

    def measure(self, name: str, value: torch.Tensor) -> torch.Tensor:
        """Wait for ``value`` and charge the wait to ``name``."""
        if self.enabled:
            t0 = time.perf_counter()
            with self.read(name, "step_wait:" + name):
                _sync(value)
            self.timings[name] = self.timings.get(name, 0.0) + (
                time.perf_counter() - t0)
        return value


def _bin_for_ladder(sizes: torch.Tensor, ladder, timer: StepTimer):
    """``bin_rows_for_ladder`` with its read of ``max(sizes)`` made here,
    so the read (``sync:max``) and the binning (``hash_binning``) are
    sibling ranges."""
    with timer.read("sync:max"):
        max_size = int(sizes.max()) if sizes.shape[0] else 0
    with profiler_range("hash_binning"):
        return bin_rows_for_ladder(sizes, ladder, max_size=max_size)


# ---------------------------------------------------------------------------
# Path 1: the six-step host-orchestrated flow (paper Fig. 2).
# ---------------------------------------------------------------------------

def _floor_schedule(row_buckets, fall_cap, plan_buckets, plan_fall):
    """Floor a freshly derived phase schedule at the plan's learned one, so
    the schedule only ever grows."""
    if plan_buckets is None:
        return row_buckets, fall_cap
    return (tuple(max(a, b) for a, b in zip(row_buckets, plan_buckets)),
            max(fall_cap, plan_fall))


def _execute_steps(A: CSR, B: CSR, plan: SpgemmPlan, timer: StepTimer, *,
                   headroom: float):
    """Cold / timing / redo path -> (result, prod_cap, nnz_cap, hash_sched).

    The capacity buckets are floored at the plan's learned ones.  For the
    hash method each phase derives its launch schedule ONCE
    (``host_schedule`` with ``headroom``, floored at the plan's), runs the
    schedule-driven kernels with it, and the combined
    :class:`HashSchedule` is returned for the caller to specialize the
    plan with (``None`` for ESC).  ``headroom`` over-provisions the
    learned bin-count buckets so steady-state bin-size jitter stays inside
    them; the engine passes the plan's adaptive-policy value.
    """
    config = plan.config
    m = A.nrows
    sym_ladder, num_ladder = plan.sym_ladder, plan.num_ladder
    sched = plan.hash_schedule

    # ---- step1: setup -------------------------------------------------------
    with profiler_range("hash_setup"):
        rpt_buf = nprod_into_rpt(A, B)                      # n_prod in C.rpt
    timer.measure("setup", rpt_buf)
    nprod = rpt_buf[:m]
    with timer.read("sync:nprod"):
        total_nprod = int(nprod.sum())      # host sync #1 (sizes launches)

    # ---- step2: symbolic binning ---------------------------------------------
    sym_binning = _bin_for_ladder(nprod, sym_ladder, timer)
    timer.measure("symbolic_binning", sym_binning.bins)
    prod_capacity = max(plan.prod_bucket or 0,
                        next_bucket(max(int(total_nprod
                                            * _CAPACITY_HEADROOM), 1)))

    # ---- step3: symbolic -------------------------------------------------------
    sym_buckets = sym_fall = None
    if config.method == "hash":
        # Packed configs need pack-aligned sym buckets; learning them
        # aligned here keeps every later union/floor aligned too.
        sym_packs = sym_ladder.rows_per_block if config.row_packing else None
        sym_buckets, sym_fall = _floor_schedule(
            *spgemm_hash.host_schedule(A, B, sym_binning, sym_ladder,
                                       headroom=headroom, packs=sym_packs,
                                       read=timer.read),
            sched.sym_row_buckets if sched else None,
            sched.fall_prod_bucket if sched else 0)
        nnz_buf, _, _ = spgemm_hash.symbolic_scheduled(
            A, B, sym_binning, sym_ladder,
            row_buckets=sym_buckets, fallback_prod_capacity=sym_fall,
            single_access=config.hash_single_access,
            row_packing=config.row_packing)
    else:
        nnz_buf = esc.symbolic(A, B, prod_capacity=prod_capacity)
    timer.measure("symbolic", nnz_buf)

    # ---- step4: alloc ------------------------------------------------------------
    nnz = nnz_buf[:m]
    # Numeric binning is dispatched BEFORE the host reads total_nnz: the
    # launch-early / allocate-later ordering of §5.4 (its own read of
    # max(nnz), sync:max, still comes first).
    num_binning = _bin_for_ladder(nnz, num_ladder, timer)
    with timer.read("sync:nnz"):
        total_nnz = int(nnz.sum())              # host sync #2 (alloc C)
    nnz_capacity = max(plan.nnz_bucket or 0,
                       next_bucket(max(int(total_nnz
                                           * _CAPACITY_HEADROOM), 1)))
    with profiler_range("hash_alloc"):
        rpt = exclusive_sum_in_place(nnz_buf)
    timer.measure("alloc", rpt)
    timer.measure("numeric_binning", num_binning.bins)

    # ---- step6: numeric ----------------------------------------------------------
    hash_sched = None
    if config.method == "hash":
        num_buckets, num_fall = _floor_schedule(
            *spgemm_hash.host_schedule(A, B, num_binning, num_ladder,
                                       headroom=headroom, read=timer.read),
            sched.num_row_buckets if sched else None,
            sched.fall_prod_bucket if sched else 0)
        # Both phases share ONE fallback expansion capacity.
        fall = max(sym_fall, num_fall)
        C, _, _ = spgemm_hash.numeric_scheduled(
            A, B, rpt, num_binning, num_ladder,
            row_buckets=num_buckets, nnz_capacity=nnz_capacity,
            fallback_prod_capacity=fall,
            single_access=config.hash_single_access)
        hash_sched = HashSchedule(sym_buckets, num_buckets, fall)
    elif config.fuse_esc:
        C = esc.spgemm_fused(A, B, prod_capacity=prod_capacity,
                             nnz_capacity=nnz_capacity)
    else:
        C = esc.numeric(A, B, rpt, prod_capacity=prod_capacity,
                        nnz_capacity=nnz_capacity)
    timer.measure("numeric", C.val)

    result = SpgemmResult(
        C=C, total_nprod=total_nprod, total_nnz=total_nnz,
        sym_binning=sym_binning, num_binning=num_binning,
        timings=timer.timings)
    return result, prod_capacity, nnz_capacity, hash_sched


# ---------------------------------------------------------------------------
# Path 2: the steady-state pipelines (one per specialized plan).
#
# Each is called as ``body(A, B, ws)``: ``ws`` is the plan's arena lease
# ``(i32, val)`` when ``plan.workspace_spec()`` is not None (the storage of
# its product expansion, written in place), else None.
# ---------------------------------------------------------------------------

def _build_hot_executable(plan: SpgemmPlan) -> Callable:
    """ESC steady state: the whole two-phase flow with the plan's buckets,
    no host read; totals come back as device scalars for finalize.  Both
    expansions (symbolic, then numeric) write the one lease in turn."""
    assert plan.is_specialized and plan.config.method == "esc"
    m = plan.a_sig.nrows
    config = plan.config
    sym_ladder, num_ladder = plan.sym_ladder, plan.num_ladder
    prod_cap, nnz_cap = plan.prod_bucket, plan.nnz_bucket

    def body(A: CSR, B: CSR, ws=None):  # opslint: steady
        nprod = nprod_into_rpt(A, B)[:m]
        total_nprod = nprod.sum()
        sym_binning = bin_rows(nprod, upper=sym_ladder.upper,
                               num_bins=sym_ladder.num_bins)
        nnz_buf = esc.symbolic(A, B, prod_capacity=prod_cap, workspace=ws)
        nnz = nnz_buf[:m]
        num_binning = bin_rows(nnz, upper=num_ladder.upper,
                               num_bins=num_ladder.num_bins)
        total_nnz = nnz.sum()
        if config.fuse_esc:
            C = esc.spgemm_fused(A, B, prod_capacity=prod_cap,
                                 nnz_capacity=nnz_cap, workspace=ws)
        else:
            C = esc.numeric(A, B, exclusive_sum_in_place(nnz_buf),
                            prod_capacity=prod_cap, nnz_capacity=nnz_cap,
                            workspace=ws)
        return C, total_nprod, total_nnz, sym_binning, num_binning

    return body


def _build_hash_executable(plan: SpgemmPlan) -> Callable:
    """Two-pass hash steady state (``fuse_numeric=False``): both binnings,
    every scheduled hash kernel and the ESC fallback rung, with the plan's
    schedule; bin sizes and fallback totals come back for finalize."""
    assert plan.is_specialized and plan.config.method == "hash"
    m = plan.a_sig.nrows
    config = plan.config
    sym_ladder, num_ladder = plan.sym_ladder, plan.num_ladder
    sched = plan.hash_schedule
    nnz_cap = plan.nnz_bucket

    def body(A: CSR, B: CSR, ws=None):  # opslint: steady
        with profiler_range("hash_setup"):
            nprod = nprod_into_rpt(A, B)[:m]
            total_nprod = nprod.sum()
        with profiler_range("hash_binning"):
            sym_binning = bin_rows(nprod, upper=sym_ladder.upper,
                                   num_bins=sym_ladder.num_bins)
        nnz_buf, sym_fall_prod, _ = spgemm_hash.symbolic_scheduled(
            A, B, sym_binning, sym_ladder,
            row_buckets=sched.sym_row_buckets,
            fallback_prod_capacity=sched.fall_prod_bucket,
            single_access=config.hash_single_access,
            row_packing=config.row_packing, workspace=ws)
        nnz = nnz_buf[:m]
        with profiler_range("hash_binning"):
            num_binning = bin_rows(nnz, upper=num_ladder.upper,
                                   num_bins=num_ladder.num_bins)
            total_nnz = nnz.sum()
        with profiler_range("hash_alloc"):
            rpt = exclusive_sum_in_place(nnz_buf)
        C, num_fall_prod, _ = spgemm_hash.numeric_scheduled(
            A, B, rpt, num_binning, num_ladder,
            row_buckets=sched.num_row_buckets, nnz_capacity=nnz_cap,
            fallback_prod_capacity=sched.fall_prod_bucket,
            single_access=config.hash_single_access, workspace=ws)
        return (C, total_nprod, total_nnz, sym_binning, num_binning,
                sym_fall_prod, num_fall_prod)

    return body


def _build_fused_hash_executable(plan: SpgemmPlan) -> Callable:
    """FUSED hash steady state (``fuse_numeric``, the hash default): one
    n_prod binning and one table build per row
    (:func:`spgemm_hash.fused_scheduled`) emitting nnz AND values.
    Finalize verifies the sym schedule, the fallback product total and the
    nnz bucket."""
    assert (plan.is_specialized and plan.config.method == "hash"
            and plan.config.fuse_numeric)
    m = plan.a_sig.nrows
    config = plan.config
    sym_ladder, num_ladder = plan.sym_ladder, plan.num_ladder
    sched = plan.hash_schedule
    nnz_cap = plan.nnz_bucket

    def body(A: CSR, B: CSR, ws=None):  # opslint: steady
        with profiler_range("hash_setup"):
            nprod = nprod_into_rpt(A, B)[:m]
            total_nprod = nprod.sum()
        with profiler_range("hash_binning"):
            sym_binning = bin_rows(nprod, upper=sym_ladder.upper,
                                   num_bins=sym_ladder.num_bins)
        C, nnz, sym_fall_prod, _ = spgemm_hash.fused_scheduled(
            A, B, sym_binning, sym_ladder,
            row_buckets=sched.sym_row_buckets, nnz_capacity=nnz_cap,
            fallback_prod_capacity=sched.fall_prod_bucket,
            single_access=config.hash_single_access,
            row_packing=config.row_packing, workspace=ws)
        # No numeric phase runs; the n_nz binning stays in the result so
        # steady calls report what cold calls report.
        with profiler_range("hash_binning"):
            total_nnz = nnz.sum()
            num_binning = bin_rows(nnz, upper=num_ladder.upper,
                                   num_bins=num_ladder.num_bins)
        return (C, total_nprod, total_nnz, sym_binning, num_binning,
                sym_fall_prod)

    return body


def _build_merge_executable(spec: ShardSpec, m: int, n: int) -> Callable:
    """The concatenation of the shards' CSRs for a sharded plan's
    partition.

    Row-block sub-products are disjoint in row space, so the merged C is a
    concatenation: each shard's row pointers rebased by the running nnz
    offsets (on the device: no host read) and its packed entries scattered
    at its offset, the padding dropped.  The output's storage is the sum
    of the shards' capacities, as in the reference.  The real row counts
    come from the spec's pinned bounds.
    """
    real_rows = tuple(spec.rows(s) for s in range(spec.n_shards))
    stats_mod.record_trace(("merge", spec.bounds, m, n))   # one build

    def run(parts):  # opslint: steady
        dev = parts[0].device
        nnzs = torch.stack([C.rpt[r] for C, r in zip(parts, real_rows)])
        offs = torch.zeros(len(parts) + 1, dtype=torch.int32, device=dev)
        offs[1:] = torch.cumsum(nnzs, 0)
        rpt = torch.cat([C.rpt[:r] + offs[i]
                         for i, (C, r) in enumerate(zip(parts, real_rows))]
                        + [offs[-1:]])
        out_cap = sum(C.capacity for C in parts)
        # One slot past the end takes every padding entry (dropped).
        col = torch.zeros(out_cap + 1, dtype=torch.int32, device=dev)
        val = torch.zeros(out_cap + 1, dtype=parts[0].val.dtype, device=dev)
        for i, C in enumerate(parts):
            idx = torch.arange(C.capacity, dtype=torch.int32, device=dev)
            tgt = torch.where(idx < nnzs[i], offs[i] + idx,
                              torch.full_like(idx, out_cap)).long()
            scatter.scatter_kept(col, tgt, C.col, limit=out_cap)
            scatter.scatter_kept(val, tgt, C.val, limit=out_cap)
        return CSR(rpt=rpt, col=col[:out_cap], val=val[:out_cap],
                   shape=(m, n))

    return run


# ---------------------------------------------------------------------------
# Request records.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SpgemmRequest:
    """One queued (A, B) product awaiting ``drain()``."""

    uid: int
    A: CSR
    B: CSR
    config: SpgemmConfig


@dataclasses.dataclass
class _Finished:
    """A call that completed on the steps path."""

    uid: int
    result: SpgemmResult
    auto_entry: Optional[CacheEntry] = None  # AUTO_SHARDS policy entry
    span: Optional[Span] = None    # open request/shard span (ends at finalize)
    t0: Optional[float] = None     # dispatch wall clock


@dataclasses.dataclass
class _Pending:
    """A dispatched steady-state call awaiting its one host read."""

    uid: int
    entry: CacheEntry
    plan: SpgemmPlan    # the plan it was dispatched with (the entry may be
                        # re-specialized before finalize)
    A: CSR
    B: CSR
    handles: tuple
    t0: float
    auto_entry: Optional[CacheEntry] = None  # AUTO_SHARDS policy entry
    span: Optional[Span] = None    # open request/shard span (ends at finalize)
    # Host phase times of an estimated cold call (estimate, build,
    # compile_dispatch), merged into the result's timings.
    timings: Dict[str, float] = dataclasses.field(default_factory=dict)
    done: Optional[torch.cuda.Event] = None   # recorded after the dispatch
    lease: Optional[Lease] = None  # arena workspace checked out at dispatch


@dataclasses.dataclass
class _ShardedPending:
    """A request fanned out into per-shard sub-dispatches awaiting merge.

    Each of ``shard_recs`` is an ordinary record (``_Finished`` from a
    cold shard, ``_Pending`` from a steady one) with its own verify read;
    the merge finalize checks the slices' storage buckets (redoing any
    truncated shard), then concatenates the shards' CSRs."""

    uid: int
    entry: CacheEntry   # the PARENT (sharded) plan's cache entry
    spec: ShardSpec     # the partition the shards were sliced with
    shard_recs: List["Record"]
    A: CSR              # the operands, kept for the slice check and the
    B: CSR              # redo of an overflowed shard
    config: SpgemmConfig
    t0: float
    auto_entry: Optional[CacheEntry] = None  # AUTO_SHARDS policy entry
    span: Optional[Span] = None    # open request span (ends at finalize)


Record = Union[_Finished, _Pending, _ShardedPending]


def _record_done(device: torch.device) -> Optional[torch.cuda.Event]:
    """An event after the work queued so far on ``device`` (None on CPU,
    where the work is done when the dispatch returns)."""
    if device.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return event


def _timing_event(device: torch.device) -> Optional[torch.cuda.Event]:
    """A timing event recorded now on ``device``'s current stream (None on
    the CPU)."""
    if device.type != "cuda":
        return None
    event = torch.cuda.Event(enable_timing=True)
    event.record(torch.cuda.current_stream(device))
    return event


def _record_ready(rec: Record) -> bool:
    """Whether a record's device work has completed (never blocks)."""
    if isinstance(rec, _ShardedPending):
        return all(_record_ready(r) for r in rec.shard_recs)
    if isinstance(rec, _Finished) or rec.done is None:
        return True
    return rec.done.query()


def _host_ints(*parts: torch.Tensor):
    """Every element of ``parts`` as Python ints, in ONE device-to-host
    copy."""
    flat = torch.cat([p.reshape(-1).to(torch.int64) for p in parts])
    return flat.tolist()


# ---------------------------------------------------------------------------
# The engine.
# ---------------------------------------------------------------------------

class SpgemmEngine:
    """SpGEMM front end: plan cache, steps / steady-state dispatch and the
    streaming request path.

    Usage::

        engine = SpgemmEngine(SpgemmConfig(method="hash"))
        r = engine.execute(A, B)                 # synchronous, plan-cached

        engine.submit(A1, B1); engine.submit(A2, B2)
        results = engine.drain(window=2)   # {uid: result}, completion order

    ``execute`` is what :func:`repro_torch.core.spgemm.spgemm` wraps; it is
    ``finalize(dispatch(A, B))``.  ``dispatch`` queues the device work of a
    steady-state call without reading the device, ``finalize`` makes its
    one host read.  ``policy`` tunes the :class:`AdaptivePolicy` knobs (hash
    headroom, trims, shard sizing, estimator); ``telemetry=True`` records
    spans and events.

    ``shards=N`` makes every plan of the engine's own config
    partition-aware: requests fan out into N flop-balanced row-block
    sub-dispatches of A whose CSRs the merge concatenates (one plan, N
    shards).  ``shards="auto"`` lets the policy learn N per plan from the
    cold flop estimate, bounded by the devices (one card: N = 1 unless
    ``AdaptivePolicy.max_shards`` lifts it), and revise it when the
    stream's flops drift.  ``mesh`` is a sequence of ``torch.device`` the
    shards are placed on round-robin (B replicated once per device), or
    None to run every shard where the operands are.

    ``arena`` is the workspace arena steady-state calls lease from (the
    process-wide ``default_arena()`` unless given), ``governor`` the
    :class:`MemoryGovernor` bounding it (unbounded unless given), and
    ``faults`` a :class:`FaultPlan` of injections (none unless given).
    """

    def __init__(self, config: Optional[SpgemmConfig] = None, *,
                 cache_capacity: int = 64,
                 shards: Union[int, str] = 1, mesh=None,
                 policy: Optional[AdaptivePolicy] = None,
                 telemetry: Union[Telemetry, bool, None] = None,
                 arena: Optional[Arena] = None,
                 governor: Optional[MemoryGovernor] = None,
                 faults: Optional[FaultPlan] = None):
        with profiler_range("engine_init"):
            if shards != "auto" and (isinstance(shards, str)
                                     or int(shards) < 1):
                raise ValueError(f"shards must be >= 1 or 'auto', got "
                                 f"{shards!r}")
            self.config = config or SpgemmConfig()
            self.shards = shards
            self.mesh = tuple(mesh) if mesh is not None else None
            self.policy = policy or AdaptivePolicy()
            # Every engine shares ONE arena by default, so the traffic of
            # all of them is bounded together; pass an Arena for isolation.
            # The default governor is unbounded.
            self.arena = arena if arena is not None else default_arena()
            self.governor = governor or MemoryGovernor()
            # Disabled by default: spans and events are no-ops, but the
            # registry still backs EngineStats and the plan counters.
            self.telemetry = resolve_telemetry(telemetry)
            # Fault injection at the sites lease_denial (workspace lease),
            # verify_overflow (finalize), executor_raise and slow_dispatch
            # (dispatch); the disabled default costs one attribute read.
            self.faults = resolve_faults(faults)
            self.cache = PlanCache(cache_capacity, telemetry=self.telemetry,
                                   arena=self.arena)
            self.stats = EngineStats(registry=self.telemetry.registry)
            # The estimator's headroom is learned across plans: its misses
            # are a property of the traffic, not of one signature.
            self.est_state = autotune.EstimatorState(self.policy)
            reg = self.telemetry.registry
            self._hist_request = reg.histogram(
                "opsparse_request_latency_seconds")
            self._hist_cold = reg.histogram("opsparse_cold_steps_seconds")
            self._hist_finalize = reg.histogram("opsparse_finalize_seconds")
            # Snapshots of the (possibly shared) arena's accounting, set on
            # every lease transition.
            self._arena_gauges = {name: reg.gauge(name) for name in (
                "opsparse_arena_bytes_in_use",
                "opsparse_arena_bytes_reserved",
                "opsparse_arena_peak_bytes", "opsparse_arena_lease_hits_total",
                "opsparse_arena_lease_misses_total",
                "opsparse_arena_pressure_events_total")}
            self._queue: List[SpgemmRequest] = []
            self._uids = itertools.count()
            # Replicas of B per shard device, made once per B (streams reuse
            # the same B request after request); a new B drops them all, so
            # stale replicas do not pin device memory.
            self._b_src = None
            self._b_placed: Dict[torch.device, CSR] = {}
            # (completion, sink) of results whose C was still in flight at
            # finalize (sharded, on the card), observed once complete.
            self._in_flight: List[
                Tuple[Completion, Callable[[float], None]]] = []
            self._in_flight_lock = threading.Lock()

    # -- public API ---------------------------------------------------------
    def _effective_config(self, config: Optional[SpgemmConfig]
                          ) -> SpgemmConfig:
        """The per-call config.  The engine-level ``shards`` (an int, or
        ``"auto"``) folds into the engine's own config only: an explicitly
        passed config is taken as it is, so ``SpgemmConfig(shards=1)`` opts
        one call out of the engine's sharding."""
        if config is not None:
            return config
        config = self.config
        if self.shards != 1 and config.shards == 1:
            shards = AUTO_SHARDS if self.shards == "auto" else self.shards
            config = dataclasses.replace(config, shards=shards)
        return config

    def execute(self, A: CSR, B: CSR,
                config: Optional[SpgemmConfig] = None) -> SpgemmResult:
        """Plan-then-execute one product (the ``spgemm()`` backend)."""
        return self.finalize(self.dispatch(A, B, config))

    def dispatch(self, A: CSR, B: CSR,
                 config: Optional[SpgemmConfig] = None) -> Record:
        """Plan the call and queue its device work.  A cold (or ``timing``)
        call runs the steps path to completion here; a steady-state call
        returns with its work in flight and no host read."""
        return self._dispatch(next(self._uids), A, B,
                              self._effective_config(config))

    def finalize(self, rec: Record) -> SpgemmResult:
        """The call's one host read: verify the buckets it ran with, or
        grow them and redo the call on the steps path."""
        return self._finalize(rec)

    def prewarm(self, A: CSR, B: CSR,
                config: Optional[SpgemmConfig] = None, *,
                prod_bucket: Optional[int] = None,
                nnz_bucket: Optional[int] = None) -> SpgemmPlan:
        """Specialize the plan of (A, B)'s signatures ahead of traffic,
        without executing.

        With both buckets given, the plan takes them (never shrinking what
        it learned); the first request then skips the cold discovery call,
        except for hash plans, which still need a launch schedule.  With
        neither, the sampling estimator sizes the plan, hash schedule
        included, so the first request of any method goes straight to the
        steady state.

        A sharded (or AUTO_SHARDS) config is refused with ``ValueError``:
        its buckets live on the shards' sub-plans, whose slices need data.
        Pass ``SpgemmConfig(shards=1)``, or ``PlanCache.load`` a dump.
        """
        config = self._effective_config(config)
        if config.shards != 1:
            raise ValueError(
                "prewarm seeds capacity buckets, which sharded (or "
                "AUTO_SHARDS) plans don't use; pass SpgemmConfig(shards=1) "
                "or PlanCache.load() a dump")
        a_sig, b_sig = MatrixSig.of(A), MatrixSig.of(B)
        entry = self.cache.get((a_sig, b_sig, config))
        if entry is None:
            entry = self.cache.insert(make_plan(a_sig, b_sig, config))
        if prod_bucket is None and nnz_bucket is None:
            if not entry.plan.is_specialized:
                uid = next(self._uids)
                with self.telemetry.span("estimate", uid=uid, prewarm=True):
                    self._estimate_specialize(
                        entry, A.with_capacity(a_sig.cap_bucket),
                        B.with_capacity(b_sig.cap_bucket), uid)
            return entry.plan
        if prod_bucket is None or nnz_bucket is None:
            raise ValueError(
                "pass both prod_bucket and nnz_bucket, or neither "
                "(estimator-sized prewarm)")
        self.cache.specialize(entry, entry.plan.with_capacities(
            max(entry.plan.prod_bucket or 0,
                next_bucket(max(prod_bucket, 1))),
            max(entry.plan.nnz_bucket or 0,
                next_bucket(max(nnz_bucket, 1)))))
        return entry.plan

    def submit(self, A: CSR, B: CSR,
               config: Optional[SpgemmConfig] = None) -> int:
        """Queue a request; returns its uid (resolved by ``drain``)."""
        if A.ncols != B.nrows:
            raise ValueError(f"inner dimensions differ: {A.shape} @ "
                             f"{B.shape}")
        uid = next(self._uids)
        self._queue.append(SpgemmRequest(uid, A, B,
                                         self._effective_config(config)))
        return uid

    def drain(self, *, drain_ordered: bool = False,
              window: int = 4) -> Dict[int, SpgemmResult]:
        """Run every queued request; returns {uid: result}.

        Requests are grouped by plan signature (a group shares one
        pipeline) and pipelined: at most ``window`` dispatches are in
        flight, and pending records are finalized in COMPLETION order, so
        a slow request does not hold up the small ones dispatched after
        it.  ``drain_ordered=True`` finalizes in dispatch order with one
        record in flight.  A dispatch refused by the memory governor
        (``ArenaPressureError``) is backpressure: one in-flight record is
        finalized (returning its lease) and the dispatch retried; with
        nothing in flight the error is raised.
        """
        queue, self._queue = self._queue, []
        self.stats.drains += 1
        groups: "OrderedDict[tuple, List[SpgemmRequest]]" = OrderedDict()
        for req in queue:
            key = (MatrixSig.of(req.A), MatrixSig.of(req.B), req.config)
            groups.setdefault(key, []).append(req)
        ordered = itertools.chain.from_iterable(groups.values())

        # The drain span parents every request span opened inside it.
        results: Dict[int, SpgemmResult] = {}
        with self.telemetry.span("drain", n_requests=len(queue),
                                 ordered=drain_ordered):
            if drain_ordered:
                inflight: Optional[Record] = None
                for req in ordered:
                    try:
                        rec = self._dispatch(req.uid, req.A, req.B,
                                             req.config)
                    except ArenaPressureError:
                        if inflight is None:
                            raise
                        results[inflight.uid] = self._finalize(inflight)
                        inflight = None
                        rec = self._dispatch(req.uid, req.A, req.B,
                                             req.config)
                    if inflight is not None:
                        if not isinstance(inflight, _Finished):
                            self.stats.overlapped += 1
                        results[inflight.uid] = self._finalize(inflight)
                    inflight = rec
                if inflight is not None:
                    results[inflight.uid] = self._finalize(inflight)
                return results

            pending: List[Record] = []
            window = max(1, int(window))
            for req in ordered:
                # Reap down BEFORE dispatching, so the window (a device-
                # memory bound) holds at the moment of dispatch.
                while len(pending) >= window:
                    self._reap_one(pending, results)
                while True:
                    try:
                        rec = self._dispatch(req.uid, req.A, req.B,
                                             req.config)
                        break
                    except ArenaPressureError:
                        if not pending:
                            raise
                        self._reap_one(pending, results)
                if any(not isinstance(r, _Finished) for r in pending):
                    self.stats.overlapped += 1   # planned k+1 while k ran
                pending.append(rec)
                self.stats.peak_inflight = max(self.stats.peak_inflight,
                                               len(pending))
            while pending:
                self._reap_one(pending, results)
        self.flush_latencies()
        return results

    def report(self) -> str:
        self.flush_latencies()
        return stats_mod.render(self)

    def on_complete(self, result: SpgemmResult,
                    sink: Callable[[float], None]) -> None:
        """Call ``sink`` with the wall clock (``time.perf_counter``) at
        which ``result``'s C was complete on the device: now when it was
        complete at return, else once its :class:`Completion` is (at the
        next finalize, drain, ``report()`` or :meth:`flush_latencies`)."""
        done = result.completion
        if done is None:
            sink(time.perf_counter())
            return
        with self._in_flight_lock:
            self._in_flight.append((done, sink))
        self.flush_latencies()

    def flush_latencies(self, *, wait: bool = False) -> int:
        """Hand every :meth:`on_complete` sink whose C has completed since
        its completion time; ``wait=True`` waits for those still in
        flight.  Returns how many sinks still wait."""
        with self._in_flight_lock:
            pending, self._in_flight = self._in_flight, []
        keep = []
        for done, sink in pending:
            if wait:
                done.end.synchronize()
            if done.ready():
                sink(done.time())
            else:
                keep.append((done, sink))
        if keep:
            with self._in_flight_lock:
                self._in_flight[:0] = keep
        return len(keep)

    # -- internals ----------------------------------------------------------
    def _reap_one(self, pending: List[Record],
                  results: Dict[int, SpgemmResult]) -> None:
        """Finalize ONE pending record, preferring one whose device work
        is done; with none done yet, the oldest."""
        for i, rec in enumerate(pending):
            if _record_ready(rec):
                if i:
                    self.stats.reordered += 1
                pending.pop(i)
                results[rec.uid] = self._finalize(rec)
                return
        rec = pending.pop(0)
        results[rec.uid] = self._finalize(rec)

    def _update_arena_gauges(self) -> None:
        """Snapshot the (possibly shared) arena's accounting into this
        engine's registry gauges; called on every lease transition."""
        a = self.arena
        g = self._arena_gauges
        g["opsparse_arena_bytes_in_use"].set(a.bytes_in_use)
        g["opsparse_arena_bytes_reserved"].set(a.bytes_reserved)
        g["opsparse_arena_peak_bytes"].set(a.peak_bytes)
        g["opsparse_arena_lease_hits_total"].set(a.lease_hits)
        g["opsparse_arena_lease_misses_total"].set(a.lease_misses)
        g["opsparse_arena_pressure_events_total"].set(a.pressure_events)

    # -- fault-injection sites (core/faults.py) -------------------------------
    def _note_fault(self, site: str, uid: int) -> None:
        self.stats.faults_injected += 1
        self.telemetry.event("fault_injected", uid=uid, site=site)

    def _consult_dispatch_faults(self, uid: int) -> None:
        """``executor_raise`` and ``slow_dispatch``, consulted once per
        request."""
        faults = self.faults
        if not faults.enabled:
            return
        spec = faults.fire("executor_raise", uid=uid)
        if spec is not None:
            self._note_fault("executor_raise", uid)
            raise InjectedFault(
                spec.message or f"injected executor fault (uid={uid})",
                site="executor_raise", transient=spec.transient)
        spec = faults.fire("slow_dispatch", uid=uid)
        if spec is not None and spec.delay_s > 0:
            self._note_fault("slow_dispatch", uid)
            time.sleep(spec.delay_s)

    def _try_lease(self, spec, cap, device, uid: int) -> Optional[Lease]:
        """Arena acquisition behind the ``lease_denial`` site: an injected
        denial is indistinguishable from the cap binding, so the governor
        ladder (and the drain's backpressure above it) runs for real.
        Each acquisition attempt, the ladder's retries included, is one
        visit of the site."""
        if self.faults.enabled \
                and self.faults.fire("lease_denial", uid=uid) is not None:
            self._note_fault("lease_denial", uid)
            return None
        return self.arena.try_acquire(spec, cap, device)

    def _forced_overflow(self, uid: int) -> bool:
        """``verify_overflow``: one visit per steady-state finalize that
        found no real overflow."""
        if not self.faults.enabled:
            return False
        if self.faults.fire("verify_overflow", uid=uid) is None:
            return False
        self._note_fault("verify_overflow", uid)
        return True

    # -- the workspace lease ------------------------------------------------
    def _lease_workspace(self, entry: CacheEntry, uid: int,
                         device: torch.device) -> Tuple[Optional[Lease], bool]:
        """Check the plan's workspace out of the arena, walking the
        governor's degradation ladder under pressure.

        Returns ``(lease, spill)``: ``lease`` is ``None`` for plans with
        nothing leasable (``workspace_spec() is None``) and under a spill;
        ``spill=True`` routes THIS call through the unleased two-pass
        steps path.  Raises :class:`ArenaPressureError` when the ladder is
        exhausted (``drain`` answers it with backpressure)."""
        spec = entry.plan.workspace_spec()
        if spec is None:
            return None, False
        cap = self.governor.cap_bytes
        lease = self._try_lease(spec, cap, device, uid)
        if lease is None:
            # rung 0: the cap binds: count the pressure, drop idle pooled
            # buffers, retry.
            self.arena.note_pressure()
            self.stats.arena_pressure += 1
            self.telemetry.event("arena_pressure", uid=uid,
                                 want_bytes=spec.nbytes, cap_bytes=cap,
                                 reserved=self.arena.bytes_reserved)
            self.arena.reclaim()
            lease = self._try_lease(spec, cap, device, uid)
        if lease is None and self.governor.trim_under_pressure:
            # rung 1: forced headroom trim: re-derive the hash schedule at
            # the policy floor from the streak's observed maxima, which
            # shrinks the plan's lease (and drops its pipeline).
            plan = entry.plan
            state = plan.policy
            if (plan.config.method == "hash"
                    and plan.hash_schedule is not None
                    and state is not None and state.sym_max is not None):
                forced = dataclasses.replace(
                    state, headroom=self.policy.headroom_min)
                trimmed = autotune.trim_schedule(
                    forced, plan.hash_schedule, m=plan.a_sig.nrows,
                    sym_ladder=plan.sym_ladder,
                    packed=plan.config.row_packing,
                    fused=plan.config.fuse_numeric, policy=self.policy)
                if trimmed is not None:
                    self.stats.arena_trims += 1
                    entry.stats.schedule_trims += 1
                    self.telemetry.event("arena_trim", uid=uid)
                    self.cache.specialize(
                        entry,
                        plan.with_hash_schedule(HashSchedule(*trimmed))
                        .with_policy(forced.after_trim(self.policy)))
                    spec = entry.plan.workspace_spec()
                    if spec is None:
                        return None, False
                    lease = self._try_lease(spec, cap, device, uid)
        if lease is None and self.governor.spill_fused \
                and entry.plan.config.method == "hash" \
                and entry.plan.config.fuse_numeric:
            # rung 2: spill the fused plan to the two-pass steps path for
            # this call: no lease, no arena growth, the same C.  Hash-fused
            # only: an ESC "spill" would allocate the same expansion per
            # call, outside the arena's accounting.
            self.stats.arena_spills += 1
            self.telemetry.event("arena_spill", uid=uid)
            return None, True
        if lease is None:
            # rung 3: refuse; the caller must return leases first.
            raise ArenaPressureError(
                f"workspace lease of {spec.nbytes} bytes exceeds the "
                f"governor cap ({cap} bytes; "
                f"{self.arena.bytes_reserved} reserved)")
        self._update_arena_gauges()
        return lease, False

    def _release_ws(self, rec: _Pending) -> None:
        """Return a dispatch's lease to the arena; called after finalize's
        host read, when the device work that wrote it is done."""
        if rec.lease is not None:
            lease, rec.lease = rec.lease, None
            self.arena.release(lease)
            if lease in rec.entry.leases:
                rec.entry.leases.remove(lease)
            self._update_arena_gauges()

    def _estimate_specialize(self, entry: CacheEntry, A: CSR, B: CSR,
                             uid: int) -> Dict[str, float]:
        """Specialize a cold plan from the sampling estimator.

        One host read of the operands' index arrays gives the exact n_prod
        per row (hence the exact symbolic-side schedule) and a measured
        row sample whose compression band predicts the nnz bucket and the
        numeric-side rung counts.  The plan is specialized in one step,
        with its policy marked ``estimated``; the first admitted finalize
        confirms it, and an under-estimate costs one grow-and-redo while
        the engine's :class:`~repro_torch.engine.autotune.EstimatorState`
        grows the headroom for the next cold plan.  Returns
        ``{"estimate": seconds}``.
        """
        plan = entry.plan
        config = plan.config
        t0 = time.perf_counter()
        est = estimate_result(
            A, B,
            sym_upper=plan.sym_ladder.upper,
            num_upper=plan.num_ladder.upper,
            n_sample=self.policy.est_sample_rows,
            quantile=self.policy.est_quantile,
            headroom=self.est_state.headroom)
        self.stats.estimates += 1
        self.telemetry.event(
            "estimate", uid=uid, sampled_rows=est.sampled_rows,
            r_lo=est.r_lo, r_hi=est.r_hi, total_nprod=est.total_nprod,
            total_nnz_high=est.total_nnz_high,
            est_headroom=self.est_state.headroom)
        prod_cap = max(plan.prod_bucket or 0,
                       next_bucket(max(int(est.total_nprod
                                           * _CAPACITY_HEADROOM), 1)))
        nnz_cap = max(plan.nnz_bucket or 0,
                      next_bucket(max(int(est.total_nnz_high
                                          * _CAPACITY_HEADROOM), 1)))
        state = plan.policy or PolicyState(
            headroom=self.policy.headroom_init)
        specialized = plan.with_capacities(prod_cap, nnz_cap)
        if config.method == "hash":
            # The bucket math of host_schedule, fed estimated counts: exact
            # rows per sym rung, band-high rows per num rung, and the
            # band-high fallback products shared by both phases.
            m_cap = next_bucket(plan.a_sig.nrows,
                                minimum=spgemm_hash._ROW_BUCKET_MIN)
            packs = (plan.sym_ladder.rows_per_block
                     if config.row_packing else None)
            sym_buckets = tuple(
                spgemm_hash.schedule_bucket(
                    c, m_cap=m_cap, headroom=state.headroom,
                    pack=(packs[b] if packs is not None and b < len(packs)
                          else 1))
                for b, c in enumerate(est.sym_counts))
            num_buckets = tuple(
                spgemm_hash.schedule_bucket(c, m_cap=m_cap,
                                            headroom=state.headroom)
                for c in est.num_counts)
            fall = max(est.sym_fall_prod, est.num_fall_prod)
            fall_bucket = (spgemm_hash.fallback_capacity_bucket(
                fall, headroom=state.headroom) if fall else 0)
            sched = HashSchedule(sym_buckets, num_buckets, fall_bucket)
            if plan.hash_schedule is not None:
                sched = sched.union(plan.hash_schedule)
            specialized = specialized.with_hash_schedule(sched)
        self.cache.specialize(
            entry, specialized.with_policy(state.with_estimated(True)))
        return {"estimate": time.perf_counter() - t0}

    def _dispatch(self, uid: int, A: CSR, B: CSR, config: SpgemmConfig, *,
                  _sub: bool = False,
                  _parent: Optional[Span] = None) -> Record:
        if A.ncols != B.nrows:
            raise ValueError(f"inner dimensions differ: {A.shape} @ "
                             f"{B.shape}")
        if config.shards == AUTO_SHARDS:
            auto_entry, config = self._resolve_auto_shards(A, B, config)
            rec = self._dispatch(uid, A, B, config, _sub=_sub,
                                 _parent=_parent)
            rec.auto_entry = auto_entry   # finalize feeds telemetry back
            return rec
        if config.shards > 1:
            if A.nrows >= 2:
                return self._dispatch_sharded(uid, A, B, config)
            # Nothing to partition: run (and key the plan) unsharded.
            config = dataclasses.replace(config, shards=1)
        if not _sub:       # shard sub-dispatches are not user requests
            self.stats.requests += 1
            self._consult_dispatch_faults(uid)
        t0 = time.perf_counter()
        tel = self.telemetry
        # The request (or shard) span stays OPEN across dispatch and
        # finalize: it rides the record and _finalize closes it.
        span = tel.start_span("shard" if _sub else "request",
                              parent=_parent, uid=uid, method=config.method)
        with tel.span("plan_lookup", parent=span, uid=uid) as lookup:
            a_sig, b_sig = MatrixSig.of(A), MatrixSig.of(B)
            entry = self.cache.get((a_sig, b_sig, config))
            lookup.set(hit=entry is not None)
            if entry is None:
                entry = self.cache.insert(make_plan(a_sig, b_sig, config))
        entry.stats.calls += 1
        # Operand storage padded to the signature buckets, so every request
        # in the bucket presents the same shapes.
        with profiler_range("operand_pad"):
            A = A.with_capacity(a_sig.cap_bucket)
            B = B.with_capacity(b_sig.cap_bucket)

        plan = entry.plan
        est_timings: Optional[Dict[str, float]] = None
        if (config.plan_mode == "estimate" and not plan.is_specialized
                and not config.timing):
            # Estimated cold path: specialize from the sampled estimate and
            # fall through to the steady state; the full symbolic sizing
            # pass never runs.  Finalize's verify (and grow-and-redo) is
            # the correctness net.
            with tel.span("estimate", parent=span, uid=uid):
                est_timings = self._estimate_specialize(entry, A, B, uid)
            plan = entry.plan

        if not plan.is_specialized or config.timing:
            state = plan.policy or PolicyState(
                headroom=self.policy.headroom_init)
            with tel.span("cold_steps", parent=span, uid=uid,
                          specialized=plan.is_specialized) as cold:
                result, prod_cap, nnz_cap, hash_sched = _execute_steps(
                    A, B, plan,
                    StepTimer(config.timing or not plan.is_specialized,
                              tracer=tel, uid=uid, stats=self.stats),
                    headroom=state.headroom)
            if tel.enabled:
                self._hist_cold.observe(cold.dur)
            if not plan.is_specialized:
                # Progressive allocation: learn the buckets (and the launch
                # schedule the run just used) for the steady state.
                with profiler_range("plan_specialize"):
                    specialized = plan.with_capacities(prod_cap, nnz_cap)
                    if hash_sched is not None:
                        specialized = specialized.with_hash_schedule(
                            hash_sched).with_policy(state)
                    self.cache.specialize(entry, specialized)
            entry.stats.steps_calls += 1
            entry.stats.time_s += time.perf_counter() - t0
            return _Finished(uid, result, span=span, t0=t0)

        # The lease comes BEFORE the pipeline: a forced pressure trim
        # re-specializes the entry, and the build must see that plan.
        with profiler_range("lease"):
            lease, spill = self._lease_workspace(entry, uid, A.device)
        if spill:
            # Fused->two-pass spill: this call runs the unleased steps
            # path (the same C); the plan and its pipeline stay cached for
            # when the pressure clears.
            state = entry.plan.policy or PolicyState(
                headroom=self.policy.headroom_init)
            with tel.span("arena_spill_steps", parent=span, uid=uid):
                result, _, _, _ = _execute_steps(
                    A, B, entry.plan,
                    StepTimer(config.timing, tracer=tel, uid=uid,
                              stats=self.stats),
                    headroom=state.headroom)
            entry.stats.steps_calls += 1
            entry.stats.time_s += time.perf_counter() - t0
            return _Finished(uid, result, span=span, t0=t0)
        plan = entry.plan
        if lease is not None:
            entry.leases.append(lease)   # eviction forfeits outstanding ones
        if entry.executable is None:
            with tel.span("build_executable", parent=span, uid=uid):
                t_build = time.perf_counter()
                if config.method != "hash":
                    make_pipeline = _build_hot_executable
                elif config.fuse_numeric:
                    make_pipeline = _build_fused_hash_executable
                else:
                    make_pipeline = _build_hash_executable
                entry.executable = make_pipeline(plan)
                stats_mod.record_trace(plan.signature)
                if est_timings is not None:
                    est_timings["build"] = time.perf_counter() - t_build
        with tel.span("dispatch", parent=span, uid=uid):
            t_disp = time.perf_counter()
            ws = None if lease is None else (lease.i32, lease.val)
            handles = entry.executable(A, B, ws)    # no host read
            done = _record_done(A.device)
            if est_timings is not None:
                est_timings["compile_dispatch"] = (time.perf_counter()
                                                   - t_disp)
        entry.stats.hot_calls += 1
        return _Pending(uid, entry, plan, A, B, handles, t0, span=span,
                        timings=est_timings or {}, done=done, lease=lease)

    def _dispatch_sharded(self, uid: int, A: CSR, B: CSR,
                          config: SpgemmConfig) -> Record:
        """Fan one request out into per-shard row-block sub-dispatches.

        The parent plan owns the learned :class:`ShardSpec`; each shard's
        A slice is padded to the spec's pow-2 row and storage buckets and
        dispatched through the ordinary (unsharded) plan machinery, so the
        shards reuse the steady-state pipelines, and shards whose buckets
        coincide share ONE sub-plan.  A slice outgrowing its bucket grows
        that shard's bucket alone (checked at finalize).
        """
        self.stats.requests += 1
        self.stats.sharded_requests += 1
        self._consult_dispatch_faults(uid)
        t0 = time.perf_counter()
        tel = self.telemetry
        span = tel.start_span("request", uid=uid, method=config.method,
                              shards=config.shards)
        a_sig, b_sig = MatrixSig.of(A), MatrixSig.of(B)
        with tel.span("plan_lookup", parent=span, uid=uid) as lookup:
            entry = self.cache.get((a_sig, b_sig, config))
            lookup.set(hit=entry is not None)
            if entry is None:
                entry = self.cache.insert(make_plan(a_sig, b_sig, config))
        entry.stats.calls += 1

        spec = entry.plan.shard_spec
        if spec is None:
            # Cold call: ONE host read of the flop estimate (and of A's row
            # pointers) balances the row blocks; the partition is then
            # pinned, so steady shard signatures never move.  Whether a
            # later request's slices FIT the learned storage buckets is
            # checked at finalize, which keeps the steady dispatch free of
            # host reads.
            with tel.span("partition", parent=span, uid=uid):
                flops = row_flops(A, B)
                rpt = A.rpt.cpu().numpy()
                spec = plan_shards(rpt, flops, config.shards, telemetry=tel)
                self.cache.specialize(entry,
                                      entry.plan.with_shard_spec(spec))

        if entry.executable is None:
            with tel.span("build_executable", parent=span, uid=uid):
                entry.executable = _build_merge_executable(
                    spec, m=A.nrows, n=B.ncols)

        devices = (shard_devices(self.mesh, spec.n_shards)
                   if self.mesh is not None else None)
        sub_cfg = dataclasses.replace(config, shards=1)
        shard_recs: List[Record] = []
        for s in range(spec.n_shards):
            A_s = A.row_slice(spec.bounds[s], spec.bounds[s + 1],
                              nrows=spec.row_buckets[s],
                              capacity=spec.cap_buckets[s])
            B_s = B
            if devices is not None:
                dev = devices[s]
                A_s = A_s.to(dev)                       # row-sharded A
                if self._b_src is not B.val:            # new B: drop replicas
                    self._b_src = B.val
                    self._b_placed = {}
                if dev not in self._b_placed:
                    self._b_placed[dev] = B.to(dev)
                B_s = self._b_placed[dev]
            try:
                rec = self._dispatch(uid, A_s, B_s, sub_cfg, _sub=True,
                                     _parent=span)
            except ArenaPressureError:
                # Unwind the fan-out: finalize the shards already in flight
                # so their leases return, then re-raise; the drain's
                # backpressure redispatches the whole request.
                for r in shard_recs:
                    self._finalize(r)
                tel.end_span(span)
                raise
            rec.span.set(shard=s)
            shard_recs.append(rec)
        return _ShardedPending(uid, entry, spec, shard_recs, A, B,
                               config, t0, span=span)

    # -- adaptive shard count (AUTO_SHARDS) ---------------------------------
    def _device_count(self, device: torch.device) -> int:
        """Occupancy bound of the shard count: the devices shards could
        land on (the mesh, else the cards, else 1 for CPU operands)."""
        if self.mesh is not None:
            return len(data_axis_devices(self.mesh))
        if device.type != "cuda":
            return 1
        return max(torch.cuda.device_count(), 1)

    def _resolve_auto_shards(self, A: CSR, B: CSR, config: SpgemmConfig):
        """Turn an AUTO_SHARDS config into a concrete one via the policy.

        The decision lives on the AUTO plan entry (keyed by the unresolved
        config), so it is learned once per signature, with ONE host read of
        the flop estimate on the cold request, then pinned; finalize
        telemetry (:meth:`_note_auto`) revises it when the stream's mean
        flops drift out of the hysteresis band.
        """
        self.stats.auto_requests += 1
        a_sig, b_sig = MatrixSig.of(A), MatrixSig.of(B)
        entry = self.cache.get((a_sig, b_sig, config))
        if entry is None:
            entry = self.cache.insert(make_plan(a_sig, b_sig, config))
        state = entry.plan.policy
        if state is None or state.shard_decision is None:
            total = int(row_flops(A, B).sum())
            n = autotune.choose_shards(total, A.nrows,
                                       self._device_count(A.device),
                                       self.policy, telemetry=self.telemetry)
            state = ((state or PolicyState(headroom=self.policy.headroom_init))
                     .with_shard_decision(n, total))
            self.cache.update_policy(entry, state)
        n = state.shard_decision
        return entry, dataclasses.replace(config, shards=max(n, 1))

    def _note_auto(self, entry: CacheEntry, result: SpgemmResult) -> None:
        """Feed one finalized request's flop estimate back to its AUTO
        plan's policy, revising the shard decision on sustained drift."""
        state = entry.plan.policy
        if state is None:
            return
        state = state.note_flops(2 * result.total_nprod)
        state, revised = autotune.revise_shards(
            state, entry.plan.a_sig.nrows,
            self._device_count(result.C.device), self.policy,
            telemetry=self.telemetry)
        if revised:
            self.stats.policy_revisions += 1
        self.cache.update_policy(entry, state)

    def _finalize(self, rec: Record) -> SpgemmResult:
        tel = self.telemetry
        self.flush_latencies()
        with tel.span("finalize", parent=rec.span, uid=rec.uid) as fin:
            result = self._finalize_record(rec)
        if rec.auto_entry is not None:
            self._note_auto(rec.auto_entry, result)
        span = rec.span
        if tel.enabled:
            self._hist_finalize.observe(fin.dur)
            if isinstance(span, Span):
                # Close the request/shard span the dispatch left open;
                # only requests feed the request-latency histogram, with
                # the time their C took to complete.
                tel.end_span(span)
                if span.name == "request" and rec.t0 is not None:
                    t0, hist = rec.t0, self._hist_request
                    self.on_complete(result,
                                     lambda t: hist.observe(t - t0))
        return result

    def _discard(self, rec: Record) -> None:
        """Drop a shard record superseded by a redo: wait for its device
        work, return its lease and close its span (its result is unused)."""
        if isinstance(rec, _Pending):
            if rec.done is not None:
                rec.done.synchronize()
            self._release_ws(rec)
        self.telemetry.end_span(rec.span)

    def _finalize_sharded(self, rec: _ShardedPending) -> SpgemmResult:
        """Merge finalize: one verify read per shard (each sub-record's
        ordinary finalize, overflow redo and all), then the concatenation
        of the shards' CSRs on the device.

        The slice-storage check happens HERE, not at dispatch: a slice
        whose nnz outgrew its learned bucket was truncated (its sub-plan
        cannot tell: the truncated slice is a valid CSR), so the read of
        A's row pointers at the bounds is part of the request's verify.
        That keeps the sharded dispatch free of host reads.  An overflow
        grows only the offending shard's bucket and redoes only that shard.
        """
        t_fin = time.perf_counter()
        tel = self.telemetry
        spec = rec.spec
        with host_read(tel, self.stats, "verify_slices", uid=rec.uid):
            bounds = torch.tensor(spec.bounds, dtype=torch.long,
                                  device=rec.A.rpt.device)
            slice_nnz = rec.A.rpt[bounds].tolist()
        sizes = [slice_nnz[s + 1] - slice_nnz[s]
                 for s in range(spec.n_shards)]
        overflowed = [s for s in range(spec.n_shards)
                      if sizes[s] > spec.cap_buckets[s]]
        if overflowed:
            tel.event("shard_grow", uid=rec.uid, shards=tuple(overflowed))
            grown = spec
            for s in overflowed:
                grown = grown.with_cap_bucket(s, 2 * sizes[s])  # headroom
                self.stats.shard_grows += 1
            rec.entry.stats.capacity_grows += len(overflowed)
            current = rec.entry.plan.shard_spec
            if current is not None:     # keep any concurrent growth
                grown = grown.union(current)
            self.cache.specialize(
                rec.entry, rec.entry.plan.with_shard_spec(grown))
            sub_cfg = dataclasses.replace(rec.config, shards=1)
            for s in overflowed:        # redo ONLY the truncated shards
                self._discard(rec.shard_recs[s])
                A_s = rec.A.row_slice(spec.bounds[s], spec.bounds[s + 1],
                                      nrows=grown.row_buckets[s],
                                      capacity=grown.cap_buckets[s])
                rec.shard_recs[s] = self._dispatch(
                    rec.uid, A_s, rec.B, sub_cfg, _sub=True,
                    _parent=rec.span)
        shard_results = [self._finalize(r) for r in rec.shard_recs]
        merge = rec.entry.executable
        if merge is None:     # the entry was re-specialized while in flight
            merge = _build_merge_executable(
                rec.spec, m=rec.spec.bounds[-1], n=rec.B.ncols)
            rec.entry.executable = merge
        parts = tuple(r.C for r in shard_results)
        home = rec.A.device
        with tel.span("shard_merge", uid=rec.uid, n_shards=spec.n_shards):
            # The merge is the request's last device work: its events give
            # the time the request's C is complete (see Completion).
            start = _timing_event(home)
            t_merge = time.perf_counter()
            if self.mesh is not None:
                # Shard results live on their shard's device: gather them
                # where the operands are before concatenating.
                parts = tuple(C.to(home) for C in parts)
            C = merge(parts)
            end = _timing_event(home)
        timings: Dict[str, float] = {}
        for r in shard_results:
            for k, v in r.timings.items():
                timings[k] = timings.get(k, 0.0) + v
        # Book only the merge/verify overhead on the parent plan: the shard
        # work is charged to the shard plans.
        rec.entry.stats.time_s += time.perf_counter() - t_fin
        return SpgemmResult(
            C=C,
            total_nprod=sum(r.total_nprod for r in shard_results),
            total_nnz=sum(r.total_nnz for r in shard_results),
            sym_binning=None, num_binning=None, timings=timings,
            completion=(None if end is None
                        else Completion(t_merge, start, end)))

    def _finalize_record(self, rec: Record) -> SpgemmResult:
        if isinstance(rec, _ShardedPending):
            return self._finalize_sharded(rec)
        if isinstance(rec, _Finished):
            return rec.result
        # Verify against the DISPATCH-TIME plan: passing a later, larger
        # plan's check would return a silently truncated C.
        plan = rec.plan
        method = plan.config.method
        tel = self.telemetry
        if method == "hash" and plan.config.fuse_numeric:
            C, tnp, tnz, sym_binning, num_binning, sym_fall = rec.handles
            nb = sym_binning.bin_size.shape[0]
            with host_read(tel, self.stats, "verify_sync", uid=rec.uid):
                fetched = _host_ints(tnp, tnz, sym_binning.bin_size,
                                     sym_fall)
            total_nprod, total_nnz = fetched[0], fetched[1]
            sym_sizes, sym_fall_prod = fetched[2:2 + nb], fetched[2 + nb]
            schedule_ok = plan.hash_schedule.admits_fused(sym_sizes,
                                                          sym_fall_prod)
            admit = dict(sym_sizes=sym_sizes, sym_fall=sym_fall_prod)
        elif method == "hash":
            (C, tnp, tnz, sym_binning, num_binning,
             sym_fall, num_fall) = rec.handles
            ns = sym_binning.bin_size.shape[0]
            nn = num_binning.bin_size.shape[0]
            with host_read(tel, self.stats, "verify_sync", uid=rec.uid):
                fetched = _host_ints(tnp, tnz, sym_binning.bin_size,
                                     num_binning.bin_size, sym_fall,
                                     num_fall)
            total_nprod, total_nnz = fetched[0], fetched[1]
            admit = dict(sym_sizes=fetched[2:2 + ns],
                         num_sizes=fetched[2 + ns:2 + ns + nn],
                         sym_fall=fetched[2 + ns + nn],
                         num_fall=fetched[3 + ns + nn])
            schedule_ok = plan.hash_schedule.admits(
                admit["sym_sizes"], admit["num_sizes"], admit["sym_fall"],
                admit["num_fall"])
        else:
            C, tnp, tnz, sym_binning, num_binning = rec.handles
            with host_read(tel, self.stats, "verify_sync", uid=rec.uid):
                total_nprod, total_nnz = _host_ints(tnp, tnz)
            schedule_ok = True
            admit = None
        # The host read waited for the stream that wrote the workspace.
        self._release_ws(rec)
        if method != "hash" and total_nprod > plan.prod_bucket:
            return self._grow_and_redo(rec, total_nprod, total_nnz)
        if not schedule_ok:
            self.stats.bin_overflows += 1
            rec.entry.stats.bin_overflows += 1
        if (not schedule_ok or total_nnz > plan.nnz_bucket
                or self._forced_overflow(rec.uid)):
            return self._grow_and_redo(rec, total_nprod, total_nnz,
                                       schedule_overflow=not schedule_ok)
        if admit is not None:
            self._note_hash_admit(rec, **admit)
        else:
            # ESC plans have no hash schedule: the estimate is confirmed
            # here rather than in _note_hash_admit.
            state = rec.entry.plan.policy
            if state is not None and state.estimated:
                self._note_estimate_confirmed(rec.uid)
                self.cache.update_policy(rec.entry,
                                         state.with_estimated(False))
        rec.entry.stats.time_s += time.perf_counter() - rec.t0
        return SpgemmResult(
            C=C, total_nprod=total_nprod, total_nnz=total_nnz,
            sym_binning=sym_binning, num_binning=num_binning,
            timings=dict(rec.timings))

    def _note_estimate_confirmed(self, uid: int) -> None:
        """An admitted finalize just verified an estimated plan: count the
        hit and let the estimator's headroom decay toward its floor."""
        self.stats.estimate_hits += 1
        self.est_state.note_hit()
        self.telemetry.event("estimate_confirmed", uid=uid,
                             est_headroom=self.est_state.headroom)

    def _note_hash_admit(self, rec: _Pending, sym_sizes, sym_fall,
                         num_sizes=None, num_fall=0) -> None:
        """Adaptive headroom for one ADMITTED hash finalize.

        Folds the bin sizes the verify read already fetched into the
        plan's policy state.  Once the streak of admitted calls reaches
        the policy's threshold, the schedule is re-derived from the
        observed maxima at a shrunken headroom and swapped in when that
        removes padding rows or whole rungs (one pipeline rebuild).  At
        most one trim fires per overflow epoch.
        """
        entry = rec.entry
        plan = entry.plan      # CURRENT plan: maxima fold monotonically
        if plan.hash_schedule is None:
            return
        state = plan.policy or PolicyState(headroom=self.policy.headroom_init)
        if state.estimated:
            # First admitted finalize under an estimated schedule: the
            # prediction held.
            self._note_estimate_confirmed(rec.uid)
            state = state.with_estimated(False)
        state = state.note_admit(sym_sizes, sym_fall, num_sizes, num_fall)
        if state.wants_trim(self.policy):
            trimmed = autotune.trim_schedule(
                state, plan.hash_schedule, m=plan.a_sig.nrows,
                sym_ladder=plan.sym_ladder, packed=plan.config.row_packing,
                fused=plan.config.fuse_numeric, policy=self.policy)
            state = state.after_trim(self.policy)
            if trimmed is not None:
                self.stats.schedule_trims += 1
                entry.stats.schedule_trims += 1
                self.telemetry.event("schedule_trim", uid=rec.uid,
                                     headroom=state.headroom)
                self.cache.specialize(entry, plan.with_hash_schedule(
                    HashSchedule(*trimmed)).with_policy(state))
                return
        self.cache.update_policy(entry, state)

    def _grow_and_redo(self, rec: _Pending, total_nprod: int,
                       total_nnz: int, *,
                       schedule_overflow: bool = False) -> SpgemmResult:
        """Overflow recovery (a same-signature request outgrew the learned
        plan): grow the buckets, redo the call on the steps path, and
        re-specialize the entry so the NEXT request is hot again.

        Only a hash BIN-SCHEDULE overflow (``schedule_overflow``) grows the
        bin headroom; a capacity overflow with an admitting schedule grows
        the pow-2 buckets alone."""
        plan = rec.plan
        self.stats.capacity_grows += 1
        rec.entry.stats.capacity_grows += 1
        tel = self.telemetry
        tel.event("capacity_grow", uid=rec.uid,
                  schedule_overflow=schedule_overflow,
                  total_nprod=total_nprod, total_nnz=total_nnz)
        # An overflowed run truncated its expansion or dropped rows past a
        # bin bucket, so its totals are lower bounds; the steps redo
        # reports the true capacities.  Floor at the entry's CURRENT
        # buckets so a concurrent grow is kept.
        current = rec.entry.plan
        grown = plan.with_capacities(
            max(plan.prod_bucket, current.prod_bucket or 0,
                next_bucket(max(total_nprod, 1))),
            max(plan.nnz_bucket, current.nnz_bucket or 0,
                next_bucket(max(total_nnz, 1))))
        state = current.policy or PolicyState(
            headroom=self.policy.headroom_init)
        if state.estimated:
            # An estimated plan under-provisioned: the redo re-derives
            # exact buckets, and the estimator's headroom grows.
            self.stats.estimate_misses += 1
            self.est_state.note_miss()
            tel.event("estimate_miss", uid=rec.uid,
                      schedule_overflow=schedule_overflow)
            state = state.with_estimated(False)
        if schedule_overflow:
            state = state.note_overflow(self.policy)
        grown = grown.with_policy(state)
        with tel.span("grow_redo", uid=rec.uid):
            result, prod_cap, nnz_cap, hash_sched = _execute_steps(
                rec.A, rec.B, grown,
                StepTimer(False, tracer=tel, uid=rec.uid, stats=self.stats),
                headroom=state.headroom)
        rec.entry.stats.steps_calls += 1
        respecialized = grown.with_capacities(prod_cap, nnz_cap)
        if hash_sched is not None:
            if current.hash_schedule is not None:
                hash_sched = hash_sched.union(current.hash_schedule)
            respecialized = respecialized.with_hash_schedule(hash_sched)
        self.cache.specialize(rec.entry, respecialized)
        rec.entry.stats.time_s += time.perf_counter() - rec.t0
        return result


# ---------------------------------------------------------------------------
# The process-wide default engine behind ``repro_torch.core.spgemm``.
# ---------------------------------------------------------------------------

_DEFAULT: Optional[SpgemmEngine] = None
_DEFAULT_LOCK = threading.Lock()


def default_engine() -> SpgemmEngine:
    """Shared engine serving every ``spgemm()`` call in the process."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            _DEFAULT = SpgemmEngine()
        return _DEFAULT


def reset_default_engine() -> None:
    """Drop the shared engine (tests that need a cold cache)."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        _DEFAULT = None
