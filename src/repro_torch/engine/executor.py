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

The adaptive headroom, arena leases, telemetry, faults, sharding and the
submit/drain stream of the reference wait for later slices: schedules are
learned with the fixed headroom ``_HEADROOM`` (it only pads them and never
changes a result).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, Optional, Union

import torch

from repro_torch.core import esc
from repro_torch.core.analysis import exclusive_sum_in_place, nprod_into_rpt
from repro_torch.core.binning import bin_rows, bin_rows_for_ladder
from repro_torch.core.csr import CSR
from repro_torch.core.spgemm import SpgemmConfig, SpgemmResult
from repro_torch.core.workspace import next_bucket
from repro_torch.kernels import spgemm_hash

from .cache import CacheEntry, PlanCache
from .plan import HashSchedule, SpgemmPlan, plan as make_plan, plan_key

# Bin-count headroom of learned hash schedules (the reference's
# AdaptivePolicy.headroom_init): steady-state bin-size jitter stays inside
# the buckets; padding rows are masked blocks.
_HEADROOM = 2.0
# Capacity buckets (product expansion / C storage) get a smaller margin: it
# only moves the pow-2 bucket when the observed total sits in the top fifth
# of one, where same-signature jitter would otherwise flip buckets.
_CAPACITY_HEADROOM = 1.25


def _sync(value: torch.Tensor) -> None:
    if value.is_cuda:
        torch.cuda.synchronize(value.device)


class StepTimer:
    """Per-step wall clock of the steps path (waits only when enabled)."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.timings: Dict[str, float] = {}

    def measure(self, name: str, value: torch.Tensor) -> torch.Tensor:
        """Wait for ``value`` and charge the wait to ``name``."""
        if self.enabled:
            t0 = time.perf_counter()
            _sync(value)
            self.timings[name] = self.timings.get(name, 0.0) + (
                time.perf_counter() - t0)
        return value


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
                   headroom: float = _HEADROOM):
    """Cold / timing / redo path -> (result, prod_cap, nnz_cap, hash_sched).

    The capacity buckets are floored at the plan's learned ones.  For the
    hash method each phase derives its launch schedule ONCE
    (``host_schedule`` with ``headroom``, floored at the plan's), runs the
    schedule-driven kernels with it, and the combined
    :class:`HashSchedule` is returned for the caller to specialize the
    plan with (``None`` for ESC).
    """
    config = plan.config
    m = A.nrows
    sym_ladder, num_ladder = plan.sym_ladder, plan.num_ladder
    sched = plan.hash_schedule

    # ---- step1: setup -------------------------------------------------------
    rpt_buf = timer.measure("setup", nprod_into_rpt(A, B))  # n_prod in C.rpt
    nprod = rpt_buf[:m]
    total_nprod = int(nprod.sum())              # host sync #1 (sizes launches)

    # ---- step2: symbolic binning ---------------------------------------------
    sym_binning = bin_rows_for_ladder(nprod, sym_ladder)
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
                                       headroom=headroom, packs=sym_packs),
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
    # launch-early / allocate-later ordering of §5.4.
    num_binning = bin_rows_for_ladder(nnz, num_ladder)
    total_nnz = int(nnz.sum())                  # host sync #2 (alloc C)
    nnz_capacity = max(plan.nnz_bucket or 0,
                       next_bucket(max(int(total_nnz
                                           * _CAPACITY_HEADROOM), 1)))
    rpt = timer.measure("alloc", exclusive_sum_in_place(nnz_buf))
    timer.measure("numeric_binning", num_binning.bins)

    # ---- step6: numeric ----------------------------------------------------------
    hash_sched = None
    if config.method == "hash":
        num_buckets, num_fall = _floor_schedule(
            *spgemm_hash.host_schedule(A, B, num_binning, num_ladder,
                                       headroom=headroom),
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
# ---------------------------------------------------------------------------

def _build_hot_executable(plan: SpgemmPlan) -> Callable:
    """ESC steady state: the whole two-phase flow with the plan's buckets,
    no host read; totals come back as device scalars for finalize."""
    assert plan.is_specialized and plan.config.method == "esc"
    m = plan.a_sig.nrows
    config = plan.config
    sym_ladder, num_ladder = plan.sym_ladder, plan.num_ladder
    prod_cap, nnz_cap = plan.prod_bucket, plan.nnz_bucket

    def body(A: CSR, B: CSR):
        nprod = nprod_into_rpt(A, B)[:m]
        total_nprod = nprod.sum()
        sym_binning = bin_rows(nprod, upper=sym_ladder.upper,
                               num_bins=sym_ladder.num_bins)
        nnz_buf = esc.symbolic(A, B, prod_capacity=prod_cap)
        nnz = nnz_buf[:m]
        num_binning = bin_rows(nnz, upper=num_ladder.upper,
                               num_bins=num_ladder.num_bins)
        total_nnz = nnz.sum()
        if config.fuse_esc:
            C = esc.spgemm_fused(A, B, prod_capacity=prod_cap,
                                 nnz_capacity=nnz_cap)
        else:
            C = esc.numeric(A, B, exclusive_sum_in_place(nnz_buf),
                            prod_capacity=prod_cap, nnz_capacity=nnz_cap)
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

    def body(A: CSR, B: CSR):
        nprod = nprod_into_rpt(A, B)[:m]
        total_nprod = nprod.sum()
        sym_binning = bin_rows(nprod, upper=sym_ladder.upper,
                               num_bins=sym_ladder.num_bins)
        nnz_buf, sym_fall_prod, _ = spgemm_hash.symbolic_scheduled(
            A, B, sym_binning, sym_ladder,
            row_buckets=sched.sym_row_buckets,
            fallback_prod_capacity=sched.fall_prod_bucket,
            single_access=config.hash_single_access,
            row_packing=config.row_packing)
        nnz = nnz_buf[:m]
        num_binning = bin_rows(nnz, upper=num_ladder.upper,
                               num_bins=num_ladder.num_bins)
        total_nnz = nnz.sum()
        C, num_fall_prod, _ = spgemm_hash.numeric_scheduled(
            A, B, exclusive_sum_in_place(nnz_buf), num_binning, num_ladder,
            row_buckets=sched.num_row_buckets, nnz_capacity=nnz_cap,
            fallback_prod_capacity=sched.fall_prod_bucket,
            single_access=config.hash_single_access)
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

    def body(A: CSR, B: CSR):
        nprod = nprod_into_rpt(A, B)[:m]
        total_nprod = nprod.sum()
        sym_binning = bin_rows(nprod, upper=sym_ladder.upper,
                               num_bins=sym_ladder.num_bins)
        C, nnz, sym_fall_prod, _ = spgemm_hash.fused_scheduled(
            A, B, sym_binning, sym_ladder,
            row_buckets=sched.sym_row_buckets, nnz_capacity=nnz_cap,
            fallback_prod_capacity=sched.fall_prod_bucket,
            single_access=config.hash_single_access,
            row_packing=config.row_packing)
        total_nnz = nnz.sum()
        # No numeric phase runs; the n_nz binning stays in the result so
        # steady calls report what cold calls report.
        num_binning = bin_rows(nnz, upper=num_ladder.upper,
                               num_bins=num_ladder.num_bins)
        return (C, total_nprod, total_nnz, sym_binning, num_binning,
                sym_fall_prod)

    return body


# ---------------------------------------------------------------------------
# Request records and the engine.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Finished:
    """A call that completed on the steps path."""

    result: SpgemmResult


@dataclasses.dataclass
class _Pending:
    """A dispatched steady-state call awaiting its one host read."""

    entry: CacheEntry
    plan: SpgemmPlan    # the plan it was dispatched with (the entry may be
                        # re-specialized before finalize)
    A: CSR
    B: CSR
    handles: tuple


Record = Union[_Finished, _Pending]


def _host_ints(*parts: torch.Tensor):
    """Every element of ``parts`` as Python ints, in ONE device-to-host
    copy."""
    flat = torch.cat([p.reshape(-1).to(torch.int64) for p in parts])
    return flat.tolist()


class SpgemmEngine:
    """SpGEMM front end: plan cache + steps / steady-state dispatch.

    ``execute(A, B)`` is what :func:`repro_torch.core.spgemm.spgemm`
    wraps.  It is ``finalize(dispatch(A, B))``: ``dispatch`` queues the
    device work of a steady-state call without reading the device, and
    ``finalize`` makes the call's one host read.
    """

    def __init__(self, config: Optional[SpgemmConfig] = None, *,
                 cache_capacity: int = 64):
        self.config = config or SpgemmConfig()
        self.cache = PlanCache(cache_capacity)

    def execute(self, A: CSR, B: CSR,
                config: Optional[SpgemmConfig] = None) -> SpgemmResult:
        """Plan-then-execute one product (the ``spgemm()`` backend)."""
        return self.finalize(self.dispatch(A, B, config))

    def dispatch(self, A: CSR, B: CSR,
                 config: Optional[SpgemmConfig] = None) -> Record:
        """Plan the call and queue its device work.  A cold (or ``timing``)
        call runs the steps path to completion here; a steady-state call
        returns with its work in flight and no host read."""
        config = config or self.config
        if A.ncols != B.nrows:
            raise ValueError(f"inner dimensions differ: {A.shape} @ "
                             f"{B.shape}")
        key = plan_key(A, B, config)
        a_sig, b_sig, _ = key
        entry = self.cache.get(key)
        if entry is None:
            entry = self.cache.insert(make_plan(a_sig, b_sig, config))
        entry.stats.calls += 1
        # Operand storage padded to the signature buckets, so every request
        # in the bucket presents the same shapes.
        A = A.with_capacity(a_sig.cap_bucket)
        B = B.with_capacity(b_sig.cap_bucket)
        plan = entry.plan

        if not plan.is_specialized or config.timing:
            result, prod_cap, nnz_cap, hash_sched = _execute_steps(
                A, B, plan, StepTimer(config.timing
                                      or not plan.is_specialized))
            if not plan.is_specialized:
                # Progressive allocation: learn the buckets (and the launch
                # schedule the run just used) for the steady state.
                specialized = plan.with_capacities(prod_cap, nnz_cap)
                if hash_sched is not None:
                    specialized = specialized.with_hash_schedule(hash_sched)
                self.cache.specialize(entry, specialized)
            entry.stats.steps_calls += 1
            return _Finished(result)

        if entry.executable is None:
            if config.method != "hash":
                make_pipeline = _build_hot_executable
            elif config.fuse_numeric:
                make_pipeline = _build_fused_hash_executable
            else:
                make_pipeline = _build_hash_executable
            entry.executable = make_pipeline(plan)
        handles = entry.executable(A, B)        # no host read
        entry.stats.hot_calls += 1
        return _Pending(entry, plan, A, B, handles)

    def finalize(self, rec: Record) -> SpgemmResult:
        """The call's one host read: verify the buckets it ran with, or
        grow them and redo the call on the steps path."""
        if isinstance(rec, _Finished):
            return rec.result
        # Verify against the DISPATCH-TIME plan: passing a later, larger
        # plan's check would return a silently truncated C.
        plan = rec.plan
        method = plan.config.method
        if method == "hash" and plan.config.fuse_numeric:
            C, tnp, tnz, sym_binning, num_binning, sym_fall = rec.handles
            nb = sym_binning.bin_size.shape[0]
            fetched = _host_ints(tnp, tnz, sym_binning.bin_size, sym_fall)
            total_nprod, total_nnz = fetched[0], fetched[1]
            schedule_ok = plan.hash_schedule.admits_fused(
                fetched[2:2 + nb], fetched[2 + nb])
        elif method == "hash":
            (C, tnp, tnz, sym_binning, num_binning,
             sym_fall, num_fall) = rec.handles
            ns = sym_binning.bin_size.shape[0]
            nn = num_binning.bin_size.shape[0]
            fetched = _host_ints(tnp, tnz, sym_binning.bin_size,
                                 num_binning.bin_size, sym_fall, num_fall)
            total_nprod, total_nnz = fetched[0], fetched[1]
            schedule_ok = plan.hash_schedule.admits(
                fetched[2:2 + ns], fetched[2 + ns:2 + ns + nn],
                fetched[2 + ns + nn], fetched[3 + ns + nn])
        else:
            C, tnp, tnz, sym_binning, num_binning = rec.handles
            total_nprod, total_nnz = _host_ints(tnp, tnz)
            schedule_ok = True
            if total_nprod > plan.prod_bucket:
                return self._grow_and_redo(rec, total_nprod, total_nnz)
        if not schedule_ok:
            rec.entry.stats.bin_overflows += 1
        if not schedule_ok or total_nnz > plan.nnz_bucket:
            return self._grow_and_redo(rec, total_nprod, total_nnz)
        return SpgemmResult(
            C=C, total_nprod=total_nprod, total_nnz=total_nnz,
            sym_binning=sym_binning, num_binning=num_binning, timings={})

    def _grow_and_redo(self, rec: _Pending, total_nprod: int,
                       total_nnz: int) -> SpgemmResult:
        """Overflow recovery (a same-signature request outgrew the learned
        plan): grow the buckets, redo the call on the steps path, and
        re-specialize the entry so the NEXT request is hot again."""
        plan = rec.plan
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
        result, prod_cap, nnz_cap, hash_sched = _execute_steps(
            rec.A, rec.B, grown, StepTimer(False))
        rec.entry.stats.steps_calls += 1
        respecialized = grown.with_capacities(prod_cap, nnz_cap)
        if hash_sched is not None:
            if current.hash_schedule is not None:
                hash_sched = hash_sched.union(current.hash_schedule)
            respecialized = respecialized.with_hash_schedule(hash_sched)
        self.cache.specialize(rec.entry, respecialized)
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
