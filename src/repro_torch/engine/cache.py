"""LRU plan cache (the reference's recompile<->cudaMalloc analog of §5.4).

The cache holds, per plan signature, the specialized
:class:`~repro_torch.engine.plan.SpgemmPlan` and the steady-state pipeline
built for it, so a repeat shape bucket skips the cold six-step path.
Hit/miss/eviction counts are first-class, and ``dump``/``load`` persist
the learned plans as JSON in the reference's format (version 4), so a
dump of either package loads into the other.  With an arena attached,
eviction is arena-aware, as in the reference: it forfeits the evicted
entry's in-flight workspace leases, and breaks LRU ties by arena
footprint.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import threading
from collections import OrderedDict
from typing import Callable, Iterable, List, Optional, Tuple

from repro_torch.core.spgemm import SpgemmConfig
from repro_torch.core.workspace import Arena, Lease, next_bucket

from . import telemetry as telemetry_mod
from .autotune import PolicyState
from .partition import ShardSpec
from .plan import HashSchedule, MatrixSig, PlanKey, SpgemmPlan
from .plan import plan as make_plan
from .stats import PlanStats, plan_label

# The reference's dump versions: v1 had no policy blob, v2 added it, v3
# merged the per-phase fallback capacities into one ``fall_prod_bucket``,
# v4 added ``plan_mode`` and the policy's ``estimated`` flag.  Older blobs
# load with the dataclass defaults.
_DUMP_VERSION = 4
_LOADABLE_VERSIONS = (1, 2, 3, 4)


@dataclasses.dataclass
class CacheEntry:
    """A cached plan plus its steady-state pipeline, counters and the
    workspace leases its dispatches hold."""

    plan: SpgemmPlan
    executable: Optional[Callable] = None
    stats: PlanStats = dataclasses.field(default_factory=PlanStats)
    leases: List[Lease] = dataclasses.field(default_factory=list)
    last_used: int = 0    # monotone LRU stamp


class PlanCache:
    """Thread-safe LRU cache keyed by plan signature.  Inserting counts as
    use; a hit moves the entry to the young end.

    With an ``arena`` attached, eviction is arena-aware: evicting an entry
    forfeits its outstanding workspace leases (the arena drops their bytes
    from accounting; queued device work may still write the buffers, so
    they are NOT recycled), and LRU ties are broken by arena footprint,
    evicting the entry holding the most workspace first.
    """

    def __init__(self, capacity: int = 64, *, telemetry=None,
                 arena: Optional[Arena] = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.arena = arena
        self.hits = 0        # guarded-by: _lock
        self.misses = 0      # guarded-by: _lock
        self.evictions = 0   # guarded-by: _lock
        # Lifecycle events go to the engine's telemetry; the shared NULL
        # handle makes a bare PlanCache() emit nothing.
        self.telemetry = (telemetry if telemetry is not None
                          else telemetry_mod.NULL)
        self._lock = threading.Lock()
        self._stamp = itertools.count(1)
        self._entries: "OrderedDict[PlanKey, CacheEntry]" = OrderedDict()  # guarded-by: _lock

    # -- lookup ------------------------------------------------------------
    def get(self, key: PlanKey) -> Optional[CacheEntry]:
        """LRU lookup; counts a hit or a miss."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            entry.last_used = next(self._stamp)
            self.hits += 1
            return entry

    def peek(self, key: PlanKey) -> Optional[CacheEntry]:
        """Lookup that counts nothing and leaves the LRU order alone (for
        advisory reads such as "is this plan hot?")."""
        with self._lock:
            return self._entries.get(key)

    def insert(self, plan: SpgemmPlan) -> CacheEntry:
        """Insert a fresh plan, evicting least-recently-used entries over
        capacity."""
        with self._lock:
            return self._insert_locked(plan)

    def _footprint(self, entry: CacheEntry) -> int:
        """Arena bytes this entry answers for: outstanding (in-flight)
        lease bytes plus the lease its specialized plan would take."""
        spec = entry.plan.workspace_spec()
        return (sum(lease.spec.nbytes for lease in entry.leases
                    if lease.active)
                + (spec.nbytes if spec is not None else 0))

    def _release_entry_locked(self, entry: CacheEntry) -> None:
        """Drop an evicted entry's pipeline and forfeit its outstanding
        arena leases (accounting only: the buffers may still be written by
        queued device work and are never recycled)."""
        entry.executable = None
        if self.arena is not None:
            for lease in entry.leases:
                self.arena.forfeit(lease)
        entry.leases.clear()

    def _evict_one_locked(self, protect: Optional[PlanKey] = None) -> None:
        """Evict the LRU victim; ties (same ``last_used``: plans loaded
        together and never hit since) go to the largest arena footprint,
        so capacity pressure frees the most workspace.  ``protect`` (the
        key just inserted) is never the victim."""
        key = min((k for k in self._entries if k != protect),
                  key=lambda k: (self._entries[k].last_used,
                                 -self._footprint(self._entries[k])))
        evicted = self._entries.pop(key)
        self._release_entry_locked(evicted)
        self.evictions += 1
        self.telemetry.event("plan_evict", plan=plan_label(evicted.plan))

    def _insert_locked(self, plan: SpgemmPlan,
                       stamp: Optional[int] = None) -> CacheEntry:
        """Insert-and-evict body; the caller holds ``self._lock``.
        Insertion counts as use; ``stamp`` lets a batch insert
        (:meth:`load`) give every loaded plan ONE shared stamp, so the
        footprint tie-break decides among loaded-but-unused plans."""
        entry = CacheEntry(plan=plan)
        entry.last_used = stamp if stamp is not None else next(self._stamp)
        self._entries[plan.signature] = entry
        self._entries.move_to_end(plan.signature)
        self.telemetry.event("plan_insert", plan=plan_label(plan))
        while len(self._entries) > self.capacity:
            self._evict_one_locked(protect=plan.signature)
        return entry

    def evict(self, key: PlanKey) -> bool:
        """Explicitly evict one entry, forfeiting its arena leases.
        Returns whether the key was present."""
        with self._lock:
            entry = self._entries.pop(key, None)
            if entry is None:
                return False
            self._release_entry_locked(entry)
            self.evictions += 1
        self.telemetry.event("plan_evict", plan=plan_label(entry.plan))
        return True

    def specialize(self, entry: CacheEntry, plan: SpgemmPlan) -> None:
        """Swap in a (re)specialized plan; the stale pipeline is dropped
        (its capacities no longer match)."""
        with self._lock:
            entry.plan = plan
            entry.executable = None
        self.telemetry.event("plan_specialize", plan=plan_label(plan),
                             prod_bucket=plan.prod_bucket,
                             nnz_bucket=plan.nnz_bucket)

    def update_policy(self, entry: CacheEntry, state: PolicyState) -> None:
        """Swap in updated adaptive-policy state and KEEP the pipeline:
        no shape depends on the policy fields."""
        with self._lock:
            entry.plan = entry.plan.with_policy(state)

    # -- persistence --------------------------------------------------------
    def dump(self, path: str) -> int:
        """Write every cached plan's learned state (capacity buckets, hash
        schedule, shard spec, policy) as JSON; pipelines are rebuilt on
        first use.
        Returns the number of plans written."""
        plans = [entry.plan for _, entry in self.items()]
        payload = {"version": _DUMP_VERSION,
                   "plans": [_plan_to_json(p) for p in plans]}
        with open(path, "w") as f:
            json.dump(payload, f, indent=1)
        return len(plans)

    def load(self, path: str) -> int:
        """Prewarm the cache from a :meth:`dump` file of either package.

        Loaded plans merge monotonically into same-signature entries
        (buckets, schedules, shard specs and policy maxima only grow), and
        every loaded
        hash schedule is re-aligned for packing first (pow-2 and
        pack-floored buckets; see :func:`_align_schedule_for_packing`).
        A merge that changes nothing, or only the policy, keeps the live
        pipeline.  Returns the number of plans loaded."""
        with open(path) as f:
            payload = json.load(f)
        if payload.get("version") not in _LOADABLE_VERSIONS:
            raise ValueError(
                f"plan-cache dump version {payload.get('version')!r} not in "
                f"{_LOADABLE_VERSIONS}")
        plans = [_align_schedule_for_packing(_plan_from_json(blob))
                 for blob in payload["plans"]]
        # One critical section for the whole merge: a concurrent grow must
        # not interleave between the read of an entry and its write-back.
        with self._lock:
            batch_stamp = next(self._stamp)   # loaded plans tie on LRU age
            for plan in plans:
                existing = self._entries.get(plan.signature)
                if existing is None:
                    self._insert_locked(plan, stamp=batch_stamp)
                    continue
                merged = existing.plan
                if plan.prod_bucket is not None:
                    merged = merged.with_capacities(
                        max(merged.prod_bucket or 0, plan.prod_bucket),
                        max(merged.nnz_bucket or 0, plan.nnz_bucket))
                if plan.hash_schedule is not None:
                    sched = plan.hash_schedule
                    if merged.hash_schedule is not None:
                        sched = sched.union(merged.hash_schedule)
                    merged = merged.with_hash_schedule(sched)
                if plan.shard_spec is not None:
                    spec = (merged.shard_spec.union(plan.shard_spec)
                            if merged.shard_spec is not None
                            else plan.shard_spec)
                    merged = merged.with_shard_spec(spec)
                if plan.policy is not None:
                    state = (merged.policy.union(plan.policy)
                             if merged.policy is not None else plan.policy)
                    merged = merged.with_policy(state)
                if merged != existing.plan:
                    policy_only = (merged.with_policy(existing.plan.policy)
                                   == existing.plan)
                    existing.plan = merged
                    if not policy_only:
                        existing.executable = None
        self.telemetry.event("plan_cache_load", path=str(path),
                             n_plans=len(plans))
        return len(plans)

    # -- introspection ------------------------------------------------------
    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __contains__(self, key: PlanKey) -> bool:
        with self._lock:
            return key in self._entries

    def items(self) -> Iterable[Tuple[PlanKey, CacheEntry]]:
        with self._lock:
            return list(self._entries.items())

    def clear(self) -> None:
        with self._lock:
            for entry in self._entries.values():
                self._release_entry_locked(entry)   # no lease leaks
            self._entries.clear()


# -- JSON (de)serialization, the reference's format --------------------------

def _plan_to_json(p: SpgemmPlan) -> dict:
    return {
        "a_sig": dataclasses.asdict(p.a_sig),
        "b_sig": dataclasses.asdict(p.b_sig),
        "config": dataclasses.asdict(p.config),
        "prod_bucket": p.prod_bucket,
        "nnz_bucket": p.nnz_bucket,
        "hash_schedule": (dataclasses.asdict(p.hash_schedule)
                          if p.hash_schedule is not None else None),
        "shard_spec": (dataclasses.asdict(p.shard_spec)
                       if p.shard_spec is not None else None),
        "policy": (dataclasses.asdict(p.policy)
                   if p.policy is not None else None),
    }


def _plan_from_json(blob: dict) -> SpgemmPlan:
    plan = make_plan(MatrixSig(**blob["a_sig"]), MatrixSig(**blob["b_sig"]),
                     SpgemmConfig(**blob["config"]))
    if blob.get("prod_bucket") is not None:
        plan = plan.with_capacities(blob["prod_bucket"], blob["nnz_bucket"])
    hs = blob.get("hash_schedule")
    if hs is not None:
        if "fall_prod_bucket" in hs:                  # v3 and later
            fall = hs["fall_prod_bucket"]
        else:  # v1/v2 kept per-phase capacities; the shared bucket is
               # their max (everything admitted stays admitted)
            fall = max(hs["sym_fall_prod_bucket"],
                       hs["num_fall_prod_bucket"])
        plan = plan.with_hash_schedule(HashSchedule(
            sym_row_buckets=tuple(hs["sym_row_buckets"]),
            num_row_buckets=tuple(hs["num_row_buckets"]),
            fall_prod_bucket=int(fall)))
    ss = blob.get("shard_spec")
    if ss is not None:
        plan = plan.with_shard_spec(ShardSpec(
            bounds=tuple(ss["bounds"]),
            row_buckets=tuple(ss["row_buckets"]),
            cap_buckets=tuple(ss["cap_buckets"])))
    pol = blob.get("policy")            # absent from v1 dumps
    if pol is not None:
        for key in ("sym_max", "num_max"):
            if pol.get(key) is not None:
                pol[key] = tuple(pol[key])   # JSON lists -> hashable state
        plan = plan.with_policy(PolicyState(**pol))
    return plan


def _align_schedule_for_packing(plan: SpgemmPlan) -> SpgemmPlan:
    """Re-derive pack alignment for a LOADED plan's hash schedule.

    A schedule written before row packing (v1 dumps), or edited by hand,
    can hold buckets that are not powers of two or are smaller than a
    rung's ``rows_per_block``; the packed kernels need pow-2 buckets of
    whole ``pack``-row blocks.  Alignment only grows buckets, so every
    request admitted before stays admitted.
    """
    sched = plan.hash_schedule
    if sched is None or plan.config.method != "hash":
        return plan
    packs = plan.sym_ladder.rows_per_block if plan.config.row_packing \
        else None

    def aligned(buckets, rung_packs):
        out = []
        for b, cap in enumerate(buckets):
            if cap:
                lo = (rung_packs[b]
                      if rung_packs is not None and b < len(rung_packs)
                      else 1)
                cap = next_bucket(int(cap), minimum=max(int(lo), 1))
            out.append(int(cap))
        return tuple(out)

    aligned_sched = HashSchedule(
        sym_row_buckets=aligned(sched.sym_row_buckets, packs),
        num_row_buckets=aligned(sched.num_row_buckets, None),
        fall_prod_bucket=sched.fall_prod_bucket)
    if aligned_sched == sched:
        return plan
    return plan.with_hash_schedule(aligned_sched)
