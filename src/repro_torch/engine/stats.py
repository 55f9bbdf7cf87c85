"""Engine counters: pipeline-build accounting and registry-backed stats.

A port of ``repro/engine/stats.py``.  The reference counts *traces* (each
one a recompile) from inside its jitted bodies.  PyTorch runs eagerly, so
the port's counterpart is a count of steady-state pipeline BUILDS:
:func:`record_trace` is called each time a cache entry's pipeline is
built (first hot call of a plan, and again after a re-specialization
dropped it).  A stream of same-signature requests that builds nothing
new is the port's "zero retraces".  :func:`reset` clears the counts.

:class:`EngineStats` and :class:`PlanStats` keep the reference's field
API (``stats.requests``, ``entry.stats.hot_calls``, ...), and every field
is a counter or gauge in a
:class:`~repro_torch.engine.telemetry.MetricsRegistry`: one set of
numbers for attribute reads and for the registry.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, Optional, Tuple

from .telemetry import MetricsRegistry

# -- pipeline-build accounting (process-wide, as the reference's traces) ----

_TRACES: Dict = defaultdict(int)
_TOTAL = {"count": 0}


def record_trace(key) -> None:
    """Count one steady-state pipeline build for plan signature ``key``."""
    _TRACES[key] += 1
    _TOTAL["count"] += 1


def total_traces() -> int:
    """Process-wide count of steady-state pipeline builds."""
    return _TOTAL["count"]


def traces_for(key) -> int:
    return _TRACES.get(key, 0)


def reset() -> None:
    """Zero the process-wide build counts."""
    _TRACES.clear()
    _TOTAL["count"] = 0


# -- per-plan / per-engine counters ----------------------------------------

def plan_label(plan) -> str:
    """Compact stable label for one plan (Prometheus label values, event
    payloads, reports): shapes, method, and the shard fan-out."""
    a, b = plan.a_sig, plan.b_sig
    label = (f"{a.nrows}x{a.ncols}·{b.nrows}x{b.ncols}"
             f"/{plan.config.method}")
    if plan.config.shards != 1:
        label += f"/sh{plan.config.shards}"
    return label


def _metric_property(field: str):
    def fget(self):
        return self._metrics[field].value

    def fset(self, v):
        self._metrics[field].value = v

    return property(fget, fset, doc=f"registry-backed '{field}' counter")


class _RegistryStats:
    """Base for stats objects whose fields live in a MetricsRegistry.

    Subclasses declare ``_COUNTERS``/``_GAUGES`` field names plus a
    metric-name prefix; attribute get/set on those names routes to the
    registry metric.  ``_NAMES`` overrides the default
    ``<prefix><field>_total`` metric naming.
    """

    _COUNTERS: Tuple[str, ...] = ()
    _GAUGES: Tuple[str, ...] = ()
    _PREFIX = "opsparse_"
    _NAMES: Dict[str, str] = {}

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self.registry = registry if registry is not None else MetricsRegistry()
        self._metrics = {}
        for field in self._COUNTERS:
            self._metrics[field] = self.registry.counter(
                self.metric_name(field))
        for field in self._GAUGES:
            self._metrics[field] = self.registry.gauge(
                self.metric_name(field))

    @classmethod
    def metric_name(cls, field: str) -> str:
        name = cls._NAMES.get(field)
        if name is not None:
            return name
        suffix = "_total" if field in cls._COUNTERS else ""
        return f"{cls._PREFIX}{field}{suffix}"

    def metric(self, field: str):
        return self._metrics[field]

    def __repr__(self) -> str:
        fields = ", ".join(f"{f}={getattr(self, f)}"
                           for f in self._COUNTERS + self._GAUGES)
        return f"{type(self).__name__}({fields})"


class PlanStats(_RegistryStats):
    """Counters of one cached plan.

    calls           requests executed under this plan
    hot_calls       served by the steady-state pipeline
    steps_calls     served by the host-orchestrated six-step path
    capacity_grows  bucket overflows that forced a re-plan
    bin_overflows   hash bin-count/fallback schedule overflows
    schedule_trims  headroom-policy schedule shrinks (autotune)
    time_s          wall-clock charged to this plan (seconds)
    """

    _PREFIX = "opsparse_plan_"
    _COUNTERS = ("calls", "hot_calls", "steps_calls", "capacity_grows",
                 "bin_overflows", "schedule_trims", "time_s")
    _NAMES = {"time_s": "opsparse_plan_time_seconds_total"}


class EngineStats(_RegistryStats):
    """Engine-level counters (cache counters live on the PlanCache).

    requests          user-visible requests (shard sub-dispatches excluded)
    overlapped        request k+1 planned while k ran on the device
    capacity_grows    pow-2 bucket overflows (re-plan + rebuild)
    bin_overflows     hash launch-schedule overflows (subset of grows)
    drains            drain() invocations
    sharded_requests  requests fanned out into row-block shards
    shard_grows       per-shard slice-storage bucket grows
    reordered         drain() finalizes ahead of dispatch order
    peak_inflight     max concurrent dispatches a drain() held (gauge)
    auto_requests     requests routed through the AUTO_SHARDS policy
    policy_revisions  telemetry-driven shard-count re-decisions
    schedule_trims    headroom-policy hash-schedule shrinks
    arena_pressure    governor-cap lease refusals (degradation entered)
    arena_trims       forced headroom trims under arena pressure
    arena_spills      fused calls spilled to the unleased two-pass path
    estimates         cold plans specialized from the sampling estimator
    estimate_hits     estimated plans confirmed by an admitted finalize
    estimate_misses   estimated plans corrected by an overflow redo
    faults_injected   scheduled FaultPlan injections this engine consumed
    host_syncs        waits of the host on the device (each a span marked
                      ``sync=True``): the steps path's reads and step
                      waits, finalize's verify read; always counted
    """

    _PREFIX = "opsparse_engine_"
    _COUNTERS = ("requests", "overlapped", "capacity_grows", "bin_overflows",
                 "drains", "sharded_requests", "shard_grows", "reordered",
                 "auto_requests", "policy_revisions", "schedule_trims",
                 "arena_pressure", "arena_trims", "arena_spills",
                 "estimates", "estimate_hits", "estimate_misses",
                 "faults_injected", "host_syncs")
    _GAUGES = ("peak_inflight",)


for _field in PlanStats._COUNTERS + PlanStats._GAUGES:
    setattr(PlanStats, _field, _metric_property(_field))
for _field in EngineStats._COUNTERS + EngineStats._GAUGES:
    setattr(EngineStats, _field, _metric_property(_field))
del _field


def render(engine) -> str:
    """Human-readable report of one engine: engine and plan counters from
    the registry-backed stats, span/event accounting and the request
    latency from its :class:`~repro_torch.engine.telemetry.Telemetry`.
    Renders empty state (no requests, unspecialized plans, an empty
    cache) without dividing by zero."""
    cache = engine.cache
    s = engine.stats
    lines = [
        "engine: %d requests, %d plans cached (cap %d)" % (
            s.requests, len(cache), cache.capacity),
        "plan cache: %d hits / %d misses / %d evictions (hit rate %.1f%%)" % (
            cache.hits, cache.misses, cache.evictions,
            100.0 * cache.hit_rate),
        "overlap: %d requests planned while predecessor executed" % s.overlapped,
        "rebuilds: %d steady-state pipeline builds, %d capacity grows "
        "(%d hash bin overflows)" % (
            total_traces(), s.capacity_grows, s.bin_overflows),
        "sharding: %d sharded requests, %d per-shard bucket grows; "
        "%d drains reordered %d finalizes (peak %d in flight)" % (
            s.sharded_requests, s.shard_grows, s.drains, s.reordered,
            s.peak_inflight),
        "policy: %d auto-shard requests, %d shard revisions, "
        "%d schedule trims" % (
            s.auto_requests, s.policy_revisions, s.schedule_trims),
    ]
    if s.faults_injected:
        lines.append("faults: %d scheduled injections consumed"
                     % s.faults_injected)
    if s.estimates:
        lines.append(
            "estimate: %d estimated plans, %d confirmed / %d redone, "
            "headroom %.2f" % (s.estimates, s.estimate_hits,
                               s.estimate_misses, engine.est_state.headroom))
    arena = engine.arena
    lines.append(
        "arena: %d B in use / %d B reserved (peak %d B), "
        "%d hits / %d misses, %d pressure events "
        "(%d trims, %d spills)" % (
            arena.bytes_in_use, arena.bytes_reserved, arena.peak_bytes,
            arena.lease_hits, arena.lease_misses, arena.pressure_events,
            s.arena_trims, s.arena_spills))
    tel = engine.telemetry
    if tel.enabled:
        spans = sum(1 for e in tel.events.snapshot()
                    if e.get("type") == "span")
        lines.append(
            "telemetry: %d events in ring (%d spans; %d of %d appended "
            "dropped)" % (len(tel.events), spans, tel.events.dropped,
                          tel.events.appended))
        hist = tel.registry.get("opsparse_request_latency_seconds")
        if hist is not None and hist.count:
            lines.append(
                "latency: %d finalized requests, mean %.2f ms" % (
                    hist.count, 1e3 * hist.mean))
    for _, entry in cache.items():
        ps = entry.stats
        p = entry.plan
        sched = ""
        if p.hash_schedule is not None:
            hs = p.hash_schedule
            sched = ", sched sym=%s num=%s fall=%d" % (
                "/".join(str(b) for b in hs.sym_row_buckets),
                "/".join(str(b) for b in hs.num_row_buckets),
                hs.fall_prod_bucket)
        if p.policy is not None:
            pol = p.policy
            sched += ", policy headroom=%.2f streak=%d%s" % (
                pol.headroom, pol.streak,
                " estimated" if pol.estimated else "")
            if pol.shard_decision is not None:
                sched += " shards->%d" % pol.shard_decision
        if p.shard_spec is not None:
            sched += ", shards=%d bounds=%s caps=%s" % (
                p.shard_spec.n_shards,
                "/".join(str(b) for b in p.shard_spec.bounds),
                "/".join(str(c) for c in p.shard_spec.cap_buckets))
        lines.append(
            "  plan %s: %d calls (%d hot / %d steps), "
            "buckets prod=%s nnz=%s%s, %.1f ms total" % (
                plan_label(p), ps.calls, ps.hot_calls, ps.steps_calls,
                p.prod_bucket, p.nnz_bucket, sched, ps.time_s * 1e3))
    return "\n".join(lines)
