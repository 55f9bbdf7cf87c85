"""SpGEMM execution-plan engine: cached plans, the executor, telemetry.

  plan.py      — immutable :class:`SpgemmPlan` over operand signatures
                 (everything derivable before data arrives), and the learned
                 :class:`HashSchedule`.
  autotune.py  — :class:`AdaptivePolicy` / :class:`PolicyState`: the
                 AUTO_SHARDS shard count, the learned hash-schedule
                 headroom, the :class:`EstimatorState` behind
                 ``plan_mode="estimate"``, and the :class:`MemoryGovernor`
                 bounding the workspace arena.
  partition.py — :class:`ShardSpec` row-block partitioning (flop-balanced
                 bounds, pow-2 shard buckets) and shard placement.
  cache.py     — LRU :class:`PlanCache` of plans + steady-state pipelines
                 (arena-aware eviction), with JSON ``dump``/``load`` in the
                 reference's format.
  executor.py  — :class:`SpgemmEngine`: cold six-step path, steady-state
                 dispatch with an arena lease, one-read finalize, overflow
                 grow-and-redo, the governor's ladder, fault sites,
                 streaming submit/drain with completion-order finalize and
                 backpressure, sharded fan-out and merge, and prewarm;
                 ``execute`` backs ``spgemm()``.
  stats.py     — pipeline-build accounting and registry-backed engine and
                 plan counters; ``render`` is ``SpgemmEngine.report``.
  telemetry.py — spans, metrics registry, ring-buffer event log, and the
                 JSONL / Chrome trace_event / Prometheus exporters.
"""
from repro_torch.core.spgemm import AUTO_SHARDS
from repro_torch.core.workspace import (Arena, ArenaPressureError, Lease,
                                        LeaseSpec, default_arena,
                                        reset_default_arena)

from .autotune import (AdaptivePolicy, EstimatorState, MemoryGovernor,
                       PolicyState, choose_shards, revise_shards,
                       trim_schedule)
from .cache import CacheEntry, PlanCache
from .executor import (SpgemmEngine, SpgemmRequest, StepTimer,
                       default_engine, reset_default_engine)
from .partition import (ShardSpec, balanced_bounds, clamp_shards,
                        data_axis_devices, plan_shards, shard_devices)
from .plan import (HashSchedule, MatrixSig, PlanKey, SpgemmPlan, plan,
                   plan_key)
from .stats import (EngineStats, PlanStats, plan_label, render,
                    total_traces, traces_for)
from .telemetry import (LATENCY_BUCKETS_S, EventLog, MetricsRegistry, Span,
                        Telemetry, engine_sample_blocks, git_rev,
                        histogram_quantile, merge_sample_blocks,
                        prometheus_text, resolve_telemetry, utc_now_iso,
                        validate_chrome_trace)

__all__ = [
    "AUTO_SHARDS", "AdaptivePolicy", "EstimatorState", "PolicyState",
    "choose_shards", "revise_shards", "trim_schedule",
    "Arena", "ArenaPressureError", "Lease", "LeaseSpec", "MemoryGovernor",
    "default_arena", "reset_default_arena",
    "CacheEntry", "PlanCache", "SpgemmEngine", "SpgemmRequest", "StepTimer",
    "default_engine", "reset_default_engine", "ShardSpec", "balanced_bounds",
    "clamp_shards", "data_axis_devices", "plan_shards", "shard_devices",
    "HashSchedule", "MatrixSig", "PlanKey", "SpgemmPlan", "plan",
    "plan_key", "EngineStats", "PlanStats", "plan_label", "render",
    "total_traces", "traces_for", "LATENCY_BUCKETS_S", "EventLog",
    "MetricsRegistry", "Span", "Telemetry", "engine_sample_blocks",
    "git_rev", "histogram_quantile", "merge_sample_blocks",
    "prometheus_text", "resolve_telemetry", "utc_now_iso",
    "validate_chrome_trace",
]
