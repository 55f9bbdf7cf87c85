"""LRU plan cache (the reference's recompile<->cudaMalloc analog of §5.4).

The cache holds, per plan signature, the specialized
:class:`~repro_torch.engine.plan.SpgemmPlan` and the steady-state pipeline
built for it, so a repeat shape bucket skips the cold six-step path.
Persistence (``dump``/``load``) waits for a later slice.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Callable, Optional

from .plan import PlanKey, SpgemmPlan


@dataclasses.dataclass
class PlanStats:
    """Per-plan counters."""

    calls: int = 0           # requests that hit this plan
    hot_calls: int = 0       # ... that ran the steady-state pipeline
    steps_calls: int = 0     # ... that ran the cold six-step path (or a redo)
    bin_overflows: int = 0   # hash schedules that failed verification


@dataclasses.dataclass
class CacheEntry:
    """A cached plan plus its steady-state pipeline and counters."""

    plan: SpgemmPlan
    executable: Optional[Callable] = None
    stats: PlanStats = dataclasses.field(default_factory=PlanStats)


class PlanCache:
    """Thread-safe LRU cache keyed by plan signature."""

    def __init__(self, capacity: int = 64):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.hits = 0        # guarded-by: _lock
        self.misses = 0      # guarded-by: _lock
        self.evictions = 0   # guarded-by: _lock
        self._lock = threading.Lock()
        self._entries: "OrderedDict[PlanKey, CacheEntry]" = OrderedDict()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def get(self, key: PlanKey) -> Optional[CacheEntry]:
        """LRU lookup; counts a hit or a miss."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return entry

    def insert(self, plan: SpgemmPlan) -> CacheEntry:
        """Insert a fresh plan, evicting least-recently-used entries over
        capacity."""
        with self._lock:
            entry = CacheEntry(plan=plan)
            self._entries[plan.signature] = entry
            self._entries.move_to_end(plan.signature)
            while len(self._entries) > self.capacity:
                _, evicted = self._entries.popitem(last=False)
                evicted.executable = None
                self.evictions += 1
            return entry

    def specialize(self, entry: CacheEntry, plan: SpgemmPlan) -> None:
        """Swap in a (re)specialized plan; the stale pipeline is dropped
        (its capacities no longer match)."""
        with self._lock:
            entry.plan = plan
            entry.executable = None
