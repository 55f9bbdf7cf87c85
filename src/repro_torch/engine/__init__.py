"""SpGEMM execution-plan engine: cached plans and the steady-state executor.

  plan.py      — immutable :class:`SpgemmPlan` over operand signatures
                 (everything derivable before data arrives), and the learned
                 :class:`HashSchedule`.
  cache.py     — LRU :class:`PlanCache` of plans + steady-state pipelines.
  executor.py  — :class:`SpgemmEngine`: cold six-step path, steady-state
                 dispatch, one-read finalize, overflow grow-and-redo;
                 ``execute`` backs ``spgemm()``.
"""
from .cache import CacheEntry, PlanCache, PlanStats
from .executor import SpgemmEngine, default_engine, reset_default_engine
from .plan import (HashSchedule, MatrixSig, PlanKey, SpgemmPlan, plan,
                   plan_key)

__all__ = [
    "CacheEntry", "PlanCache", "PlanStats", "SpgemmEngine",
    "default_engine", "reset_default_engine", "HashSchedule", "MatrixSig",
    "PlanKey", "SpgemmPlan", "plan", "plan_key",
]
