"""Deterministic fault injection for the engine (the port's own copy of
``repro/core/faults.py``, with the same visit-index semantics).

The paper's verify-and-grow recovery (and the progressive re-allocation
discipline it inherits from the Liu–Vinter framework) is only trustworthy
if every recovery rung actually runs in CI — but real memory pressure,
estimator misses, and device failures are non-deterministic and slow to
provoke.  A :class:`FaultPlan` makes them cheap and exactly repeatable:
a seedable schedule of injections at *named sites* the engine consults on
its hot path, threaded through constructors the same way ``telemetry=``
is (duck-typed keyword, zero overhead when absent).

Sites (:data:`SITES`):

  ``lease_denial``     the arena/engine workspace acquisition behaves as
                       if the governor cap were binding (returns no
                       lease) — walks the real degradation ladder, up to
                       :class:`~repro_torch.core.workspace.ArenaPressureError`
                       backpressure, without real pressure.
  ``verify_overflow``  the finalize verify treats an admitted run as
                       overflowed — exercises the overflow-grow redo
                       (bitwise via the steps oracle) on demand.
  ``executor_raise``   dispatch raises :class:`InjectedFault` — the
                       non-transient (or, with ``transient=True``,
                       transient) failure a retry classifier must
                       distinguish from pressure.
  ``slow_dispatch``    dispatch stalls ``delay_s`` of host wall-clock —
                       deadline-budget expiry on demand.

Scheduling is by *visit index*: each time the engine consults a site the
plan's per-site visit counter advances, and a :class:`FaultSpec` fires
when the index is in its ``at`` tuple (or, for soak-style chaos runs,
with seeded ``probability`` per visit).  Same specs + same seed + same
request sequence => the same injections, which is what lets the chaos
gate assert bitwise parity against a fault-free run.

This module imports nothing from the engine (mirroring ``telemetry.py``)
so executor/arena/service can all depend on it freely.
"""
from __future__ import annotations

import dataclasses
import random
import threading
import time
from typing import Dict, Iterable, Optional, Tuple

SITES: Tuple[str, ...] = ("lease_denial", "verify_overflow",
                          "executor_raise", "slow_dispatch")


class InjectedFault(RuntimeError):
    """An injected ``executor_raise`` fault.  ``transient`` is the retry
    classification the injector chose: transient faults model recoverable
    blips (a retry should succeed), non-transient ones model poisoned
    requests (a retry must NOT fire)."""

    def __init__(self, message: str, *, site: str = "executor_raise",
                 transient: bool = False):
        super().__init__(message)
        self.site = site
        self.transient = transient


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One injection rule at one site.

    ``at``           visit indices (0-based, per site) that fire; ``None``
                     means fire by ``probability`` instead.
    ``probability``  per-visit seeded coin when ``at`` is None.
    ``count``        max injections this spec contributes (None = all).
    ``delay_s``      host stall for ``slow_dispatch`` injections.
    ``transient``    classification of ``executor_raise`` injections.
    ``message``      override for the raised/injected description.
    """

    site: str
    at: Optional[Tuple[int, ...]] = None
    probability: float = 0.0
    count: Optional[int] = None
    delay_s: float = 0.0
    transient: bool = False
    message: str = ""

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r}; "
                             f"known sites: {SITES}")
        if self.at is not None:
            object.__setattr__(self, "at", tuple(int(i) for i in self.at))


class FaultPlan:
    """A deterministic, seedable schedule of fault injections.

    Thread-safe (the engine consults sites from drain loops and service
    worker threads concurrently); ``enabled`` is False for an empty plan
    so the engine's hot-path guard costs one attribute read.

    ``visits``/``injected`` are per-site counters; :meth:`snapshot`
    returns both (the chaos gate records them in its trajectory entry).
    """

    def __init__(self, specs: Iterable[FaultSpec] = (), *, seed: int = 0):
        self.specs = tuple(specs)
        for spec in self.specs:
            if not isinstance(spec, FaultSpec):
                raise TypeError(f"expected FaultSpec, got {type(spec)}")
        self.seed = int(seed)
        self.enabled = bool(self.specs)
        self._rng = random.Random(self.seed)
        self._lock = threading.Lock()
        self._remaining = [spec.count for spec in self.specs]
        self.visits: Dict[str, int] = {site: 0 for site in SITES}
        self.injected: Dict[str, int] = {site: 0 for site in SITES}

    # -- scheduling ---------------------------------------------------------
    def fire(self, site: str, *, uid: Optional[int] = None
             ) -> Optional[FaultSpec]:
        """Consult one site: advance its visit counter and return the
        spec that fires at this visit (or None).  At most one spec fires
        per visit (first match in declaration order)."""
        if not self.enabled:
            return None
        with self._lock:
            v = self.visits[site]
            self.visits[site] = v + 1
            for i, spec in enumerate(self.specs):
                if spec.site != site:
                    continue
                rem = self._remaining[i]
                if rem is not None and rem <= 0:
                    continue
                if spec.at is not None:
                    hit = v in spec.at
                else:
                    hit = (spec.probability > 0.0
                           and self._rng.random() < spec.probability)
                if hit:
                    if rem is not None:
                        self._remaining[i] = rem - 1
                    self.injected[site] += 1
                    return spec
            return None

    # -- convenience actions (the engine's site shims) ----------------------
    def maybe_raise(self, site: str = "executor_raise", *,
                    uid: Optional[int] = None) -> None:
        """Consult ``site`` and raise :class:`InjectedFault` on a hit."""
        spec = self.fire(site, uid=uid)
        if spec is not None:
            raise InjectedFault(
                spec.message or f"injected fault at {site} (uid={uid})",
                site=site, transient=spec.transient)

    def maybe_sleep(self, site: str = "slow_dispatch", *,
                    uid: Optional[int] = None) -> float:
        """Consult ``site``; stall ``delay_s`` on a hit.  Returns the
        stall applied (0.0 = no injection)."""
        spec = self.fire(site, uid=uid)
        if spec is None or spec.delay_s <= 0:
            return 0.0
        time.sleep(spec.delay_s)
        return spec.delay_s

    # -- introspection ------------------------------------------------------
    @property
    def total_injected(self) -> int:
        with self._lock:
            return sum(self.injected.values())

    def snapshot(self) -> Dict[str, Dict[str, int]]:
        with self._lock:
            return {"visits": dict(self.visits),
                    "injected": dict(self.injected)}


# The disabled default every constructor resolves to: consulting it is a
# single attribute read (``enabled`` False short-circuits fire()).
NULL_FAULTS = FaultPlan()


def resolve_faults(arg: Optional["FaultPlan"]) -> "FaultPlan":
    """Constructor sugar mirroring ``telemetry.resolve_telemetry``:
    ``None`` -> the shared disabled plan, a :class:`FaultPlan` -> itself."""
    if arg is None:
        return NULL_FAULTS
    if not isinstance(arg, FaultPlan):
        raise TypeError(f"faults= expects FaultPlan or None, got {type(arg)}")
    return arg
