"""Adaptive execution policy learned from the engine's own telemetry.

A port of ``repro/engine/autotune.py`` (paper §4.3: the binning/hashing
policy trades hash-table padding against the rebuilds an overflow costs
and must follow the workload):

:class:`AdaptivePolicy`
    The engine-level knobs: hash-schedule headroom bounds and steps, the
    trim streak, shard sizing, and the sampling estimator's knobs.  One
    per engine.

:class:`PolicyState`
    The per-plan learned state on ``SpgemmPlan.policy``, serialized by
    ``PlanCache.dump/load``: the current headroom, the eviction-free
    streak, the observed per-rung bin-size maxima, and the shard-count
    decision with the flop basis it was made from.  Host ints only.

:class:`EstimatorState`
    The engine-level learned headroom of ``plan_mode="estimate"``.

The headroom policy: an overflow redo doubles the headroom (the stream
jitters more than the schedule allowed); after ``trim_streak`` admitted
calls the schedule is re-derived from the observed maxima at a shrunken
headroom and swapped in (one pipeline rebuild) when that drops padding
rows or whole rungs.  At most one trim fires per overflow epoch.

:class:`MemoryGovernor`
    The bound on the workspace arena's bytes and the degradation ladder
    the executor walks under it.

The shard-count policy (``choose_shards``/``revise_shards``) picks N so
that every shard carries enough flops to pay for the merge, bounded by the
devices the shards could land on (one card: N = 1 unless ``max_shards``
lifts it, as the reference on one device); a stream whose mean flops
leaves a hysteresis band around the decision's basis is re-decided.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

from repro_torch.core.binning_ranges import BinLadder
from repro_torch.core.workspace import next_bucket
from repro_torch.kernels.spgemm_hash import (_ROW_BUCKET_MIN,
                                             fallback_capacity_bucket,
                                             schedule_bucket)

from .partition import clamp_shards


@dataclasses.dataclass(frozen=True)
class AdaptivePolicy:
    """Engine-level adaptive-policy knobs (one per engine, immutable).

    headroom_*      bounds and step sizes for the hash-schedule headroom:
                    ``init`` seeds fresh plans (the old fixed 2x),
                    ``grow`` multiplies on overflow (capped at ``max``),
                    ``shrink`` multiplies on a trim (floored at ``min`` —
                    the capacity-margin floor, below which pow-2 rounding
                    provides all remaining slack).
    trim_streak     eviction-free hot finalizes before a trim attempt.
    min_shard_flops flops one shard must carry to pay for the merge
                    (below it, fewer shards or none).
    max_shards      hard cap on the learned shard count (``None`` = the
                    device count: per-shard occupancy).
    revise_period   finalized requests between shard-count reviews.
    revise_factor   hysteresis band: the observed mean must leave
                    ``[basis/f, basis*f]`` before N is re-decided.
    """

    headroom_init: float = 2.0
    headroom_min: float = 1.25
    headroom_max: float = 4.0
    headroom_grow: float = 2.0
    headroom_shrink: float = 0.75
    trim_streak: int = 16
    min_shard_flops: int = 1 << 21
    max_shards: Optional[int] = None
    revise_period: int = 8
    revise_factor: float = 4.0
    # plan_mode="estimate" knobs: the sampled-ratio tail quantile, the
    # sample size, and the bounds/steps of the ENGINE-level learned headroom
    # multiplier on the estimator's tail ratio (EstimatorState) — grown
    # on an estimate miss (overflow redo of an estimated plan), shrunk
    # toward ``min`` after a sustained miss-free streak.
    est_quantile: float = 0.9
    est_sample_rows: int = 64
    est_headroom_init: float = 1.5
    est_headroom_min: float = 1.1
    est_headroom_max: float = 4.0
    est_headroom_grow: float = 2.0
    est_headroom_shrink: float = 0.9
    est_hit_streak: int = 16


@dataclasses.dataclass(frozen=True)
class PolicyState:
    """Per-plan learned policy state (lives on ``SpgemmPlan.policy``).

    Bin-size maxima are observed over the CURRENT eviction-free streak
    (reset on overflow and after a trim attempt), so a trim re-derives
    from what the stream does *now*, not what it did before the last
    regime change.  Flop telemetry windows between shard reviews.  Every
    field is a host Python int/float: JSON-serializable and wrap-proof.
    """

    headroom: float = 2.0
    streak: int = 0
    trimmed: bool = False        # one trim per overflow epoch (hysteresis)
    sym_max: Optional[Tuple[int, ...]] = None
    num_max: Optional[Tuple[int, ...]] = None
    sym_fall_max: int = 0
    num_fall_max: int = 0
    flops_total: int = 0         # window accumulator (host int64 semantics)
    flops_calls: int = 0
    shard_decision: Optional[int] = None
    shard_basis: int = 0         # mean flops the decision was made from
    # Provenance: True while the plan's buckets come from the sampling
    # estimator and no admitted finalize has confirmed them yet (cleared
    # on the first admit; an overflow redo re-derives exact buckets and also
    # clears it).  Serialized in cache dumps (format v4) so a warm-started
    # replica knows which loaded schedules are still unverified.
    estimated: bool = False

    # -- hash-schedule jitter tracking --------------------------------------
    def note_admit(self, sym_sizes: Sequence[int], sym_fall: int,
                   num_sizes: Optional[Sequence[int]] = None,
                   num_fall: int = 0) -> "PolicyState":
        """Fold one admitted (eviction-free) hot finalize's observed bin
        metadata into the streak maxima.  Inputs may be device int32
        scalars; everything is widened to Python int on entry."""
        sym = tuple(int(s) for s in sym_sizes)
        if self.sym_max is not None and len(self.sym_max) == len(sym):
            sym = tuple(max(a, b) for a, b in zip(self.sym_max, sym))
        num = self.num_max
        if num_sizes is not None:
            num = tuple(int(s) for s in num_sizes)
            if self.num_max is not None and len(self.num_max) == len(num):
                num = tuple(max(a, b) for a, b in zip(self.num_max, num))
        return dataclasses.replace(
            self, streak=self.streak + 1, sym_max=sym, num_max=num,
            sym_fall_max=max(self.sym_fall_max, int(sym_fall)),
            num_fall_max=max(self.num_fall_max, int(num_fall)))

    def note_overflow(self, policy: AdaptivePolicy) -> "PolicyState":
        """Overflow redo: the stream jitters beyond the schedule — grow
        the headroom for the rebuild, restart the streak, re-arm trims."""
        return dataclasses.replace(
            self, headroom=min(self.headroom * policy.headroom_grow,
                               policy.headroom_max),
            streak=0, trimmed=False, sym_max=None, num_max=None,
            sym_fall_max=0, num_fall_max=0)

    def after_trim(self, policy: AdaptivePolicy) -> "PolicyState":
        """Post-trim-attempt state: shrunken headroom, fresh streak, and
        no further trims until an overflow opens a new epoch."""
        return dataclasses.replace(
            self, headroom=self.trim_headroom(policy), streak=0,
            trimmed=True, sym_max=None, num_max=None,
            sym_fall_max=0, num_fall_max=0)

    def trim_headroom(self, policy: AdaptivePolicy) -> float:
        """The headroom a trim re-derives with (one shrink step down)."""
        return max(policy.headroom_min,
                   self.headroom * policy.headroom_shrink)

    def wants_trim(self, policy: AdaptivePolicy) -> bool:
        return (not self.trimmed and self.sym_max is not None
                and self.streak >= policy.trim_streak)

    # -- shard-count telemetry ----------------------------------------------
    def note_flops(self, flops: int) -> "PolicyState":
        """Accumulate one finalized request's flop estimate (host int)."""
        return dataclasses.replace(
            self, flops_total=self.flops_total + int(flops),
            flops_calls=self.flops_calls + 1)

    @property
    def mean_flops(self) -> int:
        return self.flops_total // max(self.flops_calls, 1)

    def with_shard_decision(self, n: int, basis: int) -> "PolicyState":
        return dataclasses.replace(
            self, shard_decision=int(n), shard_basis=int(basis),
            flops_total=0, flops_calls=0)

    # -- estimate provenance -------------------------------------------------
    def with_estimated(self, flag: bool) -> "PolicyState":
        return dataclasses.replace(self, estimated=bool(flag))

    # -- persistence merge ---------------------------------------------------
    def union(self, other: "PolicyState") -> "PolicyState":
        """Monotone merge for cross-process cache loads: keep the larger
        observed maxima and the more conservative (larger) headroom; an
        identical pair merges to itself, so no-op loads stay no-ops."""
        def tmax(a, b):
            if a is None:
                return b
            if b is None or len(a) != len(b):
                return a
            return tuple(max(x, y) for x, y in zip(a, b))
        return PolicyState(
            headroom=max(self.headroom, other.headroom),
            streak=max(self.streak, other.streak),
            trimmed=self.trimmed and other.trimmed,
            sym_max=tmax(self.sym_max, other.sym_max),
            num_max=tmax(self.num_max, other.num_max),
            sym_fall_max=max(self.sym_fall_max, other.sym_fall_max),
            num_fall_max=max(self.num_fall_max, other.num_fall_max),
            flops_total=max(self.flops_total, other.flops_total),
            flops_calls=max(self.flops_calls, other.flops_calls),
            shard_decision=(self.shard_decision
                            if self.shard_decision is not None
                            else other.shard_decision),
            shard_basis=max(self.shard_basis, other.shard_basis),
            # Unverified taints the merge: a verified replica merging an
            # estimated peer must not launder the peer's buckets.
            estimated=self.estimated or other.estimated,
        )


# ---------------------------------------------------------------------------
# Estimator headroom tracking (plan_mode="estimate").
# ---------------------------------------------------------------------------

class EstimatorState:
    """Engine-level learned headroom for the sampling estimator.

    Mutable (like :class:`~repro_torch.engine.stats.EngineStats`, unlike the
    per-plan immutable ``PolicyState``): the ratio tail is a property of
    the *stream*, not of one plan, so every estimated specialization
    shares one multiplier.  The same grow/shrink discipline as the hash
    headroom — an estimate miss (overflow redo of estimated buckets)
    doubles it, a sustained miss-free streak of verified estimates steps
    it back toward the floor.
    """

    def __init__(self, policy: AdaptivePolicy):
        self._policy = policy
        self.headroom: float = policy.est_headroom_init
        self.hits = 0            # estimated plans confirmed by an admit
        self.misses = 0          # estimated plans corrected by a redo
        self._streak = 0

    def note_hit(self) -> None:
        self.hits += 1
        self._streak += 1
        if self._streak >= self._policy.est_hit_streak:
            self._streak = 0
            self.headroom = max(self._policy.est_headroom_min,
                                self.headroom * self._policy.est_headroom_shrink)

    def note_miss(self) -> None:
        self.misses += 1
        self._streak = 0
        self.headroom = min(self._policy.est_headroom_max,
                            self.headroom * self._policy.est_headroom_grow)


# ---------------------------------------------------------------------------
# Shard-count selection.
# ---------------------------------------------------------------------------

def choose_shards(total_flops: int, nrows: int, devices: int,
                  policy: AdaptivePolicy, *, telemetry=None) -> int:
    """Shard count from a flop estimate and the device occupancy bound.

    Each shard must carry ``min_shard_flops`` to pay for the merge (the
    shards' verify reads and the concatenation), and fanning wider than
    the devices that could run the shards gains nothing, so tiny products
    collapse to N=1 (unsharded: no merge at all).  All host Python int: a
    multi-billion-flop stream must not wrap.  ``telemetry`` (anything with
    ``.event``) records the decision and its flop basis.
    """
    limit = (int(policy.max_shards) if policy.max_shards is not None
             else max(int(devices), 1))
    n = min(limit, int(total_flops) // max(int(policy.min_shard_flops), 1))
    n = clamp_shards(nrows, n)
    if telemetry is not None:
        telemetry.event("autotune.choose_shards", shards=n,
                        total_flops=int(total_flops), devices=int(devices))
    return n


def revise_shards(state: PolicyState, nrows: int, devices: int,
                  policy: AdaptivePolicy, *,
                  telemetry=None) -> Tuple[PolicyState, bool]:
    """Periodic shard-count review over the telemetry window.

    Every ``revise_period`` finalized requests, re-decide N from the
    window's mean flops, but only when the mean has left the hysteresis
    band around the decision's basis, so a stream near a sizing boundary
    does not flap plans (each flip costs a cold call).  Returns ``(state,
    revised)``; the window resets either way.  A revision is recorded on
    ``telemetry`` when one fires.
    """
    if state.shard_decision is None or state.flops_calls < policy.revise_period:
        return state, False
    mean = state.mean_flops
    basis = max(state.shard_basis, 1)
    state = dataclasses.replace(state, flops_total=0, flops_calls=0)
    if (mean * policy.revise_factor >= basis
            and mean <= basis * policy.revise_factor):
        return state, False                  # within the hysteresis band
    n = choose_shards(mean, nrows, devices, policy)
    if n == state.shard_decision:
        return dataclasses.replace(state, shard_basis=mean), False
    if telemetry is not None:
        telemetry.event("autotune.revise_shards", shards=n,
                        prev_shards=state.shard_decision, mean_flops=mean)
    return state.with_shard_decision(n, mean), True


# ---------------------------------------------------------------------------
# Hash-schedule trimming.
# ---------------------------------------------------------------------------

def trim_buckets(maxima: Tuple[int, ...], current: Tuple[int, ...],
                 m: int, headroom: float,
                 packs: Optional[Tuple[int, ...]] = None) -> Tuple[int, ...]:
    """Re-derive one ladder's bin-count buckets from observed maxima.

    Mirrors ``spgemm_hash.host_schedule`` bit-for-bit (the shared
    :func:`~repro_torch.kernels.spgemm_hash.schedule_bucket`), then takes the
    elementwise min with the current schedule — a trim only ever
    shrinks; rungs the streak never populated drop to 0 (statically
    absent, the biggest padding win).
    """
    m_cap = next_bucket(int(m), minimum=_ROW_BUCKET_MIN)
    return tuple(
        min(cur, schedule_bucket(
            s, m_cap=m_cap, headroom=headroom,
            pack=(packs[b] if packs is not None and b < len(packs) else 1)))
        for b, (s, cur) in enumerate(zip(maxima, current)))


def trim_fallback(fall_max: int, current: int, headroom: float,
                  active: bool) -> int:
    """Trimmed fallback-expansion capacity.

    ``active`` says whether any verified rung still uses the fallback
    expansion (either phase's last bucket nonzero for two-pass plans,
    sym's alone for fused) — when every fallback rung dropped the
    capacity drops to 0 (statically absent).  ``fall_max`` is the max of
    both phases' observed sub-products: the shared bucket must admit
    whichever phase expands more."""
    if not active:
        return 0
    if not int(fall_max):
        return current
    return min(current, fallback_capacity_bucket(fall_max,
                                                 headroom=headroom))


def trim_schedule(state: PolicyState, current, *, m: int,
                  sym_ladder: BinLadder, packed: bool, fused: bool,
                  policy: AdaptivePolicy):
    """Derive the trimmed :class:`HashSchedule` fields from a streak's
    observed maxima, or ``None`` when trimming would change nothing.

    Returns ``(sym_buckets, num_buckets, fall_prod)`` ready for
    ``HashSchedule`` — the caller owns the dataclass to keep this module
    import-light (plan.py imports us for ``PolicyState``).  Fused plans
    observe (and trim) only the symbolic side — there is no numeric
    probe pass — so their numeric buckets ride along unchanged, and the
    shared fallback capacity is sized to the max of both phases'
    observed sub-products (the state keeps them separate so policy
    serialization and ``note_admit`` call sites are unchanged; they
    merge only here).
    """
    if state.sym_max is None:
        return None
    headroom = state.trim_headroom(policy)
    # The standalone symbolic kernel packs like the fused one, so a packed
    # plan's sym buckets stay rows_per_block-aligned either way.
    packs = sym_ladder.rows_per_block if packed else None
    sym = trim_buckets(state.sym_max, current.sym_row_buckets, m, headroom,
                       packs)
    num = current.num_row_buckets
    if not fused and state.num_max is not None:
        num = trim_buckets(state.num_max, num, m, headroom)
    active = bool(sym[-1]) or (not fused and bool(num[-1]))
    fall_max = max(state.sym_fall_max,
                   0 if fused else state.num_fall_max)
    fall = trim_fallback(fall_max, current.fall_prod_bucket, headroom, active)
    if (sym == tuple(current.sym_row_buckets)
            and num == tuple(current.num_row_buckets)
            and fall == current.fall_prod_bucket):
        return None
    return sym, num, fall


# ---------------------------------------------------------------------------
# Memory governor.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MemoryGovernor:
    """Bound on total arena bytes with a graceful-degradation ladder.

    ``cap_bytes`` bounds the arena's *reserved* bytes (leased + pooled);
    ``None`` means unbounded (every lease is granted).  When a lease
    would exceed the cap the executor walks the ladder, cheapest rung
    first:

      1. ``Arena.reclaim()``: drop idle pooled buffers and retry.
      2. forced headroom trim (``trim_under_pressure``): re-derive the
         hash schedule at ``headroom_min`` from the streak's observed
         maxima, shrinking the plan's lease spec, and retry.
      3. fused->two-pass spill (``spill_fused``): route the request
         through the unleased two-pass steps path for this call.
      4. :class:`~repro_torch.core.workspace.ArenaPressureError`: the
         caller must finalize in-flight work (returning leases) or raise
         the cap; ``SpgemmEngine.drain`` does exactly that before
         re-raising.

    ``retry_after_s`` is the backpressure hint a serving layer hands a
    rejected request (the reference's ``SpgemmService``).
    """

    cap_bytes: Optional[int] = None
    trim_under_pressure: bool = True
    spill_fused: bool = True
    retry_after_s: float = 0.05
