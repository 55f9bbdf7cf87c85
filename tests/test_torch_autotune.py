"""The reference's autotune and plan-cache persistence tests on the port,
on the CPU.

From ``tests/test_autotune.py``: the shard-count policy
(``choose_shards``, ``revise_shards``, AUTO_SHARDS through the engine and
``spgemm``), schedule trims, growth of the headroom, capacity-only
overflow, the fused->two-pass fallback and the int31 bucket math.  From
``tests/test_partition.py``: the unsharded dump/load cases (the no-op
load, the fused round trip, a stale v1 schedule, an unknown version, the
monotone merge; the sharded ones are in ``tests/test_torch_partition.py``).
Only the imports and ``device="cpu"`` differ from the reference's cases.
(``test_load_v2_dump_merges_fallback_buckets`` is in
``tests/test_torch_arena.py``, with its arenas.)

The AUTO_SHARDS cases also run the reference's engine on the same inputs
(numpy in): the same shard decisions, counters and C (``rpt``/``col``
exact, ``val`` within 1e-5).  On the CPU the device count is 1 in both
packages (``jax.local_device_count()`` in the reference), so the default
policy picks one shard and only ``max_shards`` lifts it.
"""
import dataclasses
import json

import numpy as np
import pytest

from repro.core import csr as jcsr
from repro import engine as jengine
from repro_torch import convert
from repro_torch.core import (AUTO_SHARDS, CSR, SpgemmConfig, next_bucket,
                              random_csr, spgemm)
from repro_torch.core.binning_ranges import symbolic_ladder
from repro_torch.core.spgemm import spgemm_reference
from repro_torch.engine import (AdaptivePolicy, HashSchedule, MatrixSig,
                                PlanCache, PolicyState, SpgemmEngine,
                                choose_shards, clamp_shards,
                                reset_default_engine, revise_shards,
                                total_traces, trim_schedule)
from repro_torch.engine.autotune import trim_buckets, trim_fallback
from repro_torch.kernels.spgemm_hash import (fallback_capacity_bucket,
                                             schedule_bucket)


def _pair(seed, m=32, k=28, n=36, da=3.0, db=3.0, dist="uniform"):
    A = random_csr(seed, m, k, avg_nnz_per_row=da, distribution=dist,
                   device="cpu")
    B = random_csr(seed + 1, k, n, avg_nnz_per_row=db, distribution=dist,
                   device="cpu")
    return A, B


def _from_dense(d):
    return CSR.from_dense(d, device="cpu")


def _check(result, A, B):
    np.testing.assert_allclose(result.C.to_dense().numpy(),
                               spgemm_reference(A, B).numpy(),
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# Shard-count selection (tests/test_autotune.py).
# ---------------------------------------------------------------------------

def test_choose_shards_scales_with_flops_and_occupancy():
    pol = AdaptivePolicy(min_shard_flops=1000, max_shards=None)
    # Tiny products collapse to 1 (the merge would dominate).
    assert choose_shards(10, nrows=1000, devices=8, policy=pol) == 1
    assert choose_shards(999, nrows=1000, devices=8, policy=pol) == 1
    # Enough flops for 3 shards, but occupancy bounds the fan-out.
    assert choose_shards(3500, nrows=1000, devices=2, policy=pol) == 2
    assert choose_shards(3500, nrows=1000, devices=8, policy=pol) == 3
    # max_shards is a hard cap over the device count.
    cap = dataclasses.replace(pol, max_shards=2)
    assert choose_shards(10**9, nrows=1000, devices=8, policy=cap) == 2
    # Row feasibility: never more shards than the rows can carry.
    assert choose_shards(10**9, nrows=3, devices=8, policy=pol) == 1
    assert clamp_shards(8, 100) == 4 and clamp_shards(1, 5) == 1


@pytest.mark.parametrize("max_shards", [None, 2, 4])
def test_choose_shards_equals_reference(max_shards):
    kw = dict(min_shard_flops=1000, max_shards=max_shards)
    pol, jpol = AdaptivePolicy(**kw), jengine.AdaptivePolicy(**kw)
    for flops in (0, 999, 1000, 3500, 10**6, 2**36):
        for nrows in (1, 3, 8, 1000):
            for devices in (1, 2, 8):
                assert choose_shards(flops, nrows, devices, pol) \
                    == jengine.choose_shards(flops, nrows, devices, jpol)


def test_revise_shards_hysteresis_band():
    pol = AdaptivePolicy(min_shard_flops=1000, max_shards=4,
                         revise_period=2, revise_factor=2.0)
    state = PolicyState().with_shard_decision(4, 8000)
    # Window not full yet: no review.
    state = state.note_flops(7000)
    state, revised = revise_shards(state, 1000, 4, pol)
    assert not revised and state.flops_calls == 1
    # Mean inside [basis/2, basis*2]: window resets, decision holds.
    state = state.note_flops(5000)
    state, revised = revise_shards(state, 1000, 4, pol)
    assert not revised and state.shard_decision == 4
    assert state.flops_calls == 0
    # Sustained drift far below the band: shrink (here to 1).
    for f in (100, 120):
        state = state.note_flops(f)
    state, revised = revise_shards(state, 1000, 4, pol)
    assert revised and state.shard_decision == 1
    assert state.shard_basis == 110


def test_engine_auto_shards_shrink_to_one_on_tiny_products():
    """A stream that turns tiny stops fanning out: the policy revises N
    down to 1 from telemetry.  The reference's engine, fed the same
    requests, makes the same decisions and counts the same requests."""
    pol_kw = dict(min_shard_flops=1000, max_shards=2, revise_period=2,
                  revise_factor=2.0, trim_streak=10**6)
    engine = SpgemmEngine(shards="auto", policy=AdaptivePolicy(**pol_kw))
    jeng = jengine.SpgemmEngine(shards="auto",
                                policy=jengine.AdaptivePolicy(**pol_kw))
    jA = jcsr.random_csr(1, 48, 40, avg_nnz_per_row=6.0)
    jB = jcsr.random_csr(2, 40, 36, avg_nnz_per_row=6.0)
    A, B = (convert.csr_from_reference(np.asarray(M.rpt), np.asarray(M.col),
                                       np.asarray(M.val), M.shape,
                                       device="cpu") for M in (jA, jB))
    cap_a = next_bucket(A.capacity)
    d = np.zeros((48, 40), np.float32)
    d[:, 0] = 1.0                       # 1 nnz/row: a tiny product
    A_tiny = _from_dense(d).with_capacity(cap_a)
    jA_tiny = jcsr.CSR.from_dense(d).with_capacity(cap_a)
    assert MatrixSig.of(A_tiny) == MatrixSig.of(A)   # same AUTO plan

    def both(a, ja):
        r, jr = engine.execute(a, B), jeng.execute(ja, jB)
        _check(r, a, B)
        assert r.total_nnz == jr.total_nnz
        np.testing.assert_array_equal(r.C.rpt.numpy(), np.asarray(jr.C.rpt))
        return r

    both(A, jA)                         # cold: decides N=2 from flops
    assert engine.stats.sharded_requests == 1
    auto_entry = engine.cache.get(
        (MatrixSig.of(A), MatrixSig.of(B),
         dataclasses.replace(engine.config, shards=AUTO_SHARDS)))
    assert auto_entry.plan.policy.shard_decision == 2

    seen_sharded = engine.stats.sharded_requests
    for _ in range(4):                  # tiny stream: mean flops collapses
        both(A_tiny, jA_tiny)
    assert engine.stats.policy_revisions == 1
    assert auto_entry.plan.policy.shard_decision == 1
    # The last request(s) ran unsharded: the sharded counter stopped.
    assert engine.stats.sharded_requests < seen_sharded + 4
    both(A_tiny, jA_tiny)
    assert engine.stats.sharded_requests < engine.stats.auto_requests
    for field in ("requests", "sharded_requests", "auto_requests",
                  "policy_revisions", "shard_grows"):
        assert getattr(engine.stats, field) == getattr(jeng.stats, field), \
            field


def test_default_policy_on_one_device_picks_one_shard():
    """The occupancy bound: on one device the default policy never fans
    out, whatever the flops; ``max_shards`` lifts the bound."""
    A, B = _pair(1, m=48, k=40, n=36, da=6.0, db=6.0)
    engine = SpgemmEngine(shards="auto",
                          policy=AdaptivePolicy(min_shard_flops=1000))
    _check(engine.execute(A, B), A, B)
    key = (MatrixSig.of(A), MatrixSig.of(B),
           SpgemmConfig(shards=AUTO_SHARDS))
    assert engine.cache.get(key).plan.policy.shard_decision == 1
    assert engine.stats.sharded_requests == 0
    lifted = SpgemmEngine(shards="auto", policy=AdaptivePolicy(
        min_shard_flops=500, max_shards=4))     # ~3,000 flops: 6 -> 4
    _check(lifted.execute(A, B), A, B)
    assert lifted.cache.get(key).plan.policy.shard_decision == 4
    assert lifted.stats.sharded_requests == 1


def test_spgemm_auto_shards_knob():
    A, B = _pair(7)
    reset_default_engine()
    try:
        _check(spgemm(A, B, shards="auto"), A, B)
        from repro_torch.engine import default_engine
        assert default_engine().stats.auto_requests == 1
    finally:
        reset_default_engine()


# ---------------------------------------------------------------------------
# Hash-schedule headroom (tests/test_autotune.py).
# ---------------------------------------------------------------------------

def test_trim_buckets_shrink_drop_and_pack_floor():
    current = (64, 32, 16, 0, 8)
    # Observed maxima over the streak: rung 1 only ever held 9 rows, rung
    # 2 was never populated, rung 4 (fallback) unseen as well.
    maxima = (55, 9, 0, 0, 0)
    out = trim_buckets(maxima, current, m=64, headroom=1.5)
    assert out == (64, 16, 0, 0, 0)     # shrink, drop, never grow
    # Pack floors win over the derived bucket (packed fused rungs).
    out = trim_buckets(maxima, current, m=64, headroom=1.5,
                       packs=(1, 32, 1, 1))
    assert out == (64, 32, 0, 0, 0)
    # Fallback capacity trims while any fallback rung stays active, 0
    # when every rung dropped (the shared sym/num bucket).
    assert trim_fallback(100, 4096, 1.5, active=False) == 0
    assert trim_fallback(100, 4096, 1.5, active=True) == 256
    assert trim_fallback(0, 4096, 1.5, active=True) == 4096  # conservative


def test_trim_schedule_noop_returns_none():
    sched = HashSchedule(sym_row_buckets=(16, 0, 0, 0, 0, 0, 0, 0, 0),
                         num_row_buckets=(16, 0, 0, 0, 0, 0, 0, 0),
                         fall_prod_bucket=0)
    state = PolicyState(streak=8,
                        sym_max=(9, 0, 0, 0, 0, 0, 0, 0, 0),
                        num_max=(9, 0, 0, 0, 0, 0, 0, 0))
    pol = AdaptivePolicy()
    out = trim_schedule(state, sched, m=16, sym_ladder=symbolic_ladder(1.2),
                        packed=False, fused=False, policy=pol)
    assert out is None                  # 16 is already the floor bucket


def test_engine_headroom_shrinks_on_stable_stream_zero_retraces():
    """Stable stream: after the trim streak, the schedule re-derives at a
    shrunken headroom (one deliberate retrace), then stays zero-retrace —
    padded grid steps actually go away."""
    m = 64
    d = np.zeros((m, m), np.float32)
    d[:9, :30] = 1.0                    # 9 rows -> sym rung 1 (27..426)
    d[9:, 0] = 1.0                      # 55 rows -> sym rung 0
    A = _from_dense(d)
    Bc = _from_dense(np.eye(m, dtype=np.float32))
    pol = AdaptivePolicy(trim_streak=3)
    engine = SpgemmEngine(SpgemmConfig(method="hash"), policy=pol)
    oracle = SpgemmEngine(SpgemmConfig(method="hash", fuse_numeric=False))
    ref = oracle.execute(A, Bc)

    engine.execute(A, Bc)               # cold (learns 2x-headroom schedule)
    entry = next(iter(engine.cache.items()))[1]
    sched0 = entry.plan.hash_schedule
    assert sched0.sym_row_buckets[1] == 32      # 9 rows @ 2x -> 32
    for _ in range(3):                  # eviction-free streak -> trim
        engine.execute(A, Bc)
    assert engine.stats.schedule_trims == 1
    sched1 = entry.plan.hash_schedule
    assert sched1.sym_row_buckets[1] == 16      # 9 rows @ 1.5x -> 16
    assert entry.plan.policy.headroom == pytest.approx(1.5)
    assert entry.plan.policy.trimmed            # one trim per epoch

    r = engine.execute(A, Bc)           # one rebuild trace for the trim
    baseline = total_traces()
    grows = engine.stats.capacity_grows
    for _ in range(4):                  # stable stream: zero retraces after
        r = engine.execute(A, Bc)
    assert total_traces() == baseline
    assert engine.stats.capacity_grows == grows
    assert engine.stats.schedule_trims == 1     # no trim oscillation
    nnz = ref.total_nnz
    assert r.total_nnz == nnz                   # bitwise vs two-pass oracle
    np.testing.assert_array_equal(np.asarray(r.C.rpt), np.asarray(ref.C.rpt))
    np.testing.assert_array_equal(np.asarray(r.C.col)[:nnz],
                                  np.asarray(ref.C.col)[:nnz])
    np.testing.assert_array_equal(np.asarray(r.C.val)[:nnz],
                                  np.asarray(ref.C.val)[:nnz])


def test_headroom_grows_on_overflow_and_trims_rearm():
    """Overflow doubles the tracked headroom (capped) and re-arms the trim
    epoch; the redone stream is correct."""
    m = 64
    d_small = np.zeros((m, m), np.float32)
    d_small[np.arange(m), np.arange(m)] = 1.0
    d_big = np.zeros((m, m), np.float32)
    d_big[:, :32] = 1.0
    dB = np.eye(m, dtype=np.float32)
    A_small = _from_dense(d_small).with_capacity(2048)
    A_big = _from_dense(d_big)
    Bc = _from_dense(dB)
    assert MatrixSig.of(A_small) == MatrixSig.of(A_big)

    engine = SpgemmEngine(SpgemmConfig(method="hash"))
    engine.execute(A_small, Bc)
    engine.execute(A_small, Bc)                 # hot path established
    entry = next(iter(engine.cache.items()))[1]
    r = engine.execute(A_big, Bc)               # schedule overflow
    np.testing.assert_allclose(np.asarray(r.C.to_dense()), d_big @ dB,
                               rtol=1e-5)
    assert engine.stats.bin_overflows == 1
    assert entry.plan.policy.headroom == pytest.approx(4.0)  # 2x grown
    assert not entry.plan.policy.trimmed and entry.plan.policy.streak == 0


def test_capacity_only_overflow_keeps_headroom():
    """A pure nnz-capacity overflow (bins all admitted) must grow the
    pow-2 buckets but NOT inflate the bin headroom — the bins never
    jittered, and 4x-padded grid steps would be pure waste."""
    m, k = 8, 32
    d_small = np.zeros((m, k), np.float32)
    d_small[:, :2] = 1.0                 # nprod 2/row -> rung 0, tiny nnz
    d_big = np.zeros((m, k), np.float32)
    d_big[:, :26] = 1.0                  # nprod 26/row -> STILL rung 0
    A_small = _from_dense(d_small).with_capacity(256)
    A_big = _from_dense(d_big).with_capacity(256)
    Bc = _from_dense(np.eye(k, dtype=np.float32))
    assert MatrixSig.of(A_small) == MatrixSig.of(A_big)

    engine = SpgemmEngine(SpgemmConfig(method="hash"))
    engine.execute(A_small, Bc)
    engine.execute(A_small, Bc)          # hot path established
    entry = next(iter(engine.cache.items()))[1]
    r = engine.execute(A_big, Bc)        # nnz outgrows the bucket only
    np.testing.assert_allclose(np.asarray(r.C.to_dense()),
                               d_big @ np.eye(k, dtype=np.float32),
                               rtol=1e-5)
    assert engine.stats.capacity_grows == 1
    assert engine.stats.bin_overflows == 0
    assert entry.plan.policy.headroom == pytest.approx(2.0)  # untouched


def test_fused_is_hash_default_and_falls_back_to_two_pass():
    """fuse_numeric=True is the hash default; when ``admits_fused`` fails
    the request is redone on the two-pass steps oracle automatically and
    the next same-signature call is hot again."""
    assert SpgemmConfig().fuse_numeric is True
    m = 64
    d_small = np.zeros((m, m), np.float32)
    d_small[np.arange(m), np.arange(m)] = 1.0
    d_big = np.zeros((m, m), np.float32)
    d_big[:, :32] = 1.0
    dB = np.eye(m, dtype=np.float32)
    A_small = _from_dense(d_small).with_capacity(2048)
    A_big = _from_dense(d_big)
    Bc = _from_dense(dB)

    engine = SpgemmEngine(SpgemmConfig(method="hash"))
    assert engine.config.fuse_numeric
    engine.execute(A_small, Bc)
    engine.execute(A_small, Bc)
    entry = next(iter(engine.cache.items()))[1]
    assert entry.stats.hot_calls == 1 and entry.stats.steps_calls == 1

    r = engine.execute(A_big, Bc)       # fused verify fails -> steps redo
    np.testing.assert_allclose(np.asarray(r.C.to_dense()), d_big @ dB,
                               rtol=1e-5)
    assert engine.stats.bin_overflows == 1
    assert entry.stats.steps_calls == 2          # the two-pass fallback ran
    r2 = engine.execute(A_big, Bc)      # grown schedule: fused + hot again
    np.testing.assert_allclose(np.asarray(r2.C.to_dense()), d_big @ dB,
                               rtol=1e-5)
    assert entry.stats.steps_calls == 2 and entry.stats.hot_calls >= 2


def test_bucket_math_survives_near_int31_counts():
    """Headroom growth (`next_bucket` doubling) on near-2^31 observed
    counts computes in host int: buckets come out positive pow-2 ABOVE
    the int32 range instead of wrapping."""
    big = 2**31 - 100
    b = schedule_bucket(np.int64(big), m_cap=2**40, headroom=2.0)
    assert b == 2**32 and b > 2**31              # widened, not wrapped
    assert schedule_bucket(big, m_cap=2**40, headroom=1.0) == 2**31
    fb = fallback_capacity_bucket(np.int64(big), headroom=2.0)
    assert fb == 2**32 > 0
    assert next_bucket(2 * big) == 2**32
    # choose_shards on a multi-billion-flop estimate.
    pol = AdaptivePolicy(min_shard_flops=1 << 30, max_shards=64)
    assert choose_shards(2**36, nrows=10**6, devices=64, policy=pol) == 64
    # Trimming with near-wrap maxima stays monotone and positive.
    out = trim_buckets((big,), (2**32,), m=2**40, headroom=2.0)
    assert out == (2**32,)


# ---------------------------------------------------------------------------
# Plan-cache persistence (tests/test_partition.py).
# ---------------------------------------------------------------------------

def test_noop_load_keeps_live_executables(tmp_path):
    engine = SpgemmEngine()
    A, B = _pair(99)
    engine.execute(A, B)
    engine.execute(A, B)                       # executables built
    path = str(tmp_path / "plans.json")
    engine.cache.dump(path)
    before = {k: e.executable for k, e in engine.cache.items()}
    assert any(x is not None for x in before.values())
    engine.cache.load(path)                    # merge is a no-op
    for key, entry in engine.cache.items():
        assert entry.executable is before[key]  # zero-retrace state kept


def test_fused_dump_load_roundtrip_through_steady_state(tmp_path):
    """Persistence round-trip for FUSED plans (the default hash config):
    a fresh engine loading the dump serves its first request straight from
    the fused hot path — no cold steps call, no retrace storm — with
    bitwise parity against the warm engine."""
    A, B = _pair(83)
    cfg = SpgemmConfig(method="hash", fuse_numeric=True, row_packing=True)
    warm = SpgemmEngine(cfg)
    base = warm.execute(A, B)
    warm.execute(A, B)                     # fused steady state reached
    path = str(tmp_path / "plans.json")
    warm.cache.dump(path)

    blob = json.load(open(path))
    assert blob["version"] == 4
    assert blob["plans"][0]["policy"] is not None   # state persists

    fresh = SpgemmEngine(cfg)
    fresh.cache.load(path)
    entry = fresh.cache.get((MatrixSig.of(A), MatrixSig.of(B), cfg))
    # Pack alignment survives the round-trip: every populated sym bucket
    # still carves into whole rows_per_block grid steps.
    packs = entry.plan.sym_ladder.rows_per_block
    for b, cap in enumerate(entry.plan.hash_schedule.sym_row_buckets):
        if cap and b < len(packs):
            assert cap % packs[b] == 0
    r = fresh.execute(A, B)                # straight to the fused hot path
    assert sum(e.stats.steps_calls for _, e in fresh.cache.items()) == 0
    assert fresh.stats.capacity_grows == 0
    nnz = base.total_nnz
    assert r.total_nnz == nnz
    np.testing.assert_array_equal(np.asarray(r.C.rpt),
                                  np.asarray(base.C.rpt))
    np.testing.assert_array_equal(np.asarray(r.C.col)[:nnz],
                                  np.asarray(base.C.col)[:nnz])
    np.testing.assert_array_equal(np.asarray(r.C.val)[:nnz],
                                  np.asarray(base.C.val)[:nnz])


def test_load_realigns_stale_unpacked_schedule(tmp_path):
    """A v1 dump (pre-packing/fusion: no policy blob, sym buckets never
    pack-aligned — here a sub-pack, non-pow-2 bucket) must not be taken
    at face value by a fused+packed config: load re-derives the pack
    alignment (monotone) so the fused executable gets whole grid steps,
    and the first request still verifies and matches the oracle."""
    A, B = _pair(87)
    cfg = SpgemmConfig(method="hash", fuse_numeric=True, row_packing=True)
    warm = SpgemmEngine(cfg)
    warm.execute(A, B)
    warm.execute(A, B)
    path = str(tmp_path / "plans.json")
    warm.cache.dump(path)

    blob = json.load(open(path))
    blob["version"] = 1                     # pre-policy payload
    for plan in blob["plans"]:
        del plan["policy"]
        sched = plan["hash_schedule"]
        # De-align: a stale bucket smaller than the rung's pack (and not
        # pow-2) that nevertheless admits the observed sizes.
        sched["sym_row_buckets"] = [
            max(b // 2 + 1, 1) if b else 0
            for b in sched["sym_row_buckets"]]
    json.dump(blob, open(path, "w"))

    fresh = SpgemmEngine(cfg)
    assert fresh.cache.load(path) == len(blob["plans"])
    entry = fresh.cache.get((MatrixSig.of(A), MatrixSig.of(B), cfg))
    packs = entry.plan.sym_ladder.rows_per_block
    for b, cap in enumerate(entry.plan.hash_schedule.sym_row_buckets):
        assert cap == 0 or cap & (cap - 1) == 0          # pow-2 restored
        if cap and b < len(packs):
            assert cap % packs[b] == 0                   # pack-aligned
    r = fresh.execute(A, B)
    np.testing.assert_allclose(np.asarray(r.C.to_dense()),
                               np.asarray(spgemm_reference(A, B)),
                               rtol=1e-5, atol=1e-5)


def test_load_rejects_unknown_version(tmp_path):
    engine = SpgemmEngine()
    A, B = _pair(89)
    engine.execute(A, B)
    path = str(tmp_path / "plans.json")
    engine.cache.dump(path)
    blob = json.load(open(path))
    blob["version"] = 99
    json.dump(blob, open(path, "w"))
    with pytest.raises(ValueError):
        PlanCache().load(path)


def test_load_merges_monotonically(tmp_path):
    cfg = SpgemmConfig()
    A, B = _pair(95)
    engine = SpgemmEngine()
    engine.prewarm(A, B, prod_bucket=256, nnz_bucket=256)
    path = str(tmp_path / "plans.json")
    engine.cache.dump(path)
    # A cache holding BIGGER buckets must not shrink on load.
    other = SpgemmEngine()
    other.prewarm(A, B, prod_bucket=4096, nnz_bucket=4096)
    other.cache.load(path)
    p = other.cache.get((MatrixSig.of(A), MatrixSig.of(B), cfg)).plan
    assert p.prod_bucket == 4096 and p.nnz_bucket == 4096
