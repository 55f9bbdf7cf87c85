"""Port parity for the workspace arena, the memory governor and the lease
lifecycle (``repro_torch/core/workspace.py``, ``engine/autotune.py``).

The reference's ``tests/test_arena.py`` on the port's engine, on the CPU
(``device="cpu"`` leases): plans lease their product-expansion storage at
dispatch and return it at finalize; the governor's degradation ladder
(reclaim -> forced headroom trim -> fused two-pass spill -> backpressure);
arena-aware cache eviction (forfeit, no leak); dump/load with the live
arena.  Then parity: the same request sequence through the reference's
engine and the port's gives the same arena accounting (reserved and peak
bytes, lease hits and misses, pressure events), the same trims and spills,
and the same C (rpt/col exactly, val within the reference's tolerance).
The ``gpu`` tests check that leases land on the card, and skip without
one.
"""
import json

import numpy as np
import pytest
import torch

from repro.core import csr as jcsr
from repro.core.spgemm import SpgemmConfig as JConfig
from repro import engine as jengine
from repro_torch import convert
from repro_torch.core.spgemm import SpgemmConfig, spgemm_reference
from repro_torch.engine import (Arena, ArenaPressureError, HashSchedule,
                                LeaseSpec, MatrixSig, MemoryGovernor,
                                SpgemmEngine, default_arena,
                                reset_default_arena, total_traces)
from repro_torch import engine as tengine

VAL_TOL = dict(rtol=1e-5, atol=1e-5)   # tests/test_arena.py:38
CPU = "cpu"


def _port(A):
    return convert.csr_from_reference(np.asarray(A.rpt), np.asarray(A.col),
                                      np.asarray(A.val), A.shape, device=CPU)


def _ref_pair(seed, m=32, k=28, n=36, da=3.0, db=3.0, dist="uniform"):
    A = jcsr.random_csr(seed, m, k, avg_nnz_per_row=da, distribution=dist)
    B = jcsr.random_csr(seed + 1, k, n, avg_nnz_per_row=db,
                        distribution=dist)
    return A, B


def _pair(seed, **kw):
    return tuple(_port(M) for M in _ref_pair(seed, **kw))


# Hash plans lease only when their ESC fallback rung is populated.  The
# reference's test makes a dense pair (80 and 64 entries a row) for that;
# its plain hash tables take ~10 s a call on the CPU, so these tests reach
# the fallback rung with the multipliers of tests/test_torch_spgemm.py's
# "hash-fallback" case on a pair at the 48-row scale instead.
HEAVY = dict(seed=51, m=48, k=40, n=44, da=5.0, db=5.0, dist="powerlaw")
HASH_KW = dict(method="hash", sym_multiplier=1000.0, num_multiplier=1000.0)


@pytest.fixture(scope="module")
def heavy_pair():
    """A pair whose hash plans carry a nonzero fallback bucket (rows
    overflowing the largest hash rung): the hash lease."""
    kw = dict(HEAVY)
    return _pair(kw.pop("seed"), **kw)


def _check(result, A, B):
    np.testing.assert_allclose(result.C.to_dense().numpy(),
                               spgemm_reference(A, B).numpy(), **VAL_TOL)


def _lease_bytes(spec):
    return sum(Arena._bucket_bytes(k) for k in Arena._buckets(spec))


# ---------------------------------------------------------------------------
# Arena unit accounting.
# ---------------------------------------------------------------------------

def test_arena_accounting_roundtrip():
    ar = Arena()
    spec = LeaseSpec(i32_cells=100, val_cells=50, val_dtype="float32")
    nbytes = _lease_bytes(spec)          # pow-2 buckets: 128 + 64 cells
    assert nbytes == 4 * 128 + 4 * 64

    l1 = ar.acquire(spec, device=CPU)
    assert l1.active
    assert ar.bytes_in_use == ar.bytes_reserved == ar.peak_bytes == nbytes
    assert (ar.lease_misses, ar.lease_hits) == (2, 0)
    assert l1.i32.shape == (128,) and l1.i32.dtype == torch.int32
    assert l1.val.shape == (64,) and l1.val.dtype == torch.float32

    ar.release(l1)
    assert not l1.active
    assert ar.bytes_in_use == 0 and ar.bytes_free == nbytes
    ar.release(l1)                       # idempotent
    assert ar.bytes_free == nbytes

    l2 = ar.acquire(spec, device=CPU)    # same buckets -> pure free-list hit
    assert (ar.lease_misses, ar.lease_hits) == (2, 2)
    assert l2.i32 is l1.i32 and l2.val is l1.val
    assert ar.bytes_reserved == nbytes == ar.peak_bytes
    assert ar.hit_rate == 0.5
    ar.release(l2)

    assert ar.reclaim() == nbytes
    assert ar.bytes_reserved == 0
    assert ar.peak_bytes == nbytes       # high-water mark survives reclaim
    ar.reset_peak()
    assert ar.peak_bytes == 0


def test_arena_cap_binds_new_bytes_only():
    ar = Arena()
    spec = LeaseSpec(i32_cells=64, val_cells=64, val_dtype="float32")
    nbytes = _lease_bytes(spec)
    assert ar.try_acquire(spec, cap_bytes=nbytes - 1, device=CPU) is None
    lease = ar.acquire(spec, cap_bytes=nbytes, device=CPU)
    ar.release(lease)
    # A spec fully served from the free lists always succeeds, even over
    # an already-exceeded cap: reuse never adds bytes.
    assert ar.try_acquire(spec, cap_bytes=0, device=CPU) is not None
    with pytest.raises(ArenaPressureError):
        ar.acquire(LeaseSpec(4096, 4096, "float32"), cap_bytes=nbytes,
                   device=CPU)


def test_forfeit_drops_accounting_without_recycling():
    ar = Arena()
    spec = LeaseSpec(i32_cells=64, val_cells=64, val_dtype="float32")
    lease = ar.acquire(spec, device=CPU)
    nbytes = ar.bytes_in_use
    assert ar.forfeit(lease) == nbytes
    assert ar.bytes_in_use == 0
    assert ar.bytes_free == 0            # buffers NOT recycled
    assert ar.forfeit(lease) == 0        # idempotent
    ar.release(lease)                    # late finalize: no-op
    assert ar.bytes_free == 0 and ar.bytes_in_use == 0


def test_lease_rebind_recycles_the_returned_arrays():
    ar = Arena()
    spec = LeaseSpec(i32_cells=64, val_cells=64, val_dtype="float32")
    lease = ar.acquire(spec, device=CPU)
    new_i32 = torch.ones(128, dtype=torch.int32)
    new_val = torch.ones(64, dtype=torch.float32)
    ar.release(lease, rebind=(new_i32, new_val))
    relent = ar.acquire(spec, device=CPU)   # hit: hands back the rebinds
    assert relent.i32 is new_i32 and relent.val is new_val


def test_lease_spec_bytes_follow_the_value_dtype():
    for dtype, size in (("float32", 4), ("bfloat16", 2), ("float64", 8)):
        spec = LeaseSpec(i32_cells=64, val_cells=32, val_dtype=dtype)
        assert spec.nbytes == _lease_bytes(spec) == 4 * 64 + size * 32
        assert spec.nbytes == jengine.LeaseSpec(64, 32, dtype).nbytes
    with pytest.raises(ValueError):
        LeaseSpec(64, 32, "no_such_dtype").nbytes


def test_lease_without_a_device_is_the_card():
    """``device=None`` means the card: it raises without one, never falls
    back to the CPU."""
    ar = Arena()
    spec = LeaseSpec(i32_cells=64, val_cells=64, val_dtype="float32")
    if torch.cuda.is_available():
        lease = ar.acquire(spec)
        assert lease.i32.is_cuda and lease.val.is_cuda
        ar.release(lease)
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            ar.acquire(spec)
        assert ar.bytes_reserved == 0 and ar.lease_misses == 0


def test_free_lists_are_per_device():
    ar = Arena()
    spec = LeaseSpec(i32_cells=64, val_cells=64, val_dtype="float32")
    lease = ar.acquire(spec, device=CPU)
    ar.release(lease)
    assert lease.keys == Arena._buckets(spec, torch.device(CPU))
    assert all(k[2] == torch.device(CPU) for k in lease.keys)
    assert ar.acquire(spec, device=torch.device(CPU)).i32 is lease.i32


def test_default_arena_is_shared_and_resettable():
    reset_default_arena()
    a = default_arena()
    assert SpgemmEngine().arena is a and SpgemmEngine().arena is a
    reset_default_arena()
    assert default_arena() is not a


# ---------------------------------------------------------------------------
# Engine steady state: leases reused, no rebuild, gauges fresh.
# ---------------------------------------------------------------------------

def test_steady_state_reuses_one_lease_without_retrace():
    A, B = _pair(61)
    ar = Arena()
    eng = SpgemmEngine(SpgemmConfig(method="esc"), arena=ar)
    eng.execute(A, B)                    # cold: steps path, no lease
    assert ar.bytes_reserved == 0
    _check(eng.execute(A, B), A, B)      # first hot call allocates the lease
    assert ar.lease_misses == 2 and ar.bytes_in_use == 0
    nbytes = ar.bytes_reserved
    assert nbytes > 0

    t0, misses0 = total_traces(), ar.lease_misses
    for _ in range(4):
        _check(eng.execute(A, B), A, B)
    assert total_traces() == t0          # leasing rebuilt nothing
    assert ar.lease_misses == misses0    # every lease a free-list hit
    assert ar.lease_hits == 8
    assert ar.bytes_reserved == nbytes   # one parked lease, not five
    assert ar.bytes_in_use == 0

    reg = eng.telemetry.registry
    assert reg.get("opsparse_arena_bytes_reserved").value == nbytes
    assert reg.get("opsparse_arena_peak_bytes").value == nbytes
    assert reg.get("opsparse_arena_lease_hits_total").value == 8
    assert "arena: 0 B in use / %d B reserved" % nbytes in eng.report()


# ---------------------------------------------------------------------------
# Governor degradation ladder.
# ---------------------------------------------------------------------------

def test_governor_backpressure_when_ladder_exhausted():
    A, B = _pair(63)
    ar = Arena()
    eng = SpgemmEngine(SpgemmConfig(method="esc"), arena=ar,
                       governor=MemoryGovernor(cap_bytes=0))
    eng.execute(A, B)                    # cold steps path needs no lease
    # ESC has no trim (hash-only) or spill (fused-only) rung: refuse.
    with pytest.raises(ArenaPressureError):
        eng.execute(A, B)
    assert eng.stats.arena_pressure >= 1
    assert ar.pressure_events >= 1
    assert ar.bytes_in_use == 0          # nothing leaked on the way out


def test_drain_backpressure_caps_peak_at_one_lease():
    A, B = _pair(65)
    ar = Arena()
    eng = SpgemmEngine(SpgemmConfig(method="esc"), arena=ar)
    eng.execute(A, B)
    eng.execute(A, B)                    # steady: one lease parked
    cap = ar.bytes_reserved
    eng.governor = MemoryGovernor(cap_bytes=cap)
    ar.reset_peak()

    uids = [eng.submit(A, B) for _ in range(5)]
    results = eng.drain(window=4)
    assert set(results) == set(uids)
    for uid in uids:
        _check(results[uid], A, B)
    # Backpressure finalized in-flight records instead of allocating:
    # the peak never exceeded the single-lease cap.
    assert ar.peak_bytes <= cap
    assert eng.stats.arena_pressure >= 1
    assert ar.bytes_in_use == 0

    # Ordered drain walks the same ladder.
    uids = [eng.submit(A, B) for _ in range(3)]
    results = eng.drain(drain_ordered=True)
    for uid in uids:
        _check(results[uid], A, B)
    assert ar.peak_bytes <= cap


def test_governor_forced_trim_shrinks_lease(heavy_pair):
    A, B = heavy_pair
    cfg = SpgemmConfig(**HASH_KW)
    ar = Arena()
    eng = SpgemmEngine(cfg, arena=ar)
    eng.execute(A, B)
    eng.execute(A, B)
    entry = eng.cache.get((MatrixSig.of(A), MatrixSig.of(B), cfg))
    sched = entry.plan.hash_schedule
    assert sched.fall_prod_bucket > 0    # fallback rows present (the lease)
    cap = ar.bytes_reserved              # exactly the steady-state lease

    # Inflate the fallback bucket 4x, as if the schedule had been sized
    # by a much larger union partner, then cap the arena at the honest
    # size: rung 1 must re-derive the schedule from the streak's observed
    # maxima and fit back under the cap.
    eng.cache.specialize(entry, entry.plan.with_hash_schedule(HashSchedule(
        sched.sym_row_buckets, sched.num_row_buckets,
        4 * sched.fall_prod_bucket)))
    eng.governor = MemoryGovernor(cap_bytes=cap)
    _check(eng.execute(A, B), A, B)
    assert eng.stats.arena_trims == 1
    assert entry.plan.hash_schedule.fall_prod_bucket < 4 * sched.fall_prod_bucket
    assert _lease_bytes(entry.plan.workspace_spec()) <= cap

    # Post-trim steady state: no further pressure.
    pressure = eng.stats.arena_pressure
    _check(eng.execute(A, B), A, B)
    assert eng.stats.arena_pressure == pressure


def test_governor_spills_fused_to_two_pass(heavy_pair):
    A, B = heavy_pair
    cfg = SpgemmConfig(**HASH_KW, fuse_numeric=True)
    ar = Arena()
    eng = SpgemmEngine(cfg, arena=ar)
    eng.execute(A, B)
    eng.execute(A, B)
    entry = eng.cache.get((MatrixSig.of(A), MatrixSig.of(B), cfg))
    assert entry.plan.workspace_spec() is not None

    eng.governor = MemoryGovernor(cap_bytes=0, trim_under_pressure=False)
    ar.reclaim()                         # park nothing: the cap must bind
    spilled = eng.execute(A, B)          # rung 2: unleased two-pass path
    assert eng.stats.arena_spills == 1
    assert ar.bytes_in_use == 0
    _check(spilled, A, B)
    # The fused pipeline stays cached for when pressure clears.
    assert entry.executable is not None
    eng.governor = MemoryGovernor()
    _check(eng.execute(A, B), A, B)
    assert eng.stats.arena_spills == 1   # leased fused path again


# ---------------------------------------------------------------------------
# Arena-aware cache eviction: no leak, in-flight leases forfeited.
# ---------------------------------------------------------------------------

def test_evict_forfeits_inflight_lease_without_leak():
    A, B = _pair(67)
    cfg = SpgemmConfig(method="esc")
    ar = Arena()
    eng = SpgemmEngine(cfg, arena=ar)
    eng.execute(A, B)
    eng.execute(A, B)
    key = (MatrixSig.of(A), MatrixSig.of(B), cfg)

    # Dispatch without finalizing: the lease is checked out (in flight).
    rec = eng._dispatch(next(eng._uids), A, B, cfg)
    assert ar.bytes_in_use > 0
    free_before = ar.bytes_free
    assert eng.cache.evict(key)
    # Forfeited: dropped from accounting but NOT recycled: queued device
    # work may still write the buffers.
    assert ar.bytes_in_use == 0
    assert ar.bytes_free == free_before
    # The straggler finalize still verifies, and its release is a no-op.
    _check(eng._finalize(rec), A, B)
    assert ar.bytes_in_use == 0
    assert ar.bytes_free == free_before

    # Clearing a cache with parked (released) leases leaks nothing.
    eng.execute(A, B)
    eng.execute(A, B)
    eng.cache.clear()
    assert ar.bytes_in_use == 0


def test_evict_prefers_smaller_stamp_then_bigger_footprint():
    cfg = SpgemmConfig(method="esc")
    cache_engine = SpgemmEngine(cfg, arena=Arena(), cache_capacity=2)
    small = _pair(71, m=16, k=12, n=14)
    big = _pair(73, m=48, k=44, n=40, da=6.0, db=6.0)
    cache_engine.execute(*small)
    cache_engine.execute(*small)
    cache_engine.execute(*big)           # cache full: {small, big}
    key_small = (MatrixSig.of(small[0]), MatrixSig.of(small[1]), cfg)
    key_big = (MatrixSig.of(big[0]), MatrixSig.of(big[1]), cfg)
    cache_engine.execute(*small)         # small is now most recently used
    other = _pair(75, m=20, k=18, n=22)
    cache_engine.execute(*other)         # evicts big (older stamp)
    assert cache_engine.cache.get(key_small) is not None
    assert cache_engine.cache.get(key_big) is None


def test_loaded_ties_evict_the_bigger_footprint_first(tmp_path):
    """Plans loaded together share one LRU stamp; the tie goes to the plan
    whose lease is larger."""
    cfg = SpgemmConfig(method="esc")
    warm = SpgemmEngine(cfg, arena=Arena())
    small = _pair(81, m=16, k=12, n=14)
    big = _pair(83, m=48, k=44, n=40, da=6.0, db=6.0)
    for pair in (small, big):
        warm.execute(*pair)
    path = str(tmp_path / "plans.json")
    warm.cache.dump(path)
    fresh = SpgemmEngine(cfg, arena=Arena(), cache_capacity=2)
    fresh.cache.load(path)
    key = lambda p: (MatrixSig.of(p[0]), MatrixSig.of(p[1]), cfg)  # noqa
    assert (fresh.cache.peek(key(big)).plan.workspace_spec().nbytes
            > fresh.cache.peek(key(small)).plan.workspace_spec().nbytes)
    fresh.execute(*_pair(85, m=20, k=18, n=22))   # third plan: one must go
    assert fresh.cache.peek(key(big)) is None
    assert fresh.cache.peek(key(small)) is not None


# ---------------------------------------------------------------------------
# Dump/load: loaded plans lease from the live arena; v2 compat mapping.
# ---------------------------------------------------------------------------

def test_load_rebinds_plans_to_live_arena(tmp_path):
    A, B = _pair(77)
    cfg = SpgemmConfig(method="esc")
    a1 = Arena()
    warm = SpgemmEngine(cfg, arena=a1)
    warm.execute(A, B)
    warm.execute(A, B)
    reserved1 = a1.bytes_reserved
    path = str(tmp_path / "plans.json")
    assert warm.cache.dump(path) >= 1

    a2 = Arena()
    fresh = SpgemmEngine(cfg, arena=a2)
    assert fresh.cache.load(path) >= 1
    _check(fresh.execute(A, B), A, B)    # loaded plan: straight to hot path
    # The lease came from the NEW engine's arena, not the dump's origin.
    assert a2.lease_misses == 2 and a2.bytes_reserved > 0
    assert a1.bytes_reserved == reserved1
    fresh.cache.clear()
    assert a2.bytes_in_use == 0


def test_load_v2_dump_merges_fallback_buckets(tmp_path):
    A, B = _pair(79)
    cfg = SpgemmConfig(method="hash")
    warm = SpgemmEngine(cfg, arena=Arena())
    warm.execute(A, B)
    warm.execute(A, B)
    path = str(tmp_path / "plans.json")
    warm.cache.dump(path)

    blob = json.load(open(path))
    assert blob["version"] == 4
    blob["version"] = 2                  # pre-merge payload: split buckets
    for plan in blob["plans"]:
        hs = plan["hash_schedule"]
        del hs["fall_prod_bucket"]
        hs["sym_fall_prod_bucket"] = 1024
        hs["num_fall_prod_bucket"] = 4096
    json.dump(blob, open(path, "w"))

    fresh = SpgemmEngine(cfg, arena=Arena())
    assert fresh.cache.load(path) >= 1
    entry = fresh.cache.get((MatrixSig.of(A), MatrixSig.of(B), cfg))
    # v2's separate sym/num fallback buckets merge to their max.
    assert entry.plan.hash_schedule.fall_prod_bucket == 4096


# ---------------------------------------------------------------------------
# Parity: the same request sequence through both packages' engines.
# ---------------------------------------------------------------------------

ARENA_FIELDS = ("bytes_in_use", "bytes_reserved", "peak_bytes",
                "lease_hits", "lease_misses", "pressure_events")
ENGINE_FIELDS = ("arena_pressure", "arena_trims", "arena_spills",
                 "capacity_grows", "requests")


def _scenario(pkg, name, A, B):
    """Drive one request sequence; returns (numbers after each step,
    every result).  ``pkg`` is either package's engine module, with its
    config class beside it."""
    ns, Config = pkg
    ar = ns.Arena()
    results, trail = [], []

    def snap(eng):
        trail.append(tuple(getattr(ar, f) for f in ARENA_FIELDS)
                     + tuple(getattr(eng.stats, f) for f in ENGINE_FIELDS)
                     + (eng.arena.bytes_reserved,))

    if name == "esc-steady":
        eng = ns.SpgemmEngine(Config(method="esc"), arena=ar)
        for _ in range(4):
            results.append(eng.execute(A, B))
            snap(eng)
    elif name == "esc-drain-backpressure":
        eng = ns.SpgemmEngine(Config(method="esc"), arena=ar)
        results += [eng.execute(A, B), eng.execute(A, B)]
        eng.governor = ns.MemoryGovernor(cap_bytes=ar.bytes_reserved)
        ar.reset_peak()
        for ordered in (False, True):
            for _ in range(3):
                eng.submit(A, B)
            results += list(eng.drain(window=2,
                                      drain_ordered=ordered).values())
            snap(eng)
    elif name in ("hash-trim", "hash-spill"):
        cfg = Config(**HASH_KW)
        eng = ns.SpgemmEngine(cfg, arena=ar)
        results += [eng.execute(A, B), eng.execute(A, B)]
        snap(eng)
        entry = eng.cache.get((ns.MatrixSig.of(A), ns.MatrixSig.of(B), cfg))
        if name == "hash-trim":
            sched = entry.plan.hash_schedule
            eng.cache.specialize(entry, entry.plan.with_hash_schedule(
                ns.HashSchedule(sched.sym_row_buckets, sched.num_row_buckets,
                                4 * sched.fall_prod_bucket)))
            eng.governor = ns.MemoryGovernor(cap_bytes=ar.bytes_reserved)
        else:
            eng.governor = ns.MemoryGovernor(cap_bytes=0)
            ar.reclaim()                 # park nothing: the cap must bind
        for _ in range(2):
            results.append(eng.execute(A, B))
            snap(eng)
        trail.append(entry.plan.hash_schedule.fall_prod_bucket)
    return trail, results


@pytest.mark.parametrize("name", ["esc-steady", "esc-drain-backpressure",
                                  "hash-trim", "hash-spill"])
def test_same_sequence_same_arena_numbers(name):
    if name.startswith("hash"):
        kw = dict(HEAVY)
        jA, jB = _ref_pair(kw.pop("seed"), **kw)
    else:
        jA, jB = _ref_pair(65)
    A, B = _port(jA), _port(jB)
    t_trail, t_res = _scenario((tengine, SpgemmConfig), name, A, B)
    j_trail, j_res = _scenario((jengine, JConfig), name, jA, jB)
    assert t_trail == j_trail
    assert len(t_res) == len(j_res)
    for t, j in zip(t_res, j_res):
        nz = t.total_nnz
        assert nz == j.total_nnz
        np.testing.assert_array_equal(t.C.rpt.numpy(), np.asarray(j.C.rpt))
        np.testing.assert_array_equal(t.C.col[:nz].numpy(),
                                      np.asarray(j.C.col)[:nz])
        np.testing.assert_allclose(t.C.val[:nz].numpy(),
                                   np.asarray(j.C.val)[:nz], **VAL_TOL)
    if name == "hash-trim":
        assert t_trail[-2][ARENA_FIELDS.index("pressure_events")] >= 1
        assert t_trail[-2][len(ARENA_FIELDS) + 1] == 1       # one trim
    if name == "hash-spill":
        assert t_trail[-2][len(ARENA_FIELDS) + 1] == 1       # one trim
        assert t_trail[-2][len(ARENA_FIELDS) + 2] == 2       # two spills


# ---------------------------------------------------------------------------
# On the card (skip without one).
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: leases of a CUDA engine live there")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.gpu
def test_engine_leases_live_on_the_card(cuda_device, heavy_pair):
    A, B = (convert.csr_from_reference(*convert.csr_to_numpy(M),
                                       device=cuda_device)
            for M in heavy_pair)
    ar = Arena()
    eng = SpgemmEngine(SpgemmConfig(**HASH_KW), arena=ar)
    eng.execute(A, B)
    rec = eng.dispatch(A, B)
    lease = rec.lease
    assert lease is not None and lease.device == cuda_device
    assert lease.i32.device == cuda_device and lease.val.device == cuda_device
    res = eng.finalize(rec)
    np.testing.assert_allclose(res.C.to_dense().cpu().numpy(),
                               spgemm_reference(*heavy_pair).numpy(),
                               **VAL_TOL)
    assert ar.bytes_in_use == 0 and ar.lease_misses == 2
    assert all(k[2] == cuda_device for k in lease.keys)
