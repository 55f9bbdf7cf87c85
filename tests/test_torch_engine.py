"""The reference's engine tests (tests/test_engine.py) on the port: plans,
cache, batched executor, retraces.

Each of the reference's sixteen test functions keeps its body, on the
port's CPU tensors (``device="cpu"`` where the port's constructors default
to the card); ``test_plan_signature_equality_and_hashing`` and
``test_plan_rejects_mismatched_shapes`` are the reference's word for word.
The operands come from the reference's key-derived seeds
(``int(jax.random.bits(jax.random.PRNGKey(s)))``, as ``repro.core.csr``
derives them), so both packages multiply the same matrices.  Added: the
engine against the reference package's engine on the same pairs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import SpgemmConfig as JConfig
from repro.core import csr as jcsr
from repro.engine import SpgemmEngine as JEngine
from repro_torch.core import CSR, SpgemmConfig, next_bucket, spgemm
from repro_torch.core import random_csr as _random_csr
from repro_torch.core.spgemm import spgemm_reference
from repro_torch.engine import (MatrixSig, PlanCache, SpgemmEngine, plan,
                                plan_key, total_traces)
from repro_torch.engine.executor import default_engine


def _seed(key):
    """The reference's int seed of a ``jax.random.PRNGKey``."""
    return int(jax.random.bits(key, dtype=jnp.uint32))


def random_csr(key, m, n, **kw):
    """The port's generator at the reference's seed for ``key``, on the
    CPU."""
    return _random_csr(_seed(key), m, n, device="cpu", **kw)


def _pair(seed, m=32, k=28, n=36, da=3.0, db=3.0, dist="uniform"):
    A = random_csr(jax.random.PRNGKey(seed), m, k, avg_nnz_per_row=da,
                   distribution=dist)
    B = random_csr(jax.random.PRNGKey(seed + 1), k, n, avg_nnz_per_row=db,
                   distribution=dist)
    return A, B


def _sigs(A, B):
    return MatrixSig.of(A), MatrixSig.of(B)


# ---------------------------------------------------------------------------
# Plan signatures.
# ---------------------------------------------------------------------------

def test_matrix_sig_bucketing():
    A, _ = _pair(1)
    sig = MatrixSig.of(A)
    assert sig.nrows == A.nrows and sig.ncols == A.ncols
    assert sig.cap_bucket == next_bucket(A.capacity)
    # Padding within the bucket does not change the signature.
    assert MatrixSig.of(A.with_capacity(sig.cap_bucket)) == sig
    # Crossing the bucket boundary does.
    assert MatrixSig.of(A.with_capacity(2 * sig.cap_bucket)) != sig


def test_plan_signature_equality_and_hashing():
    A, B = _pair(3)
    a_sig, b_sig = _sigs(A, B)
    cfg = SpgemmConfig()
    p1, p2 = plan(a_sig, b_sig, cfg), plan(a_sig, b_sig, cfg)
    assert p1 == p2
    assert hash(p1) == hash(p2)
    assert p1.signature == plan_key(A, B, cfg)
    # Config is part of the identity.
    p3 = plan(a_sig, b_sig, SpgemmConfig(method="hash"))
    assert p3 != p1 and p3.signature != p1.signature
    # Specialization learns buckets without changing the cache identity.
    sp = p1.with_capacities(1024, 512)
    assert sp.is_specialized and not p1.is_specialized
    assert sp.signature == p1.signature
    assert sp.admits(A, B)


def test_plan_rejects_mismatched_shapes():
    A, B = _pair(5)
    with pytest.raises(AssertionError):
        plan(MatrixSig.of(B), MatrixSig.of(A), SpgemmConfig())


# ---------------------------------------------------------------------------
# Plan cache.
# ---------------------------------------------------------------------------

def test_plan_cache_hit_miss_evict():
    cfg = SpgemmConfig()
    cache = PlanCache(capacity=2)
    plans = []
    for m in (8, 16, 24):
        A, B = _pair(m, m=m)
        plans.append(plan(*_sigs(A, B), cfg))

    assert cache.get(plans[0].signature) is None          # miss
    e0 = cache.insert(plans[0])
    assert cache.get(plans[0].signature) is e0            # hit
    cache.insert(plans[1])
    cache.insert(plans[2])                                # evicts plans[0] (LRU)
    assert len(cache) == 2
    assert cache.evictions == 1
    assert plans[0].signature not in cache
    assert plans[2].signature in cache
    assert cache.get(plans[0].signature) is None          # miss again
    assert cache.hits == 1 and cache.misses == 2

    # Re-specialization drops the stale executable.
    e2 = cache.get(plans[2].signature)
    e2.executable = lambda *a: None
    cache.specialize(e2, plans[2].with_capacities(64, 64))
    assert e2.executable is None and e2.plan.is_specialized


def test_plan_cache_lru_order_refresh():
    cfg = SpgemmConfig()
    cache = PlanCache(capacity=2)
    pa = plan(*_sigs(*_pair(8, m=8)), cfg)
    pb = plan(*_sigs(*_pair(16, m=16)), cfg)
    pc = plan(*_sigs(*_pair(24, m=24)), cfg)
    cache.insert(pa)
    cache.insert(pb)
    cache.get(pa.signature)       # refresh pa -> pb becomes LRU
    cache.insert(pc)
    assert pa.signature in cache
    assert pb.signature not in cache


# ---------------------------------------------------------------------------
# Executor vs dense oracle.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dist", ["uniform", "powerlaw", "banded"])
def test_engine_matches_oracle_cold_and_hot(dist):
    engine = SpgemmEngine()
    A, B = _pair(7, dist=dist)
    ref = np.asarray(spgemm_reference(A, B))
    r_cold = engine.execute(A, B)       # steps path (learns buckets)
    r_hot = engine.execute(A, B)        # steady-state pipeline
    np.testing.assert_allclose(np.asarray(r_cold.C.to_dense()), ref,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(r_hot.C.to_dense()), ref,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(r_cold.C.rpt),
                                  np.asarray(r_hot.C.rpt))
    assert r_cold.total_nnz == r_hot.total_nnz
    entry = next(iter(engine.cache.items()))[1]
    assert entry.stats.steps_calls == 1 and entry.stats.hot_calls == 1


def test_engine_batched_drain_matches_oracle():
    engine = SpgemmEngine()
    # Mixed stream: two shape buckets interleaved.
    reqs = []
    for s in range(6):
        A, B = _pair(40 + s, m=24 if s % 2 else 32)
        reqs.append((engine.submit(A, B), A, B))
    results = engine.drain()
    assert len(results) == len(reqs)
    for uid, A, B in reqs:
        ref = np.asarray(spgemm_reference(A, B))
        np.testing.assert_allclose(np.asarray(results[uid].C.to_dense()),
                                   ref, rtol=1e-5, atol=1e-5)
    assert engine.stats.requests == 6
    assert len(engine.cache) == 2          # one plan per shape bucket


def test_drain_bounds_inflight_at_window():
    """Regression for the drain() off-by-one: dispatching before reaping
    held ``window + 1`` records in flight.  The bound is a device-memory
    budget, so it must hold at the moment of dispatch — count live
    records across dispatch/finalize and pin the peak at ``window``."""

    class Probe(SpgemmEngine):
        live = 0
        peak = 0

        def _dispatch(self, *a, **k):
            rec = super()._dispatch(*a, **k)
            self.live += 1
            self.peak = max(self.peak, self.live)
            return rec

        def _finalize(self, rec):
            out = super()._finalize(rec)
            self.live -= 1
            return out

    engine = Probe()
    A, B = _pair(130)
    engine.execute(A, B)                  # specialize: dispatches go async
    cap_a, cap_b = MatrixSig.of(A).cap_bucket, MatrixSig.of(B).cap_bucket
    reqs = []
    for s in range(9):
        A2, B2 = _pair(140 + s)
        reqs.append((engine.submit(A2.with_capacity(cap_a),
                                   B2.with_capacity(cap_b)), A2, B2))
    engine.live = engine.peak = 0
    results = engine.drain(window=3)
    assert engine.peak <= 3               # was window + 1 = 4 before the fix
    assert engine.stats.peak_inflight <= 3
    assert len(results) == len(reqs)
    for uid, A2, B2 in reqs:
        np.testing.assert_allclose(np.asarray(results[uid].C.to_dense()),
                                   np.asarray(spgemm_reference(A2, B2)),
                                   rtol=1e-5, atol=1e-5)
    # Degenerate window values still drain everything.
    engine.submit(A, B)
    assert len(engine.drain(window=1)) == 1


def test_engine_drain_overlaps_requests():
    engine = SpgemmEngine()
    A, B = _pair(60)
    engine.execute(A, B)                   # specialize the plan
    cap_a, cap_b = MatrixSig.of(A).cap_bucket, MatrixSig.of(B).cap_bucket
    for s in range(4):
        A2, B2 = _pair(70 + s)
        engine.submit(A2.with_capacity(cap_a), B2.with_capacity(cap_b))
    engine.drain()
    # Hot-path requests k+1 were planned while k executed on device.
    assert engine.stats.overlapped >= 3


# ---------------------------------------------------------------------------
# Retrace / capacity-bucket behavior.
# ---------------------------------------------------------------------------

def test_repeated_shape_triggers_zero_retraces():
    engine = SpgemmEngine()
    A, B = _pair(80)
    cap_a, cap_b = MatrixSig.of(A).cap_bucket, MatrixSig.of(B).cap_bucket
    engine.execute(A, B)                   # cold: steps path, no build
    engine.execute(A, B)                   # first hot call: exactly 1 build
    baseline = total_traces()
    for s in range(3):                     # distinct same-bucket matrices
        A2, B2 = _pair(90 + s)
        r = engine.execute(A2.with_capacity(cap_a), B2.with_capacity(cap_b))
        ref = np.asarray(spgemm_reference(A2, B2))
        np.testing.assert_allclose(np.asarray(r.C.to_dense()), ref,
                                   rtol=1e-5, atol=1e-5)
    assert total_traces() == baseline      # zero rebuilds on repeats
    assert engine.stats.capacity_grows == 0
    assert engine.cache.hits >= 4


@pytest.mark.parametrize("dist", ["uniform", "powerlaw"])
def test_hash_engine_matches_oracle_cold_and_hot(dist):
    """The hash method has a steady-state pipeline, like ESC."""
    engine = SpgemmEngine(SpgemmConfig(method="hash"))
    A, B = _pair(7, dist=dist)
    ref = np.asarray(spgemm_reference(A, B))
    r_cold = engine.execute(A, B)       # steps path (learns the schedule)
    r_hot = engine.execute(A, B)        # steady-state pipeline
    np.testing.assert_allclose(np.asarray(r_cold.C.to_dense()), ref,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(r_hot.C.to_dense()), ref,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(r_cold.C.rpt),
                                  np.asarray(r_hot.C.rpt))
    assert r_cold.total_nnz == r_hot.total_nnz
    entry = next(iter(engine.cache.items()))[1]
    assert entry.stats.steps_calls == 1 and entry.stats.hot_calls == 1
    assert entry.plan.hash_schedule is not None


def test_hash_repeated_shape_triggers_zero_retraces():
    """Zero-rebuild regression for the hash steady state (mirrors the ESC
    one above): after warmup, same-bucket repeats reuse ONE pipeline.

    Warmup covers rung DISCOVERY: a rung the first matrix left empty is
    learned as statically absent, so the first stream member that
    populates it costs one schedule grow (+1 build) — the documented
    bin-count-bucketing trade-off.  The steady-state guarantee starts once
    the schedule has seen the stream's rungs.
    """
    engine = SpgemmEngine(SpgemmConfig(method="hash"))
    A, B = _pair(80)
    cap_a, cap_b = MatrixSig.of(A).cap_bucket, MatrixSig.of(B).cap_bucket

    def run(seed):
        A2, B2 = _pair(seed)
        r = engine.execute(A2.with_capacity(cap_a), B2.with_capacity(cap_b))
        ref = np.asarray(spgemm_reference(A2, B2))
        np.testing.assert_allclose(np.asarray(r.C.to_dense()), ref,
                                   rtol=1e-5, atol=1e-5)

    seeds = (90, 91, 92, 93)
    engine.execute(A, B)                   # cold: steps path, no build
    for s in seeds:                        # warmup pass: rung discovery may
        run(s)                             #   grow the schedule (builds ok)
    run(seeds[0])                          # rebuild after any final grow
    baseline = total_traces()
    grows = engine.stats.capacity_grows
    for s in seeds:                        # replay: monotone schedule growth
        run(s)                             #   admits everything seen before
    assert total_traces() == baseline      # zero rebuilds on the replay
    assert engine.stats.capacity_grows == grows   # and zero further grows
    entry = next(iter(engine.cache.items()))[1]
    assert entry.stats.hot_calls >= 5      # replay served from the hot path


def test_hash_bin_bucket_growth_on_overflow():
    """A same-signature request whose rows land in a rung the schedule
    learned as empty must be detected (truncated hot run), redone via the
    steps path, and must grow the schedule so the NEXT call is hot."""
    m = 64
    d_small = np.zeros((m, m), np.float32)
    d_small[np.arange(m), np.arange(m)] = 1.0      # 1 nnz/row -> tiny nprod
    d_big = np.zeros((m, m), np.float32)
    d_big[:, :32] = 1.0                            # 32 nnz/row -> bigger rung
    dB = np.eye(m, dtype=np.float32)               # 1 nnz/row keeps nprod=nnzA
    A_small = CSR.from_dense(d_small, device="cpu").with_capacity(2048)
    A_big = CSR.from_dense(d_big, device="cpu")    # capacity 2048 naturally
    Bc = CSR.from_dense(dB, device="cpu")
    assert MatrixSig.of(A_small) == MatrixSig.of(A_big)

    engine = SpgemmEngine(SpgemmConfig(method="hash"))
    engine.execute(A_small, Bc)
    engine.execute(A_small, Bc)            # hot path established
    sched0 = next(iter(engine.cache.items()))[1].plan.hash_schedule
    assert sched0.sym_row_buckets[1] == 0  # rung 1 statically absent

    r = engine.execute(A_big, Bc)          # same plan, rows overflow rung 0
    np.testing.assert_allclose(np.asarray(r.C.to_dense()), d_big @ dB,
                               rtol=1e-5)
    assert engine.stats.capacity_grows == 1
    assert engine.stats.bin_overflows == 1
    sched1 = next(iter(engine.cache.items()))[1].plan.hash_schedule
    assert sched1.sym_row_buckets[1] >= 64       # rung 1 now scheduled
    assert sched1.sym_row_buckets[0] >= sched0.sym_row_buckets[0]  # monotone

    r2 = engine.execute(A_big, Bc)         # grown schedule now holds (hot)
    np.testing.assert_allclose(np.asarray(r2.C.to_dense()), d_big @ dB,
                               rtol=1e-5)
    assert engine.stats.capacity_grows == 1
    # The small request still runs correctly under the grown plan.
    r3 = engine.execute(A_small, Bc)
    np.testing.assert_allclose(np.asarray(r3.C.to_dense()), d_small @ dB,
                               rtol=1e-5)


def test_prewarm_skips_cold_discovery():
    engine = SpgemmEngine()
    A, B = _pair(120)
    engine.prewarm(A, B, prod_bucket=4096, nnz_bucket=4096)
    r = engine.execute(A, B)               # first real call is already hot
    ref = np.asarray(spgemm_reference(A, B))
    np.testing.assert_allclose(np.asarray(r.C.to_dense()), ref,
                               rtol=1e-5, atol=1e-5)
    entry = next(iter(engine.cache.items()))[1]
    assert entry.stats.hot_calls == 1 and entry.stats.steps_calls == 0
    assert engine.stats.capacity_grows == 0
    # Prewarming never shrinks learned buckets.
    p = engine.prewarm(A, B, prod_bucket=16, nnz_bucket=16)
    assert p.prod_bucket == 4096 and p.nnz_bucket == 4096


def test_capacity_bucket_growth_under_pressure():
    engine = SpgemmEngine()
    d_small = np.zeros((8, 8), np.float32)
    d_small[0, :3] = 1.0                   # 3 nnz -> tiny learned buckets
    d_big = np.ones((8, 8), np.float32)    # 64 nnz -> overflows them
    dB = np.ones((8, 8), np.float32)
    A_small = CSR.from_dense(d_small, device="cpu").with_capacity(64)
    A_big = CSR.from_dense(d_big, device="cpu")   # capacity 64: same sig
    Bc = CSR.from_dense(dB, device="cpu")
    assert MatrixSig.of(A_small) == MatrixSig.of(A_big)

    engine.execute(A_small, Bc)
    engine.execute(A_small, Bc)            # hot path established
    r = engine.execute(A_big, Bc)          # same plan, bigger product
    np.testing.assert_allclose(np.asarray(r.C.to_dense()), d_big @ dB,
                               rtol=1e-5)
    assert engine.stats.capacity_grows == 1
    r2 = engine.execute(A_big, Bc)         # grown buckets now hold
    np.testing.assert_allclose(np.asarray(r2.C.to_dense()), d_big @ dB,
                               rtol=1e-5)
    assert engine.stats.capacity_grows == 1
    # The small request still runs correctly under the grown plan.
    r3 = engine.execute(A_small, Bc)
    np.testing.assert_allclose(np.asarray(r3.C.to_dense()), d_small @ dB,
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# The core API rides on the engine.
# ---------------------------------------------------------------------------

def test_spgemm_wrapper_routes_through_default_engine():
    A, B = _pair(99)
    before = default_engine().stats.requests
    res = spgemm(A, B)
    assert default_engine().stats.requests == before + 1
    # Public result surface is unchanged.
    for field in ("C", "total_nprod", "total_nnz", "sym_binning",
                  "num_binning", "timings"):
        assert hasattr(res, field)
    assert res.compression_ratio >= 1.0


# ---------------------------------------------------------------------------
# Against the reference package.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["esc", "hash"])
def test_engine_matches_reference_engine(method):
    """The same pair through both packages' engines, cold then steady: the
    same C (rpt and col exactly, values within the reference's
    tolerance) and the same learned buckets."""
    A, B = _pair(7, dist="powerlaw")
    jA = jcsr.random_csr(jax.random.PRNGKey(7), 32, 28, avg_nnz_per_row=3.0,
                         distribution="powerlaw")
    jB = jcsr.random_csr(jax.random.PRNGKey(8), 28, 36, avg_nnz_per_row=3.0,
                         distribution="powerlaw")
    engine = SpgemmEngine(SpgemmConfig(method=method))
    jengine = JEngine(JConfig(method=method))
    for _ in range(2):
        r, j = engine.execute(A, B), jengine.execute(jA, jB)
        nnz = j.total_nnz
        assert r.total_nnz == nnz and r.total_nprod == j.total_nprod
        np.testing.assert_array_equal(np.asarray(r.C.rpt),
                                      np.asarray(j.C.rpt))
        np.testing.assert_array_equal(np.asarray(r.C.col)[:nnz],
                                      np.asarray(j.C.col)[:nnz])
        np.testing.assert_allclose(np.asarray(r.C.val)[:nnz],
                                   np.asarray(j.C.val)[:nnz], rtol=1e-5,
                                   atol=1e-5)
    tp = next(iter(engine.cache.items()))[1].plan
    jp = next(iter(jengine.cache.items()))[1].plan
    assert (tp.prod_bucket, tp.nnz_bucket) == (jp.prod_bucket, jp.nnz_bucket)
    assert tp.hash_schedule == jp.hash_schedule or (
        tp.hash_schedule.__dict__ == jp.hash_schedule.__dict__)
