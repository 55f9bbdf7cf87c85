"""Port parity for the engine's request path.

The same stream of requests goes through the reference's ``SpgemmEngine``
and the port's, via ``submit`` and ``drain``: both must return the same C
(rpt/col exactly, val within the reference's tolerance), count the same
engine statistics and learn the same hash schedules.  Also: prewarm, the
plan-cache dump/load (in both directions of format), the drain window and
the report.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import csr as jcsr
from repro.core.spgemm import SpgemmConfig as JConfig
from repro.engine import SpgemmEngine as JEngine
from repro.engine import executor as jexecutor
from repro_torch import convert
from repro_torch.core.spgemm import SpgemmConfig, spgemm_reference
from repro_torch.engine import (AdaptivePolicy, MatrixSig, SpgemmEngine,
                                Telemetry, plan_key)

VAL_TOL = dict(rtol=1e-5, atol=1e-5)   # tests/test_kernels_spgemm_hash.py:56

STATS = ("requests", "drains", "overlapped", "peak_inflight", "estimates",
         "estimate_hits", "estimate_misses", "capacity_grows",
         "bin_overflows")


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _port(A):
    return convert.csr_from_reference(np.asarray(A.rpt), np.asarray(A.col),
                                      np.asarray(A.val), A.shape,
                                      device="cpu")


def _pair(seed, m, da=5.0, dist="powerlaw"):
    A = jcsr.random_csr(seed, m, m, avg_nnz_per_row=da, distribution=dist)
    B = jcsr.random_csr(seed + 100, m, m, avg_nnz_per_row=4.0,
                        distribution=dist)
    return A, B


def _assert_same_result(t, j):
    assert t.total_nprod == j.total_nprod
    assert t.total_nnz == j.total_nnz
    nz = t.total_nnz
    np.testing.assert_array_equal(_np(t.C.rpt), np.asarray(j.C.rpt))
    np.testing.assert_array_equal(_np(t.C.col)[:nz], np.asarray(j.C.col)[:nz])
    np.testing.assert_allclose(_np(t.C.val)[:nz], np.asarray(j.C.val)[:nz],
                               **VAL_TOL)


@pytest.fixture
def in_order_reference(monkeypatch):
    """The reference's drain asks JAX whether a dispatch has finished,
    which on the CPU depends on thread timing; waiting for the result
    first pins its completion order to dispatch order, as the port's CPU
    records are (they are done when the dispatch returns)."""
    import jax

    def ready(rec):
        jax.block_until_ready(getattr(rec, "handles", None))
        return True

    monkeypatch.setattr(jexecutor, "_record_ready", ready)


def _stream():
    """3 hash + 2 ESC requests over two operand signatures."""
    P1, P2 = _pair(7, 64), _pair(9, 48)
    return [("hash", P1), ("esc", P2), ("hash", P1), ("hash", P2),
            ("esc", P1)]


@pytest.mark.parametrize("plan_mode", ["exact", "estimate"])
def test_stream_matches_reference(in_order_reference, plan_mode):
    jeng, teng = JEngine(), SpgemmEngine()
    uids = []
    for method, (A, B) in _stream():
        kw = dict(method=method, plan_mode=plan_mode)
        ju = jeng.submit(A, B, JConfig(**kw))
        tu = teng.submit(_port(A), _port(B), SpgemmConfig(**kw))
        assert ju == tu
        uids.append(tu)
    jres, tres = jeng.drain(window=2), teng.drain(window=2)
    assert sorted(tres) == sorted(jres) == sorted(uids)
    for uid in uids:
        _assert_same_result(tres[uid], jres[uid])
    for name in STATS:
        assert getattr(teng.stats, name) == getattr(jeng.stats, name), name
    assert teng.stats.requests == 5 and teng.stats.drains == 1
    assert teng.stats.peak_inflight == 2
    assert teng.stats.estimates == (4 if plan_mode == "estimate" else 0)
    assert (teng.cache.hits, teng.cache.misses) == \
        (jeng.cache.hits, jeng.cache.misses)
    jplans = {(k[0].nrows, k[2].method): e.plan
              for k, e in jeng.cache.items()}
    assert len(jplans) == len(teng.cache) == 4
    for key, entry in teng.cache.items():
        jplan = jplans[(key[0].nrows, key[2].method)]
        assert (entry.plan.prod_bucket, entry.plan.nnz_bucket) == \
            (jplan.prod_bucket, jplan.nnz_bucket)
        if jplan.hash_schedule is None:
            assert entry.plan.hash_schedule is None
        else:
            assert dataclasses.astuple(entry.plan.hash_schedule) == \
                dataclasses.astuple(jplan.hash_schedule)
        assert dataclasses.asdict(entry.plan.policy or _no_policy()) == \
            dataclasses.asdict(jplan.policy or _no_policy())


def _no_policy():
    from repro_torch.engine import PolicyState
    return PolicyState()


@pytest.mark.parametrize("drain_ordered", [False, True])
def test_drain_orders_agree_with_execute(drain_ordered):
    A, B = _pair(11, 64)
    TA, TB = _port(A), _port(B)
    cfg = SpgemmConfig(method="hash")
    want = SpgemmEngine().execute(TA, TB, cfg)
    eng = SpgemmEngine(cfg)
    uids = [eng.submit(TA, TB) for _ in range(3)]
    res = eng.drain(drain_ordered=drain_ordered, window=2)
    for uid in uids:
        assert torch.equal(res[uid].C.rpt, want.C.rpt)
        nz = want.total_nnz
        assert torch.equal(res[uid].C.col[:nz], want.C.col[:nz])
    assert eng.stats.overlapped >= 1     # hot k+1 planned while k ran


def test_drain_bounds_inflight_at_window():
    """Live records never exceed ``window`` (tests/test_engine.py:148)."""

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

    eng = Probe(SpgemmConfig(method="esc"))
    A, B = _pair(13, 32, da=3.0, dist="uniform")
    TA, TB = _port(A), _port(B)
    eng.execute(TA, TB)                   # specialize: dispatches go hot
    cap_a, cap_b = MatrixSig.of(TA).cap_bucket, MatrixSig.of(TB).cap_bucket
    reqs = []
    for s in range(7):
        A2, B2 = _pair(20 + s, 32, da=3.0, dist="uniform")
        TA2 = _port(A2).with_capacity(cap_a)
        TB2 = _port(B2).with_capacity(cap_b)
        reqs.append((eng.submit(TA2, TB2), TA2, TB2))
    eng.live = eng.peak = 0
    results = eng.drain(window=3)
    assert eng.peak <= 3 and eng.stats.peak_inflight <= 3
    assert len(results) == len(reqs)
    for uid, TA2, TB2 in reqs:
        np.testing.assert_allclose(_np(results[uid].C.to_dense()),
                                   _np(spgemm_reference(TA2, TB2)),
                                   **VAL_TOL)
    eng.submit(TA, TB)
    assert len(eng.drain(window=1)) == 1


def test_prewarm_estimate_specializes_without_executing():
    A, B = _pair(15, 64)
    TA, TB = _port(A), _port(B)
    cfg = SpgemmConfig(method="hash", plan_mode="estimate")
    eng = SpgemmEngine(cfg)
    p = eng.prewarm(TA, TB)
    assert p.is_specialized and p.hash_schedule is not None
    assert p.policy.estimated
    assert eng.stats.estimates == 1 and eng.stats.requests == 0
    entry = eng.cache.get(plan_key(TA, TB, cfg))
    assert entry.executable is None          # nothing ran
    r = eng.execute(TA, TB)
    np.testing.assert_allclose(_np(r.C.to_dense()),
                               _np(spgemm_reference(TA, TB)), **VAL_TOL)
    assert (entry.stats.steps_calls, entry.stats.hot_calls) == (0, 1)
    assert eng.stats.estimate_hits == 1
    assert not entry.plan.policy.estimated
    # The same plan through the reference: the same schedule.
    jeng = JEngine(JConfig(method="hash", plan_mode="estimate"))
    jp = jeng.prewarm(A, B)
    assert dataclasses.astuple(p.hash_schedule) == \
        dataclasses.astuple(jp.hash_schedule)


def test_prewarm_with_buckets_makes_first_call_hot():
    A, B = _pair(17, 32, da=3.0, dist="uniform")
    TA, TB = _port(A), _port(B)
    eng = SpgemmEngine()
    eng.prewarm(TA, TB, prod_bucket=4096, nnz_bucket=4096)
    r = eng.execute(TA, TB)
    np.testing.assert_allclose(_np(r.C.to_dense()),
                               _np(spgemm_reference(TA, TB)), **VAL_TOL)
    entry = next(iter(eng.cache.items()))[1]
    assert (entry.stats.hot_calls, entry.stats.steps_calls) == (1, 0)
    p = eng.prewarm(TA, TB, prod_bucket=16, nnz_bucket=16)
    assert (p.prod_bucket, p.nnz_bucket) == (4096, 4096)   # never shrinks
    with pytest.raises(ValueError):
        eng.prewarm(TA, TB, prod_bucket=256)


@pytest.mark.parametrize("method", ["hash", "esc"])
def test_dump_load_roundtrip(tmp_path, method):
    A, B = _pair(19, 64)
    TA, TB = _port(A), _port(B)
    cfg = SpgemmConfig(method=method)
    warm = SpgemmEngine(cfg)
    warm.execute(TA, TB)
    warm.execute(TA, TB)
    path = str(tmp_path / "plans.json")
    assert warm.cache.dump(path) == 1
    fresh = SpgemmEngine(cfg)
    assert fresh.cache.load(path) == 1
    key = plan_key(TA, TB, cfg)
    assert key in fresh.cache
    assert fresh.cache.peek(key).plan == warm.cache.peek(key).plan
    r = fresh.execute(TA, TB)
    entry = fresh.cache.get(key)
    assert (entry.stats.steps_calls, entry.stats.hot_calls) == (0, 1)
    want = warm.execute(TA, TB)
    assert torch.equal(r.C.rpt, want.C.rpt)
    # Loading the same dump again changes nothing and keeps the pipeline.
    fresh.cache.load(path)
    assert fresh.cache.peek(key).executable is not None


def test_reference_dump_loads_into_port(tmp_path):
    A, B = _pair(21, 64)
    jcfg = JConfig(method="hash", plan_mode="estimate")
    jeng = JEngine(jcfg)
    jeng.execute(A, B)
    jeng.execute(A, B)
    path = str(tmp_path / "plans.json")
    jeng.cache.dump(path)
    jplan = next(iter(jeng.cache.items()))[1].plan

    TA, TB = _port(A), _port(B)
    cfg = SpgemmConfig(method="hash", plan_mode="estimate")
    eng = SpgemmEngine(cfg)
    assert eng.cache.load(path) == 1
    entry = eng.cache.peek(plan_key(TA, TB, cfg))
    assert entry is not None
    assert dataclasses.astuple(entry.plan.hash_schedule) == \
        dataclasses.astuple(jplan.hash_schedule)
    assert dataclasses.asdict(entry.plan.policy) == \
        dataclasses.asdict(jplan.policy)
    r = eng.execute(TA, TB)                 # first call is hot
    assert (entry.stats.steps_calls, entry.stats.hot_calls) == (0, 1)
    assert eng.stats.estimates == 0
    _assert_same_result(r, jeng.execute(A, B))


def test_port_dump_loads_into_reference(tmp_path):
    A, B = _pair(23, 64)
    TA, TB = _port(A), _port(B)
    eng = SpgemmEngine(SpgemmConfig(method="hash"))
    eng.execute(TA, TB)
    path = str(tmp_path / "plans.json")
    eng.cache.dump(path)
    jeng = JEngine(JConfig(method="hash"))
    assert jeng.cache.load(path) == 1
    jeng.execute(A, B)
    entry = next(iter(jeng.cache.items()))[1]
    assert (entry.stats.steps_calls, entry.stats.hot_calls) == (0, 1)


def test_learned_headroom_trims_like_reference(in_order_reference):
    """After ``trim_streak`` admitted calls both engines re-derive the
    schedule from the observed bin maxima at the shrunken headroom, the
    same way (the port's fixed 2x headroom is gone)."""
    from repro.engine import AdaptivePolicy as JPolicy
    knobs = dict(headroom_init=4.0, headroom_shrink=0.25, trim_streak=2)
    A, B = _pair(25, 64)
    TA, TB = _port(A), _port(B)
    jeng = JEngine(JConfig(method="hash"), policy=JPolicy(**knobs))
    teng = SpgemmEngine(SpgemmConfig(method="hash"),
                        policy=AdaptivePolicy(**knobs))
    scheds = []
    for _ in range(5):
        _assert_same_result(teng.execute(TA, TB), jeng.execute(A, B))
        scheds.append(next(iter(teng.cache.items()))[1].plan.hash_schedule)
    tplan = next(iter(teng.cache.items()))[1].plan
    jplan = next(iter(jeng.cache.items()))[1].plan
    assert teng.stats.schedule_trims == jeng.stats.schedule_trims == 1
    assert scheds[-1] != scheds[0]          # the trim shrank the schedule
    assert all(a <= b for a, b in zip(scheds[-1].sym_row_buckets,
                                      scheds[0].sym_row_buckets))
    assert dataclasses.astuple(tplan.hash_schedule) == \
        dataclasses.astuple(jplan.hash_schedule)
    assert dataclasses.asdict(tplan.policy) == dataclasses.asdict(
        jplan.policy)


def test_report_and_trace_render():
    A, B = _pair(27, 48)
    TA, TB = _port(A), _port(B)
    eng = SpgemmEngine(SpgemmConfig(method="hash", plan_mode="estimate"),
                       telemetry=True)
    eng.submit(TA, TB)
    eng.submit(TA, TB)
    eng.drain(window=2)
    text = eng.report()
    assert "engine: 2 requests" in text
    assert "estimate: 1 estimated plans, 1 confirmed / 0 redone" in text
    assert "latency: 2 finalized requests" in text
    names = {e["name"] for e in eng.telemetry.finished_spans()}
    assert {"drain", "request", "estimate", "dispatch", "finalize",
            "verify_sync"} <= names
    trace = eng.telemetry.chrome_trace()
    assert all(ev["ph"] in ("X", "i") for ev in trace["traceEvents"])
    # An empty engine renders too.
    assert "engine: 0 requests" in SpgemmEngine().report()
    assert isinstance(eng.telemetry, Telemetry)
