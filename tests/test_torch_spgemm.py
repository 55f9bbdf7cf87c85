"""Port parity end to end: ``spgemm()`` through the plan-caching engine.

Each case runs the same sequence of calls through the reference's default
engine and the port's: a cold call (the six-step path: symbolic and
numeric kernels) and steady calls (the fused hash pipeline for the hash
default).  C must match exactly in rpt/col and within the reference's
tolerance in val, call for call.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import csr as jcsr
from repro.core import spgemm as jspgemm
from repro.core.spgemm import SpgemmConfig as JConfig
from repro.engine import default_engine as jdefault
from repro.engine import reset_default_engine as jreset
from repro_torch import convert
from repro_torch.core.spgemm import (SpgemmConfig, spgemm,
                                     spgemm_reference)
from repro_torch.engine import (MatrixSig, SpgemmEngine, default_engine,
                                plan_key, reset_default_engine)

VAL_TOL = dict(rtol=1e-5, atol=1e-5)   # tests/test_kernels_spgemm_hash.py:56


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _port(A, device="cpu"):
    return convert.csr_from_reference(np.asarray(A.rpt), np.asarray(A.col),
                                      np.asarray(A.val), A.shape,
                                      device=device)


def _assert_same_result(t, j):
    assert t.total_nprod == j.total_nprod
    assert t.total_nnz == j.total_nnz
    assert t.C.capacity == j.C.capacity
    nz = t.total_nnz
    np.testing.assert_array_equal(_np(t.C.rpt), np.asarray(j.C.rpt))
    np.testing.assert_array_equal(_np(t.C.col)[:nz], np.asarray(j.C.col)[:nz])
    np.testing.assert_allclose(_np(t.C.val)[:nz], np.asarray(j.C.val)[:nz],
                               **VAL_TOL)
    for name in ("sym_binning", "num_binning"):
        tb, jb = getattr(t, name), getattr(j, name)
        np.testing.assert_array_equal(_np(tb.bin_size),
                                      np.asarray(jb.bin_size))


def _pair(seed=5, m=96, k=96, n=96, da=6.0, db=5.0, dist="powerlaw"):
    A = jcsr.random_csr(seed, m, k, avg_nnz_per_row=da, distribution=dist)
    B = jcsr.random_csr(seed + 100, k, n, avg_nnz_per_row=db,
                        distribution=dist)
    return A, B


@pytest.fixture
def fresh_engines():
    jreset()
    reset_default_engine()
    yield
    jreset()
    reset_default_engine()


CASES = {
    "hash-fused": dict(method="hash"),
    "hash-fused-cas": dict(method="hash", hash_single_access=False),
    "hash-fused-packed": dict(method="hash", row_packing=True),
    "hash-two-pass": dict(method="hash", fuse_numeric=False),
    "esc": dict(),
    "esc-fused": dict(fuse_esc=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_cold_then_steady_matches_reference(fresh_engines, case):
    kw = CASES[case]
    A, B = _pair()
    TA, TB = _port(A), _port(B)
    jcfg, tcfg = JConfig(**kw), SpgemmConfig(**kw)
    results = []
    for _ in range(3):                      # cold, then two steady calls
        j = jspgemm(A, B, jcfg)
        t = spgemm(TA, TB, tcfg)
        _assert_same_result(t, j)
        results.append(t)
    entry = default_engine().cache.get(plan_key(TA, TB, tcfg))
    assert (entry.stats.calls, entry.stats.steps_calls,
            entry.stats.hot_calls) == (3, 1, 2)
    if kw.get("method") == "hash":
        plan = entry.plan
        jplan = next(e.plan for _, e in jdefault().cache.items())
        assert dataclasses.astuple(plan.hash_schedule) == \
            dataclasses.astuple(jplan.hash_schedule)
        assert (plan.prod_bucket, plan.nnz_bucket) == \
            (jplan.prod_bucket, jplan.nnz_bucket)
    # The steady pipeline sums every product in the cold path's order.
    for r in results[1:]:
        assert torch.equal(r.C.val, results[0].C.val)
    want = _np(spgemm_reference(TA, TB))
    np.testing.assert_allclose(_np(results[-1].C.to_dense()), want,
                               **VAL_TOL)


def _overflow_pair():
    """A1, A2 with the same signature; A2 has a row in a rung that A1's
    learned schedule left empty, so its steady call overflows."""
    A1 = jcsr.random_csr(31, 96, 96, avg_nnz_per_row=2.0)
    B = jcsr.random_csr(131, 96, 96, avg_nnz_per_row=2.0)
    d = np.asarray(A1.to_dense()).copy()
    d[0, :40] = np.linspace(0.5, 2.0, 40, dtype=np.float32)
    A2 = jcsr.CSR.from_dense(d)
    return A1, A2, B


@pytest.mark.parametrize("fuse_numeric", [True, False])
def test_overflow_grows_and_redoes_like_reference(fresh_engines,
                                                  fuse_numeric):
    A1, A2, B = _overflow_pair()
    TA1, TA2, TB = _port(A1), _port(A2), _port(B)
    assert MatrixSig.of(TA1) == MatrixSig.of(TA2)
    kw = dict(method="hash", fuse_numeric=fuse_numeric)
    jcfg, tcfg = JConfig(**kw), SpgemmConfig(**kw)
    for JA, TA in ((A1, TA1), (A2, TA2), (A2, TA2), (A1, TA1)):
        _assert_same_result(spgemm(TA, TB, tcfg), jspgemm(JA, B, jcfg))
    entry = default_engine().cache.get(plan_key(TA1, TB, tcfg))
    # cold (steps), overflow (hot + steps redo), then hot twice
    assert entry.stats.bin_overflows == 1
    assert entry.stats.steps_calls == 2
    assert entry.stats.hot_calls == 3
    jplan = next(e.plan for _, e in jdefault().cache.items())
    assert dataclasses.astuple(entry.plan.hash_schedule) == \
        dataclasses.astuple(jplan.hash_schedule)


def test_nnz_bucket_overflow_redo():
    """A same-signature request whose C outgrows the learned nnz bucket
    (with an admitting schedule) grows the bucket and redoes the call."""
    eng = SpgemmEngine()
    A1 = jcsr.random_csr(41, 64, 64, avg_nnz_per_row=2.0)
    d = np.asarray(A1.to_dense()).copy()
    d[:, :8] = 1.0                          # denser C
    TA1 = _port(A1.with_capacity(1024))
    TA2 = _port(jcsr.CSR.from_dense(d).with_capacity(1024))
    TB = _port(jcsr.random_csr(141, 64, 64, avg_nnz_per_row=2.0))
    assert MatrixSig.of(TA1) == MatrixSig.of(TA2)
    cfg = SpgemmConfig(method="esc")
    first = eng.execute(TA1, TB, cfg)
    r = eng.execute(TA2, TB, cfg)
    assert r.total_nnz > first.C.capacity     # outgrew the learned bucket
    want = _np(TA2.to_dense()) @ _np(TB.to_dense())
    np.testing.assert_allclose(_np(r.C.to_dense()), want, **VAL_TOL)
    entry = eng.cache.get(plan_key(TA1, TB, cfg))
    assert entry.stats.steps_calls == 2 and entry.stats.hot_calls == 1
    assert entry.plan.nnz_bucket >= r.total_nnz


def test_dispatch_then_finalize():
    eng = SpgemmEngine(SpgemmConfig(method="hash"))
    A, B = _pair(seed=8)
    TA, TB = _port(A), _port(B)
    cold = eng.finalize(eng.dispatch(TA, TB))
    rec = eng.dispatch(TA, TB)
    assert hasattr(rec, "handles")          # steady: work queued, not read
    hot = eng.finalize(rec)
    assert torch.equal(hot.C.rpt, cold.C.rpt)
    assert torch.equal(hot.C.col, cold.C.col)


def test_timing_runs_the_steps_path():
    eng = SpgemmEngine()
    A, B = _pair(seed=9)
    TA, TB = _port(A), _port(B)
    cfg = SpgemmConfig(method="hash", timing=True)
    eng.execute(TA, TB, cfg)
    r = eng.execute(TA, TB, cfg)
    assert {"setup", "symbolic", "numeric"} <= set(r.timings)
    assert eng.cache.get(plan_key(TA, TB, cfg)).stats.steps_calls == 2


def test_config_matches_reference_fields_and_defaults():
    jf = {f.name: f.default for f in dataclasses.fields(JConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(SpgemmConfig)}
    assert tf == jf


@pytest.mark.parametrize("kw,exc", [(dict(shards=2), NotImplementedError),
                                    (dict(plan_mode="estimate"),
                                     NotImplementedError),
                                    (dict(method="dense"), ValueError)])
def test_unported_options_raise(kw, exc):
    A, B = _pair(seed=2, m=8, k=8, n=8)
    with pytest.raises(exc):
        SpgemmEngine().execute(_port(A), _port(B), SpgemmConfig(**kw))


def test_inner_dimension_mismatch_raises():
    A, _ = _pair(seed=2, m=8, k=8, n=8)
    B = jcsr.random_csr(3, 9, 8, avg_nnz_per_row=2.0)
    with pytest.raises(ValueError):
        spgemm(_port(A), _port(B))


def test_plan_cache_lru_eviction():
    eng = SpgemmEngine(cache_capacity=2)
    for m in (8, 16, 32):
        A, B = _pair(seed=m, m=m, k=8, n=8, da=2.0, db=2.0,
                     dist="uniform")
        eng.execute(_port(A), _port(B))
    assert len(eng.cache) == 2 and eng.cache.evictions == 1


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hash kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_hash_spgemm_on_card_matches_cpu(cuda_device):
    A, B = _pair()
    cfg = SpgemmConfig(method="hash")
    eng_gpu, eng_cpu = SpgemmEngine(), SpgemmEngine()
    GA, GB = _port(A, cuda_device), _port(B, cuda_device)
    CA, CB = _port(A), _port(B)
    for _ in range(3):
        g = eng_gpu.execute(GA, GB, cfg)
        c = eng_cpu.execute(CA, CB, cfg)
        nz = c.total_nnz
        assert g.total_nnz == nz
        assert torch.equal(g.C.rpt.cpu(), c.C.rpt)
        assert torch.equal(g.C.col[:nz].cpu(), c.C.col[:nz])
        torch.testing.assert_close(g.C.val[:nz].cpu(), c.C.val[:nz],
                                   **VAL_TOL)
