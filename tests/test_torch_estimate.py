"""Port parity for the sampling estimator and ``plan_mode="estimate"``.

The port's copy of the reference's host estimator must give the same
``ResultEstimate`` on the same operands, field by field; an estimated
cold call must skip the sizing pass in both packages and return the same
C; and a deliberate under-estimate must be caught and redone to the same
C as an exact-mode call.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import csr as jcsr
from repro.core import analysis as janalysis
from repro.core.spgemm import SpgemmConfig as JConfig
from repro.engine import SpgemmEngine as JEngine
from repro.engine import executor as jexecutor
from repro_torch import convert
from repro_torch.core import analysis
from repro_torch.core.spgemm import SpgemmConfig, spgemm_reference
from repro_torch.engine import SpgemmEngine, plan_key
from repro_torch.engine import executor as texecutor

VAL_TOL = dict(rtol=1e-5, atol=1e-5)   # tests/test_kernels_spgemm_hash.py:56


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _port(A):
    return convert.csr_from_reference(np.asarray(A.rpt), np.asarray(A.col),
                                      np.asarray(A.val), A.shape,
                                      device="cpu")


def _pair(seed, m=96, k=80, n=72, da=4.0, db=4.0, dist="uniform"):
    A = jcsr.random_csr(seed, m, k, avg_nnz_per_row=da, distribution=dist)
    B = jcsr.random_csr(seed + 1, k, n, avg_nnz_per_row=db,
                        distribution=dist)
    return A, B


@pytest.mark.parametrize("dist", ["uniform", "powerlaw", "banded"])
@pytest.mark.parametrize("n_sample,quantile,headroom",
                         [(64, 0.9, 1.5), (8, 0.5, 1.1)])
def test_estimate_result_matches_reference(dist, n_sample, quantile,
                                           headroom):
    A, B = _pair(17, dist=dist)
    sym, num = SpgemmConfig().ladders()
    kw = dict(sym_upper=sym.upper, num_upper=num.upper, n_sample=n_sample,
              quantile=quantile, headroom=headroom)
    got = analysis.estimate_result(_port(A), _port(B), **kw)
    want = janalysis.estimate_result(A, B, **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_host_primitives_match_reference():
    A, B = _pair(13, dist="powerlaw")
    a_rpt, a_col = analysis.host_index(_port(A))
    b_rpt, b_col = analysis.host_index(_port(B))
    ja_rpt, ja_col = janalysis.host_index(A)
    np.testing.assert_array_equal(a_rpt, ja_rpt)
    np.testing.assert_array_equal(a_col, ja_col)
    nprod = analysis.host_nprod(a_rpt, a_col, b_rpt)
    np.testing.assert_array_equal(
        nprod, _np(analysis.nprod_into_rpt(_port(A), _port(B))[:A.nrows]))
    rows = analysis.sample_rows_for_estimate(nprod, 16)
    np.testing.assert_array_equal(
        rows, janalysis.sample_rows_for_estimate(nprod, 16))
    np.testing.assert_array_equal(
        analysis.measure_sample_nnz(rows, a_rpt, a_col, b_rpt, b_col),
        janalysis.measure_sample_nnz(rows, a_rpt, a_col, b_rpt, b_col))


def test_derive_estimate_near_2p31_is_int64_safe():
    big = np.int64(2 ** 30)
    nprod = np.full(4, big, dtype=np.int64)
    kw = dict(sym_upper=(16, 512), num_upper=(16, 512), ncols=2 ** 31 - 1)
    got = analysis.derive_estimate(nprod, np.array([0]), np.array([big]),
                                   **kw)
    want = janalysis.derive_estimate(nprod, np.array([0]), np.array([big]),
                                     **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.total_nprod == 4 * int(big) > 2 ** 31
    assert got.total_nnz_high == got.sym_fall_prod == 4 * int(big)


@pytest.mark.parametrize("method,fused,packed", [
    ("esc", False, False),
    ("hash", False, False),
    ("hash", True, True),
])
def test_estimated_cold_call_matches_reference(method, fused, packed):
    A, B = _pair(23, m=48, k=40, n=44, da=3.0, db=3.0)
    TA, TB = _port(A), _port(B)
    kw = dict(method=method, fuse_numeric=fused, row_packing=packed,
              plan_mode="estimate")
    eng, jeng = SpgemmEngine(SpgemmConfig(**kw)), JEngine(JConfig(**kw))
    r, jr = eng.execute(TA, TB), jeng.execute(A, B)
    nz = r.total_nnz
    assert nz == jr.total_nnz
    np.testing.assert_array_equal(_np(r.C.rpt), np.asarray(jr.C.rpt))
    np.testing.assert_array_equal(_np(r.C.col)[:nz],
                                  np.asarray(jr.C.col)[:nz])
    np.testing.assert_allclose(_np(r.C.val)[:nz], np.asarray(jr.C.val)[:nz],
                               **VAL_TOL)
    # The sizing pass never ran: no steps call, one estimated plan,
    # confirmed by the admitted finalize.
    entry = eng.cache.get(plan_key(TA, TB, SpgemmConfig(**kw)))
    assert (entry.stats.steps_calls, entry.stats.hot_calls) == (0, 1)
    assert (eng.stats.estimates, eng.stats.estimate_hits,
            eng.stats.estimate_misses) == (1, 1, 0)
    assert not entry.plan.policy.estimated
    assert {"estimate", "build", "compile_dispatch"} <= set(r.timings)
    jplan = next(iter(jeng.cache.items()))[1].plan
    assert (entry.plan.prod_bucket, entry.plan.nnz_bucket) == \
        (jplan.prod_bucket, jplan.nnz_bucket)
    if method == "hash":
        assert dataclasses.astuple(entry.plan.hash_schedule) == \
            dataclasses.astuple(jplan.hash_schedule)


def _lowball(real):
    def estimate(A, B, **kw):
        est = real(A, B, **kw)
        return dataclasses.replace(est, total_nnz_high=1, num_fall_prod=0,
                                   num_counts=(0,) * len(est.num_counts))
    return estimate


@pytest.mark.parametrize("method", ["esc", "hash"])
def test_under_estimate_recovers_like_reference(method, monkeypatch):
    """A lowballed estimate is caught by finalize's verify and redone on
    the steps path: the same C as an exact-mode call, in both packages
    (tests/test_estimate.py:182)."""
    A, B = _pair(29, m=48, k=40, n=44)
    TA, TB = _port(A), _port(B)
    exact = SpgemmEngine(SpgemmConfig(method=method)).execute(TA, TB)
    monkeypatch.setattr(texecutor, "estimate_result",
                        _lowball(analysis.estimate_result))
    monkeypatch.setattr(jexecutor, "estimate_result",
                        _lowball(janalysis.estimate_result))
    cfg = dict(method=method, plan_mode="estimate")
    eng, jeng = SpgemmEngine(SpgemmConfig(**cfg)), JEngine(JConfig(**cfg))
    headroom0 = eng.est_state.headroom
    r, jr = eng.execute(TA, TB), jeng.execute(A, B)
    assert (eng.stats.estimates, eng.stats.estimate_misses) == (1, 1)
    assert eng.est_state.headroom == jeng.est_state.headroom > headroom0
    nz = exact.total_nnz
    assert r.total_nnz == jr.total_nnz == nz
    assert torch.equal(r.C.rpt, exact.C.rpt)
    assert torch.equal(r.C.col[:nz], exact.C.col[:nz])
    np.testing.assert_array_equal(_np(r.C.col)[:nz],
                                  np.asarray(jr.C.col)[:nz])
    np.testing.assert_allclose(_np(r.C.val)[:nz], _np(exact.C.val)[:nz],
                               **VAL_TOL)
    # The corrected plan serves the next request without another miss.
    r2 = eng.execute(TA, TB)
    assert eng.stats.estimate_misses == 1
    assert torch.equal(r2.C.rpt, exact.C.rpt)


def test_exact_mode_never_estimates():
    A, B = _pair(41, m=32, k=32, n=32)
    eng = SpgemmEngine(SpgemmConfig(method="esc"))
    eng.execute(_port(A), _port(B))
    eng.execute(_port(A), _port(B))
    assert eng.stats.estimates == 0


def test_estimate_all_empty_rows():
    z = np.zeros((16, 12), np.float32)
    TA = convert.csr_from_reference(*_dense_csr(z), device="cpu")
    TB = convert.csr_from_reference(*_dense_csr(np.zeros((12, 10),
                                                         np.float32)),
                                    device="cpu")
    sym, num = SpgemmConfig().ladders()
    est = analysis.estimate_result(TA, TB, sym_upper=sym.upper,
                                   num_upper=num.upper)
    assert est.sampled_rows == 0 and est.total_nnz_high == 0
    assert est.sym_counts[0] == 16 and est.num_counts[0] == 16
    eng = SpgemmEngine(SpgemmConfig(method="hash", plan_mode="estimate"))
    r = eng.execute(TA, TB)
    assert r.total_nnz == 0
    np.testing.assert_array_equal(_np(r.C.to_dense()),
                                  _np(spgemm_reference(TA, TB)))


def _dense_csr(d):
    C = jcsr.CSR.from_dense(d)
    return np.asarray(C.rpt), np.asarray(C.col), np.asarray(C.val), C.shape


# ---------------------------------------------------------------------------
# The rest of tests/test_estimate.py on the port, on the reference's own
# matrices: its _pair draws from PRNGKey(seed) and PRNGKey(seed + 1), which
# the port draws through prng_key_seed.
# ---------------------------------------------------------------------------

def _key_pair(seed, m=48, k=40, n=44, da=3.0, db=3.0, dist="uniform"):
    """tests/test_estimate.py's ``_pair`` in the port (on the CPU)."""
    from repro_torch.core.csr import prng_key_seed, random_csr
    A = random_csr(prng_key_seed(seed), m, k, avg_nnz_per_row=da,
                   distribution=dist, device="cpu")
    B = random_csr(prng_key_seed(seed + 1), k, n, avg_nnz_per_row=db,
                   distribution=dist, device="cpu")
    return A, B


def _true_nnz_per_row(A, B):
    """Oracle: exact structural nnz per C row (the ESC symbolic pass)."""
    from repro_torch.core import esc, next_bucket
    nprod = _np(analysis.nprod_into_rpt(A, B)[:A.nrows])
    buf = esc.symbolic(A, B,
                       prod_capacity=next_bucket(max(int(nprod.sum()), 1)))
    return _np(buf[:A.nrows]).astype(np.int64)


def test_measure_sample_nnz_is_exact():
    """:54: sampling every row measures every row's nnz exactly."""
    A, B = _key_pair(13, dist="powerlaw", da=4.0)
    a_rpt, a_col = analysis.host_index(A)
    b_rpt, b_col = analysis.host_index(B)
    rows = np.arange(A.nrows, dtype=np.int64)      # "sample" = every row
    measured = analysis.measure_sample_nnz(rows, a_rpt, a_col, b_rpt, b_col)
    np.testing.assert_array_equal(measured, _true_nnz_per_row(A, B))


def test_sample_rows_deterministic_and_stratified():
    """:64."""
    nprod = np.array([0, 9, 1, 7, 0, 3, 100, 2, 5, 4], dtype=np.int64)
    rows = analysis.sample_rows_for_estimate(nprod, n_sample=4)
    assert rows.size == 4
    assert 6 in rows                     # the heaviest row is always taken
    assert np.all(nprod[rows] > 0)       # empty rows carry no ratio signal
    np.testing.assert_array_equal(
        rows, analysis.sample_rows_for_estimate(nprod, n_sample=4))
    # Small populations come back whole.
    np.testing.assert_array_equal(
        analysis.sample_rows_for_estimate(nprod, n_sample=64),
        np.flatnonzero(nprod))


def test_estimator_prewarm_specializes_without_execution():
    """:218."""
    A, B = _key_pair(31)
    cfg = SpgemmConfig(method="hash", plan_mode="estimate")
    engine = SpgemmEngine(cfg)
    p = engine.prewarm(A, B)
    assert p.is_specialized
    assert p.hash_schedule is not None       # buckets alone can't do this
    assert p.policy.estimated                # unverified until a finalize
    assert engine.stats.estimates == 1
    res = engine.execute(A, B)
    torch.testing.assert_close(res.C.to_dense(), spgemm_reference(A, B),
                               rtol=1e-4, atol=1e-4)
    assert sum(e.stats.steps_calls for _, e in engine.cache.items()) == 0
    assert engine.stats.estimate_hits == 1


def test_prewarm_rejects_half_specified_buckets():
    """:235."""
    A, B = _key_pair(37)
    engine = SpgemmEngine()
    with pytest.raises(ValueError):
        engine.prewarm(A, B, prod_bucket=256)


def test_invalid_plan_mode_rejected():
    """:250."""
    A, B = _key_pair(43)
    engine = SpgemmEngine()
    with pytest.raises(ValueError):
        engine.execute(A, B, SpgemmConfig(plan_mode="guess"))


def test_dump_v4_roundtrips_plan_mode_and_estimated(tmp_path):
    """:261."""
    import json
    from repro_torch.engine import MatrixSig
    A, B = _key_pair(47)
    cfg = SpgemmConfig(method="hash", plan_mode="estimate")
    engine = SpgemmEngine(cfg)
    engine.prewarm(A, B)            # estimated=True persists (no finalize)
    path = str(tmp_path / "plans.json")
    engine.cache.dump(path)

    blob = json.load(open(path))
    assert blob["version"] == 4
    assert blob["plans"][0]["config"]["plan_mode"] == "estimate"
    assert blob["plans"][0]["policy"]["estimated"] is True

    fresh = SpgemmEngine(cfg)
    fresh.cache.load(path)
    entry = fresh.cache.get((MatrixSig.of(A), MatrixSig.of(B), cfg))
    assert entry.plan.config.plan_mode == "estimate"
    assert entry.plan.policy.estimated
    res = fresh.execute(A, B)       # straight to hot; finalize verifies
    torch.testing.assert_close(res.C.to_dense(), spgemm_reference(A, B),
                               rtol=1e-4, atol=1e-4)
    assert sum(e.stats.steps_calls for _, e in fresh.cache.items()) == 0


def test_v3_dump_loads_with_default_plan_fields(tmp_path):
    """:286."""
    import json
    from repro_torch.engine import MatrixSig
    A, B = _key_pair(53)
    cfg = SpgemmConfig(method="hash")
    warm = SpgemmEngine(cfg)
    warm.execute(A, B)
    warm.execute(A, B)
    path = str(tmp_path / "plans.json")
    warm.cache.dump(path)

    blob = json.load(open(path))
    blob["version"] = 3             # pre-estimate payload: no new fields
    for p in blob["plans"]:
        p["config"].pop("plan_mode")
        if p.get("policy"):
            p["policy"].pop("estimated")
    json.dump(blob, open(path, "w"))

    fresh = SpgemmEngine(cfg)
    assert fresh.cache.load(path) >= 1
    entry = fresh.cache.get((MatrixSig.of(A), MatrixSig.of(B), cfg))
    assert entry.plan.config.plan_mode == "exact"    # dataclass default
    assert entry.plan.policy.estimated is False
