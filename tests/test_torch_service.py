"""The port's SpGEMM service (``repro_torch/serve/spgemm_service.py``).

The reference's service tests (``tests/test_service.py``) run on the port
on the CPU, with only the imports and the device changed (its fault-plan
and engine-level injection tests are in ``tests/test_torch_faults.py``).
Then the same seeded request sequence under the same ``FaultPlan`` goes
through both packages' services, and each request's status, retries,
degradation rung, faults survived and C must agree, as must every
tenant's service counters; tenant threads on one service must give the
single-thread results; and, on the card, the service must give the CPU's
results for ESC and hash.  Everything but the card test runs ESC, as the
reference's tests do.
"""
import re
import sys
import threading
import urllib.request

import numpy as np
import pytest
import torch

from repro.core import csr as jcsr
from repro.core import faults as jfaults
from repro.core.spgemm import SpgemmConfig as JConfig
from repro.core.workspace import Arena as JArena
from repro.serve import SpgemmService as JService
from repro_torch import convert
from repro_torch.core import SpgemmConfig, random_csr
from repro_torch.core import faults as tfaults
from repro_torch.core.faults import FaultPlan, FaultSpec
from repro_torch.core.workspace import Arena
from repro_torch.engine import MemoryGovernor
from repro_torch.serve import ServiceResult, SpgemmService

CFG = SpgemmConfig(method="esc")
VAL_TOL = dict(rtol=1e-5, atol=1e-5)   # tests/test_kernels_spgemm_hash.py:56


def _pair(seed, m=48, k=48, n=48, avg=4.0, device="cpu"):
    A = random_csr(seed, m, k, avg_nnz_per_row=avg, device=device)
    B = random_csr(seed + 1, k, n, avg_nnz_per_row=avg, device=device)
    return A, B


def _assert_bitwise(r, ref):
    """Both results carry identical CSR payloads, bit for bit."""
    assert torch.equal(r.C.rpt, ref.C.rpt)
    nnz = int(ref.C.rpt[-1])
    assert torch.equal(r.C.col[:nnz], ref.C.col[:nnz])
    assert torch.equal(r.C.val[:nnz], ref.C.val[:nnz])


def _assert_same_c(rpt, col, val, want_rpt, want_col, want_val):
    """rpt/col exactly, values within VAL_TOL (host arrays)."""
    np.testing.assert_array_equal(rpt, want_rpt)
    nz = int(want_rpt[-1])
    np.testing.assert_array_equal(col[:nz], want_col[:nz])
    np.testing.assert_allclose(val[:nz], want_val[:nz], **VAL_TOL)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the port's hand-written kernels)")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# The reference's service-level contract, on the port.
# ---------------------------------------------------------------------------

def test_service_retries_injected_pressure_bitwise():
    A, B = _pair(6)
    ref = SpgemmService(CFG, arena=Arena()).call(A, B).value

    fp = FaultPlan([FaultSpec(site="lease_denial", at=(1, 2))])
    svc = SpgemmService(CFG, arena=Arena(), faults=fp,
                        backoff_base_s=1e-4)
    svc.call(A, B)                 # cold
    svc.call(A, B)                 # hot: visit 0 (clean)
    r = svc.call(A, B)             # hot: both attempts denied -> retry
    assert r.ok and r.retries == 1 and r.degraded == "reclaim"
    assert r.faults_survived == 2
    _assert_bitwise(r.value, ref)
    text = svc.prometheus_text()
    assert re.search(
        r'opsparse_service_retries_total\{tenant="default"\} 1', text)
    assert re.search(
        r'opsparse_service_faults_survived_total\{tenant="default"\} 2',
        text)


def test_service_nontransient_fault_does_not_retry():
    A, B = _pair(8)
    fp = FaultPlan([FaultSpec(site="executor_raise", at=(0,),
                              message="poisoned request")])
    svc = SpgemmService(CFG, arena=Arena(), faults=fp)
    r = svc.call(A, B)
    assert r.status == "error" and not r.ok
    assert r.retries == 0          # fatal => exactly one attempt
    assert "poisoned request" in r.error
    assert fp.injected["executor_raise"] == 1
    # The tenant keeps serving after the poisoned request.
    assert svc.call(A, B).ok


def test_service_transient_fault_retries_and_succeeds():
    A, B = _pair(10)
    fp = FaultPlan([FaultSpec(site="executor_raise", at=(0,),
                              transient=True, message="blip")])
    svc = SpgemmService(CFG, arena=Arena(), faults=fp,
                        backoff_base_s=1e-4)
    r = svc.call(A, B)
    assert r.ok and r.retries == 1
    assert r.faults_survived == 1


def test_service_deadline_admission_and_expiry():
    A, B = _pair(12)
    svc = SpgemmService(CFG, arena=Arena())
    assert svc.call(A, B).ok       # calibrates cold_s_per_flop

    # Up-front rejection: predicted latency exceeds an absurd budget.
    r = svc.call(_pair(14)[0], _pair(14)[1], deadline_s=1e-9)
    assert r.status == "timeout" and r.value is None
    assert "predicted" in r.error

    # Expiry during the request: an injected stall on a known-hot plan
    # admits (steady-state quantile is tiny) but blows the budget.
    fp = FaultPlan([FaultSpec(site="slow_dispatch", at=(1,),
                              delay_s=0.3)])
    svc2 = SpgemmService(CFG, arena=Arena(), faults=fp)
    assert svc2.call(A, B).ok      # builds latency history
    r = svc2.call(A, B, deadline_s=0.05)
    assert r.status == "timeout"
    text = svc2.prometheus_text()
    assert re.search(
        r'opsparse_service_timeouts_total\{tenant="default"\} 1', text)


def test_service_never_raises():
    A, B = _pair(16)
    # Every site armed at once, repeatedly; no exception may escape.
    fp = FaultPlan([
        FaultSpec(site="lease_denial", probability=0.3),
        FaultSpec(site="verify_overflow", probability=0.3),
        FaultSpec(site="executor_raise", probability=0.2, transient=True),
        FaultSpec(site="slow_dispatch", probability=0.2, delay_s=0.001),
    ], seed=3)
    svc = SpgemmService(CFG, arena=Arena(), faults=fp,
                        backoff_base_s=1e-4)
    statuses = [svc.call(A, B, deadline_s=30.0).status for _ in range(8)]
    assert set(statuses) <= {"ok", "timeout", "rejected", "error"}


def test_service_per_tenant_cache_isolation():
    # Tenant "small" has one plan; tenant "churn" floods its OWN cache
    # past capacity.  Isolation: churn's evictions never touch small's
    # plan, and the shared arena stays bounded by one governor.
    A, B = _pair(18)
    svc = SpgemmService(CFG, arena=Arena(), cache_capacity=2,
                        governor=MemoryGovernor(cap_bytes=256 << 20))
    assert svc.call(A, B, tenant="small").ok
    for i, m in enumerate((16, 24, 40, 72, 136)):   # distinct pow-2 sigs
        assert svc.call(*_pair(20 + i, m=m), tenant="churn").ok
    churn_engine = svc.engine("churn")
    small_engine = svc.engine("small")
    assert churn_engine.cache.evictions > 0
    assert small_engine.cache.evictions == 0
    assert len(small_engine.cache) == 1
    # And the hot path still works for the quiet tenant.
    assert svc.call(A, B, tenant="small").ok


def test_service_tenant_roster_admission():
    A, B = _pair(30)
    svc = SpgemmService(CFG, arena=Arena(), max_tenants=2)
    assert svc.call(A, B, tenant="a").ok
    assert svc.call(A, B, tenant="b").ok
    r = svc.call(A, B, tenant="c")
    assert r.status == "rejected" and r.retry_after_s is not None
    with pytest.raises(RuntimeError):
        svc.engine("d")
    assert svc.tenants() == ["a", "b"]


def test_service_session_batches():
    A, B = _pair(32)
    svc = SpgemmService(CFG, arena=Arena())
    ref = svc.call(A, B).value
    with svc.session() as sess:
        uids = [sess.submit(A, B) for _ in range(3)]
        results = sess.drain()
    assert sorted(results) == sorted(uids)
    for r in results.values():
        _assert_bitwise(r, ref)


def test_service_http_metrics_endpoint():
    A, B = _pair(34)
    svc = SpgemmService(CFG, arena=Arena())
    svc.call(A, B, tenant="acme")
    svc.call(A, B, tenant="zeta")
    server = svc.serve_http()
    try:
        body = urllib.request.urlopen(server.url, timeout=10).read().decode()
        health = urllib.request.urlopen(
            server.url.replace("/metrics", "/healthz"), timeout=10).read()
    finally:
        svc.close()
    assert health == b"ok\n"
    assert 'opsparse_service_requests_total{tenant="acme"} 1' in body
    assert 'opsparse_service_requests_total{tenant="zeta"} 1' in body
    assert 'opsparse_engine_requests_total{tenant="acme"}' in body
    assert "opsparse_service_tenants 2" in body
    # Valid exposition shape: one TYPE header per metric name.
    for name in ("opsparse_service_requests_total",
                 "opsparse_engine_requests_total"):
        assert body.count(f"# TYPE {name} ") == 1


def test_service_result_ok_property():
    assert ServiceResult(status="ok", tenant="t").ok
    assert not ServiceResult(status="timeout", tenant="t").ok


# ---------------------------------------------------------------------------
# Request for request against the reference's service.
# ---------------------------------------------------------------------------

def _ref_matrix(seed, m=48, avg=4.0):
    return jcsr.random_csr(seed, m, m, avg_nnz_per_row=avg)


def _port(M, device="cpu"):
    return convert.csr_from_reference(np.asarray(M.rpt), np.asarray(M.col),
                                      np.asarray(M.val), M.shape,
                                      device=device)


# (tenant, matrix seed, shards of the request's config): three tenants,
# repeat signatures (hot plans), and a sharded tenant whose denied leases
# walk the service's shed_shards rung.
PARITY_REQUESTS = [("alpha", 0, 1), ("beta", 2, 1), ("alpha", 4, 1),
                   ("gamma", 6, 2), ("beta", 2, 1), ("alpha", 0, 1),
                   ("gamma", 6, 2), ("beta", 8, 1), ("gamma", 6, 2),
                   ("alpha", 4, 1), ("beta", 2, 1), ("gamma", 6, 2),
                   ("alpha", 0, 1), ("beta", 8, 1)]


def _parity_specs(mod):
    return [mod.FaultSpec(site="executor_raise", at=(2,), transient=True,
                          message="blip"),
            mod.FaultSpec(site="executor_raise", at=(9,),
                          message="poisoned"),
            mod.FaultSpec(site="lease_denial", at=(3, 4, 14, 15, 16, 17)),
            mod.FaultSpec(site="lease_denial", probability=0.2),
            mod.FaultSpec(site="verify_overflow", probability=0.3)]


def _service_counters(text):
    return sorted(line for line in text.splitlines()
                  if line.startswith(("opsparse_service_",
                                      "opsparse_engine_faults_injected")))


def test_service_matches_reference_request_for_request():
    mats = {s: _ref_matrix(s) for _, s, _ in PARITY_REQUESTS}
    jplan = jfaults.FaultPlan(_parity_specs(jfaults), seed=5)
    tplan = FaultPlan(_parity_specs(tfaults), seed=5)
    jsvc = JService(JConfig(method="esc"), arena=JArena(), faults=jplan,
                    backoff_base_s=1e-4)
    tsvc = SpgemmService(CFG, arena=Arena(), faults=tplan,
                         backoff_base_s=1e-4)
    statuses = set()
    for tenant, seed, shards in PARITY_REQUESTS:
        jA = mats[seed]
        A = _port(jA)
        j = jsvc.call(jA, jA, tenant=tenant,
                      config=JConfig(method="esc", shards=shards))
        t = tsvc.call(A, A, tenant=tenant,
                      config=SpgemmConfig(method="esc", shards=shards))
        got = (t.status, t.retries, t.degraded, t.faults_survived)
        want = (j.status, j.retries, j.degraded, j.faults_survived)
        assert got == want, (tenant, seed, shards)
        statuses.add((t.status, t.degraded))
        if t.ok:
            _assert_same_c(*(x.cpu().numpy() for x in (
                t.value.C.rpt, t.value.C.col, t.value.C.val)),
                *(np.asarray(x) for x in (j.value.C.rpt, j.value.C.col,
                                          j.value.C.val)))
    # The sequence reaches every outcome it is meant to.
    assert {("ok", None), ("ok", "reclaim"), ("ok", "shed_shards"),
            ("error", None)} <= statuses, statuses
    assert tplan.snapshot() == jplan.snapshot()
    assert _service_counters(tsvc.prometheus_text()) == _service_counters(
        jsvc.prometheus_text())


# ---------------------------------------------------------------------------
# Tenant threads.
# ---------------------------------------------------------------------------

def test_service_tenant_threads_match_single_thread():
    """More tenant threads than cores on one service, with a short switch
    interval: each thread's results equal the single-thread ones bit for
    bit (ESC on the CPU), each tenant counts its own requests, and the
    shared arena ends with no lease out."""
    n_threads, per_thread = 12, 6
    pairs = [_pair(40 + 2 * i) for i in range(3)]
    single = SpgemmService(CFG, arena=Arena())
    refs = [single.call(A, B).value for A, B in pairs]
    svc = SpgemmService(CFG, arena=Arena(), max_tenants=n_threads)
    got = {i: [] for i in range(n_threads)}
    errors = []

    def loop(i):
        try:
            for k in range(per_thread):
                A, B = pairs[k % len(pairs)]
                got[i].append(svc.call(A, B, tenant=f"t{i}"))
        except Exception as exc:  # noqa: BLE001 — asserted below
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=loop, args=(i,))
                   for i in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert not errors, errors
    for i in range(n_threads):
        assert len(got[i]) == per_thread
        for k, r in enumerate(got[i]):
            assert r.ok
            _assert_bitwise(r.value, refs[k % len(pairs)])
    assert svc.arena.bytes_in_use == 0
    text = svc.prometheus_text()
    for i in range(n_threads):
        assert (f'opsparse_service_requests_total{{tenant="t{i}"}} '
                f'{per_thread}') in text
    assert f"opsparse_service_tenants {n_threads}" in text


# ---------------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("method", ["esc", "hash"])
def test_service_on_card_matches_cpu(card, method):
    cfg = SpgemmConfig(method=method)
    pairs = [_pair(50 + 2 * i, m=64) for i in range(2)]
    host = SpgemmService(cfg, arena=Arena())
    dev = SpgemmService(cfg, arena=Arena())
    for k in range(6):                 # cold, then steady, two tenants
        A, B = pairs[k % 2]
        tenant = ("alpha", "beta")[k % 2]
        want = host.call(A, B, tenant=tenant)
        got = dev.call(A.to(card), B.to(card), tenant=tenant)
        assert got.ok and want.ok
        assert got.value.C.rpt.device.type == "cuda"
        _assert_same_c(*(x.cpu().numpy() for x in (
            got.value.C.rpt, got.value.C.col, got.value.C.val)),
            *(x.numpy() for x in (want.value.C.rpt, want.value.C.col,
                                  want.value.C.val)))
    assert dev.arena.bytes_in_use == 0
