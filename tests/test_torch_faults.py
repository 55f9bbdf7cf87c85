"""Port parity for fault injection (``repro_torch/core/faults.py``).

The port keeps its own copy of the reference's ``FaultPlan``: the same
specs, seed and visit sequence must give the same injections in both
packages.  The reference's engine-level injection tests
(``tests/test_service.py``) run on the port's engine on the CPU, where
recovery is bitwise; the same fault plan on both packages' engines must
consume the same injections, and the recovered C must agree (rpt/col
exactly, val within the reference's tolerance).  Everything runs the ESC
method, as the reference's tests do.
"""
import numpy as np
import pytest
import torch

from repro.core import csr as jcsr
from repro.core import faults as jfaults
from repro.core.spgemm import SpgemmConfig as JConfig
from repro.core.workspace import Arena as JArena
from repro.engine import SpgemmEngine as JEngine
from repro_torch import convert
from repro_torch.core import faults as tfaults
from repro_torch.core.faults import (NULL_FAULTS, SITES, FaultPlan,
                                     FaultSpec, InjectedFault,
                                     resolve_faults)
from repro_torch.core.spgemm import SpgemmConfig
from repro_torch.engine import Arena, SpgemmEngine

VAL_TOL = dict(rtol=1e-5, atol=1e-5)   # tests/test_kernels_spgemm_hash.py:56
CFG = SpgemmConfig(method="esc")


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _port(A):
    return convert.csr_from_reference(np.asarray(A.rpt), np.asarray(A.col),
                                      np.asarray(A.val), A.shape,
                                      device="cpu")


def _ref_pair(seed, m=48, k=48, n=48, avg=4.0):
    A = jcsr.random_csr(seed, m, k, avg_nnz_per_row=avg)
    B = jcsr.random_csr(seed + 1, k, n, avg_nnz_per_row=avg)
    return A, B


def _pair(seed, **kw):
    return tuple(_port(M) for M in _ref_pair(seed, **kw))


def _assert_bitwise(r, ref):
    """Both results carry identical CSR payloads, bit for bit."""
    assert torch.equal(r.C.rpt, ref.C.rpt)
    nnz = int(ref.C.rpt[-1])
    assert torch.equal(r.C.col[:nnz], ref.C.col[:nnz])
    assert torch.equal(r.C.val[:nnz], ref.C.val[:nnz])


def _assert_same_c(t, j):
    nz = t.total_nnz
    assert nz == j.total_nnz
    np.testing.assert_array_equal(_np(t.C.rpt), np.asarray(j.C.rpt))
    np.testing.assert_array_equal(_np(t.C.col)[:nz], np.asarray(j.C.col)[:nz])
    np.testing.assert_allclose(_np(t.C.val)[:nz], np.asarray(j.C.val)[:nz],
                               **VAL_TOL)


# ---------------------------------------------------------------------------
# FaultPlan scheduling semantics.
# ---------------------------------------------------------------------------

def test_fault_plan_at_indices_fire_deterministically():
    fp = FaultPlan([FaultSpec(site="lease_denial", at=(1, 3))])
    hits = [fp.fire("lease_denial") is not None for _ in range(5)]
    assert hits == [False, True, False, True, False]
    snap = fp.snapshot()
    assert snap["visits"]["lease_denial"] == 5
    assert snap["injected"]["lease_denial"] == 2


def test_fault_plan_probability_is_seed_deterministic():
    def run(seed):
        fp = FaultPlan([FaultSpec(site="executor_raise", probability=0.5)],
                       seed=seed)
        return [fp.fire("executor_raise") is not None for _ in range(32)]

    assert run(7) == run(7)
    assert run(7) != run(8)        # astronomically unlikely to collide


def test_fault_plan_count_bounds_injections():
    fp = FaultPlan([FaultSpec(site="verify_overflow", at=(0, 1, 2),
                              count=2)])
    hits = [fp.fire("verify_overflow") is not None for _ in range(4)]
    assert hits == [True, True, False, False]


def test_fault_plan_validation_and_resolve():
    with pytest.raises(ValueError):
        FaultSpec(site="nope")
    with pytest.raises(TypeError):
        resolve_faults("not a plan")
    assert resolve_faults(None) is NULL_FAULTS
    assert not NULL_FAULTS.enabled
    assert NULL_FAULTS.fire("lease_denial") is None


def _specs(mod):
    """One spec list covering every rule kind, in either package."""
    return [mod.FaultSpec(site="lease_denial", at=(0, 2, 5)),
            mod.FaultSpec(site="executor_raise", probability=0.3, count=4),
            mod.FaultSpec(site="slow_dispatch", probability=0.6),
            mod.FaultSpec(site="verify_overflow", at=(1,), count=1),
            mod.FaultSpec(site="verify_overflow", probability=0.5)]


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_fault_plan_matches_reference_visit_for_visit(seed):
    """Same specs + seed + visit sequence: the same spec fires at the same
    visit in both packages (the probability coin is one shared stream)."""
    assert SITES == jfaults.SITES
    ours = FaultPlan(_specs(tfaults), seed=seed)
    theirs = jfaults.FaultPlan(_specs(jfaults), seed=seed)
    order = np.random.default_rng(seed).integers(0, len(SITES), 200)
    for i in order:
        site = SITES[i]
        a, b = ours.fire(site), theirs.fire(site)
        assert (a is None) == (b is None), site
        if a is not None:
            assert (a.site, a.at, a.probability, a.count) == (
                b.site, b.at, b.probability, b.count)
    assert ours.snapshot() == theirs.snapshot()
    assert ours.total_injected == theirs.total_injected > 0


def test_maybe_raise_and_maybe_sleep():
    fp = FaultPlan([FaultSpec(site="executor_raise", at=(1,),
                              transient=True, message="blip"),
                    FaultSpec(site="slow_dispatch", at=(0,), delay_s=0.01)])
    fp.maybe_raise()
    with pytest.raises(InjectedFault, match="blip") as exc_info:
        fp.maybe_raise()
    assert exc_info.value.transient and exc_info.value.site == \
        "executor_raise"
    assert fp.maybe_sleep() == 0.01
    assert fp.maybe_sleep() == 0.0
    assert fp.total_injected == 2


# ---------------------------------------------------------------------------
# Engine-level injection: denial walks the real ladder, overflow redoes.
# ---------------------------------------------------------------------------

def test_injected_lease_denial_drains_and_retries_bitwise():
    A, B = _pair(0)
    ref = SpgemmEngine(CFG, arena=Arena()).execute(A, B)

    # Visits advance once per successful acquisition, once per ladder
    # attempt when denied.  Deny BOTH attempts of the drain's second
    # request (visits: cold call none, hot#1 0, drain 1, then 2 and the
    # post-reclaim 3) while the first is in flight: drain finalizes it to
    # free its lease and retries, so the batch still completes, bitwise.
    fp = FaultPlan([FaultSpec(site="lease_denial", at=(2, 3))])
    eng = SpgemmEngine(CFG, arena=Arena(), faults=fp)
    eng.execute(A, B)              # cold: specializes the plan
    eng.execute(A, B)              # hot #1: visit 0
    for _ in range(3):
        eng.submit(A, B)
    results = eng.drain()
    assert len(results) == 3
    for r in results.values():
        _assert_bitwise(r, ref)
    assert fp.injected["lease_denial"] == 2
    assert eng.stats.faults_injected == 2
    assert eng.stats.arena_pressure == 1


def test_injected_verify_overflow_recovers_bitwise():
    A, B = _pair(2)
    ref = SpgemmEngine(CFG, arena=Arena()).execute(A, B)

    fp = FaultPlan([FaultSpec(site="verify_overflow", at=(0,))])
    eng = SpgemmEngine(CFG, arena=Arena(), faults=fp)
    eng.execute(A, B)              # cold: no verify visit
    grows_before = eng.stats.capacity_grows
    r = eng.execute(A, B)          # hot: forced overflow -> steps redo
    _assert_bitwise(r, ref)
    assert fp.injected["verify_overflow"] == 1
    assert eng.stats.capacity_grows > grows_before
    r2 = eng.execute(A, B)         # next call is clean again
    _assert_bitwise(r2, ref)
    assert eng.arena.bytes_in_use == 0


def test_injected_executor_raise_classification():
    A, B = _pair(4)
    fp = FaultPlan([FaultSpec(site="executor_raise", at=(0,),
                              message="poisoned")])
    eng = SpgemmEngine(CFG, arena=Arena(), faults=fp)
    with pytest.raises(InjectedFault, match="poisoned") as exc_info:
        eng.execute(A, B)
    assert not exc_info.value.transient
    # The engine survives the injected failure: next request succeeds.
    ref = SpgemmEngine(CFG, arena=Arena()).execute(A, B)
    _assert_bitwise(eng.execute(A, B), ref)


# ---------------------------------------------------------------------------
# The same fault plan on both packages' engines.
# ---------------------------------------------------------------------------

PARITY_PLANS = {
    "lease_denial": [("lease_denial", (2, 3))],
    "verify_overflow": [("verify_overflow", (0, 2))],
    "slow_dispatch": [("slow_dispatch", (1,))],
    "mixed": [("lease_denial", (1,)), ("verify_overflow", (1,)),
              ("slow_dispatch", (3,))],
}


@pytest.mark.parametrize("name", list(PARITY_PLANS))
def test_same_fault_plan_same_injections_in_both_engines(name):
    """One request sequence (cold, one hot call, a drain of three) on both
    packages' engines with the same plan: the same visits and injections
    at every site, the same pressure events, and the same C."""
    jA, jB = _ref_pair(6)
    A, B = _port(jA), _port(jB)

    def plan(mod):
        return mod.FaultPlan([mod.FaultSpec(site=site, at=at, delay_s=0.001)
                              for site, at in PARITY_PLANS[name]])

    ours, theirs = plan(tfaults), plan(jfaults)
    t_eng = SpgemmEngine(CFG, arena=Arena(), faults=ours)
    j_eng = JEngine(JConfig(method="esc"), arena=JArena(), faults=theirs)
    t_res = [t_eng.execute(A, B), t_eng.execute(A, B)]
    j_res = [j_eng.execute(jA, jB), j_eng.execute(jA, jB)]
    for _ in range(3):
        t_eng.submit(A, B)
        j_eng.submit(jA, jB)
    t_res += list(t_eng.drain(drain_ordered=True).values())
    j_res += list(j_eng.drain(drain_ordered=True).values())
    assert ours.snapshot() == theirs.snapshot()
    assert ours.total_injected > 0
    for stat in ("faults_injected", "arena_pressure", "capacity_grows",
                 "requests"):
        assert getattr(t_eng.stats, stat) == getattr(j_eng.stats, stat), stat
    assert t_eng.arena.pressure_events == j_eng.arena.pressure_events
    for t, j in zip(t_res, j_res):
        _assert_same_c(t, j)
