"""Row-block sharding on the port against the reference, on the CPU.

The reference's ``tests/test_partition.py`` on the port's engine (the
partitioner, ``CSR.row_slice``, sharded parity with the unsharded path,
per-shard growth, the drains, plan-cache persistence of sharded plans),
plus parity with the reference on the same inputs: ``row_flops``, the
``ShardSpec`` the partitioner learns, the sharded C, and sharded dumps
loaded across the packages in both directions.  The matrices come from the
reference's ``random_csr`` with the reference tests' seeds and reach the
port as numpy arrays.

Tolerance: ``rpt``, ``col``, capacities, totals and specs exact; ``val``
within 1e-5 (``rtol`` and ``atol``, the reference tests' tolerance).  On
the CPU the port's sharded C is bitwise equal to its unsharded C.

The reference's ``test_sharded_on_two_device_mesh_subprocess`` forces two
XLA host devices in a subprocess.  The port's mesh is a sequence of
``torch.device`` and torch has one CPU device, so the case runs here in
one process on ``mesh=(cpu, cpu)`` (the mesh path, with nothing to move);
the ``gpu`` test ``test_sharded_on_card_and_cpu_mesh`` puts the two shards
on two devices for real (the card and the CPU) and the merge gathers them
home.

The ``gpu`` tests run the sharded path on the card (sharded against
unsharded for ESC and both hash steady states, a host-sync-free
``row_slice``, the merge of a padded capacity) and skip without one.
"""
import json
import warnings

import numpy as np
import pytest
import torch

from repro.core import csr as jcsr
from repro.core.analysis import row_flops as jrow_flops
from repro.core.spgemm import SpgemmConfig as JConfig
from repro import engine as jengine
from repro_torch import convert
from repro_torch.core import CSR, SpgemmConfig, spgemm, spgemm_reference
from repro_torch.core.analysis import row_flops
from repro_torch.engine import (MatrixSig, PlanCache, ShardSpec,
                                SpgemmEngine, balanced_bounds,
                                data_axis_devices, plan_shards,
                                reset_default_engine, shard_devices,
                                total_traces)
from repro_torch.engine.executor import _build_merge_executable

VAL_TOL = dict(rtol=1e-5, atol=1e-5)   # tests/test_partition.py
CPU = "cpu"


def _port(A, device=CPU):
    return convert.csr_from_reference(np.asarray(A.rpt), np.asarray(A.col),
                                      np.asarray(A.val), A.shape,
                                      device=device)


def _ref_pair(seed, m=32, k=28, n=36, da=3.0, db=3.0, dist="uniform"):
    A = jcsr.random_csr(seed, m, k, avg_nnz_per_row=da, distribution=dist)
    B = jcsr.random_csr(seed + 1, k, n, avg_nnz_per_row=db,
                        distribution=dist)
    return A, B


def _pair(seed, **kw):
    return tuple(_port(M) for M in _ref_pair(seed, **kw))


def _from_dense(d):
    return CSR.from_dense(d, device=CPU)


def _check(result, A, B):
    np.testing.assert_allclose(result.C.to_dense().numpy(),
                               spgemm_reference(A, B).numpy(), **VAL_TOL)


def _assert_same_csr(C, D, nnz):
    """rpt exact, col exact and val within VAL_TOL on the first nnz
    entries; C and D are (rpt, col, val) host arrays."""
    np.testing.assert_array_equal(np.asarray(C[0]), np.asarray(D[0]))
    np.testing.assert_array_equal(np.asarray(C[1])[:nnz],
                                  np.asarray(D[1])[:nnz])
    np.testing.assert_allclose(np.asarray(C[2])[:nnz],
                               np.asarray(D[2])[:nnz], **VAL_TOL)


def _csr_arrays(C):
    return tuple(np.asarray(x) for x in (C.rpt, C.col, C.val))


def _same_spec(spec, jspec):
    """Whether a port ShardSpec and a reference one are equal."""
    return (spec.bounds, spec.row_buckets, spec.cap_buckets) == (
        jspec.bounds, jspec.row_buckets, jspec.cap_buckets)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the port's hand-written kernels)")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# The partitioner: flop-balanced contiguous row blocks.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_shards", [2, 3, 4])
def test_balanced_bounds_skewed_weights(n_shards):
    # A heavy head (100x the tail): an even ROW split would give shard 0
    # nearly all the flops; the flop split stays within 2x of the mean.
    weights = np.concatenate([np.full(8, 100, np.int64),
                              np.full(56, 1, np.int64)])
    bounds = balanced_bounds(weights, n_shards)
    assert bounds[0] == 0 and bounds[-1] == len(weights)
    assert list(bounds) == sorted(bounds)
    loads = [int(weights[bounds[s]:bounds[s + 1]].sum())
             for s in range(n_shards)]
    mean = weights.sum() / n_shards
    assert max(loads) <= 2 * mean, (loads, mean)
    assert bounds == jengine.balanced_bounds(weights, n_shards)


def test_balanced_bounds_on_flop_estimate():
    jA, jB = _ref_pair(11, m=128, da=4.0, dist="powerlaw")
    A, B = _port(jA), _port(jB)
    flops = row_flops(A, B)
    assert flops.dtype == np.int64        # host-side, wrap-proof weights
    np.testing.assert_array_equal(flops, jrow_flops(jA, jB))
    bounds = balanced_bounds(flops, 4)
    loads = [int(flops[bounds[s]:bounds[s + 1]].sum()) for s in range(4)]
    assert max(loads) <= 2 * (flops.sum() / 4), (loads, flops.sum())
    # balanced_bounds' own guarantee: total/n + the largest row.
    assert max(loads) <= flops.sum() / 4 + flops.max()


def test_balanced_bounds_degenerate_inputs():
    assert balanced_bounds(np.zeros(6, np.int64), 3) == (0, 2, 4, 6)
    assert balanced_bounds(np.ones(2, np.int64), 5) == (0, 1, 2)  # clamped
    assert balanced_bounds(np.ones(0, np.int64), 3) == (0, 0)


def test_plan_shards_buckets_are_pow2():
    jA, jB = _ref_pair(13, m=50, da=3.0)
    A, B = _port(jA), _port(jB)
    spec = plan_shards(A.rpt.numpy(), row_flops(A, B), 3)
    assert spec.n_shards == 3
    assert sum(spec.rows(s) for s in range(3)) == A.nrows
    for s in range(3):
        rb, cb = spec.row_buckets[s], spec.cap_buckets[s]
        assert rb >= spec.rows(s) and rb & (rb - 1) == 0
        assert cb & (cb - 1) == 0
    # Per-shard growth touches only the grown shard's bucket.
    grown = spec.with_cap_bucket(1, spec.cap_buckets[1] + 1)
    assert grown.cap_buckets[1] > spec.cap_buckets[1]
    assert grown.cap_buckets[0] == spec.cap_buckets[0]
    assert grown.cap_buckets[2] == spec.cap_buckets[2]
    assert grown.bounds == spec.bounds


@pytest.mark.parametrize("seed,m,n_shards,dist", [
    (13, 50, 3, "uniform"), (11, 128, 4, "powerlaw"),
    (23, 48, 3, "powerlaw"), (31, 32, 2, "uniform")])
def test_shard_spec_equals_reference(seed, m, n_shards, dist):
    jA, jB = _ref_pair(seed, m=m, dist=dist)
    A, B = _port(jA), _port(jB)
    spec = plan_shards(A.rpt.numpy(), row_flops(A, B), n_shards)
    want = jengine.plan_shards(np.asarray(jA.rpt), jrow_flops(jA, jB),
                               n_shards)
    assert (spec.bounds, spec.row_buckets, spec.cap_buckets) == (
        want.bounds, want.row_buckets, want.cap_buckets)


def test_shard_spec_union_is_monotone():
    spec = ShardSpec(bounds=(0, 4, 8), row_buckets=(4, 4),
                     cap_buckets=(64, 128))
    bigger = ShardSpec(bounds=(0, 4, 8), row_buckets=(4, 4),
                       cap_buckets=(256, 16))
    assert spec.union(bigger).cap_buckets == (256, 128)
    # Incomparable partitions keep self.
    other = ShardSpec(bounds=(0, 2, 8), row_buckets=(2, 8),
                      cap_buckets=(512, 512))
    assert spec.union(other) is spec


# ---------------------------------------------------------------------------
# CSR.row_slice: the shard substrate.
# ---------------------------------------------------------------------------

def test_row_slice_roundtrip_and_padding():
    jA, _ = _ref_pair(17, m=24)
    A = _port(jA)
    dense = A.to_dense().numpy()
    sl = A.row_slice(3, 17)
    np.testing.assert_array_equal(sl.to_dense().numpy(), dense[3:17])
    # Padded to static buckets: extra rows are empty, storage zero-filled.
    padded = A.row_slice(3, 17, nrows=32, capacity=256)
    assert padded.shape == (32, A.ncols) and padded.capacity == 256
    out = padded.to_dense().numpy()
    np.testing.assert_array_equal(out[:14], dense[3:17])
    assert not out[14:].any()
    # Whole-matrix slice is the identity in structure.
    whole = A.row_slice(0, A.nrows)
    np.testing.assert_array_equal(whole.to_dense().numpy(), dense)


@pytest.mark.parametrize("start,stop,nrows,capacity", [
    (3, 17, None, None), (3, 17, 32, 256), (0, 24, 32, 128),
    (20, 24, 4, 16), (5, 5, 1, 16)])
def test_row_slice_equals_reference(start, stop, nrows, capacity):
    jA, _ = _ref_pair(17, m=24)
    got = _port(jA).row_slice(start, stop, nrows=nrows, capacity=capacity)
    want = jA.row_slice(start, stop, nrows=nrows, capacity=capacity)
    assert got.shape == want.shape and got.capacity == want.capacity
    for g, w in zip(_csr_arrays(got), _csr_arrays(want)):
        np.testing.assert_array_equal(g, w)
    assert got.rpt.dtype == torch.int32 and got.col.dtype == torch.int32


def test_row_slice_truncates_to_a_valid_prefix():
    """A capacity below the slice's nnz keeps the leading entries, as the
    reference does; the port also clamps the row pointers to the capacity
    (torch raises on the out-of-range gathers JAX clamps), so the slice
    stays a valid CSR of the rows' first entries."""
    jA, _ = _ref_pair(17, m=24)
    A = _port(jA)
    nnz = int(A.rpt[17] - A.rpt[3])
    cap = 16
    assert nnz > cap
    got = A.row_slice(3, 17, capacity=cap)
    want = jA.row_slice(3, 17, capacity=cap)
    np.testing.assert_array_equal(got.col.numpy(), np.asarray(want.col))
    np.testing.assert_array_equal(got.val.numpy(), np.asarray(want.val))
    np.testing.assert_array_equal(
        got.rpt.numpy(), np.minimum(np.asarray(want.rpt), cap))
    assert int(got.nnz()) == cap


# ---------------------------------------------------------------------------
# Sharded execution: parity with the unsharded path, the oracle and the
# reference.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["esc", "hash"])
def test_sharded_matches_unsharded_bitwise(method):
    jA, jB = _ref_pair(23, m=48, dist="powerlaw")
    A, B = _port(jA), _port(jB)
    base = SpgemmEngine(SpgemmConfig(method=method)).execute(A, B)
    engine = SpgemmEngine(SpgemmConfig(method=method), shards=3)
    jeng = jengine.SpgemmEngine(JConfig(method=method), shards=3)
    for _ in range(2):       # cold (learns the partition), then steady
        r = engine.execute(A, B)
        jr = jeng.execute(jA, jB)
        _check(r, A, B)
        assert r.total_nnz == base.total_nnz == jr.total_nnz
        assert r.total_nprod == base.total_nprod == jr.total_nprod
        nnz = base.total_nnz
        assert torch.equal(r.C.rpt, base.C.rpt)
        assert torch.equal(r.C.col[:nnz], base.C.col[:nnz])
        assert torch.equal(r.C.val[:nnz], base.C.val[:nnz])
        assert r.C.capacity == jr.C.capacity
        _assert_same_csr(_csr_arrays(r.C), _csr_arrays(jr.C), nnz)
    key = (MatrixSig.of(A), MatrixSig.of(B),
           SpgemmConfig(method=method, shards=3))
    parent = engine.cache.get(key)
    assert parent is not None and parent.plan.shard_spec is not None
    jparent = jeng.cache.get((jengine.MatrixSig.of(jA),
                              jengine.MatrixSig.of(jB),
                              JConfig(method=method, shards=3)))
    assert _same_spec(parent.plan.shard_spec,
                             jparent.plan.shard_spec)
    assert engine.stats.sharded_requests == jeng.stats.sharded_requests


def test_spgemm_shards_knob_routes_through_engine():
    A, B = _pair(29)
    reset_default_engine()
    try:
        r = spgemm(A, B, shards=2)
        _check(r, A, B)
        from repro_torch.engine import default_engine
        assert default_engine().stats.sharded_requests == 1
    finally:
        reset_default_engine()


def test_sharded_stream_zero_rebuilds_and_cache_hits():
    engine = SpgemmEngine(shards=2)
    A, B = _pair(31)
    cap_a, cap_b = MatrixSig.of(A).cap_bucket, MatrixSig.of(B).cap_bucket
    engine.execute(A, B)                   # cold: learns partition + buckets
    engine.execute(A, B)                   # first steady call builds shards
    baseline = total_traces()
    for s in range(4):                     # distinct same-bucket matrices
        A2, B2 = _pair(40 + s)
        r = engine.execute(A2.with_capacity(cap_a), B2.with_capacity(cap_b))
        _check(r, A2, B2)
    assert total_traces() == baseline      # zero pipeline builds on repeats
    assert engine.stats.shard_grows == 0
    assert engine.cache.hit_rate >= 0.75   # stream-wide, incl. cold misses


def test_per_shard_bucket_growth_touches_one_shard():
    m = 32
    d_even = np.zeros((m, m), np.float32)
    d_even[:, 0] = 1.0                     # 1 nnz/row, uniform balance
    d_skew = np.zeros((m, m), np.float32)
    d_skew[:, 0] = 1.0
    d_skew[m // 2:, :24] = 1.0             # bottom half outgrows its slice
    dB = np.eye(m, dtype=np.float32)
    A_even = _from_dense(d_even).with_capacity(1024)
    A_skew = _from_dense(d_skew).with_capacity(1024)
    assert MatrixSig.of(A_even) == MatrixSig.of(A_skew)
    Bc = _from_dense(dB)

    engine = SpgemmEngine(shards=2)
    engine.execute(A_even, Bc)             # learns an even partition
    key = (MatrixSig.of(A_even), MatrixSig.of(Bc), SpgemmConfig(shards=2))
    spec0 = engine.cache.get(key).plan.shard_spec
    r = engine.execute(A_skew, Bc)         # shard 1's slice overflows
    np.testing.assert_allclose(r.C.to_dense().numpy(), d_skew @ dB,
                               rtol=1e-5)
    assert engine.stats.shard_grows >= 1
    spec1 = engine.cache.get(key).plan.shard_spec
    assert spec1.bounds == spec0.bounds            # partition pinned
    assert spec1.cap_buckets[0] == spec0.cap_buckets[0]   # shard 0 untouched
    assert spec1.cap_buckets[1] > spec0.cap_buckets[1]    # shard 1 grown
    # The superseded shard's lease went back to the arena.
    assert engine.arena.bytes_in_use == 0
    r2 = engine.execute(A_skew, Bc)        # grown bucket now admits it
    np.testing.assert_allclose(r2.C.to_dense().numpy(), d_skew @ dB,
                               rtol=1e-5)

    # The reference learns and grows the same specs.
    jeng = jengine.SpgemmEngine(shards=2)
    jeven = jcsr.CSR.from_dense(d_even).with_capacity(1024)
    jskew = jcsr.CSR.from_dense(d_skew).with_capacity(1024)
    jB = jcsr.CSR.from_dense(dB)
    jeng.execute(jeven, jB)
    jkey = (jengine.MatrixSig.of(jeven), jengine.MatrixSig.of(jB),
            JConfig(shards=2))
    assert _same_spec(spec0, jeng.cache.get(jkey).plan.shard_spec)
    jeng.execute(jskew, jB)
    assert _same_spec(spec1, jeng.cache.get(jkey).plan.shard_spec)
    assert engine.stats.shard_grows == jeng.stats.shard_grows


def test_sharded_on_two_device_mesh():
    """The mesh path with two entries (placement, B's replicas, the
    merge's gather home).  The reference forces two XLA host devices in a
    subprocess; torch has one CPU device, so both entries are the CPU
    here (see ``test_sharded_on_card_and_cpu_mesh`` for two devices)."""
    A, B = _pair(0, m=40, k=36, n=30)
    mesh = (torch.device(CPU), torch.device(CPU))
    eng = SpgemmEngine(shards=2, mesh=mesh)
    for _ in range(2):   # cold + steady
        r = eng.execute(A, B)
        _check(r, A, B)
        assert r.C.device == A.device
    assert eng.stats.sharded_requests == 2


def test_sharded_with_mesh_placement():
    mesh = [CPU]
    assert len(data_axis_devices(mesh)) >= 1
    assert shard_devices(mesh, 3) == (torch.device(CPU),) * 3
    engine = SpgemmEngine(shards=2, mesh=mesh)
    A, B = _pair(53)
    r = engine.execute(A, B)
    _check(r, A, B)
    with pytest.raises(ValueError):
        data_axis_devices([])


# ---------------------------------------------------------------------------
# Completion-order drain.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("drain_ordered", [False, True])
def test_drain_modes_match_oracle(drain_ordered):
    engine = SpgemmEngine()
    reqs = []
    for s in range(6):
        A, B = _pair(60 + s, m=24 if s % 2 else 40)   # mixed-size stream
        reqs.append((engine.submit(A, B), A, B))
    results = engine.drain(drain_ordered=drain_ordered)
    assert len(results) == len(reqs)
    for uid, A, B in reqs:
        _check(results[uid], A, B)


@pytest.mark.parametrize("drain_ordered", [False, True])
def test_sharded_drain_matches_oracle(drain_ordered):
    engine = SpgemmEngine(shards=2)
    reqs = []
    for s in range(4):
        A, B = _pair(70 + s)
        reqs.append((engine.submit(A, B), A, B))
    results = engine.drain(drain_ordered=drain_ordered)
    for uid, A, B in reqs:
        _check(results[uid], A, B)
    assert engine.stats.sharded_requests == 4
    assert engine.stats.requests == 4


# ---------------------------------------------------------------------------
# Request accounting and the engine-level knob.
# ---------------------------------------------------------------------------

def test_sharded_requests_counted_once():
    engine = SpgemmEngine(shards=3)
    A, B = _pair(97)
    engine.execute(A, B)
    engine.execute(A, B)
    assert engine.stats.requests == 2           # not 2 * (1 + n_shards)
    assert engine.stats.sharded_requests == 2


def test_explicit_config_opts_out_of_engine_sharding():
    engine = SpgemmEngine(shards=3)
    A, B = _pair(98)
    r = engine.execute(A, B, SpgemmConfig(shards=1))   # explicit opt-out
    _check(r, A, B)
    assert engine.stats.sharded_requests == 0


def test_prewarm_rejects_sharded_config():
    engine = SpgemmEngine(shards=2)
    A, B = _pair(96)
    with pytest.raises(ValueError):
        engine.prewarm(A, B, prod_bucket=256, nnz_bucket=256)
    # Explicit unsharded config still prewarms (the sub-problem path).
    p = engine.prewarm(A, B, SpgemmConfig(shards=1),
                       prod_bucket=256, nnz_bucket=256)
    assert p.is_specialized


def test_engine_rejects_bad_shard_counts():
    for bad in (0, -1, "two"):
        with pytest.raises(ValueError):
            SpgemmEngine(shards=bad)


def test_single_row_operand_runs_unsharded():
    A = _from_dense(np.ones((1, 8), np.float32))
    B = _from_dense(np.eye(8, dtype=np.float32))
    engine = SpgemmEngine(shards=4)
    r = engine.execute(A, B)
    _check(r, A, B)
    assert engine.stats.sharded_requests == 0 and engine.stats.requests == 1


# ---------------------------------------------------------------------------
# Plan-cache persistence of sharded plans.
# ---------------------------------------------------------------------------

def test_plan_cache_dump_load_roundtrip(tmp_path):
    engine = SpgemmEngine()
    A, B = _pair(81)
    engine.execute(A, B)                                   # ESC plan
    engine.execute(A, B, SpgemmConfig(method="hash"))      # hash schedule
    engine.execute(A, B, SpgemmConfig(shards=2))           # shard spec
    path = str(tmp_path / "plans.json")
    n = engine.cache.dump(path)
    assert n == len(engine.cache)

    blob = json.load(open(path))
    assert blob["version"] == 4 and len(blob["plans"]) == n
    assert any(p["shard_spec"] is not None for p in blob["plans"])

    fresh = PlanCache()
    assert fresh.load(path) == n
    orig = {k: e.plan for k, e in engine.cache.items()}
    for key, entry in fresh.items():
        assert entry.plan == orig[key]
        assert entry.executable is None    # pipelines are not persisted


def test_loaded_cache_prewarms_fresh_engine(tmp_path):
    A, B = _pair(91)
    path = str(tmp_path / "plans.json")
    warm = SpgemmEngine(SpgemmConfig(method="hash"), shards=2)
    warm.execute(A, B)
    warm.cache.dump(path)

    engine = SpgemmEngine(SpgemmConfig(method="hash"), shards=2)
    engine.cache.load(path)
    r = engine.execute(A, B)               # straight to the steady state
    _check(r, A, B)
    assert sum(e.stats.steps_calls for _, e in engine.cache.items()) == 0
    assert engine.stats.capacity_grows == 0


def test_noop_load_keeps_live_executables(tmp_path):
    engine = SpgemmEngine(shards=2)
    A, B = _pair(99)
    engine.execute(A, B)
    engine.execute(A, B)                       # pipelines built
    path = str(tmp_path / "plans.json")
    engine.cache.dump(path)
    before = {k: e.executable for k, e in engine.cache.items()}
    assert any(x is not None for x in before.values())
    engine.cache.load(path)                    # merge is a no-op
    for key, entry in engine.cache.items():
        assert entry.executable is before[key]


def test_load_merges_shard_specs_monotonically(tmp_path):
    A, B = _pair(95)
    engine = SpgemmEngine(shards=2)
    engine.execute(A, B)
    key = (MatrixSig.of(A), MatrixSig.of(B), SpgemmConfig(shards=2))
    spec = engine.cache.get(key).plan.shard_spec
    path = str(tmp_path / "plans.json")
    engine.cache.dump(path)
    blob = json.load(open(path))
    for p in blob["plans"]:
        if p["shard_spec"] is not None:
            p["shard_spec"]["cap_buckets"] = [
                c * 4 for c in p["shard_spec"]["cap_buckets"]]
    json.dump(blob, open(path, "w"))
    engine.cache.load(path)                    # bigger buckets: grow
    grown = engine.cache.get(key).plan.shard_spec
    assert grown.cap_buckets == tuple(4 * c for c in spec.cap_buckets)
    engine.cache.dump(path)
    other = SpgemmEngine(shards=2)
    other.execute(A, B)
    other.cache.load(path)
    assert other.cache.get(key).plan.shard_spec == grown
    _check(other.execute(A, B), A, B)


def test_reference_sharded_dump_loads_into_port(tmp_path):
    jA, jB = _ref_pair(91)
    A, B = _port(jA), _port(jB)
    path = str(tmp_path / "ref_plans.json")
    jeng = jengine.SpgemmEngine(shards=2)
    jr = jeng.execute(jA, jB)
    n = jeng.cache.dump(path)

    engine = SpgemmEngine(shards=2)
    assert engine.cache.load(path) == n
    key = (MatrixSig.of(A), MatrixSig.of(B), SpgemmConfig(shards=2))
    jkey = (jengine.MatrixSig.of(jA), jengine.MatrixSig.of(jB),
            JConfig(shards=2))
    assert _same_spec(engine.cache.get(key).plan.shard_spec,
                             jeng.cache.get(jkey).plan.shard_spec)
    r = engine.execute(A, B)               # steady from the first request
    assert sum(e.stats.steps_calls for _, e in engine.cache.items()) == 0
    assert r.total_nnz == jr.total_nnz
    _assert_same_csr(_csr_arrays(r.C), _csr_arrays(jr.C), r.total_nnz)
    # The port writes back what it read: the same JSON.
    out = str(tmp_path / "port_plans.json")
    engine.cache.dump(out)
    ref_blob = json.load(open(path))
    port_blob = json.load(open(out))
    key_of = (lambda p: (json.dumps(p["a_sig"], sort_keys=True),
                         json.dumps(p["config"], sort_keys=True)))
    ref_specs = {key_of(p): p["shard_spec"] for p in ref_blob["plans"]}
    port_specs = {key_of(p): p["shard_spec"] for p in port_blob["plans"]}
    assert ref_specs == port_specs


def test_port_sharded_dump_loads_into_reference(tmp_path):
    jA, jB = _ref_pair(92)
    A, B = _port(jA), _port(jB)
    path = str(tmp_path / "port_plans.json")
    engine = SpgemmEngine(shards=2)
    r = engine.execute(A, B)
    n = engine.cache.dump(path)

    jeng = jengine.SpgemmEngine(shards=2)
    assert jeng.cache.load(path) == n
    key = (MatrixSig.of(A), MatrixSig.of(B), SpgemmConfig(shards=2))
    jkey = (jengine.MatrixSig.of(jA), jengine.MatrixSig.of(jB),
            JConfig(shards=2))
    assert _same_spec(engine.cache.get(key).plan.shard_spec,
                             jeng.cache.get(jkey).plan.shard_spec)
    jr = jeng.execute(jA, jB)              # steady from the first request
    assert sum(e.stats.steps_calls for _, e in jeng.cache.items()) == 0
    assert jr.total_nnz == r.total_nnz
    _assert_same_csr(_csr_arrays(r.C), _csr_arrays(jr.C), r.total_nnz)


# ---------------------------------------------------------------------------
# The merge.
# ---------------------------------------------------------------------------

def _merge_case(device):
    """Two padded shard CSRs (rows 0..2 and 3..4 of a 5 x 6 matrix) with
    capacities past their nnz and junk in the padding."""
    spec = ShardSpec(bounds=(0, 3, 5), row_buckets=(4, 2),
                     cap_buckets=(16, 16))
    d = np.array([[1, 0, 2, 0, 0, 0], [0, 0, 0, 0, 0, 0],
                  [0, 3, 0, 0, 4, 5], [6, 0, 0, 0, 0, 7],
                  [0, 0, 0, 8, 0, 0]], np.float32)
    parts = []
    for lo, hi, rows, cap in ((0, 3, 4, 8), (3, 5, 2, 4)):
        S = CSR.from_dense(d[lo:hi], device=device)
        nnz = int(S.rpt[-1])
        rpt = torch.cat([S.rpt, S.rpt[-1:].repeat(rows - (hi - lo))])
        col = torch.full((cap,), 5, dtype=torch.int32, device=device)
        val = torch.full((cap,), 99.0, device=device)
        col[:nnz], val[:nnz] = S.col[:nnz], S.val[:nnz]
        parts.append(CSR(rpt=rpt, col=col, val=val, shape=(rows, 6)))
    return spec, d, tuple(parts)


def _check_merge(device):
    spec, d, parts = _merge_case(device)
    C = _build_merge_executable(spec, m=5, n=6)(parts)
    assert C.shape == (5, 6) and C.capacity == 12   # the shards' sum
    nnz = int(C.rpt[-1])
    assert nnz == 8
    np.testing.assert_array_equal(C.to_dense().cpu().numpy(), d)
    assert not C.col[nnz:].any() and not C.val[nnz:].any()  # pad dropped


def test_merge_drops_padding():
    _check_merge(CPU)


# ---------------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("shards", [2, 3])
@pytest.mark.parametrize("cfg", [
    dict(method="hash"), dict(method="hash", fuse_numeric=False),
    dict(method="esc")], ids=["hash-fused", "hash-two-pass", "esc"])
def test_sharded_matches_unsharded_on_card(card, cfg, shards):
    jA, jB = _ref_pair(23, m=48, dist="powerlaw")
    A, B = _port(jA, card), _port(jB, card)
    config = SpgemmConfig(**cfg)
    base = SpgemmEngine(config).execute(A, B)
    engine = SpgemmEngine(config, shards=shards)
    for _ in range(2):       # cold, then steady
        r = engine.execute(A, B)
        assert r.C.device.type == "cuda"
        assert r.total_nnz == base.total_nnz
        _assert_same_csr(_csr_arrays(r.C.to(CPU)),
                         _csr_arrays(base.C.to(CPU)), base.total_nnz)
    key = (MatrixSig.of(A), MatrixSig.of(B),
           SpgemmConfig(**cfg, shards=shards))
    assert engine.cache.get(key).plan.shard_spec.n_shards == shards


@pytest.mark.gpu
def test_sharded_on_card_and_cpu_mesh(card):
    """Two shards on two devices: shard 0 on the card (its kernels), shard
    1 on the CPU (its plain path), B replicated once per device; the merge
    gathers the CPU shard home to the card."""
    jA, jB = _ref_pair(0, m=40, k=36, n=30)
    A, B = _port(jA, card), _port(jB, card)
    base = SpgemmEngine(SpgemmConfig(method="hash")).execute(A, B)
    eng = SpgemmEngine(SpgemmConfig(method="hash"), shards=2,
                       mesh=(card, torch.device(CPU)))
    for _ in range(2):   # cold + steady
        r = eng.execute(A, B)
        assert r.C.device.type == "cuda"
        _assert_same_csr(_csr_arrays(r.C.to(CPU)),
                         _csr_arrays(base.C.to(CPU)), base.total_nnz)
    assert set(eng._b_placed) == {torch.device("cuda", A.device.index or 0),
                                  torch.device(CPU)}


@pytest.mark.gpu
def test_row_slice_on_card_syncs_nothing(card):
    jA, _ = _ref_pair(17, m=24)
    A = _port(jA, card)
    want = jA.row_slice(3, 17, nrows=32, capacity=256)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            got = A.row_slice(3, 17, nrows=32, capacity=256)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message) for w in caught
             if "called a synchronizing" in str(w.message)]
    assert not syncs, syncs
    for g, w in zip(_csr_arrays(got.to(CPU)), _csr_arrays(want)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.gpu
def test_merge_drops_padding_on_card(card):
    _check_merge(card)
