"""The reference's fused-hash tests (tests/test_fused_hash.py) on the port.

Each case keeps the reference's body, on the port's CPU tensors; the
operands come from the reference's key-derived seeds
(``int(jax.random.bits(jax.random.PRNGKey(s)))``, as ``repro.core.csr``
derives them), so both packages multiply the same matrices.  Two of the
reference's cases test TPU internals and have no counterpart here:
``test_packed_geometry_and_ladder_rows_per_block`` (the VMEM tile geometry
``_packed_geom``) and ``test_interpret_auto_detect`` (Pallas interpret
mode).  Added: the fused pipeline against the reference package's on the
same pair, and, on the card, the fixed-order kernels
(``torch.use_deterministic_algorithms(True)``) bit for bit against the
CPU's plain versions and fused against two-pass.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import csr as jcsr
from repro.core.binning_ranges import symbolic_ladder as jsymbolic_ladder
from repro.core.binning import bin_rows_for_ladder as jbin
from repro.core.analysis import nprod_into_rpt as jnprod
from repro.kernels import spgemm_hash as jsh
from repro_torch.core import (SpgemmConfig, bin_rows_for_ladder, esc,
                              next_bucket, nprod_into_rpt, random_csr)
from repro_torch.core.analysis import exclusive_sum_in_place
from repro_torch.core.binning_ranges import (make_ladder, numeric_ladder,
                                             symbolic_ladder)
from repro_torch.engine import SpgemmEngine, total_traces
from repro_torch.kernels import spgemm_hash

VAL_TOL = dict(rtol=1e-5, atol=1e-5)   # tests/test_kernels_spgemm_hash.py:56


def _seed(s):
    """The reference's int seed of ``jax.random.PRNGKey(s)``."""
    return int(jax.random.bits(jax.random.PRNGKey(s), dtype=jnp.uint32))


def _pair(seed, m, k, n, da, db, dist="uniform"):
    A = random_csr(_seed(seed), m, k, avg_nnz_per_row=da,
                   distribution=dist, device="cpu")
    B = random_csr(_seed(seed + 100), k, n, avg_nnz_per_row=db,
                   distribution=dist, device="cpu")
    return A, B


def _two_pass(A, B, sym_lad, num_lad, single_access=True):
    """The two-pass oracle: symbolic -> rpt -> numeric."""
    m = A.nrows
    nprod = nprod_into_rpt(A, B)[:m]
    sym_bn = bin_rows_for_ladder(nprod, sym_lad)
    nnz_buf = spgemm_hash.symbolic_binned(A, B, sym_bn, sym_lad,
                                          single_access=single_access)
    num_bn = bin_rows_for_ladder(nnz_buf[:m], num_lad)
    cap = next_bucket(max(int(nnz_buf[:m].sum()), 1))
    rpt = exclusive_sum_in_place(nnz_buf)
    C = spgemm_hash.numeric_binned(A, B, rpt, num_bn, num_lad,
                                   nnz_capacity=cap,
                                   single_access=single_access)
    return C, cap, sym_bn


def _fused(A, B, sym_lad, cap, sym_bn, *, single_access=True, packed=False):
    return spgemm_hash.fused_binned(A, B, sym_bn, sym_lad, nnz_capacity=cap,
                                    single_access=single_access,
                                    row_packing=packed)


@pytest.mark.parametrize("single_access", [True, False])
def test_fused_vs_two_pass_bitwise_parity(single_access):
    """One table build must reproduce the double build EXACTLY: same nnz,
    same sorted structure, bitwise-equal values (the per-column accumulation
    order — A-entry major, B-entry minor — is identical in both kernels)."""
    A, B = _pair(7, 72, 96, 80, 5.0, 4.0)
    sym_lad, num_lad = symbolic_ladder(1.2), numeric_ladder(2.0)
    C2, cap, sym_bn = _two_pass(A, B, sym_lad, num_lad, single_access)
    C1 = _fused(A, B, sym_lad, cap, sym_bn, single_access=single_access)
    nnz = int(C2.rpt[-1])
    assert nnz > 0
    np.testing.assert_array_equal(np.asarray(C1.rpt), np.asarray(C2.rpt))
    np.testing.assert_array_equal(np.asarray(C1.col)[:nnz],
                                  np.asarray(C2.col)[:nnz])
    np.testing.assert_array_equal(np.asarray(C1.val)[:nnz],
                                  np.asarray(C2.val)[:nnz])


def test_fused_multi_rung_with_fallback_matches_oracle():
    """Tiny ladders force several rungs AND the ESC fallback rung through
    the fused path; nnz/structure stay exact against the dense oracle
    (values allclose: ESC fallback rows may sum in a different order)."""
    m = 96
    A, B = _pair(9, m, 200, 150, 10.0, 8.0, dist="powerlaw")
    sym_lad = make_ladder((32, 64, 128), 1.2, (32, 64, 128))
    nprod = nprod_into_rpt(A, B)[:m]
    sym_bn = bin_rows_for_ladder(nprod, sym_lad)
    sizes = np.asarray(sym_bn.bin_size)
    assert (sizes[:-1] > 0).sum() >= 2 and sizes[-1] > 0  # rungs + fallback
    nnz_buf = esc.symbolic(A, B, prod_capacity=next_bucket(8192))
    cap = next_bucket(int(nnz_buf.sum()))
    C = spgemm_hash.fused_binned(A, B, sym_bn, sym_lad, nnz_capacity=cap)
    ref = np.asarray(A.to_dense()) @ np.asarray(B.to_dense())
    np.testing.assert_array_equal(
        np.asarray(C.rpt[1:]) - np.asarray(C.rpt[:-1]),
        (ref != 0).sum(axis=1))
    np.testing.assert_allclose(np.asarray(C.to_dense()), ref,
                               rtol=1e-5, atol=1e-5)
    rptn, coln = np.asarray(C.rpt), np.asarray(C.col)
    for i in range(m):
        seg = coln[rptn[i]:rptn[i + 1]]
        assert (np.diff(seg) > 0).all()    # rows sorted by column


def test_packed_vs_unpacked_bitwise_parity_across_rungs():
    """Row packing is a pure occupancy/layout change: sub-tables keep the
    per-row table size, so probe sequences — and therefore nnz, structure,
    values, and transaction counts — are bitwise-identical."""
    m = 96
    A, B = _pair(11, m, 160, 120, 8.0, 6.0, dist="powerlaw")
    sym_lad = make_ladder((32, 64, 128, 256), 1.2, (32, 64, 128, 256))
    assert sym_lad.rows_per_block[0] > 1     # packing actually engages
    nprod = nprod_into_rpt(A, B)[:m]
    sym_bn = bin_rows_for_ladder(nprod, sym_lad)
    assert (np.asarray(sym_bn.bin_size)[:-1] > 0).sum() >= 2
    cap = next_bucket(int(esc.symbolic(A, B,
                                       prod_capacity=next_bucket(8192)).sum()))
    Cu, acc_u = spgemm_hash.fused_binned(A, B, sym_bn, sym_lad,
                                         nnz_capacity=cap, row_packing=False,
                                         collect_accesses=True)
    Cp, acc_p = spgemm_hash.fused_binned(A, B, sym_bn, sym_lad,
                                         nnz_capacity=cap, row_packing=True,
                                         collect_accesses=True)
    np.testing.assert_array_equal(np.asarray(Cu.rpt), np.asarray(Cp.rpt))
    np.testing.assert_array_equal(np.asarray(Cu.col), np.asarray(Cp.col))
    np.testing.assert_array_equal(np.asarray(Cu.val), np.asarray(Cp.val))
    assert int(acc_u) == int(acc_p)


def test_fused_accesses_leq_two_pass_per_row():
    """Access-count regression (the Fig.-9 counters, per row): building the
    table once must cost no more transactions than building it twice —
    fused <= symbolic + numeric for EVERY row."""
    m = 80
    A, B = _pair(13, m, 100, 90, 6.0, 5.0)
    sym_lad, num_lad = symbolic_ladder(1.2), numeric_ladder(2.0)
    nprod = nprod_into_rpt(A, B)[:m]
    sym_bn = bin_rows_for_ladder(nprod, sym_lad)
    nnz_buf = spgemm_hash.symbolic_binned(A, B, sym_bn, sym_lad)
    num_bn = bin_rows_for_ladder(nnz_buf[:m], num_lad)

    def per_row_accesses(binning, ladder, call):
        out = {}
        sizes = np.asarray(binning.bin_size)
        for b, t_size in enumerate(ladder.table_sizes):
            if not sizes[b]:
                continue
            rows_cap = next_bucket(int(sizes[b]), minimum=8)
            rows, count = binning.rows_of_bin(b, rows_cap)
            acc = call(rows, count.reshape(1), t_size, rows_cap)
            rr, aa = np.asarray(rows), np.asarray(acc)
            for i in range(int(sizes[b])):
                out[int(rr[i])] = int(aa[i])
        return out

    sym_acc = per_row_accesses(
        sym_bn, sym_lad,
        lambda rows, cnt, t, cap: spgemm_hash.symbolic_bin_call(
            rows, cnt, A.rpt, A.col, B.rpt, B.col,
            t_size=t, rows_cap=cap, single_access=True)[1])
    num_acc = per_row_accesses(
        num_bn, num_lad,
        lambda rows, cnt, t, cap: spgemm_hash.numeric_bin_call(
            rows, cnt, A.rpt, A.col, A.val, B.rpt, B.col, B.val,
            t_size=t, rows_cap=cap, single_access=True)[2])
    fused_acc = per_row_accesses(
        sym_bn, sym_lad,
        lambda rows, cnt, t, cap: spgemm_hash.fused_bin_call(
            rows, cnt, A.rpt, A.col, A.val, B.rpt, B.col, B.val,
            t_size=t, rows_cap=cap, single_access=True)[3])

    assert set(fused_acc) == set(sym_acc)
    checked = 0
    for r, f in fused_acc.items():
        if r in num_acc:               # row served by kernels in both phases
            assert f <= sym_acc[r] + num_acc[r], r
            checked += 1
    assert checked >= m // 2
    total_two = sum(sym_acc.values()) + sum(num_acc.values())
    total_fused = sum(fused_acc.values())
    assert total_fused * 3 <= total_two * 2    # >= 1.5x reduction overall


def test_host_schedule_pack_alignment():
    """``host_schedule(packs=...)`` floors populated rungs at their pack
    so packed kernels always get whole grid steps."""
    m = 96
    A, B = _pair(17, m, 160, 120, 8.0, 6.0, dist="powerlaw")
    lad = make_ladder((32, 64, 128), 1.2, (32, 64, 128))
    bn = bin_rows_for_ladder(nprod_into_rpt(A, B)[:m], lad)
    buckets, _ = spgemm_hash.host_schedule(A, B, bn, lad,
                                           packs=lad.rows_per_block)
    sizes = np.asarray(bn.bin_size)
    for b, (s, cap) in enumerate(zip(sizes[:-1], buckets[:-1])):
        if not s:
            assert cap == 0
            continue
        pack = lad.rows_per_block[b]
        assert cap >= max(int(s), pack) and cap % pack == 0


@pytest.mark.parametrize("row_packing", [False, True])
def test_engine_fused_steady_state_zero_retraces(row_packing):
    """The fused executable serves repeat shapes with zero retraces and
    stays bitwise-identical to the two-pass engine path."""
    cfg = SpgemmConfig(method="hash", fuse_numeric=True,
                       row_packing=row_packing)
    engine = SpgemmEngine(cfg)
    # Explicit two-pass oracle: fuse_numeric became the hash DEFAULT, so
    # a bare hash config would compare the fused executable with itself.
    oracle = SpgemmEngine(SpgemmConfig(method="hash", fuse_numeric=False))
    pairs = [_pair(31 + s, 48, 64, 56, 4.0, 3.0) for s in range(5)]
    cap_a = next_bucket(max(A.capacity for A, _ in pairs))
    cap_b = next_bucket(max(B.capacity for _, B in pairs))
    pairs = [(A.with_capacity(cap_a), B.with_capacity(cap_b))
             for A, B in pairs]

    baseline = None
    for i, (A, B) in enumerate(pairs):
        res = engine.execute(A, B)
        ref = oracle.execute(A, B)
        nnz = ref.total_nnz
        assert res.total_nnz == nnz
        # Steady-state fused results keep the cold-call telemetry shape.
        assert res.sym_binning is not None and res.num_binning is not None
        np.testing.assert_array_equal(np.asarray(res.C.rpt),
                                      np.asarray(ref.C.rpt))
        np.testing.assert_array_equal(np.asarray(res.C.col)[:nnz],
                                      np.asarray(ref.C.col)[:nnz])
        np.testing.assert_array_equal(np.asarray(res.C.val)[:nnz],
                                      np.asarray(ref.C.val)[:nnz])
        if i == 1:
            baseline = total_traces()   # cold + first fused/oracle traces
    assert total_traces() == baseline   # zero retraces on the tail
    entry = next(e for _, e in engine.cache.items())
    assert entry.stats.hot_calls >= 3
    assert entry.plan.config.fuse_numeric


def test_engine_fused_overflow_grows_and_recovers():
    """A same-signature request outgrowing the fused plan's schedule must
    fall back to the steps oracle, grow the plan, and stay correct."""
    cfg = SpgemmConfig(method="hash", fuse_numeric=True, row_packing=True)
    engine = SpgemmEngine(cfg)
    small = _pair(41, 64, 96, 72, 2.0, 2.0)
    big = _pair(43, 64, 96, 72, 12.0, 9.0, dist="powerlaw")
    cap_a = next_bucket(max(small[0].capacity, big[0].capacity))
    cap_b = next_bucket(max(small[1].capacity, big[1].capacity))
    for A, B in (small, big, small):
        A, B = A.with_capacity(cap_a), B.with_capacity(cap_b)
        res = engine.execute(A, B)
        ref = np.asarray(A.to_dense()) @ np.asarray(B.to_dense())
        np.testing.assert_allclose(np.asarray(res.C.to_dense()), ref,
                                   rtol=1e-4, atol=1e-4)


def _bitwise_same(C1, C2, nnz):
    np.testing.assert_array_equal(np.asarray(C1.rpt), np.asarray(C2.rpt))
    np.testing.assert_array_equal(np.asarray(C1.col)[:nnz],
                                  np.asarray(C2.col)[:nnz])
    np.testing.assert_array_equal(np.asarray(C1.val)[:nnz],
                                  np.asarray(C2.val)[:nnz])


@pytest.mark.parametrize("row_packing", [False, True])
def test_fused_degenerate_all_zero_rows(row_packing):
    """All-zero rows under the fused/packed path: empty rows become empty
    sub-tables (nnz 0, no scatter), bitwise-mirroring the two-pass
    oracle.  Regression for the packed sub-table offsets of empty rows."""
    from repro_torch.core import CSR
    m = 48
    d = np.zeros((m, 40), np.float32)
    rng = np.random.RandomState(0)
    occupied = rng.choice(m, size=m // 3, replace=False)
    d[occupied, :5] = rng.rand(len(occupied), 5).astype(np.float32) + 0.5
    A = CSR.from_dense(d, device="cpu")
    B = random_csr(_seed(3), 40, 36, avg_nnz_per_row=4.0, device="cpu")
    sym_lad, num_lad = symbolic_ladder(1.2), numeric_ladder(2.0)
    C2, cap, sym_bn = _two_pass(A, B, sym_lad, num_lad)
    C1 = spgemm_hash.fused_binned(A, B, sym_bn, sym_lad, nnz_capacity=cap,
                                  row_packing=row_packing)
    nnz = int(C2.rpt[-1])
    assert nnz > 0
    _bitwise_same(C1, C2, nnz)
    # Zero rows really are zero in the result.
    rpt = np.asarray(C1.rpt)
    empty = np.setdiff1d(np.arange(m), occupied)
    assert (rpt[empty + 1] == rpt[empty]).all()


@pytest.mark.parametrize("zero_side", ["A", "B", "both"])
def test_fused_degenerate_nnz_zero_matrices(zero_side):
    """nnz=0 operands through the fused/packed pipeline: the result is the
    empty CSR, bitwise-mirroring the two-pass oracle (empty rows' packed
    sub-table offsets must not scatter anything)."""
    from repro_torch.core import CSR
    m, k, n = 32, 28, 24
    A = (CSR.from_dense(np.zeros((m, k), np.float32), device="cpu")
         if zero_side != "B"
         else random_csr(_seed(5), m, k, avg_nnz_per_row=3.0, device="cpu"))
    B = (CSR.from_dense(np.zeros((k, n), np.float32), device="cpu")
         if zero_side != "A"
         else random_csr(_seed(6), k, n, avg_nnz_per_row=3.0, device="cpu"))
    sym_lad, num_lad = symbolic_ladder(1.2), numeric_ladder(2.0)
    C2, cap, sym_bn = _two_pass(A, B, sym_lad, num_lad)
    C1 = spgemm_hash.fused_binned(A, B, sym_bn, sym_lad, nnz_capacity=cap,
                                  row_packing=True)
    assert int(C1.rpt[-1]) == 0
    _bitwise_same(C1, C2, 0)
    assert not np.asarray(C1.to_dense()).any()


def test_engine_fused_packed_degenerate_stream():
    """The engine's fused+packed steady state on degenerate inputs: an
    all-zero A and a zero-row A share the signature bucket with a dense
    one; every result mirrors the two-pass engine bitwise."""
    from repro_torch.core import CSR
    m, k, n = 32, 28, 24
    cfg = SpgemmConfig(method="hash", fuse_numeric=True, row_packing=True)
    engine = SpgemmEngine(cfg)
    oracle = SpgemmEngine(SpgemmConfig(method="hash", fuse_numeric=False))
    dense, B = _pair(51, m, k, n, 3.0, 3.0)
    d_half = np.asarray(dense.to_dense()).copy()
    d_half[m // 2:] = 0.0                # bottom half all-zero rows
    cap_a = next_bucket(dense.capacity)
    variants = [dense.with_capacity(cap_a),
                CSR.from_dense(d_half, device="cpu").with_capacity(cap_a),
                CSR.from_dense(np.zeros((m, k), np.float32), device="cpu")
                .with_capacity(cap_a)]
    for A in variants * 2:               # cold + hot coverage per variant
        res = engine.execute(A, B)
        ref = oracle.execute(A, B)
        assert res.total_nnz == ref.total_nnz
        _bitwise_same(res.C, ref.C, ref.total_nnz)


# ---------------------------------------------------------------------------
# Against the reference package, and the fixed-order kernels on the card.
# ---------------------------------------------------------------------------

def test_fused_matches_reference_package():
    """The port's fused pipeline against the reference's (Pallas in
    interpret mode) on the pair of the bitwise-parity case: nnz, rpt and
    col exactly, values within the reference's tolerance."""
    A, B = _pair(7, 72, 96, 80, 5.0, 4.0)
    jA = jcsr.random_csr(jax.random.PRNGKey(7), 72, 96, avg_nnz_per_row=5.0)
    jB = jcsr.random_csr(jax.random.PRNGKey(107), 96, 80,
                         avg_nnz_per_row=4.0)
    np.testing.assert_array_equal(np.asarray(A.col), np.asarray(jA.col))
    sym_lad = symbolic_ladder(1.2)
    m = A.nrows
    sym_bn = bin_rows_for_ladder(nprod_into_rpt(A, B)[:m], sym_lad)
    jl = jsymbolic_ladder(1.2)
    jbn = jbin(jnprod(jA, jB)[:m], jl)
    cap = 4096
    C = spgemm_hash.fused_binned(A, B, sym_bn, sym_lad, nnz_capacity=cap)
    jC = jsh.fused_binned(jA, jB, jbn, jl, nnz_capacity=cap, interpret=True)
    nnz = int(jC.rpt[-1])
    assert nnz > 0
    np.testing.assert_array_equal(np.asarray(C.rpt), np.asarray(jC.rpt))
    np.testing.assert_array_equal(np.asarray(C.col)[:nnz],
                                  np.asarray(jC.col)[:nnz])
    np.testing.assert_allclose(np.asarray(C.val)[:nnz],
                               np.asarray(jC.val)[:nnz], **VAL_TOL)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hash kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture
def fixed_order():
    """torch.use_deterministic_algorithms(True) for the test, then the
    mode it found."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


def _sorted_rows(cols, vals, valid):
    """Each valid row's table sorted by column: (cols, vals)."""
    s, order = torch.sort(cols[valid], dim=1)
    return s, vals[valid].gather(1, order)


# Every populated rung of the default ladders on the bitwise pair, and one
# rung of each extended route (cluster, global), on the heavy rows.
_ROUTE_RUNGS = {"fused": (65536, 262144), "numeric": (32768, 524288)}


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["fused", "numeric"])
def test_cuda_fixed_order_kernels_match_cpu_bitwise(cuda_device, fixed_order,
                                                    kind):
    """Under torch.use_deterministic_algorithms(True) the wrapper launches
    the fixed-order kernel on every route (shared memory, cluster, global):
    each valid row's sorted columns AND values are the CPU plain version's
    bit for bit, and each launch is counted in ``launches_ordered``."""
    A, B = _pair(7, 72, 96, 80, 5.0, 4.0)
    GA, GB = A.to(cuda_device), B.to(cuda_device)
    m = A.nrows
    lad = symbolic_ladder(1.2) if kind == "fused" else numeric_ladder(2.0)
    sizes = (nprod_into_rpt(A, B)[:m] if kind == "fused"
             else esc.symbolic(A, B, prod_capacity=1 << 15)[:m])
    bn = bin_rows_for_ladder(sizes, lad)
    cases = []
    for b, t in enumerate(lad.table_sizes):
        if int(bn.bin_size[b]):
            rows, count = bn.rows_of_bin(b, 128)
            cases.append((rows, count.reshape(1), t, 128))
    heavy = torch.argsort(nprod_into_rpt(A, B)[:m],
                          descending=True)[:8].to(torch.int32)
    for t in _ROUTE_RUNGS[kind]:
        cases.append((heavy, torch.tensor([8], dtype=torch.int32), t, 8))
    fn = getattr(spgemm_hash, f"{kind}_bin_call")
    plain = getattr(spgemm_hash, f"{kind}_bin_plain")
    routes = set()
    for rows, count, t, cap in cases:
        args = (rows, count, A.rpt, A.col, A.val, B.rpt, B.col, B.val)
        gargs = tuple(x.to(cuda_device) for x in args[:2]) + (
            GA.rpt, GA.col, GA.val, GB.rpt, GB.col, GB.val)
        before = fn.launches_ordered
        k = fn(*gargs, t_size=t, rows_cap=cap, single_access=True)
        torch.cuda.synchronize()
        assert fn.launches_ordered == before + 1
        p = plain(*args, t_size=t, rows_cap=cap, single_access=True)
        kc, kv, pc, pv = ((k[0], k[1], p[0], p[1]) if kind == "numeric"
                          else (k[1], k[2], p[1], p[2]))
        if kind == "fused":
            assert torch.equal(k[0].cpu(), p[0])
        valid = torch.arange(cap) < count
        ks, kvs = _sorted_rows(kc.cpu(), kv.cpu(), valid)
        ps, pvs = _sorted_rows(pc, pv, valid)
        assert torch.equal(ks, ps)
        assert torch.equal(kvs.view(torch.int32), pvs.view(torch.int32))
        routes.add(spgemm_hash.rung_route(
            t, spgemm_hash.numeric_launch_geometry(t)[0]
            if kind == "numeric" else 1, True, cuda_device))
    assert routes == {"smem", "cluster", "global"}


@pytest.mark.gpu
@pytest.mark.parametrize("single_access", [True, False])
def test_cuda_fixed_order_fused_equals_two_pass_and_cpu(cuda_device,
                                                        fixed_order,
                                                        single_access):
    """The reference's bitwise fused-vs-two-pass parity on the card, under
    torch.use_deterministic_algorithms(True): fused == two-pass on the
    card, and both == the CPU's, bit for bit."""
    A, B = _pair(7, 72, 96, 80, 5.0, 4.0)
    GA, GB = A.to(cuda_device), B.to(cuda_device)
    sym_lad, num_lad = symbolic_ladder(1.2), numeric_ladder(2.0)
    C2, cap, sym_bn = _two_pass(A, B, sym_lad, num_lad, single_access)
    G2, gcap, gsym_bn = _two_pass(GA, GB, sym_lad, num_lad, single_access)
    G1 = _fused(GA, GB, sym_lad, gcap, gsym_bn, single_access=single_access)
    assert gcap == cap
    nnz = int(C2.rpt[-1])
    assert nnz > 0
    for G in (G1, G2):
        _bitwise_same(G.to("cpu"), C2, nnz)
