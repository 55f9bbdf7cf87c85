"""Port parity: the ESC accumulator (expand–sort–compress)."""
import numpy as np
import pytest
import torch

from repro.core import csr as jcsr
from repro.core import esc as jesc
from repro.core.analysis import exclusive_sum_in_place as jexcl
from repro_torch import convert
from repro_torch.core import esc as tesc
from repro_torch.core.analysis import exclusive_sum_in_place as texcl
from repro_torch.kernels import ref as tref

VAL_TOL = dict(rtol=1e-5, atol=1e-5)   # tests/test_kernels_spgemm_hash.py:56

SHAPES = [(16, 16, 16, 2.0, 2.0, "uniform"),
          (48, 32, 64, 4.0, 3.0, "powerlaw"),
          (64, 64, 64, 6.0, 6.0, "uniform"),
          (96, 80, 70, 8.0, 5.0, "powerlaw")]


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _port(A):
    return convert.csr_from_reference(np.asarray(A.rpt), np.asarray(A.col),
                                      np.asarray(A.val), A.shape,
                                      device="cpu")


def _pair(seed, m, k, n, da, db, dist):
    A = jcsr.random_csr(seed, m, k, avg_nnz_per_row=da, distribution=dist)
    B = jcsr.random_csr(seed + 100, k, n, avg_nnz_per_row=db,
                        distribution=dist)
    return A, B


@pytest.mark.parametrize("with_values", [True, False])
@pytest.mark.parametrize("shape", SHAPES[:2])
def test_expand_products_matches_reference(shape, with_values):
    A, B = _pair(3, *shape)
    A = A.with_capacity(1024)
    cap = 4096
    jr, jc, jv, jvalid = jesc.expand_products(A, B, prod_capacity=cap,
                                              with_values=with_values)
    tr, tc, tv, tvalid = tesc.expand_products(_port(A), _port(B),
                                              prod_capacity=cap,
                                              with_values=with_values)
    np.testing.assert_array_equal(_np(tr), np.asarray(jr))
    np.testing.assert_array_equal(_np(tc), np.asarray(jc))
    np.testing.assert_array_equal(_np(tvalid), np.asarray(jvalid))
    if with_values:
        np.testing.assert_array_equal(_np(tv), np.asarray(jv))
    else:
        assert tv is None and jv is None


@pytest.mark.parametrize("shape", SHAPES)
def test_symbolic_numeric_match_reference(shape):
    A, B = _pair(7, *shape)
    TA, TB = _port(A), _port(B)
    cap = 8192
    jbuf = jesc.symbolic(A, B, prod_capacity=cap)
    tbuf = tesc.symbolic(TA, TB, prod_capacity=cap)
    assert tbuf.dtype == torch.int32
    np.testing.assert_array_equal(_np(tbuf), np.asarray(jbuf))
    np.testing.assert_array_equal(_np(tbuf[:-1]),
                                  tref.row_nnz_from_support(TA, TB))
    nnz_cap = 4096
    jC = jesc.numeric(A, B, jexcl(jbuf), prod_capacity=cap,
                      nnz_capacity=nnz_cap)
    tC = tesc.numeric(TA, TB, texcl(tbuf), prod_capacity=cap,
                      nnz_capacity=nnz_cap)
    np.testing.assert_array_equal(_np(tC.rpt), np.asarray(jC.rpt))
    np.testing.assert_array_equal(_np(tC.col), np.asarray(jC.col))
    np.testing.assert_allclose(_np(tC.val), np.asarray(jC.val), **VAL_TOL)
    np.testing.assert_allclose(_np(tC.to_dense()),
                               _np(tref.spgemm_dense_ref(TA, TB)), **VAL_TOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_spgemm_fused_matches_reference(shape):
    A, B = _pair(13, *shape)
    cap, nnz_cap = 8192, 4096
    jC = jesc.spgemm_fused(A, B, prod_capacity=cap, nnz_capacity=nnz_cap)
    tC = tesc.spgemm_fused(_port(A), _port(B), prod_capacity=cap,
                           nnz_capacity=nnz_cap)
    assert tC.capacity == nnz_cap
    np.testing.assert_array_equal(_np(tC.rpt), np.asarray(jC.rpt))
    np.testing.assert_array_equal(_np(tC.col), np.asarray(jC.col))
    np.testing.assert_allclose(_np(tC.val), np.asarray(jC.val), **VAL_TOL)


def test_capacity_overflow_drops_like_reference():
    """Keys past nnz_capacity and products past prod_capacity are dropped
    as the reference drops them (mode="drop")."""
    A, B = _pair(5, 32, 40, 48, 6.0, 5.0, "uniform")
    jbuf = jesc.symbolic(A, B, prod_capacity=8192)
    total = int(jbuf.sum())
    small = max(total // 2, 1)
    jC = jesc.spgemm_fused(A, B, prod_capacity=8192, nnz_capacity=small)
    tC = tesc.spgemm_fused(_port(A), _port(B), prod_capacity=8192,
                           nnz_capacity=small)
    np.testing.assert_array_equal(_np(tC.col), np.asarray(jC.col))
    np.testing.assert_allclose(_np(tC.val), np.asarray(jC.val), **VAL_TOL)
    jC2 = jesc.spgemm_fused(A, B, prod_capacity=256, nnz_capacity=4096)
    tC2 = tesc.spgemm_fused(_port(A), _port(B), prod_capacity=256,
                            nnz_capacity=4096)
    np.testing.assert_array_equal(_np(tC2.rpt), np.asarray(jC2.rpt))
    np.testing.assert_array_equal(_np(tC2.col), np.asarray(jC2.col))
    np.testing.assert_allclose(_np(tC2.val), np.asarray(jC2.val), **VAL_TOL)


def test_all_zero_rows_and_empty_product():
    d = np.zeros((12, 10), np.float32)
    d[2, 3] = 1.5
    d[7, [0, 9]] = [2.0, -1.0]
    A = jcsr.CSR.from_dense(d)
    B = jcsr.CSR.from_dense(np.zeros((10, 6), np.float32))
    jbuf = jesc.symbolic(A, B, prod_capacity=64)
    tbuf = tesc.symbolic(_port(A), _port(B), prod_capacity=64)
    np.testing.assert_array_equal(_np(tbuf), np.asarray(jbuf))
    assert int(tbuf.sum()) == 0
    At = _port(jcsr.CSR.from_dense(d.T))
    tC = tesc.spgemm_fused(_port(A), At, prod_capacity=64, nnz_capacity=64)
    np.testing.assert_allclose(_np(tC.to_dense()), d @ d.T, **VAL_TOL)


# ---------------------------------------------------------------------------
# Each key's products summed in order, in either mode.
# ---------------------------------------------------------------------------

def _segments(seed=0, n=400):
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 40, size=n)
    vals = (rng.standard_normal(int(lens.sum()))
            * 10.0 ** rng.integers(-3, 4, int(lens.sum()))).astype(np.float32)
    offs = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    return vals, offs


def test_segment_sum_is_the_references_scatter_add():
    """segment_sum (the plain version on the CPU) gives every segment the
    reference's in-order scatter-add sum bit for bit, and 0 past n_real."""
    import jax.numpy as jnp
    from repro_torch.kernels.segment_sum import segment_sum
    vals, offs = _segments()
    n = offs.shape[0] - 1
    seg = np.repeat(np.arange(n), np.diff(offs))
    want = np.asarray(jnp.zeros(n, jnp.float32).at[seg].add(vals))
    got = segment_sum(torch.from_numpy(vals), torch.from_numpy(offs),
                      n_real=n - 1)
    np.testing.assert_array_equal(_np(got)[:n - 1].view(np.int32),
                                  want[:n - 1].view(np.int32))
    assert float(got[n - 1]) == 0.0


@pytest.mark.parametrize("deterministic", [False, True],
                         ids=["default", "deterministic"])
@pytest.mark.parametrize("shape", SHAPES[1:])
def test_esc_matches_reference_bitwise(shape, deterministic):
    """With or without torch.use_deterministic_algorithms(True) the port's
    ESC values are the reference's bit for bit (its scatter-add's
    order)."""
    A, B = _pair(5, *shape)
    cap = 8192
    jC = jesc.spgemm_fused(A, B, prod_capacity=cap, nnz_capacity=cap)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(deterministic)
    try:
        tC = tesc.spgemm_fused(_port(A), _port(B), prod_capacity=cap,
                               nnz_capacity=cap)
    finally:
        torch.use_deterministic_algorithms(was)
    nnz = int(jC.rpt[-1])
    np.testing.assert_array_equal(_np(tC.rpt), np.asarray(jC.rpt))
    np.testing.assert_array_equal(_np(tC.col)[:nnz], np.asarray(jC.col)[:nnz])
    np.testing.assert_array_equal(_np(tC.val)[:nnz].view(np.int32),
                                  np.asarray(jC.val)[:nnz].view(np.int32))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: segment_sum's kernel has no CPU "
                    "mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_segment_sum_matches_plain_bitwise(cuda_device):
    from repro_torch.kernels.segment_sum import (segment_sum,
                                                 segment_sum_plain)
    vals, offs = _segments(1, 5000)
    v, o = torch.from_numpy(vals), torch.from_numpy(offs)
    n = o.shape[0] - 1
    before = segment_sum.launches
    got = segment_sum(v.to(cuda_device), o.to(cuda_device), n_real=n - 1)
    torch.cuda.synchronize()
    assert segment_sum.launches == before + 1
    want = segment_sum_plain(v, o, n_real=n - 1)
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


@pytest.mark.gpu
def test_cuda_esc_fixed_order_matches_cpu_bitwise(cuda_device):
    """ESC on the card in the fixed-order mode: C bit for bit the CPU's."""
    A, B = _pair(5, *SHAPES[3])
    TA, TB = _port(A), _port(B)
    GA, GB = TA.to(cuda_device), TB.to(cuda_device)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        C = tesc.spgemm_fused(TA, TB, prod_capacity=8192, nnz_capacity=8192)
        G = tesc.spgemm_fused(GA, GB, prod_capacity=8192, nnz_capacity=8192)
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(was)
    nnz = int(C.rpt[-1])
    assert torch.equal(G.rpt.cpu(), C.rpt)
    assert torch.equal(G.col.cpu()[:nnz], C.col[:nnz])
    assert torch.equal(G.val.cpu()[:nnz].view(torch.int32),
                       C.val[:nnz].view(torch.int32))


def _drop_scatter_case(seed=2, n=20000, limit=5000):
    """Writes to distinct targets below ``limit`` and dropped writes aimed
    at the dump slot ``limit`` (the port's pattern)."""
    rng = np.random.default_rng(seed)
    keep = rng.random(n) < 0.2
    targets = rng.permutation(limit)
    index = np.full(n, limit, np.int64)
    kept = np.flatnonzero(keep)[:limit]
    index[kept] = targets[:kept.size]
    return (torch.from_numpy(index),
            torch.from_numpy(rng.standard_normal(n).astype(np.float32)),
            torch.from_numpy(rng.integers(0, 3, n).astype(np.int32)))


def test_scatter_kept_and_count_into_match_the_torch_ops_in_both_modes():
    """kernels/scatter on the CPU, with or without
    torch.use_deterministic_algorithms(True): the values of the torch ops
    below the dump slot."""
    from repro_torch.kernels import scatter
    index, vals, counts = _drop_scatter_case()
    limit = 5000
    want_v = torch.zeros(limit + 1)
    want_v[index] = vals
    want_c = torch.zeros(limit + 1, dtype=torch.int32).index_add_(
        0, index, counts)
    was = torch.are_deterministic_algorithms_enabled()
    try:
        for mode in (False, True):
            torch.use_deterministic_algorithms(mode)
            got_v = scatter.scatter_kept(torch.zeros(limit + 1), index,
                                         vals, limit=limit)
            got_c = scatter.count_into(
                torch.zeros(limit + 1, dtype=torch.int32), index, counts,
                limit=limit)
            assert torch.equal(got_v[:limit], want_v[:limit])
            assert torch.equal(got_c[:limit], want_c[:limit])
    finally:
        torch.use_deterministic_algorithms(was)


@pytest.mark.gpu
def test_cuda_scatter_kernels_match_plain(cuda_device):
    """scatter_kept and count_into on the card against their plain
    versions below the dump slot, each launch counted."""
    from repro_torch.kernels import scatter
    index, vals, counts = _drop_scatter_case(3, 200000, 40000)
    limit = 40000
    for fn, plain, src, dtype in (
            (scatter.scatter_kept, scatter.scatter_kept_plain, vals,
             torch.float32),
            (scatter.count_into, scatter.count_into_plain, counts,
             torch.int32)):
        want = plain(torch.zeros(limit + 1, dtype=dtype), index, src,
                     limit=limit)
        before = fn.launches
        got = fn(torch.zeros(limit + 1, dtype=dtype, device=cuda_device),
                 index.to(cuda_device), src.to(cuda_device), limit=limit)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        assert torch.equal(got[:limit].cpu(), want[:limit])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16,
                                   torch.int16])
def test_cuda_scatter_kept_moves_each_element_width(cuda_device, dtype):
    """scatter_kept on 8- and 2-byte elements, as bits."""
    from repro_torch.kernels import scatter
    index, vals, _ = _drop_scatter_case(4, 50000, 10000)
    limit = 10000
    src = (vals * 100).to(dtype)
    want = scatter.scatter_kept_plain(torch.zeros(limit + 1, dtype=dtype),
                                      index, src, limit=limit)
    got = scatter.scatter_kept(
        torch.zeros(limit + 1, dtype=dtype, device=cuda_device),
        index.to(cuda_device), src.to(cuda_device), limit=limit)
    assert torch.equal(got[:limit].cpu(), want[:limit])


@pytest.mark.gpu
def test_cuda_count_into_on_sorted_runs(cuda_device):
    """count_into on sorted indices (runs of one target across and within
    warps, the dropped ones at the end), as ESC's counts arrive."""
    from repro_torch.kernels import scatter
    rng = np.random.default_rng(5)
    limit = 2048
    index = np.sort(rng.integers(0, limit + 1, 300001)).astype(np.int64)
    counts = rng.integers(0, 2, index.shape[0]).astype(np.int32)
    idx, src = torch.from_numpy(index), torch.from_numpy(counts)
    want = scatter.count_into_plain(
        torch.zeros(limit + 1, dtype=torch.int32), idx, src, limit=limit)
    got = scatter.count_into(
        torch.zeros(limit + 1, dtype=torch.int32, device=cuda_device),
        idx.to(cuda_device), src.to(cuda_device), limit=limit)
    assert torch.equal(got[:limit].cpu(), want[:limit])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16,
                                   torch.float16])
def test_cuda_segment_sum_other_dtypes_match_plain_bitwise(cuda_device,
                                                          dtype):
    from repro_torch.kernels.segment_sum import (segment_sum,
                                                 segment_sum_plain)
    vals, offs = _segments(2, 3000)
    v = torch.from_numpy(vals / 1000).to(dtype)
    o = torch.from_numpy(offs)
    n = o.shape[0] - 1
    got = segment_sum(v.to(cuda_device), o.to(cuda_device), n_real=n - 1)
    want = segment_sum_plain(v, o, n_real=n - 1)
    assert got.dtype == dtype
    assert torch.equal(got.cpu(), want)
