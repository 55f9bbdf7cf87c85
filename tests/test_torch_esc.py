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
