"""Port parity: CSR container, generator, setup analysis and conversion.

The same int seeds build the same matrices in both packages; data moves
between them as numpy arrays.  Integer results must match exactly.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import analysis as jan
from repro.core import csr as jcsr
from repro_torch import convert
from repro_torch.core import analysis as tan
from repro_torch.core import csr as tcsr
from repro_torch.core.binning_ranges import (NUMERIC_TABLE_SIZES,
                                             SYMBOLIC_TABLE_SIZES,
                                             numeric_ladder, symbolic_ladder)
from repro_torch.core.workspace import next_bucket


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _port(A):
    """The reference CSR carried to the port (CPU) as numpy arrays."""
    return convert.csr_from_reference(np.asarray(A.rpt), np.asarray(A.col),
                                      np.asarray(A.val), A.shape,
                                      device="cpu")


@pytest.mark.parametrize("dist", ["uniform", "powerlaw", "banded"])
@pytest.mark.parametrize("shape", [(16, 16, 3.0), (64, 96, 6.0),
                                   (96, 40, 9.0)])
def test_random_csr_bit_for_bit(dist, shape):
    m, n, avg = shape
    seed = 1000 + m + n
    J = jcsr.random_csr(seed, m, n, avg_nnz_per_row=avg, distribution=dist)
    T = tcsr.random_csr(seed, m, n, avg_nnz_per_row=avg, distribution=dist,
                        device="cpu")
    assert T.shape == J.shape
    assert T.rpt.dtype == torch.int32 and T.col.dtype == torch.int32
    np.testing.assert_array_equal(_np(T.rpt), np.asarray(J.rpt))
    np.testing.assert_array_equal(_np(T.col), np.asarray(J.col))
    np.testing.assert_array_equal(_np(T.val), np.asarray(J.val))


def test_random_csr_max_nnz_clip():
    J = jcsr.random_csr(7, 80, 90, avg_nnz_per_row=12.0, max_nnz_per_row=20,
                        distribution="powerlaw")
    T = tcsr.random_csr(7, 80, 90, avg_nnz_per_row=12.0, max_nnz_per_row=20,
                        distribution="powerlaw", device="cpu")
    np.testing.assert_array_equal(_np(T.rpt), np.asarray(J.rpt))
    assert int(T.nnz_per_row().max()) <= 20


def test_unknown_distribution_raises():
    with pytest.raises(ValueError):
        tcsr.random_csr(1, 4, 4, avg_nnz_per_row=1.0, distribution="zipf",
                        device="cpu")


def test_row_methods_match_reference():
    J = jcsr.random_csr(3, 40, 50, avg_nnz_per_row=5.0).with_capacity(512)
    T = _port(J)
    assert T.capacity == J.capacity == 512
    assert int(T.nnz()) == int(J.nnz())
    np.testing.assert_array_equal(_np(T.nnz_per_row()),
                                  np.asarray(J.nnz_per_row()))
    np.testing.assert_array_equal(_np(T.entry_mask()),
                                  np.asarray(J.entry_mask()))
    np.testing.assert_array_equal(_np(T.row_ids()), np.asarray(J.row_ids()))
    np.testing.assert_allclose(_np(T.to_dense()), np.asarray(J.to_dense()),
                               rtol=0, atol=0)


@pytest.mark.parametrize("cap", [64, 300, 1024])
def test_with_capacity_matches_reference(cap):
    J = jcsr.random_csr(4, 30, 30, avg_nnz_per_row=6.0)
    T = _port(J)
    Jc, Tc = J.with_capacity(cap), T.with_capacity(cap)
    assert Tc.capacity == cap
    np.testing.assert_array_equal(_np(Tc.col), np.asarray(Jc.col))
    np.testing.assert_array_equal(_np(Tc.val), np.asarray(Jc.val))


def test_from_dense_round_trip():
    rng = np.random.default_rng(0)
    d = rng.standard_normal((24, 18)).astype(np.float32)
    d[rng.random(d.shape) < 0.7] = 0
    d[3] = 0                                    # an all-zero row
    J = jcsr.CSR.from_dense(d)
    T = tcsr.CSR.from_dense(d, device="cpu")
    np.testing.assert_array_equal(_np(T.rpt), np.asarray(J.rpt))
    np.testing.assert_array_equal(_np(T.col), np.asarray(J.col))
    np.testing.assert_array_equal(_np(T.to_dense()), d)
    E = tcsr.CSR.from_dense(np.zeros((5, 5), np.float32), device="cpu")
    assert E.capacity == 1 and int(E.nnz()) == 0


def test_from_numpy_to_numpy_and_convert_round_trip():
    J = jcsr.random_csr(11, 20, 33, avg_nnz_per_row=4.0)
    T = _port(J)
    rpt, col, val, shape = convert.csr_to_numpy(T)
    np.testing.assert_array_equal(rpt, np.asarray(J.rpt))
    np.testing.assert_array_equal(col, np.asarray(J.col))
    np.testing.assert_array_equal(val, np.asarray(J.val))
    assert shape == J.shape
    T2 = convert.csr_from_reference(rpt, col, val, shape, device="cpu")
    for a, b in zip(T2.to_numpy(), T.to_numpy()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 5])
def test_gather_rows_matches_reference(seed):
    J = jcsr.random_csr(seed, 48, 40, avg_nnz_per_row=6.0,
                        distribution="powerlaw")
    T = _port(J)
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 48, size=16).astype(np.int32)
    valid = rng.random(16) < 0.7
    rows_padded = np.where(valid, rows, 48).astype(np.int32)
    Js = jcsr.gather_rows(J, jnp.asarray(rows_padded), jnp.asarray(valid))
    Ts = tcsr.gather_rows(T, torch.from_numpy(rows_padded),
                          torch.from_numpy(valid))
    for a, b in ((Ts.rpt, Js.rpt), (Ts.col, Js.col), (Ts.val, Js.val)):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    assert Ts.shape == Js.shape


@pytest.mark.parametrize("dist", ["uniform", "powerlaw"])
def test_setup_analysis_matches_reference(dist):
    A = jcsr.random_csr(21, 64, 80, avg_nnz_per_row=6.0,
                        distribution=dist).with_capacity(512)
    B = jcsr.random_csr(121, 80, 70, avg_nnz_per_row=5.0,
                        distribution=dist)
    TA, TB = _port(A), _port(B)
    np.testing.assert_array_equal(_np(tan.nprod_per_entry(TA, TB)),
                                  np.asarray(jan.nprod_per_entry(A, B)))
    buf_t = tan.nprod_into_rpt(TA, TB)
    buf_j = jan.nprod_into_rpt(A, B)
    assert buf_t.dtype == torch.int32
    np.testing.assert_array_equal(_np(buf_t), np.asarray(buf_j))
    assert int(tan.total_nprod(TA, TB)) == int(jan.total_nprod(A, B))
    np.testing.assert_array_equal(_np(tan.exclusive_sum_in_place(buf_t)),
                                  np.asarray(jan.exclusive_sum_in_place(buf_j)))


def test_compression_ratio_matches_reference():
    from repro.core import spgemm as jspgemm
    from repro.core.spgemm import SpgemmConfig as JConfig
    from repro.engine import reset_default_engine as jreset
    from repro_torch.core.spgemm import SpgemmConfig, spgemm
    from repro_torch.engine import reset_default_engine
    A = jcsr.random_csr(8, 30, 30, avg_nnz_per_row=4.0)
    jreset()
    reset_default_engine()
    Cj = jspgemm(A, A, JConfig()).C
    TA = _port(A)
    Ct = spgemm(TA, TA, SpgemmConfig()).C
    assert tan.compression_ratio(TA, TA, Ct) == pytest.approx(
        jan.compression_ratio(A, A, Cj))


def test_workspace_and_ladders_match_reference():
    from repro.core import binning_ranges as jbr
    from repro.core.workspace import next_bucket as jnext
    for n in (0, 1, 7, 8, 9, 16, 17, 1000, 2 ** 20 + 1):
        for lo in (8, 16):
            assert next_bucket(n, minimum=lo) == jnext(n, minimum=lo)
    assert SYMBOLIC_TABLE_SIZES == jbr.SYMBOLIC_TABLE_SIZES
    assert NUMERIC_TABLE_SIZES == jbr.NUMERIC_TABLE_SIZES
    for ext in (False, True):
        assert dataclasses.astuple(symbolic_ladder(1.2, vmem_extended=ext)) \
            == dataclasses.astuple(jbr.symbolic_ladder(1.2,
                                                       vmem_extended=ext))
        assert dataclasses.astuple(numeric_ladder(2.0, vmem_extended=ext)) \
            == dataclasses.astuple(jbr.numeric_ladder(2.0,
                                                      vmem_extended=ext))


def test_default_device_is_the_card():
    """Entry points default to CUDA.  Without a card they raise instead of
    falling back to the CPU; with one they build on it."""
    d = np.eye(4, dtype=np.float32)
    if torch.cuda.is_available():
        assert tcsr.random_csr(1, 8, 8, avg_nnz_per_row=2.0).device.type \
            == "cuda"
        assert tcsr.CSR.from_dense(d).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcsr.random_csr(1, 8, 8, avg_nnz_per_row=2.0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcsr.CSR.from_dense(d)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcsr.CSR.from_numpy([0, 1], [0], [1.0], (1, 1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.csr_from_reference([0, 1], [0], [1.0], (1, 1))
