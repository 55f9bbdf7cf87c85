"""Port parity for the fused metadata workspace (``core/workspace.py``,
OpSparse §5.3) and the leased product expansion.

``bin_rows_into`` writes both binning passes into one int32 buffer; on the
CPU its pass 1 is the plain version of ``binning_histogram``.  It is held
against the reference's ``bin_rows_into`` cell for cell on both ladders,
with ``m = 0`` and the Alg-3 identity case (every row in bin 0) among the
inputs.  ``esc.expand_products(out=...)`` must give the arrays of the
unleased call bit for bit.  The ``gpu`` tests do the same on the card,
where pass 1 is the CUDA kernel, and skip without one.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import csr as jcsr
from repro.core import numeric_ladder as jnumeric_ladder
from repro.core import symbolic_ladder as jsymbolic_ladder
from repro.core import workspace as jworkspace
from repro_torch import convert
from repro_torch.core import esc
from repro_torch.core.binning import bin_rows
from repro_torch.core.workspace import (WorkspacePlan, bin_rows_into,
                                        binning_from_buffer)
from repro_torch.kernels.binning_histogram import binning_histogram

LADDERS = {"symbolic": jsymbolic_ladder(1.2), "numeric": jnumeric_ladder(2.0)}


def _port(A, device="cpu"):
    return convert.csr_from_reference(np.asarray(A.rpt), np.asarray(A.col),
                                      np.asarray(A.val), A.shape,
                                      device=device)


def _sizes(m, kind, lad, seed=0):
    rng = np.random.default_rng(seed + m)
    if kind == "identity":            # Alg 3: every row fits bin 0
        return rng.integers(0, lad.upper[0] + 1, m, dtype=np.int32)
    return rng.integers(0, 30000, m, dtype=np.int32)


def _reference_buffer(sizes, lad):
    m = sizes.shape[0]
    wp = jworkspace.WorkspacePlan(m, lad.num_bins)
    buf = jworkspace.bin_rows_into(jnp.asarray(sizes), wp.alloc(),
                                   upper=lad.upper, num_bins=lad.num_bins,
                                   m=m)
    return np.asarray(buf), wp


@pytest.mark.parametrize("ladder", list(LADDERS))
@pytest.mark.parametrize("m,kind", [(0, "random"), (7, "random"),
                                    (256, "random"), (1000, "random"),
                                    (300, "identity")])
def test_bin_rows_into_matches_reference(ladder, m, kind):
    lad = LADDERS[ladder]
    sizes = _sizes(m, kind, lad)
    want, jwp = _reference_buffer(sizes, lad)
    wp = WorkspacePlan(m, lad.num_bins)
    assert wp.size == jwp.size == m + 2 * lad.num_bins + 1
    buf = wp.alloc("cpu")
    ptr = buf.data_ptr()
    out = bin_rows_into(torch.from_numpy(sizes), buf, upper=lad.upper,
                        num_bins=lad.num_bins, m=m)
    assert out is buf and buf.data_ptr() == ptr     # written in place
    np.testing.assert_array_equal(buf.numpy(), want)  # cell for cell
    if kind == "identity":
        np.testing.assert_array_equal(buf[:m].numpy(), np.arange(m))
        assert int(buf[m]) == m

    got = binning_from_buffer(buf, torch.from_numpy(sizes), wp, lad.upper)
    ref = jworkspace.binning_from_buffer(jnp.asarray(want),
                                         jnp.asarray(sizes), jwp, lad.upper)
    for name in ("bins", "bin_size", "bin_offset", "bin_of_row",
                 "max_size"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)), name)
    views = wp.views(buf)
    assert views.bin_size.data_ptr() == buf[m:].data_ptr()
    assert int(views.max_size) == (int(sizes.max()) if m else 0)


def test_bin_rows_into_matches_bin_rows():
    lad = LADDERS["symbolic"]
    sizes = torch.from_numpy(_sizes(500, "random", lad))
    buf = bin_rows_into(sizes, WorkspacePlan(500, lad.num_bins).alloc("cpu"),
                        upper=lad.upper, num_bins=lad.num_bins, m=500)
    want = bin_rows(sizes, upper=lad.upper, num_bins=lad.num_bins)
    got = binning_from_buffer(buf, sizes, WorkspacePlan(500, lad.num_bins),
                              lad.upper)
    for name in ("bins", "bin_size", "bin_offset", "bin_of_row"):
        assert torch.equal(getattr(got, name).long(),
                           getattr(want, name).long()), name
    assert int(got.max_size) == int(want.max_size)


def test_bin_rows_into_rejects_a_wrong_buffer():
    lad = LADDERS["numeric"]
    sizes = torch.zeros(10, dtype=torch.int32)
    for bad in (torch.zeros(10 + 2 * lad.num_bins, dtype=torch.int32),
                torch.zeros(11 + 2 * lad.num_bins, dtype=torch.int64)):
        with pytest.raises(ValueError):
            bin_rows_into(sizes, bad, upper=lad.upper,
                          num_bins=lad.num_bins, m=10)
    with pytest.raises(ValueError):
        binning_histogram(sizes, upper=lad.upper, num_bins=lad.num_bins,
                          out=(torch.zeros(2, dtype=torch.int32),
                               torch.zeros((), dtype=torch.int32)))


def _operands(seed, device="cpu"):
    A = jcsr.random_csr(seed, 64, 80, avg_nnz_per_row=6.0,
                        distribution="powerlaw")
    B = jcsr.random_csr(seed + 1, 80, 72, avg_nnz_per_row=5.0,
                        distribution="powerlaw")
    return _port(A, device), _port(B, device)


def _leased_equals_unleased(A, B, cap):
    """expand_products into an oversized lease (the pow-2 buckets of the
    arena) against the plain call, bit for bit, and the three ESC
    entry points with and without the lease."""
    dev = A.device
    i32 = torch.full((4 * cap,), -7, dtype=torch.int32, device=dev)
    val = torch.full((2 * cap,), -7.0, dtype=torch.float32, device=dev)
    want = esc.expand_products(A, B, prod_capacity=cap)
    got = esc.expand_products(A, B, prod_capacity=cap, out=(i32, val))
    assert got[0].data_ptr() == i32.data_ptr()
    assert got[1].data_ptr() == i32[cap:].data_ptr()
    assert got[2].data_ptr() == val.data_ptr()
    for w, g in zip(want, got):
        assert torch.equal(w, g)
    nnz = esc.symbolic(A, B, prod_capacity=cap)
    assert torch.equal(nnz, esc.symbolic(A, B, prod_capacity=cap,
                                         workspace=(i32, val)))
    rpt = torch.zeros_like(nnz)
    rpt[1:] = torch.cumsum(nnz[:-1], 0)
    kw = dict(prod_capacity=cap, nnz_capacity=cap)
    for C0, C1 in (
            (esc.numeric(A, B, rpt, **kw),
             esc.numeric(A, B, rpt, workspace=(i32, val), **kw)),
            (esc.spgemm_fused(A, B, **kw),
             esc.spgemm_fused(A, B, workspace=(i32, val), **kw))):
        for name in ("rpt", "col", "val"):
            assert torch.equal(getattr(C0, name), getattr(C1, name)), name


def test_expand_products_into_lease_is_bit_equal():
    A, B = _operands(3)
    _leased_equals_unleased(A, B, 4096)


def test_expand_products_rejects_a_short_lease():
    A, B = _operands(5)
    cap = 4096
    with pytest.raises(ValueError):
        esc.expand_products(A, B, prod_capacity=cap,
                            out=(torch.empty(2 * cap - 1, dtype=torch.int32),
                                 torch.empty(cap)))
    with pytest.raises(ValueError):
        esc.expand_products(A, B, prod_capacity=cap,
                            out=(torch.empty(2 * cap, dtype=torch.int32),
                                 torch.empty(cap, dtype=torch.float64)))


# ---------------------------------------------------------------------------
# On the card (skip without one).
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("ladder", list(LADDERS))
@pytest.mark.parametrize("m,kind", [(0, "random"), (1000, "random"),
                                    (70000, "random"), (300, "identity")])
def test_bin_rows_into_kernel_matches_plain(cuda_device, ladder, m, kind):
    lad = LADDERS[ladder]
    sizes = torch.from_numpy(_sizes(m, kind, lad))
    wp = WorkspacePlan(m, lad.num_bins)
    want = bin_rows_into(sizes, wp.alloc("cpu"), upper=lad.upper,
                         num_bins=lad.num_bins, m=m)
    before = binning_histogram.launches
    buf = wp.alloc(cuda_device)
    got = bin_rows_into(sizes.to(cuda_device), buf, upper=lad.upper,
                        num_bins=lad.num_bins, m=m)
    assert got.is_cuda and got.data_ptr() == buf.data_ptr()
    assert binning_histogram.launches == before + (1 if m else 0)
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
def test_expand_products_into_lease_is_bit_equal_on_card(cuda_device):
    A, B = _operands(3, device=cuda_device)
    _leased_equals_unleased(A, B, 4096)
