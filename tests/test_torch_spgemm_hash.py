"""Port parity: the three hash-table kernels and their drivers.

On the CPU each kernel wrapper runs its plain version, which must
reproduce the reference's Pallas kernels (run in interpret mode, as the
reference's own tests run them) exactly: nnz, the raw tables (the first
``t_size`` entries of each sub-table) and the access counts; values within
the tolerance of ``tests/test_kernels_spgemm_hash.py:56``.  The CUDA
kernels themselves are held against the plain versions on the card by the
``gpu`` tests below and by ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import csr as jcsr
from repro.core import esc as jesc
from repro.core.analysis import exclusive_sum_in_place as jexcl
from repro.core.analysis import nprod_into_rpt as jnprod
from repro.core.binning import bin_rows_for_ladder as jbin
from repro.core.binning_ranges import make_ladder as jladder
from repro.kernels import spgemm_hash as jsh
from repro_torch import convert
from repro_torch.core.analysis import exclusive_sum_in_place as texcl
from repro_torch.core.analysis import nprod_into_rpt as tnprod
from repro_torch.core.binning import bin_rows_for_ladder as tbin
from repro_torch.core.binning_ranges import make_ladder, symbolic_ladder
from repro_torch.kernels import spgemm_hash as tsh

VAL_TOL = dict(rtol=1e-5, atol=1e-5)   # tests/test_kernels_spgemm_hash.py:56
SYM = ((32, 64, 128), 1.2, (32, 64, 128))      # every rung + fallback
NUM = ((16, 32, 64), 2.0, (15, 31, 63))        # mod-path tables


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _port(A, device="cpu"):
    return convert.csr_from_reference(np.asarray(A.rpt), np.asarray(A.col),
                                      np.asarray(A.val), A.shape,
                                      device=device)


def _pair():
    """96x96 powerlaw pair whose rows fill every rung of SYM and NUM, plus
    the fallback rung of each."""
    A = jcsr.random_csr(3, 96, 96, avg_nnz_per_row=5.0,
                        distribution="powerlaw")
    B = jcsr.random_csr(103, 96, 96, avg_nnz_per_row=4.0,
                        distribution="powerlaw")
    return A, B


def _zero_row_pair():
    """A with all-zero rows and rows that only hit empty rows of B."""
    rng = np.random.default_rng(4)
    a = rng.standard_normal((40, 30)).astype(np.float32)
    a[rng.random(a.shape) < 0.8] = 0
    a[[0, 5, 17]] = 0
    b = rng.standard_normal((30, 36)).astype(np.float32)
    b[rng.random(b.shape) < 0.7] = 0
    b[[2, 3, 11]] = 0
    a[9] = 0
    a[9, [2, 3, 11]] = 1.0                      # products: none
    return jcsr.CSR.from_dense(a), jcsr.CSR.from_dense(b)


def _bins(A, B, lad, sizes=None):
    """Reference and port binnings by n_prod (or by ``sizes``)."""
    m = A.nrows
    js = jnprod(A, B)[:m] if sizes is None else jnp.asarray(sizes)
    ts = torch.from_numpy(np.asarray(js).copy())
    return (jbin(js, jladder(*lad)), tbin(ts, make_ladder(*lad)))


def _rung_inputs(jb, tb, b, rows_cap):
    jr, jc = jb.rows_of_bin(b, rows_cap)
    tr, tc = tb.rows_of_bin(b, rows_cap)
    np.testing.assert_array_equal(_np(tr), np.asarray(jr))
    return jr, jc.reshape(1), tr, tc.reshape(1)


def _populated(jb, lad):
    sizes = np.asarray(jb.bin_size)
    rungs = [b for b in range(len(lad[0])) if sizes[b]]
    return rungs, sizes


@pytest.mark.parametrize("single_access", [True, False])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("kind", ["symbolic", "fused"])
def test_sym_ladder_kernels_match_reference_exactly(kind, packed,
                                                    single_access):
    A, B = _pair()
    TA, TB = _port(A), _port(B)
    jb, tb = _bins(A, B, SYM)
    rungs, sizes = _populated(jb, SYM)
    assert rungs == [0, 1, 2] and sizes[-1] > 0
    lad = make_ladder(*SYM)
    for b in rungs:
        t = SYM[2][b]
        rows_cap = 128
        pack = lad.rows_per_block[b] if packed else 1
        jr, jc, tr, tc = _rung_inputs(jb, tb, b, rows_cap)
        if kind == "symbolic":
            jn, ja = jsh.symbolic_bin_call(
                jr, jc, A.rpt, A.col, B.rpt, B.col, t_size=t,
                rows_cap=rows_cap, pack=pack, single_access=single_access,
                interpret=True)
            tn, ta = tsh.symbolic_bin_call(
                tr, tc, TA.rpt, TA.col, TB.rpt, TB.col, t_size=t,
                rows_cap=rows_cap, pack=pack, single_access=single_access)
        else:
            jn, jcol, jval, ja = jsh.fused_bin_call(
                jr, jc, A.rpt, A.col, A.val, B.rpt, B.col, B.val, t_size=t,
                rows_cap=rows_cap, pack=pack, single_access=single_access,
                interpret=True)
            tn, tcol, tval, ta = tsh.fused_bin_call(
                tr, tc, TA.rpt, TA.col, TA.val, TB.rpt, TB.col, TB.val,
                t_size=t, rows_cap=rows_cap, pack=pack,
                single_access=single_access)
            assert tuple(tcol.shape) == (rows_cap, t)
            np.testing.assert_array_equal(_np(tcol),
                                          np.asarray(jcol)[:, :t])
            np.testing.assert_allclose(_np(tval), np.asarray(jval)[:, :t],
                                       **VAL_TOL)
            assert (np.asarray(jcol)[:, t:] == -1).all()
        assert tn.dtype == ta.dtype == torch.int32
        np.testing.assert_array_equal(_np(tn), np.asarray(jn))
        np.testing.assert_array_equal(_np(ta), np.asarray(ja))


@pytest.mark.parametrize("single_access", [True, False])
def test_numeric_kernel_matches_reference_exactly(single_access):
    A, B = _pair()
    TA, TB = _port(A), _port(B)
    nnz = jesc.symbolic(A, B, prod_capacity=1 << 15)[:A.nrows]
    jb, tb = _bins(A, B, NUM, sizes=nnz)
    rungs, sizes = _populated(jb, NUM)
    assert rungs == [0, 1, 2] and sizes[-1] > 0
    for b in rungs:
        t = NUM[2][b]
        jr, jc, tr, tc = _rung_inputs(jb, tb, b, 64)
        jcol, jval, ja = jsh.numeric_bin_call(
            jr, jc, A.rpt, A.col, A.val, B.rpt, B.col, B.val, t_size=t,
            rows_cap=64, single_access=single_access, interpret=True)
        tcol, tval, ta = tsh.numeric_bin_call(
            tr, tc, TA.rpt, TA.col, TA.val, TB.rpt, TB.col, TB.val,
            t_size=t, rows_cap=64, single_access=single_access)
        assert tuple(tcol.shape) == (64, t)     # stride t_size, no padding
        np.testing.assert_array_equal(_np(tcol), np.asarray(jcol)[:, :t])
        np.testing.assert_allclose(_np(tval), np.asarray(jval)[:, :t],
                                   **VAL_TOL)
        np.testing.assert_array_equal(_np(ta), np.asarray(ja))


@pytest.mark.parametrize("kind", ["symbolic", "numeric", "fused"])
def test_all_zero_rows_match_reference(kind):
    A, B = _zero_row_pair()
    TA, TB = _port(A), _port(B)
    m = A.nrows
    rows = np.arange(64, dtype=np.int32) % m
    count = np.array([m], np.int32)
    jr, jc = jnp.asarray(rows), jnp.asarray(count)
    tr, tc = torch.from_numpy(rows), torch.from_numpy(count)
    t = 64 if kind != "numeric" else 63
    if kind == "symbolic":
        j = jsh.symbolic_bin_call(jr, jc, A.rpt, A.col, B.rpt, B.col,
                                  t_size=t, rows_cap=64, interpret=True)
        o = tsh.symbolic_bin_call(tr, tc, TA.rpt, TA.col, TB.rpt, TB.col,
                                  t_size=t, rows_cap=64)
        pairs = list(zip(o, j))
    else:
        args_j = (jr, jc, A.rpt, A.col, A.val, B.rpt, B.col, B.val)
        args_t = (tr, tc, TA.rpt, TA.col, TA.val, TB.rpt, TB.col, TB.val)
        if kind == "numeric":
            j = jsh.numeric_bin_call(*args_j, t_size=t, rows_cap=64,
                                     single_access=True, interpret=True)
            o = tsh.numeric_bin_call(*args_t, t_size=t, rows_cap=64,
                                     single_access=True)
        else:
            j = jsh.fused_bin_call(*args_j, t_size=t, rows_cap=64,
                                   interpret=True)
            o = tsh.fused_bin_call(*args_t, t_size=t, rows_cap=64)
        pairs = [(a, np.asarray(b)[:, :t] if np.asarray(b).ndim == 2 else b)
                 for a, b in zip(o, j)]
    for a, b in pairs:
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)
    acc = _np(o[-1])
    nprod = _np(tnprod(TA, TB))[rows]
    assert (acc[:m][nprod[:m] == 0] == 0).all()   # zero rows: no accesses
    assert (acc[m:] == 0).all()                   # padded rows: none


@pytest.mark.parametrize("headroom", [1.0, 2.0])
@pytest.mark.parametrize("packed", [False, True])
def test_host_schedule_matches_reference(headroom, packed):
    A, B = _pair()
    TA, TB = _port(A), _port(B)
    jb, tb = _bins(A, B, SYM)
    jl, tl = jladder(*SYM), make_ladder(*SYM)
    jpacks = jl.rows_per_block if packed else None
    tpacks = tl.rows_per_block if packed else None
    assert tsh.host_schedule(TA, TB, tb, tl, headroom=headroom,
                             packs=tpacks) == \
        jsh.host_schedule(A, B, jb, jl, headroom=headroom, packs=jpacks)


def test_schedule_bucket_math_matches_reference():
    for count in (0, 1, 7, 8, 9, 63, 64, 65, 1000, 2 ** 31 - 1):
        for headroom in (1.0, 1.5, 2.0):
            for pack in (1, 2, 32):
                assert tsh.schedule_bucket(count, m_cap=4096,
                                           headroom=headroom, pack=pack) == \
                    jsh.schedule_bucket(count, m_cap=4096,
                                        headroom=headroom, pack=pack)
            assert tsh.fallback_capacity_bucket(count, headroom=headroom) \
                == jsh.fallback_capacity_bucket(count, headroom=headroom)


def test_nprod_of_rows_matches_reference():
    A, B = _pair()
    rows = np.array([0, 5, 95, 96, 96, 40], np.int32)   # 96 = padding id
    np.testing.assert_array_equal(
        _np(tsh.nprod_of_rows(_port(A), _port(B), torch.from_numpy(rows))),
        np.asarray(jsh.nprod_of_rows(A, B, jnp.asarray(rows))))


def test_hash_init_matches_reference():
    keys = np.array([0, 1, 12345, 20069940, 20069941, 2 ** 30, 2 ** 31 - 1],
                    np.int32)
    for t in (32, 512, 24576, 31, 255, 8191, 12288):
        got = _np(tsh._hash_init(torch.from_numpy(keys), t))
        want = np.asarray(jsh._hash_init(jnp.asarray(keys), t))
        np.testing.assert_array_equal(got, want)
        assert ((got >= 0) & (got < t)).all()


@pytest.mark.parametrize("single_access", [True, False])
@pytest.mark.parametrize("packed", [False, True])
def test_scheduled_drivers_match_reference(single_access, packed):
    """symbolic_scheduled, numeric_scheduled and fused_scheduled over tiny
    ladders with every rung and the ESC fallback rung populated."""
    A, B = _pair()
    TA, TB = _port(A), _port(B)
    m = A.nrows
    jl, tl = jladder(*SYM), make_ladder(*SYM)
    jb, tb = _bins(A, B, SYM)
    packs = (jl.rows_per_block, tl.rows_per_block) if packed else (None,
                                                                   None)
    sched = jsh.host_schedule(A, B, jb, jl, packs=packs[0])
    assert sched[0][-1] and sched[1]            # fallback rung populated
    kw = dict(row_buckets=sched[0], fallback_prod_capacity=sched[1],
              single_access=single_access, row_packing=packed,
              collect_accesses=True)
    jn, jsp, jacc = jsh.symbolic_scheduled(A, B, jb, jl, interpret=True,
                                           **kw)
    tn, tsp, tacc = tsh.symbolic_scheduled(TA, TB, tb, tl, **kw)
    np.testing.assert_array_equal(_np(tn), np.asarray(jn))
    assert int(tsp) == int(jsp) and int(tacc) == int(jacc)

    nnz_cap = 4096
    jC, jnz, jsp, jacc = jsh.fused_scheduled(
        A, B, jb, jl, nnz_capacity=nnz_cap, interpret=True, **kw)
    tC, tnz, tsp, tacc = tsh.fused_scheduled(TA, TB, tb, tl,
                                             nnz_capacity=nnz_cap, **kw)
    np.testing.assert_array_equal(_np(tnz), np.asarray(jnz))
    np.testing.assert_array_equal(_np(tC.rpt), np.asarray(jC.rpt))
    np.testing.assert_array_equal(_np(tC.col), np.asarray(jC.col))
    np.testing.assert_allclose(_np(tC.val), np.asarray(jC.val), **VAL_TOL)
    assert int(tsp) == int(jsp) and int(tacc) == int(jacc)

    jnl, tnl = jladder(*NUM), make_ladder(*NUM)
    jnb, tnb = jbin(jn[:m], jnl), tbin(tn[:m], tnl)
    nsched = jsh.host_schedule(A, B, jnb, jnl)
    assert nsched == tsh.host_schedule(TA, TB, tnb, tnl)
    assert nsched[0][-1]
    nkw = dict(row_buckets=nsched[0], fallback_prod_capacity=nsched[1],
               nnz_capacity=nnz_cap, single_access=single_access,
               collect_accesses=True)
    jC2, jsp2, jacc2 = jsh.numeric_scheduled(A, B, jexcl(jn), jnb, jnl,
                                             interpret=True, **nkw)
    tC2, tsp2, tacc2 = tsh.numeric_scheduled(TA, TB, texcl(tn), tnb, tnl,
                                             **nkw)
    np.testing.assert_array_equal(_np(tC2.rpt), np.asarray(jC2.rpt))
    np.testing.assert_array_equal(_np(tC2.col), np.asarray(jC2.col))
    np.testing.assert_allclose(_np(tC2.val), np.asarray(jC2.val), **VAL_TOL)
    assert int(tsp2) == int(jsp2) and int(tacc2) == int(jacc2)
    # Two-pass and fused sum every product in the same order: same bits.
    np.testing.assert_array_equal(_np(tC2.val), _np(tC.val))


def test_binned_wrappers_and_single_access_fewer_transactions():
    A, B = _pair()
    TA, TB = _port(A), _port(B)
    lad = symbolic_ladder(1.2)
    tb = tbin(tnprod(TA, TB)[:TA.nrows], lad)
    n1, acc_single = tsh.symbolic_binned(TA, TB, tb, lad,
                                         single_access=True,
                                         collect_accesses=True)
    n2, acc_multi = tsh.symbolic_binned(TA, TB, tb, lad,
                                        single_access=False,
                                        collect_accesses=True)
    assert torch.equal(n1, n2)
    assert int(acc_single) < int(acc_multi)
    C = tsh.fused_binned(TA, TB, tb, lad, nnz_capacity=4096)
    want = _np(TA.to_dense()) @ _np(TB.to_dense())
    np.testing.assert_allclose(_np(C.to_dense()), want, **VAL_TOL)


def test_cpu_calls_do_not_count_launches():
    A, B = _pair()
    TA, TB = _port(A), _port(B)
    tsh.reset_launches()
    tb = tbin(tnprod(TA, TB)[:TA.nrows], symbolic_ladder(1.2))
    tsh.fused_binned(TA, TB, tb, symbolic_ladder(1.2), nnz_capacity=4096)
    assert [f.launches for f in tsh.KERNELS] == [0, 0, 0]


def test_launch_geometry():
    for t in (15, 31, 32, 255, 512, 1024, 4095, 8192, 12288, 24576):
        rows_per_cta, threads = tsh.launch_geometry(t, 1)
        assert rows_per_cta == 1 and threads % 32 == 0
        assert 32 <= threads <= 1024
    assert tsh.launch_geometry(32, 32) == (32, 32)       # warp per row
    with pytest.raises(ValueError):
        tsh.symbolic_bin_plain(torch.zeros(6, dtype=torch.int32),
                               torch.zeros(1, dtype=torch.int32),
                               *[torch.zeros(2, dtype=torch.int32)] * 4,
                               t_size=32, rows_cap=6, pack=4)


# ---------------------------------------------------------------------------
# On the card: each CUDA kernel against its plain version.
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hash kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("single_access", [True, False])
@pytest.mark.parametrize("kind", ["symbolic", "numeric", "fused"])
def test_cuda_kernels_match_plain(cuda_device, kind, single_access):
    A, B = _pair()
    TA, TB = _port(A, cuda_device), _port(B, cuda_device)
    lad = SYM if kind != "numeric" else NUM
    sizes = None
    if kind == "numeric":
        sizes = np.asarray(jesc.symbolic(A, B, prod_capacity=1 << 15))[:96]
    jb, _ = _bins(A, B, lad, sizes)
    ts = (tnprod(TA, TB)[:96] if sizes is None
          else torch.from_numpy(sizes.copy()).to(cuda_device))
    tb = tbin(ts, make_ladder(*lad))
    for b in _populated(jb, lad)[0]:
        t = lad[2][b]
        rows, count = tb.rows_of_bin(b, 128)
        count = count.reshape(1)
        if kind == "symbolic":
            args = (rows, count, TA.rpt, TA.col, TB.rpt, TB.col)
            k = tsh.symbolic_bin_call(*args, t_size=t, rows_cap=128,
                                      single_access=single_access)
            p = tsh.symbolic_bin_plain(*args, t_size=t, rows_cap=128)
            assert torch.equal(k[0], p[0])
            continue
        args = (rows, count, TA.rpt, TA.col, TA.val, TB.rpt, TB.col, TB.val)
        if kind == "numeric":
            kc, kv, _ = tsh.numeric_bin_call(*args, t_size=t, rows_cap=128,
                                             single_access=single_access)
            pc, pv, _ = tsh.numeric_bin_plain(*args, t_size=t, rows_cap=128,
                                              single_access=True)
        else:
            kn, kc, kv, _ = tsh.fused_bin_call(
                *args, t_size=t, rows_cap=128, single_access=single_access)
            pn, pc, pv, _ = tsh.fused_bin_plain(*args, t_size=t,
                                                rows_cap=128)
            assert torch.equal(kn, pn)
        ks, ko = torch.sort(kc, dim=1)
        ps, po = torch.sort(pc, dim=1)
        assert torch.equal(ks, ps)
        torch.testing.assert_close(kv.gather(1, ko), pv.gather(1, po),
                                   rtol=1e-5, atol=1e-5)
