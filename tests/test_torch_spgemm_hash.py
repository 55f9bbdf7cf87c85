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
from repro_torch.core.binning_ranges import (NUMERIC_TABLE_SIZES,
                                             make_ladder, symbolic_ladder)
from repro_torch.core.csr import CSR
from repro_torch.kernels import spgemm_hash as tsh

VAL_TOL = dict(rtol=1e-5, atol=1e-5)   # tests/test_kernels_spgemm_hash.py:56
SYM = ((32, 64, 128), 1.2, (32, 64, 128))      # every rung + fallback
NUM = ((16, 32, 64), 2.0, (15, 31, 63))        # mod-path tables
# The vmem_extended rungs (binning_ranges.py), past a block's shared memory
# on the card: their tables at a multiplier that spreads the pair's rows
# over every rung plus the fallback, 8 rows a bin.
EXT_SYM = ((65536, 262144, 1048576), 8192.0, (65536, 262144, 1048576))
EXT_NUM = ((32768, 131072, 524288), 8192.0, (32768, 131072, 524288))
LADDERS = {"tiny": (SYM, NUM, 128, 64), "extended": (EXT_SYM, EXT_NUM, 8, 8)}


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
@pytest.mark.parametrize("ladder,packed", [("tiny", False), ("tiny", True),
                                           ("extended", False)])
@pytest.mark.parametrize("kind", ["symbolic", "fused"])
def test_sym_ladder_kernels_match_reference_exactly(kind, ladder, packed,
                                                    single_access):
    A, B = _pair()
    TA, TB = _port(A), _port(B)
    sym, _, rows_cap, _ = LADDERS[ladder]
    jb, tb = _bins(A, B, sym)
    rungs, sizes = _populated(jb, sym)
    assert rungs == [0, 1, 2] and sizes[-1] > 0
    lad = make_ladder(*sym)
    for b in rungs:
        t = sym[2][b]
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


@pytest.mark.parametrize("ladder", ["tiny", "extended"])
@pytest.mark.parametrize("single_access", [True, False])
def test_numeric_kernel_matches_reference_exactly(single_access, ladder):
    A, B = _pair()
    TA, TB = _port(A), _port(B)
    _, num, _, rows_cap = LADDERS[ladder]
    nnz = jesc.symbolic(A, B, prod_capacity=1 << 15)[:A.nrows]
    jb, tb = _bins(A, B, num, sizes=nnz)
    rungs, sizes = _populated(jb, num)
    assert rungs == [0, 1, 2] and sizes[-1] > 0
    for b in rungs:
        t = num[2][b]
        jr, jc, tr, tc = _rung_inputs(jb, tb, b, rows_cap)
        jcol, jval, ja = jsh.numeric_bin_call(
            jr, jc, A.rpt, A.col, A.val, B.rpt, B.col, B.val, t_size=t,
            rows_cap=rows_cap, single_access=single_access, interpret=True)
        tcol, tval, ta = tsh.numeric_bin_call(
            tr, tc, TA.rpt, TA.col, TA.val, TB.rpt, TB.col, TB.val,
            t_size=t, rows_cap=rows_cap, single_access=single_access)
        assert tuple(tcol.shape) == (rows_cap, t)  # stride t_size, no pad
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



def _divide_free_slot(keys: np.ndarray, t_size: int) -> np.ndarray:
    """The CUDA kernels' hash for a t_size that is not a power of two
    (hash_slot in csrc/spgemm_hash.cu), step by step in uint32 arithmetic,
    with the wrapper's constants from hash_mod."""
    magic, shift, wrap = tsh.hash_mod(t_size)
    m32 = np.uint64(0xFFFFFFFF)
    p = (keys.astype(np.uint64) * np.uint64(107)) & m32
    t1 = (p * np.uint64(magic)) >> np.uint64(32)                # __umulhi
    q = (((p - t1) >> np.uint64(1)) + t1) & m32
    q >>= np.uint64(shift)
    r = ((p - q * np.uint64(t_size)) & m32).astype(np.int64)
    negative = p >= np.uint64(2 ** 31)                          # int32 < 0
    r = np.where(negative, r - wrap, r)
    return np.where(r < 0, r + t_size, r)


@pytest.mark.parametrize("t_size", NUMERIC_TABLE_SIZES + (12288, 24576, 3,
                                                          15, 1000))
def test_divide_free_hash_is_the_reference_floor_mod(t_size):
    """Keys near 0, near 2^31/107 (where key*107 first wraps int32) and
    near 2^31 - 1, plus random ones: the kernels' multiply-high mod gives
    numpy's floor mod of the int32 product, and the reference's slot."""
    edge = 2 ** 31 // 107
    keys = np.concatenate([
        np.arange(0, 4096), np.arange(edge - 4096, edge + 4096),
        np.arange(2 ** 31 - 4096, 2 ** 31),
        np.random.default_rng(t_size).integers(0, 2 ** 31, 100_000),
    ]).astype(np.int64)
    product = ((keys * 107) & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    want = np.mod(product.astype(np.int64), t_size)
    got = _divide_free_slot(keys, t_size)
    np.testing.assert_array_equal(got, want)
    assert (want[keys == edge + 1]
            == np.mod(107 * (edge + 1) - 2 ** 32, t_size)).all()
    sample = keys[::37].astype(np.int32)
    np.testing.assert_array_equal(
        got[::37], np.asarray(jsh._hash_init(jnp.asarray(sample), t_size)))
    magic, shift, wrap = tsh.hash_mod(t_size)
    assert 0 < magic < 2 ** 32 and wrap == 2 ** 32 % t_size


def test_hash_mod_of_power_of_two_sizes_is_unused():
    for t in (1, 2, 32, 512, 8192):
        assert tsh.hash_mod(t) == (0, 0, 0)


@pytest.mark.parametrize("t_size", NUMERIC_TABLE_SIZES)
def test_numeric_launch_geometry_packs_the_one_warp_rungs(t_size):
    rows_per_cta, threads = tsh.numeric_launch_geometry(t_size)
    assert threads == tsh.launch_geometry(t_size, 1)[1]
    if threads == 32:            # t_size 31 and 255
        assert t_size <= 255
        assert rows_per_cta == tsh.NUMERIC_ROWS_PER_CTA == 8
    else:
        assert t_size >= 511 and rows_per_cta == 1
    # A block's tables (8 B an entry) and per-row counters fit the 48 KB
    # every launch may take without the opt-in, but for the top rungs.
    smem = rows_per_cta * (t_size * 8 + 8)
    assert smem <= 48 * 1024 or t_size >= 8191


H100_SMEM = 232_448    # shared memory a block may opt into on the H100
# Every extended rung of both ladders, with and without values: the route
# at the H100's limit, and for a cluster the smallest cluster that holds
# the table and its slice (t_size / C slots of 8 or 4 B, plus the row's
# 16 B of counters and its 16,512 B entry list).  The ladders' own rungs are symbolic (keys only) and
# fused (values) on EXT_SYM, numeric (values) on EXT_NUM.
EXT_ROUTES = {
    (65536, False): ("cluster", 2, 147_600),
    (262144, False): ("cluster", 8, 147_600),
    (1048576, False): ("global", None, None),
    (65536, True): ("cluster", 4, 147_600),
    (262144, True): ("global", None, None),
    (1048576, True): ("global", None, None),
    (32768, True): ("cluster", 2, 147_600),
    (131072, True): ("cluster", 8, 147_600),
    (524288, True): ("global", None, None),
    (32768, False): ("smem", None, None),       # 131,080 B: one block
    (131072, False): ("cluster", 4, 147_600),
    (524288, False): ("global", None, None),
}


@pytest.mark.parametrize("t_size,with_values", sorted(EXT_ROUTES))
def test_hash_route_of_every_extended_rung(t_size, with_values):
    route, least, slice_bytes = EXT_ROUTES[(t_size, with_values)]
    assert t_size in EXT_SYM[2] + EXT_NUM[2]
    assert tsh.hash_route(t_size, 1, with_values, H100_SMEM) == route
    assert tsh.smallest_cluster(t_size, with_values, H100_SMEM) == (
        least if route == "cluster" else
        None if route == "global" else 2)
    if route != "cluster":
        return
    assert tsh.cluster_slice_bytes(t_size, least, with_values) \
        == slice_bytes <= H100_SMEM
    assert tsh.cluster_slice_bytes(t_size, least // 2, with_values) \
        > H100_SMEM
    c = tsh.cluster_size(t_size, with_values, H100_SMEM)
    assert least <= c <= tsh.CLUSTER_MAX == 8 and c & (c - 1) == 0
    assert tsh.cluster_slice_bytes(t_size, c, with_values) <= H100_SMEM


def test_hash_route_default_rungs_packing_and_limits():
    """Tables that fit a block stay on the shared-memory kernels, packed
    or not; several rows to a block past shared memory raise; a table
    that no cluster holds (or that is not a power of two) goes to device
    memory, up to GLOBAL_MAX_T_SIZE."""
    for t in (24576, 12288, 8192, 512, 32):
        assert tsh.hash_route(t, 1, True, H100_SMEM) == "smem"
    assert tsh.hash_route(8191, 1, True, H100_SMEM) == "smem"
    assert tsh.hash_route(4096, 4, True, H100_SMEM) == "smem"
    assert tsh.table_bytes(4096, 4, True) == 4 * (4096 * 8 + 8)
    for pack, t in ((2, 65536), (2, 16384), (4, 8192)):
        with pytest.raises(ValueError, match="one row a block"):
            tsh.hash_route(t, pack, True, H100_SMEM)
    assert tsh.hash_route(40000, 1, True, H100_SMEM) == "global"
    assert tsh.smallest_cluster(40000, True, H100_SMEM) is None
    with pytest.raises(ValueError, match="past the global"):
        tsh.hash_route(2 ** 31, 1, False, H100_SMEM)
    # A smaller card: the same rung takes a larger cluster, or none.
    assert tsh.smallest_cluster(65536, True, 99 * 1024) == 8
    assert tsh.hash_route(131072, 1, True, 99 * 1024) == "global"
    assert tsh.cluster_size(65536, True, 99 * 1024) == 8
    for (with_values, t), c in tsh.CLUSTER_SIZES.items():
        assert tsh.hash_route(t, 1, with_values, H100_SMEM) == "cluster"
        assert c & (c - 1) == 0 and (
            tsh.smallest_cluster(t, with_values, H100_SMEM) <= c <= 8)
        assert tsh.cluster_size(t, with_values, H100_SMEM) == c


def _wrapping_keys(t_size: int, cluster: int, n: int) -> np.ndarray:
    """Keys whose hash slots crowd the end of each rank's slice and the end
    of the table, so their probes cross from rank to rank and wrap from
    the last rank to rank 0; some repeat (a hit adds)."""
    s = t_size // cluster
    cand = np.arange(1, 4_000_000, dtype=np.int64)
    slot = ((cand * 107) & 0xFFFFFFFF) & (t_size - 1)
    hot = np.concatenate([np.arange(r * s + s - 3, r * s + s)
                          for r in range(cluster)])
    keys = cand[np.isin(slot, hot)][:n]
    return np.concatenate([keys, keys[::5]])


def _cluster_emulation(keys, vals, t_size: int, cluster: int):
    """The cluster kernel's table for one row, inserted in the given order
    with its addressing: slot h in rank h >> log2(t_size / C) at offset
    h & (t_size / C - 1) of that rank's shared memory, probes wrapping
    across ranks; then the dump, rank r's slice to row entries
    [r * t_size / C, (r + 1) * t_size / C)."""
    s = t_size // cluster
    shift = s.bit_length() - 1
    smem_k = np.full((cluster, s), -1, np.int64)
    smem_v = np.zeros((cluster, s), np.float32)
    for key, v in zip(keys, vals):
        h = int((key * 107) & 0xFFFFFFFF) & (t_size - 1)
        for _ in range(2 * t_size):
            rank, off = h >> shift, h & (s - 1)
            if smem_k[rank, off] in (-1, key):
                smem_k[rank, off] = key
                smem_v[rank, off] += v
                break
            h = (h + 1) & (t_size - 1)
    cols = np.empty(t_size, np.int64)
    vals_out = np.empty(t_size, np.float32)
    for rank in range(cluster):
        cols[rank * s:(rank + 1) * s] = smem_k[rank]
        vals_out[rank * s:(rank + 1) * s] = smem_v[rank]
    return cols, vals_out


@pytest.mark.parametrize("t_size,cluster", [(32768, 2), (65536, 4),
                                            (131072, 8), (65536, 2)])
def test_cluster_layout_reproduces_the_row_major_table(t_size, cluster):
    """A row whose probes cross ranks and wrap, through a numpy emulation
    of the cluster kernel's slot split and dump: the plain version's
    row-major t_size table, slot for slot (values in the same order)."""
    keys = _wrapping_keys(t_size, cluster, 12 * cluster)
    m = len(keys)
    vals = np.random.default_rng(t_size + cluster).standard_normal(
        m).astype(np.float32)
    B = _csr(np.arange(m + 1), keys, vals, (m, 2 ** 31 - 1), "cpu")
    A = _csr([0, m], np.arange(m), np.ones(m), (1, m), "cpu")
    rows = torch.zeros(1, dtype=torch.int32)
    count = torch.ones(1, dtype=torch.int32)
    nnz, cols, tvals, _ = tsh.fused_bin_plain(
        rows, count, A.rpt, A.col, A.val, B.rpt, B.col, B.val,
        t_size=t_size, rows_cap=1)
    want_cols, want_vals = _cluster_emulation(keys, vals, t_size, cluster)
    np.testing.assert_array_equal(_np(cols[0]), want_cols)
    np.testing.assert_array_equal(_np(tvals[0]), want_vals)
    assert int(nnz[0]) == len(set(keys.tolist()))
    s = t_size // cluster
    assert (want_cols[0:3] >= 0).all()           # wrapped past the end
    assert all((want_cols[r * s:r * s + 2] >= 0).all()
               for r in range(1, cluster))       # crossed into rank r


def test_numeric_epilogue_ignores_padding_row_tables():
    """On the card the tables of rows >= count are left unwritten; the
    epilogue must give the same C whatever they hold."""
    A, B = _pair()
    TA, TB = _port(A), _port(B)
    m = A.nrows
    nnz = jesc.symbolic(A, B, prod_capacity=1 << 15)[:m]
    jb, tb = _bins(A, B, NUM, sizes=nnz)
    rpt = texcl(torch.from_numpy(np.asarray(nnz).copy()))
    jrpt = jexcl(nnz)
    cap = int(rpt[-1]) + 8
    rng = np.random.default_rng(11)
    for b in _populated(jb, NUM)[0]:
        t = NUM[2][b]
        jr, jc, tr, tc = _rung_inputs(jb, tb, b, 64)
        jcol, jval, _ = jsh.numeric_bin_call(
            jr, jc, A.rpt, A.col, A.val, B.rpt, B.col, B.val, t_size=t,
            rows_cap=64, single_access=True, interpret=True)
        tcol, tval, _ = tsh.numeric_bin_call(
            tr, tc, TA.rpt, TA.col, TA.val, TB.rpt, TB.col, TB.val,
            t_size=t, rows_cap=64, single_access=True)
        n = int(tc[0])
        assert n < 64                               # the bin has padding
        gcol, gval = tcol.clone(), tval.clone()
        gcol[n:] = torch.from_numpy(rng.integers(
            -5, TB.ncols, (64 - n, t), dtype=np.int32))
        gval[n:] = torch.from_numpy(rng.standard_normal(
            (64 - n, t)).astype(np.float32))
        gval[n:, ::7] = float("nan")
        outs = []
        for col_tabs, val_tabs in ((tcol, tval), (gcol, gval)):
            c_col = torch.zeros(cap + 1, dtype=torch.int32)
            c_val = torch.zeros(cap + 1, dtype=torch.float32)
            tsh.numeric_epilogue(col_tabs, val_tabs, tr, tc, rpt, c_col,
                                 c_val, nnz_capacity=cap)
            outs.append((c_col[:cap], c_val[:cap]))
        jcc, jcv = jsh.numeric_epilogue(
            jcol, jval, jr, jc, jrpt, jnp.zeros(cap + 1, jnp.int32),
            jnp.zeros(cap + 1, jnp.float32), nnz_capacity=cap)
        for c_col, c_val in outs:
            np.testing.assert_array_equal(_np(c_col), np.asarray(jcc)[:cap])
            np.testing.assert_allclose(_np(c_val), np.asarray(jcv)[:cap],
                                       **VAL_TOL)


@pytest.mark.parametrize("packed", [False, True])
def test_fused_rungs_and_scheduled_match_reference_with_padding(packed):
    """fused_scheduled's rung list (largest tables first) and its result
    on a 2x-headroom schedule, whose buckets hold padding rows, against
    the reference's fused_bin_call and fused_scheduled."""
    A, B = _pair()
    TA, TB = _port(A), _port(B)
    jl, tl = jladder(*SYM), make_ladder(*SYM)
    jb, tb = _bins(A, B, SYM)
    packs = (jl.rows_per_block, tl.rows_per_block) if packed else (None,
                                                                   None)
    sched = jsh.host_schedule(A, B, jb, jl, headroom=2.0, packs=packs[0])
    assert sched == tsh.host_schedule(TA, TB, tb, tl, headroom=2.0,
                                      packs=packs[1])
    rungs = tsh.fused_rungs(tb, tl, sched[0], row_packing=packed)
    assert [r.b for r in rungs] == [2, 1, 0]
    outs = tsh.launch_fused_rungs(TA, TB, rungs)
    for rung, (tn, tcol, tval, ta) in zip(rungs, outs):
        assert int(rung.count[0]) < rung.rows_cap   # padding rows present
        jr, jc = jb.rows_of_bin(rung.b, rung.rows_cap)
        jn, jcol, jval, ja = jsh.fused_bin_call(
            jr, jc.reshape(1), A.rpt, A.col, A.val, B.rpt, B.col, B.val,
            t_size=rung.t_size, rows_cap=rung.rows_cap, pack=rung.pack,
            interpret=True)
        np.testing.assert_array_equal(_np(tn), np.asarray(jn))
        np.testing.assert_array_equal(_np(ta), np.asarray(ja))
        np.testing.assert_array_equal(_np(tcol),
                                      np.asarray(jcol)[:, :rung.t_size])
        np.testing.assert_allclose(_np(tval),
                                   np.asarray(jval)[:, :rung.t_size],
                                   **VAL_TOL)
    kw = dict(row_buckets=sched[0], fallback_prod_capacity=sched[1],
              nnz_capacity=4096, row_packing=packed, collect_accesses=True)
    jC, jnz, jsp, jacc = jsh.fused_scheduled(A, B, jb, jl, interpret=True,
                                             **kw)
    tC, tnz, tsp, tacc = tsh.fused_scheduled(TA, TB, tb, tl, **kw)
    np.testing.assert_array_equal(_np(tnz), np.asarray(jnz))
    np.testing.assert_array_equal(_np(tC.rpt), np.asarray(jC.rpt))
    np.testing.assert_array_equal(_np(tC.col), np.asarray(jC.col))
    np.testing.assert_allclose(_np(tC.val), np.asarray(jC.val), **VAL_TOL)
    assert int(tsp) == int(jsp) and int(tacc) == int(jacc)


# ---------------------------------------------------------------------------
# On the card: each CUDA kernel against its plain version.
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hash kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("deterministic", [False, True])
@pytest.mark.parametrize("single_access", [True, False])
@pytest.mark.parametrize("t_size", [4, 7, 64, 127])
def test_cuda_plain_graph_rounds_equal_the_cpu_plain(cuda_device, t_size,
                                                     single_access,
                                                     deterministic):
    """The plain body on the card (its probe round replayed from a CUDA
    graph) equals the same body on the CPU bit for bit, tables of 4 and 7
    entries included, where rows give up at the probe guard."""
    A, B = _pair()
    nprod = tnprod(_port(A), _port(B))[:96]
    rows = torch.argsort(nprod, descending=True).to(torch.int32)
    count = torch.tensor([90], dtype=torch.int32)
    out = {}
    for dev in ("cpu", cuda_device):
        TA, TB = _port(A, dev), _port(B, dev)
        args = (rows.to(dev), count.to(dev), TA.rpt, TA.col, TA.val,
                TB.rpt, TB.col, TB.val)
        before = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(deterministic)
        try:
            out[str(dev)] = tsh.fused_bin_plain(
                *args, t_size=t_size, rows_cap=96,
                single_access=single_access)
        finally:
            torch.use_deterministic_algorithms(before)
    for got, want in zip(out[str(cuda_device)], out["cpu"]):
        assert torch.equal(got.cpu(), want)
    assert int(out["cpu"][0].sum()) > 0


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
    nprod = tnprod(TA, TB).long()
    for b in _populated(jb, lad)[0]:
        t = lad[2][b]
        rows, count = tb.rows_of_bin(b, 128)
        count = count.reshape(1)
        valid = torch.arange(128, device=cuda_device) < count
        if kind == "symbolic":
            args = (rows, count, TA.rpt, TA.col, TB.rpt, TB.col)
            kn, ka = tsh.symbolic_bin_call(*args, t_size=t, rows_cap=128,
                                           single_access=single_access)
            pn, _ = tsh.symbolic_bin_plain(*args, t_size=t, rows_cap=128)
            assert torch.equal(kn, pn)
        else:
            args = (rows, count, TA.rpt, TA.col, TA.val, TB.rpt, TB.col,
                    TB.val)
            if kind == "numeric":
                kc, kv, ka = tsh.numeric_bin_call(
                    *args, t_size=t, rows_cap=128,
                    single_access=single_access)
                pc, pv, _ = tsh.numeric_bin_plain(
                    *args, t_size=t, rows_cap=128, single_access=True)
            else:
                kn, kc, kv, ka = tsh.fused_bin_call(
                    *args, t_size=t, rows_cap=128,
                    single_access=single_access)
                pn, pc, pv, _ = tsh.fused_bin_plain(*args, t_size=t,
                                                    rows_cap=128)
                assert torch.equal(kn, pn)           # all rows, 0 on padding
            # Tables only below count: the padding rows' stay unwritten.
            ks, ko = torch.sort(kc[valid], dim=1)
            ps, po = torch.sort(pc[valid], dim=1)
            assert torch.equal(ks, ps)
            torch.testing.assert_close(kv[valid].gather(1, ko),
                                       pv[valid].gather(1, po),
                                       rtol=1e-5, atol=1e-5)
        # Accesses on all rows: at least one per product, none on padding.
        ka = ka.long()
        assert bool((ka[valid] >= nprod[rows.long()][valid]).all())
        assert not bool(ka[~valid].any())


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["symbolic", "numeric", "fused"])
def test_cuda_kernels_count_zero(cuda_device, kind):
    """A bin with no valid row: every block exits at once, nnz and accesses
    are 0 on every row."""
    A, B = _pair()
    TA, TB = _port(A, cuda_device), _port(B, cuda_device)
    rows = torch.arange(256, dtype=torch.int32, device=cuda_device) % 96
    count = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    ints = (TA.rpt, TA.col)
    if kind == "symbolic":
        nnz, acc = tsh.symbolic_bin_call(rows, count, *ints, TB.rpt, TB.col,
                                         t_size=64, rows_cap=256, pack=32)
    elif kind == "numeric":
        _, _, acc = tsh.numeric_bin_call(
            rows, count, *ints, TA.val, TB.rpt, TB.col, TB.val, t_size=63,
            rows_cap=256, single_access=True)
        nnz = torch.zeros_like(acc)
    else:
        nnz, _, _, acc = tsh.fused_bin_call(
            rows, count, *ints, TA.val, TB.rpt, TB.col, TB.val, t_size=128,
            rows_cap=256)
    torch.cuda.synchronize()
    assert not bool(nnz.any()) and not bool(acc.any())


@pytest.mark.gpu
@pytest.mark.parametrize("packed", [False, True])
def test_cuda_fused_scheduled_on_side_streams_matches_cpu(cuda_device,
                                                          packed):
    """fused_scheduled on the card (rungs on side streams) against the
    plain path on the CPU, on a 2x-headroom schedule with padding rows."""
    A, B = _pair()
    TA, TB = _port(A), _port(B)
    GA, GB = _port(A, cuda_device), _port(B, cuda_device)
    tl = make_ladder(*SYM)
    tb = tbin(tnprod(TA, TB)[:TA.nrows], tl)
    gb = tbin(tnprod(GA, GB)[:GA.nrows], tl)
    packs = tl.rows_per_block if packed else None
    buckets, fall = tsh.host_schedule(TA, TB, tb, tl, headroom=2.0,
                                      packs=packs)
    kw = dict(row_buckets=buckets, fallback_prod_capacity=fall,
              nnz_capacity=4096, row_packing=packed)
    C0, nnz0, _, _ = tsh.fused_scheduled(TA, TB, tb, tl, **kw)
    C, nnz, _, _ = tsh.fused_scheduled(GA, GB, gb, tl, **kw)
    torch.cuda.synchronize()
    assert torch.equal(nnz.cpu(), nnz0)
    assert torch.equal(C.rpt.cpu(), C0.rpt)
    nz = int(C0.rpt[-1])
    assert torch.equal(C.col[:nz].cpu(), C0.col[:nz])
    torch.testing.assert_close(C.val[:nz].cpu(), C0.val[:nz], rtol=1e-5,
                               atol=1e-5)


def _csr(rpt, col, val, shape, device):
    return CSR(torch.from_numpy(np.asarray(rpt, np.int32)).to(device),
               torch.from_numpy(np.asarray(col, np.int32)).to(device),
               torch.from_numpy(np.asarray(val, np.float32)).to(device),
               shape)


def _rows_csr(rows_of_cols, vals, shape, device):
    """CSR from one column array (and value array) per row."""
    rpt = np.concatenate([[0], np.cumsum([len(c) for c in rows_of_cols])])
    col = (np.concatenate(rows_of_cols) if len(rows_of_cols)
           else np.zeros(0))
    return _csr(rpt, col, np.concatenate(vals), shape, device)


def _sized_pair(t_size: int, device, *, m: int = 24, seed: int = 0):
    """A (m x 512) and B (512 x 4*t_size): every B row has 8 entries, and
    row i of A at most t_size // 16 entries, so each row's products (and
    distinct columns) fill at most half of a t_size table."""
    rng = np.random.default_rng(seed + t_size)
    k, per_b, n = 512, 8, 4 * t_size
    b_cols = [np.sort(rng.choice(n, per_b, replace=False)) for _ in range(k)]
    b_vals = [rng.standard_normal(per_b) for _ in range(k)]
    a_len = rng.integers(1, max(t_size // 16, 1) + 1, m)
    a_cols = [np.sort(rng.choice(k, j, replace=False)) for j in a_len]
    a_vals = [rng.standard_normal(j) for j in a_len]
    return (_rows_csr(a_cols, a_vals, (m, k), device),
            _rows_csr(b_cols, b_vals, (k, n), device))


def _numeric_bin(args, *, t_size, rows_cap, single_access,
                 rows_per_cta=None):
    """numeric_bin_call, or with ``rows_per_cta`` the C entry point
    launched in that geometry (as ``repro_torch.kernels.ablate`` launches
    it); the outputs are the wrapper's."""
    if rows_per_cta is None:
        return tsh.numeric_bin_call(*args, t_size=t_size, rows_cap=rows_cap,
                                    single_access=single_access)
    from repro_torch.kernels import build
    dev = args[0].device
    _, threads = tsh.numeric_launch_geometry(t_size)
    cols = torch.empty((rows_cap, t_size), dtype=torch.int32, device=dev)
    vals = torch.empty((rows_cap, t_size), dtype=torch.float32, device=dev)
    acc = torch.empty(rows_cap, dtype=torch.int32, device=dev)
    build.check(build.library("spgemm_hash").numeric_bin(
        *(a.data_ptr() for a in args), t_size, rows_cap, rows_per_cta,
        threads, int(single_access), *tsh.hash_mod(t_size), cols.data_ptr(),
        vals.data_ptr(), acc.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream), "numeric_bin")
    return cols, vals, acc


def _check_numeric_against_plain(A, B, rows, count, t_size, rows_cap, *,
                                 single_access, rows_per_cta=None,
                                 exact_slots=False):
    """numeric_bin_call on the card against its plain version: sorted
    columns exactly (and, with ``exact_slots``, every slot), values within
    1e-5 + 1e-5*|v| (few products per entry), accesses by the invariants.
    Returns the card's total accesses over the valid rows."""
    args = (rows, count, A.rpt, A.col, A.val, B.rpt, B.col, B.val)
    kc, kv, ka = _numeric_bin(args, t_size=t_size, rows_cap=rows_cap,
                              single_access=single_access,
                              rows_per_cta=rows_per_cta)
    pc, pv, _ = tsh.numeric_bin_plain(*args, t_size=t_size,
                                      rows_cap=rows_cap, single_access=True)
    torch.cuda.synchronize()
    valid = torch.arange(rows_cap, device=rows.device) < count
    if exact_slots:
        assert torch.equal(kc[valid], pc[valid])
    ks, ko = torch.sort(kc[valid], dim=1)
    ps, po = torch.sort(pc[valid], dim=1)
    assert torch.equal(ks, ps)
    torch.testing.assert_close(kv[valid].gather(1, ko),
                               pv[valid].gather(1, po), rtol=1e-5, atol=1e-5)
    nprod = tnprod(A, B).long()[rows.long().clamp(max=A.nrows - 1)]
    ka = ka.long()
    assert bool((ka[valid] >= nprod[valid]).all())
    assert not bool(ka[~valid].any())
    return int(ka[valid].sum())


@pytest.mark.gpu
@pytest.mark.parametrize("rows_per_cta", [None, 1])
@pytest.mark.parametrize("t_size", NUMERIC_TABLE_SIZES)
def test_cuda_numeric_bin_every_ladder_size(cuda_device, t_size,
                                            rows_per_cta):
    """Every numeric-ladder size, in the wrapper's geometry (8 rows to a
    block on the one-warp rungs) and one row to a block, both disciplines;
    70 rows (not a multiple of 8: a ragged last block), 61 valid."""
    A, B = _sized_pair(t_size, cuda_device)
    rows_cap = 70
    rows = (torch.arange(rows_cap, dtype=torch.int32, device=cuda_device)
            * 7) % A.nrows
    count = torch.tensor([61], dtype=torch.int32, device=cuda_device)
    totals = {sa: _check_numeric_against_plain(
        A, B, rows, count, t_size, rows_cap, single_access=sa,
        rows_per_cta=rows_per_cta) for sa in (True, False)}
    assert totals[True] < totals[False]


@pytest.mark.gpu
@pytest.mark.parametrize("t_size", NUMERIC_TABLE_SIZES + (12288,))
def test_cuda_numeric_hash_where_key_times_107_wraps(cuda_device, t_size):
    """Column ids past 2^31/107 = 20,069,940, where key*107 wraps int32 to
    negative values and the floor mod adds t_size back.  Rows with one
    product hold their key at its hash slot, so the card's tables must
    equal the plain version's slot for slot; rows with several products
    are compared as sets."""
    rng = np.random.default_rng(t_size)
    edge = 2 ** 31 // 107
    keys = np.concatenate([np.arange(edge - 3, edge + 5),
                           np.arange(2 ** 31 - 8, 2 ** 31),
                           rng.integers(edge, 2 ** 31, 16)])
    n = 2 ** 31 - 1
    m = len(keys)
    B = _rows_csr([[k] for k in keys], [rng.standard_normal(1)
                                        for _ in keys], (m, n), cuda_device)
    A = _rows_csr([[i] for i in range(m)], [np.ones(1)] * m, (m, m),
                  cuda_device)
    rows = torch.arange(m, dtype=torch.int32, device=cuda_device)
    count = torch.tensor([m], dtype=torch.int32, device=cuda_device)
    for sa in (True, False):
        _check_numeric_against_plain(A, B, rows, count, t_size, m,
                                     single_access=sa, exact_slots=True)
    many = min(t_size // 2, m)
    A2 = _rows_csr([rng.choice(m, many, replace=False) for _ in range(8)],
                   [rng.standard_normal(many) for _ in range(8)], (8, m),
                   cuda_device)
    rows2 = torch.arange(8, dtype=torch.int32, device=cuda_device)
    count2 = torch.tensor([8], dtype=torch.int32, device=cuda_device)
    _check_numeric_against_plain(A2, B, rows2, count2, t_size, 8,
                                 single_access=True)


@pytest.mark.gpu
@pytest.mark.parametrize("t_size", [31, 255, 2047])
def test_cuda_many_products_on_few_columns(cuda_device, t_size):
    """96 A entries a row, every B row the same 3 columns: 288 products
    race for 3 slots (across the warps of a row where it has several).
    Values are positive, so any summation order stays within 96 * 2^-24
    relative of the plain version's."""
    rng = np.random.default_rng(5)
    k, m = 128, 40
    B = _rows_csr([np.array([5, 17, 29])] * k,
                  [rng.uniform(0.5, 1.5, 3) for _ in range(k)], (k, 64),
                  cuda_device)
    A = _rows_csr([np.sort(rng.choice(k, 96, replace=False))
                   for _ in range(m)],
                  [rng.uniform(0.5, 1.5, 96) for _ in range(m)], (m, k),
                  cuda_device)
    rows = torch.arange(m, dtype=torch.int32, device=cuda_device)
    count = torch.tensor([m], dtype=torch.int32, device=cuda_device)
    for sa in (True, False):
        for rows_per_cta in (None, 1):
            _check_numeric_against_plain(A, B, rows, count, t_size, m,
                                         single_access=sa,
                                         rows_per_cta=rows_per_cta)
        nnz, acc = tsh.symbolic_bin_call(rows, count, A.rpt, A.col, B.rpt,
                                         B.col, t_size=max(t_size, 32),
                                         rows_cap=m, single_access=sa)
        torch.cuda.synchronize()
        assert bool((nnz == 3).all()) and bool((acc >= 288).all())


@pytest.mark.gpu
@pytest.mark.parametrize("kind,t_size,rows_cap,rows_per_cta", [
    ("numeric", 31, 70, None), ("numeric", 2047, 64, None),
    ("numeric", 255, 64, 1), ("symbolic", 512, 64, None),
    ("symbolic", 12288, 16, None)])
def test_cuda_slot_kernels_count_zero(cuda_device, kind, t_size, rows_cap,
                                      rows_per_cta):
    """symbolic_bin and numeric_bin with no valid row, in each geometry:
    nnz and accesses are 0 on every row."""
    A, B = _pair()
    TA, TB = _port(A, cuda_device), _port(B, cuda_device)
    rows = torch.arange(rows_cap, dtype=torch.int32, device=cuda_device) % 96
    count = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    if kind == "symbolic":
        nnz, acc = tsh.symbolic_bin_call(rows, count, TA.rpt, TA.col, TB.rpt,
                                         TB.col, t_size=t_size,
                                         rows_cap=rows_cap)
    else:
        _, _, acc = _numeric_bin(
            (rows, count, TA.rpt, TA.col, TA.val, TB.rpt, TB.col, TB.val),
            t_size=t_size, rows_cap=rows_cap, single_access=True,
            rows_per_cta=rows_per_cta)
        nnz = torch.zeros_like(acc)
    torch.cuda.synchronize()
    assert not bool(nnz.any()) and not bool(acc.any())


# ---------------------------------------------------------------------------
# On the card: the cluster and global-memory kernels of the vmem_extended
# rungs.
# ---------------------------------------------------------------------------

EXT_SIZES = {"symbolic": EXT_SYM[2], "fused": EXT_SYM[2],
             "numeric": EXT_NUM[2]}


def _poison_allocator(device, nbytes: int) -> None:
    """Leave ``nbytes`` of 0x5A bytes in the caching allocator's free
    blocks, so a table the kernel fails to fill reads as garbage, not as
    the zeros of fresh device memory."""
    junk = torch.full((nbytes // 4,), 0x5A5A5A5A, dtype=torch.int32,
                      device=device)
    del junk


def _extended_bin(kind, A, B, rows, count, t_size, rows_cap, single_access,
                  cluster=None):
    """One bin through the wrapper (a cluster or global launch at these
    sizes), or with ``cluster`` the cluster kernel's C entry point at that
    cluster size -> (nnz or None, col_tabs or None, val_tabs or None,
    accesses)."""
    if cluster is not None:
        return _cluster_entry(kind, A, B, rows, count, t_size, rows_cap,
                              single_access, cluster)
    if kind == "symbolic":
        nnz, acc = tsh.symbolic_bin_call(
            rows, count, A.rpt, A.col, B.rpt, B.col, t_size=t_size,
            rows_cap=rows_cap, single_access=single_access)
        return nnz, None, None, acc
    args = (rows, count, A.rpt, A.col, A.val, B.rpt, B.col, B.val)
    if kind == "numeric":
        cols, vals, acc = tsh.numeric_bin_call(
            *args, t_size=t_size, rows_cap=rows_cap,
            single_access=single_access)
        return None, cols, vals, acc
    return tsh.fused_bin_call(*args, t_size=t_size, rows_cap=rows_cap,
                              single_access=single_access)


def _cluster_entry(kind, A, B, rows, count, t_size, rows_cap, single_access,
                   cluster):
    """``hash_bin_cluster`` at a given cluster size, with the wrapper's
    outputs (as ``repro_torch.kernels.ablate`` launches it)."""
    from repro_torch.kernels import build
    dev = rows.device
    with_values = kind != "symbolic"
    nnz = (torch.empty(rows_cap, dtype=torch.int32, device=dev)
           if kind != "numeric" else None)
    acc = torch.empty(rows_cap, dtype=torch.int32, device=dev)
    cols = vals = None
    if with_values:
        cols = torch.empty((rows_cap, t_size), dtype=torch.int32, device=dev)
        vals = torch.empty((rows_cap, t_size), dtype=torch.float32,
                           device=dev)

    def ptr(x):
        return None if x is None else x.data_ptr()
    build.check(build.library("spgemm_hash").hash_bin_cluster(
        int(with_values), int(single_access), rows.data_ptr(),
        count.data_ptr(), A.rpt.data_ptr(), A.col.data_ptr(),
        ptr(A.val if with_values else None), B.rpt.data_ptr(),
        B.col.data_ptr(), ptr(B.val if with_values else None), t_size,
        rows_cap, cluster, tsh.launch_geometry(t_size, 1)[1], ptr(nnz),
        ptr(cols), ptr(vals), acc.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream), "hash_bin_cluster")
    return nnz, cols, vals, acc


def _check_extended_against_plain(kind, A, B, rows, count, t_size,
                                  rows_cap, single_access, *,
                                  check_rows=None, cluster=None):
    """The card's kernel for an extended rung (the one the wrapper routes
    to, counted on its ``launches_cluster`` or ``launches_global``; or,
    with ``cluster``, the cluster kernel at that size) against the plain
    version: nnz on every row, each valid row's sorted columns exactly and
    values within VAL_TOL, accesses by the invariants (>= n_prod on valid
    rows, 0 on padding).  ``check_rows`` (a slice) compares those rows
    only, against the plain version run on them alone.  Returns the card's
    accesses."""
    fn = getattr(tsh, f"{kind}_bin_call")
    route = tsh.rung_route(t_size, 1, kind != "symbolic", rows.device)
    before = (fn.launches_cluster, fn.launches_global)
    k = _extended_bin(kind, A, B, rows, count, t_size, rows_cap,
                      single_access, cluster)
    torch.cuda.synchronize()
    if cluster is None:
        assert (fn.launches_cluster, fn.launches_global) == (
            before[0] + (route == "cluster"), before[1] + (route == "global"))
    n = int(count[0])
    sel = slice(0, rows_cap) if check_rows is None else check_rows
    p_rows = rows[sel].contiguous()
    p_cap = p_rows.shape[0]
    p_count = torch.tensor([max(0, min(n - (sel.start or 0), p_cap))],
                           dtype=torch.int32, device=rows.device)
    p = tsh.fused_bin_plain(p_rows, p_count, A.rpt, A.col, A.val, B.rpt,
                            B.col, B.val, t_size=t_size, rows_cap=p_cap)
    valid = torch.arange(p_cap, device=rows.device) < p_count
    if k[0] is not None:
        assert torch.equal(k[0][sel], p[0])        # 0 on padding rows
    if k[1] is not None:
        ks, ko = torch.sort(k[1][sel][valid], dim=1)
        ps, po = torch.sort(p[1][valid], dim=1)
        assert torch.equal(ks, ps)
        torch.testing.assert_close(k[2][sel][valid].gather(1, ko),
                                   p[2][valid].gather(1, po), **VAL_TOL)
    nprod = tnprod(A, B).long()[p_rows.long()]
    acc = k[3][sel].long()
    assert bool((acc[valid] >= nprod[valid]).all())
    assert not bool(acc[~valid].any())
    return int(acc[valid].sum())


def _heavy_rows(TA, TB, device):
    """The pair's 8 rows with the most products."""
    nprod = tnprod(TA, TB)[:TA.nrows]
    return torch.argsort(nprod, descending=True)[:8].to(torch.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("valid_rows", [0, 1, 8])
@pytest.mark.parametrize("size_rung", [0, 1, 2])
@pytest.mark.parametrize("kind", ["symbolic", "numeric", "fused"])
def test_cuda_global_kernels_match_plain(cuda_device, kind, size_rung,
                                         valid_rows):
    """Every extended table size of each kernel, on the kernel the wrapper
    routes it to (cluster or global-memory), both disciplines, on the
    pair's 8 rows with the most products, with 0, 1 and all 8 valid."""
    A, B = _pair()
    TA, TB = _port(A, cuda_device), _port(B, cuda_device)
    t_size = EXT_SIZES[kind][size_rung]
    with_values = kind != "symbolic"
    assert tsh.rung_route(t_size, 1, with_values, cuda_device) == \
        EXT_ROUTES[(t_size, with_values)][0]
    rows = _heavy_rows(TA, TB, cuda_device)
    count = torch.tensor([valid_rows], dtype=torch.int32, device=cuda_device)
    totals = {}
    for sa in (True, False):
        _poison_allocator(cuda_device, 8 * t_size * 8)
        totals[sa] = _check_extended_against_plain(kind, TA, TB, rows, count,
                                                   t_size, 8, sa)
    if valid_rows:
        assert totals[True] < totals[False]
    else:
        assert totals == {True: 0, False: 0}


# Every cluster rung of the extended ladders and every cluster size from
# the smallest that holds its table to 8 (the sizes the ablation sweeps).
CLUSTER_CASES = [(kind, t, c) for kind, sizes in EXT_SIZES.items()
                 for t in sizes
                 if EXT_ROUTES[(t, kind != "symbolic")][0] == "cluster"
                 for c in (2, 4, 8)
                 if c >= EXT_ROUTES[(t, kind != "symbolic")][1]]


@pytest.mark.gpu
@pytest.mark.parametrize("valid_rows", [0, 1, 8])
@pytest.mark.parametrize("kind,t_size,cluster", CLUSTER_CASES)
def test_cuda_cluster_kernels_match_plain(cuda_device, kind, t_size,
                                          cluster, valid_rows):
    """The cluster kernel at every cluster size a cluster rung may take,
    both disciplines, 0x5A-poisoned tables, 0, 1 and 8 valid rows."""
    A, B = _pair()
    TA, TB = _port(A, cuda_device), _port(B, cuda_device)
    rows = _heavy_rows(TA, TB, cuda_device)
    count = torch.tensor([valid_rows], dtype=torch.int32, device=cuda_device)
    totals = {}
    for sa in (True, False):
        _poison_allocator(cuda_device, 8 * t_size * 8)
        totals[sa] = _check_extended_against_plain(
            kind, TA, TB, rows, count, t_size, 8, sa, cluster=cluster)
    if valid_rows:
        assert totals[True] < totals[False]
    else:
        assert totals == {True: 0, False: 0}


@pytest.mark.gpu
def test_cuda_cluster_kernel_past_2_31_table_entries(cuda_device):
    """fused_bin on the 65,536 rung (a cluster rung) with a bucket of
    32,776 rows, every row valid: the tables hold 2^31 + 2^19 entries, and
    the last 8 rows start past entry 2^31.  Those rows and the first 8
    must match the plain version."""
    A, B = _pair()
    TA, TB = _port(A, cuda_device), _port(B, cuda_device)
    t_size, rows_cap = EXT_SYM[2][0], 32776
    assert (rows_cap - 8) * t_size >= 2 ** 31
    assert tsh.rung_route(t_size, 1, True, cuda_device) == "cluster"
    rows = (torch.arange(rows_cap, dtype=torch.int32, device=cuda_device)
            * 5) % TA.nrows
    count = torch.tensor([rows_cap], dtype=torch.int32, device=cuda_device)
    for sel in (slice(rows_cap - 8, rows_cap), slice(0, 8)):
        _check_extended_against_plain("fused", TA, TB, rows, count, t_size,
                                      rows_cap, True, check_rows=sel)
        torch.cuda.empty_cache()


@pytest.mark.gpu
def test_cuda_symbolic_cluster_rung_allocates_no_table(cuda_device):
    """symbolic_bin on a cluster rung keeps its tables in the clusters'
    shared memory: the call allocates its two (rows_cap,) outputs and no
    rows_cap x t_size scratch table, which the global rung still takes."""
    A, B = _pair()
    TA, TB = _port(A, cuda_device), _port(B, cuda_device)
    rows_cap = 1024
    rows = (torch.arange(rows_cap, dtype=torch.int32, device=cuda_device)
            * 7) % TA.nrows
    count = torch.tensor([rows_cap], dtype=torch.int32, device=cuda_device)
    args = (rows, count, TA.rpt, TA.col, TB.rpt, TB.col)
    grown = {}
    for t_size in (EXT_SYM[2][0], EXT_SYM[2][2]):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated(cuda_device)
        torch.cuda.reset_peak_memory_stats(cuda_device)
        nnz, acc = tsh.symbolic_bin_call(*args, t_size=t_size,
                                         rows_cap=rows_cap)
        torch.cuda.synchronize()
        grown[t_size] = torch.cuda.max_memory_allocated(cuda_device) - before
        del nnz, acc
    assert grown[EXT_SYM[2][0]] <= 2 * 4 * rows_cap + 2 * 512
    assert grown[EXT_SYM[2][2]] >= 4 * rows_cap * EXT_SYM[2][2]


@pytest.mark.gpu
def test_cuda_extended_launch_counters(cuda_device):
    """Each wrapper counts a cluster rung's launch in launches and
    launches_cluster, a global rung's in launches and launches_global."""
    A, B = _pair()
    TA, TB = _port(A, cuda_device), _port(B, cuda_device)
    rows = _heavy_rows(TA, TB, cuda_device)
    count = torch.tensor([8], dtype=torch.int32, device=cuda_device)
    cases = {"symbolic": (EXT_SYM[2][0], EXT_SYM[2][2]),
             "fused": (EXT_SYM[2][0], EXT_SYM[2][1]),
             "numeric": (EXT_NUM[2][1], EXT_NUM[2][2])}
    for kind, (on_cluster, on_global) in cases.items():
        fn = getattr(tsh, f"{kind}_bin_call")
        tsh.reset_launches()
        _extended_bin(kind, TA, TB, rows, count, on_cluster, 8, True)
        assert (fn.launches, fn.launches_cluster, fn.launches_global) == \
            (1, 1, 0)
        _extended_bin(kind, TA, TB, rows, count, on_global, 8, True)
        assert (fn.launches, fn.launches_cluster, fn.launches_global) == \
            (2, 1, 1)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


@pytest.mark.gpu
def test_cuda_residency_of_cluster_and_global_rungs(cuda_device):
    """A cluster rung's residency is its clusters in flight on the card,
    any other rung's its CTAs per SM; each function refuses the other's
    rungs."""
    cases = {"symbolic_bin": (EXT_SYM[2][0], EXT_SYM[2][2]),
             "fused_bin": (EXT_SYM[2][0], EXT_SYM[2][1]),
             "numeric_bin": (EXT_NUM[2][1], EXT_NUM[2][2])}
    for kind, (on_cluster, on_global) in cases.items():
        assert tsh.clusters_in_flight(on_cluster, kernel=kind,
                                      device=cuda_device) > 0
        assert tsh.ctas_per_sm(on_global, kernel=kind,
                               device=cuda_device) > 0
        with pytest.raises(ValueError, match="clusters_in_flight"):
            tsh.ctas_per_sm(on_cluster, kernel=kind, device=cuda_device)
        with pytest.raises(ValueError, match="ctas_per_sm"):
            tsh.clusters_in_flight(on_global, kernel=kind,
                                   device=cuda_device)


@pytest.mark.gpu
def test_cuda_refused_cluster_launch_raises(cuda_device, monkeypatch):
    """A cluster launch the card refuses (here a cluster of 16 blocks,
    past the portable 8, which the launch does not opt out of) raises, and
    nothing else runs in its place."""
    A, B = _pair()
    TA, TB = _port(A, cuda_device), _port(B, cuda_device)
    rows = _heavy_rows(TA, TB, cuda_device)
    count = torch.tensor([8], dtype=torch.int32, device=cuda_device)
    monkeypatch.setitem(tsh.CLUSTER_SIZES, (True, 65536), 16)
    tsh.reset_launches()
    with pytest.raises(RuntimeError, match="hash_bin_cluster"):
        tsh.fused_bin_call(rows, count, TA.rpt, TA.col, TA.val, TB.rpt,
                           TB.col, TB.val, t_size=65536, rows_cap=8)
    assert [(f.launches, f.launches_cluster, f.launches_global)
            for f in tsh.KERNELS] == [(0, 0, 0)] * 3


@pytest.mark.gpu
def test_cuda_global_kernel_past_2_31_table_entries(cuda_device):
    """numeric_bin on the 524,288 rung with a bucket of 4,104 rows, every
    row valid: the tables hold 2^31 + 2^22 entries, and the last 8 rows
    start past entry 2^31.  Those rows and the first 8 must match the
    plain version."""
    A, B = _pair()
    TA, TB = _port(A, cuda_device), _port(B, cuda_device)
    t_size, rows_cap = EXT_NUM[2][2], 4104
    assert (rows_cap - 8) * t_size >= 2 ** 31
    assert tsh.rung_route(t_size, 1, True, cuda_device) == "global"
    rows = (torch.arange(rows_cap, dtype=torch.int32, device=cuda_device)
            * 5) % TA.nrows
    count = torch.tensor([rows_cap], dtype=torch.int32, device=cuda_device)
    for sel in (slice(rows_cap - 8, rows_cap), slice(0, 8)):
        _check_extended_against_plain("numeric", TA, TB, rows, count,
                                      t_size, rows_cap, True, check_rows=sel)
        torch.cuda.empty_cache()


@pytest.mark.gpu
def test_cuda_global_rung_refuses_packing(cuda_device):
    """A packed launch cannot take the cluster or the global kernel: the
    wrapper raises before launching."""
    A, B = _pair()
    TA, TB = _port(A, cuda_device), _port(B, cuda_device)
    rows = torch.arange(8, dtype=torch.int32, device=cuda_device)
    count = torch.tensor([8], dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="one row a block"):
        tsh.fused_bin_call(rows, count, TA.rpt, TA.col, TA.val, TB.rpt,
                           TB.col, TB.val, t_size=65536, rows_cap=8, pack=2)
