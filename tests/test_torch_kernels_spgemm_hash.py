"""Port parity: the kernel-level cases of tests/test_kernels_spgemm_hash.py,
and the hash kernels in the reference's 16-bit value types.

On the CPU the port's binned drivers (the kernels' plain versions) run the
reference's sweeps (``:28``, ``:42``, ``:60``, ``:74``, ``:237``) on the
reference's own matrices (``PRNGKey`` seeds) and must give the reference's
results: nnz and access counts exactly, values within the reference's
tolerance.  ``:42`` also runs in bfloat16 and float16, where the tables hold
the value type as the reference's do.

Tolerance of a 16-bit value: at shapes where no entry of C sums more
than 8 products, within 4e-2 * (|A| |B|)_ij + 1e-3 in bfloat16 and
4e-3 * (|A| |B|)_ij + 1e-4 in float16 of the exact product.  The n
products' roundings move the entry by at most u (|A| |B|)_ij together,
and each of its n - 1 sums by at most u (|A| |B|)_ij, with u the type's
unit roundoff (2^-8, 2^-11), so for n <= 8 the error is below
8 u (|A| |B|)_ij: 3.1e-2 and 3.9e-3 of it; the absolute terms cover
float16's subnormals (a step of 2^-24).

On the card (``gpu``) the 16-bit kernels are held against their plain
versions on every route (shared memory, cluster, global memory): in the
fixed-order mode bit for bit, and otherwise within the bound that two
orders of the same sum can differ by: 3 n (u S + e) for n products of
absolute sum S (the same rounded products, n - 1 rounded sums each way;
e the type's subnormal step).
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import (bin_rows_for_ladder, esc, next_bucket,
                        nprod_into_rpt, random_csr)
from repro.core.analysis import exclusive_sum_in_place
from repro.core.binning_ranges import (make_ladder, numeric_ladder,
                                       symbolic_ladder)
from repro.core.spgemm import SpgemmConfig as JConfig
from repro.core.spgemm import spgemm as jspgemm
from repro.kernels import ref as kref
from repro.kernels import spgemm_hash
from repro_torch import convert
from repro_torch.core import binning as tbinning
from repro_torch.core import binning_ranges as tranges
from repro_torch.core import esc as tesc
from repro_torch.core.analysis import exclusive_sum_in_place as texcl
from repro_torch.core.analysis import nprod_into_rpt as tnprod
from repro_torch.core.csr import CSR, prng_key_seed
from repro_torch.core.csr import random_csr as trandom_csr
from repro_torch.core.spgemm import SpgemmConfig, spgemm
from repro_torch.kernels import spgemm_hash as tsh

JAX_TYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
             torch.float16: jnp.float16}
# (relative to (|A| |B|)_ij, absolute): see the module docstring.
BOUND = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (4e-2, 1e-3),
         torch.float16: (4e-3, 1e-4)}
UNIT_ROUNDOFF = {torch.bfloat16: 2.0 ** -8, torch.float16: 2.0 ** -11}
SUBNORMAL_STEP = {torch.bfloat16: 2.0 ** -133, torch.float16: 2.0 ** -24}
MAX_PRODUCTS = 8


def _pair(seed, m, k, n, da, db, dist="uniform", dtype=jnp.float32):
    """tests/test_kernels_spgemm_hash.py's ``_pair``."""
    A = random_csr(jax.random.PRNGKey(seed), m, k, avg_nnz_per_row=da,
                   distribution=dist, dtype=dtype)
    B = random_csr(jax.random.PRNGKey(seed + 100), k, n, avg_nnz_per_row=db,
                   distribution=dist, dtype=dtype)
    return A, B


def _port(M, device="cpu"):
    val = np.asarray(M.val)
    if val.dtype.name in ("bfloat16", "float16"):
        val = val.astype(np.float32)     # exact; cast back below
    C = convert.csr_from_reference(np.asarray(M.rpt), np.asarray(M.col),
                                   val, M.shape, device=device)
    dt = {"bfloat16": torch.bfloat16,
          "float16": torch.float16}.get(np.asarray(M.val).dtype.name)
    return C if dt is None else _with_val(C, C.val.to(dt))


def _with_val(M, val):
    return CSR(rpt=M.rpt, col=M.col, val=val, shape=M.shape)


def _dense(M) -> np.ndarray:
    """A port or reference CSR as a float64 dense matrix."""
    if isinstance(M.rpt, torch.Tensor):
        rpt, col, val = (x.cpu() for x in (M.rpt, M.col, M.val))
        rpt, col, val = rpt.numpy(), col.numpy(), val.double().numpy()
    else:
        rpt, col = np.asarray(M.rpt), np.asarray(M.col)
        val = np.asarray(M.val).astype(np.float64)
    out = np.zeros(M.shape)
    for i in range(M.shape[0]):
        s = slice(rpt[i], rpt[i + 1])
        np.add.at(out[i], col[s], val[s])
    return out


def _products_per_entry(dA: np.ndarray, dB: np.ndarray) -> int:
    return int(((dA != 0).astype(np.int64) @ (dB != 0)).max(initial=0))


def _assert_within_bound(got: np.ndarray, dA, dB, dtype):
    """|C - A B| <= rel * (|A| |B|) + abs, elementwise (float64)."""
    rel, tol = BOUND[dtype]
    exact = dA @ dB
    mag = np.abs(dA) @ np.abs(dB)
    err = np.abs(got - exact)
    assert (err <= rel * mag + tol).all(), float((err - rel * mag).max())


# ---------------------------------------------------------------------------
# The reference's kernel sweeps on the port (CPU: the plain versions).
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(16, 16, 16, 2.0, 2.0),
                                   (48, 32, 64, 4.0, 3.0),
                                   (9, 130, 7, 8.0, 1.5),
                                   (64, 64, 64, 6.0, 6.0)])
@pytest.mark.parametrize("single_access", [True, False])
def test_symbolic_kernel_sweep(shape, single_access):
    """:28: symbolic_binned's nnz is the support's, and the reference's."""
    m, k, n, da, db = shape
    A, B = _pair(int(m + n), m, k, n, da, db)
    lad = symbolic_ladder(1.2)
    want = np.asarray(spgemm_hash.symbolic_binned(
        A, B, bin_rows_for_ladder(nprod_into_rpt(A, B)[:m], lad), lad,
        prod_capacity=1, single_access=single_access))
    TA, TB = _port(A), _port(B)
    tlad = tranges.symbolic_ladder(1.2)
    nnz = tsh.symbolic_binned(
        TA, TB, tbinning.bin_rows_for_ladder(tnprod(TA, TB)[:m], tlad), tlad,
        single_access=single_access)
    np.testing.assert_array_equal(nnz[:m].numpy(), kref.row_nnz_from_support(
        A, B))
    np.testing.assert_array_equal(nnz.numpy(), want)


def _numeric_binned_port(TA, TB, m, single_access):
    nnz_buf = tesc.symbolic(TA, TB, prod_capacity=next_bucket(4096))
    rpt = texcl(nnz_buf)
    cap = next_bucket(int(rpt[-1]))
    lad = tranges.numeric_ladder(2.0)
    bn = tbinning.bin_rows_for_ladder(nnz_buf[:m], lad)
    return tsh.numeric_binned(TA, TB, rpt, bn, lad, nnz_capacity=cap,
                              single_access=single_access)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("single_access", [True, False])
def test_numeric_kernel_sweep(dtype, single_access):
    """:42, with bfloat16 and float16 beside float32: numeric_binned's C
    against the dense product (the module's bound) and against the
    reference's numeric_binned in the same type (rpt and col exactly,
    values within the bound of each other)."""
    m, k, n = 40, 48, 36
    A, B = _pair(5, m, k, n, 5.0, 4.0, dtype=JAX_TYPES[dtype])
    dA, dB = _dense(A), _dense(B)
    assert _products_per_entry(dA, dB) <= MAX_PRODUCTS
    nnz_buf = esc.symbolic(A, B, prod_capacity=next_bucket(4096))
    rpt = exclusive_sum_in_place(nnz_buf)
    lad = numeric_ladder(2.0)
    jC = spgemm_hash.numeric_binned(
        A, B, rpt, bin_rows_for_ladder(nnz_buf[:m], lad), lad,
        prod_capacity=1, nnz_capacity=next_bucket(int(rpt[-1])),
        single_access=single_access)
    TA, TB = _port(A), _port(B)
    C = _numeric_binned_port(TA, TB, m, single_access)
    assert C.val.dtype == dtype
    _assert_within_bound(_dense(C), dA, dB, dtype)
    nn = int(C.rpt[-1])
    np.testing.assert_array_equal(C.rpt.numpy(), np.asarray(jC.rpt))
    np.testing.assert_array_equal(C.col[:nn].numpy(),
                                  np.asarray(jC.col)[:nn])
    np.testing.assert_allclose(
        C.val[:nn].double().numpy(),
        np.asarray(jC.val)[:nn].astype(np.float64),
        rtol=BOUND[dtype][0], atol=BOUND[dtype][1])


def test_tiny_ladder_forces_every_rung():
    """:60: tiny tables put rows on several rungs and the fallback."""
    m = 96
    A, B = _pair(9, m, 200, 150, 10.0, 8.0, dist="powerlaw")
    TA, TB = _port(A), _port(B)
    lad = tranges.make_ladder((32, 64, 128), 1.2, (32, 64, 128))
    bn = tbinning.bin_rows_for_ladder(tnprod(TA, TB)[:m], lad)
    assert (bn.bin_size > 0).sum() >= 2, bn.bin_size
    jlad = make_ladder((32, 64, 128), 1.2, (32, 64, 128))
    jbn = bin_rows_for_ladder(nprod_into_rpt(A, B)[:m], jlad)
    np.testing.assert_array_equal(bn.bin_size.numpy(),
                                  np.asarray(jbn.bin_size))
    nnz = tsh.symbolic_binned(TA, TB, bn, lad)
    np.testing.assert_array_equal(nnz[:m].numpy(),
                                  kref.row_nnz_from_support(A, B))


def test_single_access_reduces_transactions():
    """:74, Fig. 9's mechanism: single access takes fewer transactions, and
    the port counts the reference's exactly."""
    m = 64
    A, B = _pair(21, m, 80, 90, 6.0, 5.0)
    lad = symbolic_ladder(1.2)
    jbn = bin_rows_for_ladder(nprod_into_rpt(A, B)[:m], lad)
    TA, TB = _port(A), _port(B)
    tlad = tranges.symbolic_ladder(1.2)
    bn = tbinning.bin_rows_for_ladder(tnprod(TA, TB)[:m], tlad)
    acc = {}
    for single in (True, False):
        _, want = spgemm_hash.symbolic_binned(
            A, B, jbn, lad, prod_capacity=1, single_access=single,
            collect_accesses=True)
        _, acc[single] = tsh.symbolic_binned(
            TA, TB, bn, tlad, single_access=single, collect_accesses=True)
        assert int(acc[single]) == int(want)
    assert int(acc[True]) < int(acc[False])


def test_numeric_epilogue_sorted_and_complete():
    """:237: every row of numeric_binned's C is sorted and complete, and
    C is the reference's."""
    m, k, n = 32, 32, 32
    A, B = _pair(33, m, k, n, 4.0, 4.0)
    TA, TB = _port(A), _port(B)
    nnz_buf = tesc.symbolic(TA, TB, prod_capacity=2048)
    rpt = texcl(nnz_buf)
    lad = tranges.numeric_ladder(2.0)
    C = tsh.numeric_binned(TA, TB, rpt,
                           tbinning.bin_rows_for_ladder(nnz_buf[:m], lad),
                           lad, nnz_capacity=next_bucket(int(rpt[-1])))
    rptn, coln = C.rpt.numpy(), C.col.numpy()
    for i in range(m):
        seg = coln[rptn[i]:rptn[i + 1]]
        assert (np.diff(seg) > 0).all()
    np.testing.assert_array_equal(rptn[1:] - rptn[:-1],
                                  kref.row_nnz_from_support(A, B))
    np.testing.assert_allclose(_dense(C), _dense(A) @ _dense(B), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# 16-bit values end to end: the port's spgemm against the reference's.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["hash", "esc"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_spgemm_value_types_match_reference(dtype, method):
    """spgemm(A, B) in each value type on the CPU: C's rpt and col are the
    reference's (Pallas in interpret mode) exactly, its values within the
    module's bound of the exact product and of the reference's."""
    A, B = _pair(7, 48, 40, 44, 4.0, 3.0, dtype=JAX_TYPES[dtype])
    dA, dB = _dense(A), _dense(B)
    assert _products_per_entry(dA, dB) <= MAX_PRODUCTS
    jC = jspgemm(A, B, JConfig(method=method)).C
    C = spgemm(_port(A), _port(B), SpgemmConfig(method=method)).C
    assert C.val.dtype == dtype
    nn = int(C.rpt[-1])
    np.testing.assert_array_equal(C.rpt.numpy(), np.asarray(jC.rpt))
    np.testing.assert_array_equal(C.col[:nn].numpy(),
                                  np.asarray(jC.col)[:nn])
    _assert_within_bound(_dense(C), dA, dB, dtype)
    np.testing.assert_allclose(
        C.val[:nn].double().numpy(),
        np.asarray(jC.val)[:nn].astype(np.float64),
        rtol=BOUND[dtype][0], atol=BOUND[dtype][1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_fused_route_follows_the_value_type(dtype):
    """A fused table takes 8 B an entry in shared memory in every value
    type (float32 keys and values side by side, a 16-bit value in the slot
    kernel's 64-bit slot), so the 32,768-entry rung (262,152 B of a
    block's 232,448) goes to a cluster in every type, as numeric_bin's
    does, and the default ladder's top rung (196,616 B) fits a block; the
    launch is the type's own entry point."""
    limit = 232448
    assert tsh.table_bytes(32768, 1, True) == \
        32768 * 8 + tsh.ROW_COUNTER_BYTES
    assert tsh.hash_route(32768, 1, True, limit) == "cluster"
    assert tsh.hash_route(24576, 1, True, limit) == "smem"
    assert tsh.hash_route(65536, 1, True, limit) == "cluster"
    assert tsh.table_bytes(255, 1, True) == 255 * 8 + 8
    assert tsh.table_bytes(255, 1, False) == 255 * 4 + 8
    sfx = {torch.float32: "", torch.bfloat16: "_bf16",
           torch.float16: "_f16"}[dtype]
    assert tsh.entry_point("fused_bin", dtype, False) == "fused_bin" + sfx
    assert tsh.entry_point("numeric_bin", dtype, True) == \
        "numeric_bin_ordered" + sfx


# The default fused ladder's rungs and the blocks of their launch an SM
# holds: one block a row of t/8 threads (64 to 1,024), 8 B an entry.
FUSED_CTAS_PER_SM = {512: 32, 1024: 16, 2048: 8, 4096: 4, 8192: 2,
                     12288: 2, 24576: 1}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("ordered", [False, True])
def test_fused_16bit_launch_geometry_and_shared_memory(dtype, ordered):
    """The 16-bit fused_bin call on the shared-memory route: its entry
    point (which launches slot_rows_kernel), float32's geometry, and a
    block's shared memory at 8 B an entry (the fixed-order instance's
    stage beside it) within the card's 232,448 B on every rung of both
    ladders that takes that route.  On the default ladder the threads, not
    the 8 B, bound the blocks an SM holds (2,048 threads, 32 blocks,
    233,472 B with 1 KB a block), but on the top rung, which one block
    fills in 6 B an entry as well."""
    limit, sm_bytes = 232448, 233472
    seen = 0
    for lad in (tranges.symbolic_ladder(), tranges.symbolic_ladder(
            vmem_extended=True)):
        for t_size in lad.table_sizes:
            rows_per_cta, threads = tsh.launch_geometry(t_size, 1)
            if tsh.hash_route(t_size, rows_per_cta, True, limit) != "smem":
                assert t_size > 24576
                continue
            smem = (tsh.ordered_smem_bytes(t_size, rows_per_cta, threads)
                    if ordered else tsh.table_bytes(t_size, rows_per_cta,
                                                    True))
            assert smem <= limit, (t_size, smem)
            assert tsh.table_bytes(t_size, rows_per_cta, True) == \
                8 * t_size + tsh.ROW_COUNTER_BYTES
            seen += 1
    assert seen == 2 * len(tranges.symbolic_ladder().table_sizes)
    for t_size, want in FUSED_CTAS_PER_SM.items():
        rows_per_cta, threads = tsh.launch_geometry(t_size, 1)
        assert rows_per_cta == 1 and threads == min(1024, t_size // 8)
        by_threads = min(32, 2048 // threads)
        by_smem = sm_bytes // (tsh.table_bytes(t_size, 1, True) + 1024)
        assert min(by_threads, by_smem) == want
        assert by_threads == want or (t_size == 24576 and sm_bytes // (
            6 * t_size + 8 + 1024) == want)
    assert tsh.entry_point("fused_bin", dtype, ordered) == (
        "fused_bin" + ("_ordered" if ordered else "")
        + ("_bf16" if dtype == torch.bfloat16 else "_f16"))


def test_cuda_inputs_of_mixed_or_other_types_raise():
    """The CUDA wrappers' input check: int32 indices, values of one of the
    three types; float64 or mixed values raise (checked without a card)."""
    rows = torch.zeros(8, dtype=torch.int32)
    count = torch.zeros(1, dtype=torch.int32)
    ok = torch.zeros(4, dtype=torch.bfloat16)
    tsh._check_cuda_inputs(rows, count, [], [("a_val", ok), ("b_val", ok)],
                           8)
    for a, b in ((ok, ok.float()), (ok.double(), ok.double())):
        with pytest.raises(ValueError):
            tsh._check_cuda_inputs(rows, count, [],
                                   [("a_val", a), ("b_val", b)], 8)


# ---------------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hash kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("single_access", [True, False])
def test_cuda_numeric_kernel_sweep(cuda_device, dtype, single_access):
    """:42 on the card, in each value type: numeric_binned's C within the
    module's bound of the exact product."""
    m, k, n = 40, 48, 36
    A, B = _pair(5, m, k, n, 5.0, 4.0, dtype=JAX_TYPES[dtype])
    dA, dB = _dense(A), _dense(B)
    before = tsh.numeric_bin_call.launches
    C = _numeric_binned_port(_port(A, cuda_device), _port(B, cuda_device), m,
                             single_access)
    assert tsh.numeric_bin_call.launches > before
    assert C.val.dtype == dtype
    _assert_within_bound(_dense(C), dA, dB, dtype)


# (kind, t_size, pack, rows): the shared-memory rungs (packed and not, the
# mod-hashed numeric sizes), fused 32,768 (past a block at 8 B an entry: a
# cluster, as in float32), and the cluster and global-memory rungs of the
# extended ladders.
CARD_CASES = [("fused", 256, 1, 96), ("fused", 256, 4, 96),
              ("fused", 32768, 1, 8), ("fused", 65536, 1, 8),
              ("fused", 262144, 1, 8), ("numeric", 255, 1, 96),
              ("numeric", 1023, 1, 96), ("numeric", 32768, 1, 8),
              ("numeric", 131072, 1, 8), ("numeric", 524288, 1, 8)]


def card_case(kind, t_size, pack, n_rows, dtype, device, seed=3):
    """The kernel's inputs: a 96 x 96 powerlaw pair in ``dtype`` (the
    reference's PRNGKey(seed) and PRNGKey(seed + 100) matrices) and its
    ``n_rows`` rows with the most products, 8 rows of padding after them.
    -> (A, B, rows, count, rows_cap)."""
    A, B = (trandom_csr(prng_key_seed(s), 96, 96, avg_nnz_per_row=a,
                        distribution="powerlaw", dtype=dtype, device=device)
            for s, a in ((seed, 5.0), (seed + 100, 4.0)))
    order = torch.argsort(tnprod(A, B)[:96], descending=True, stable=True)
    rows_cap = n_rows + 8
    rows = torch.zeros(rows_cap, dtype=torch.int32, device=device)
    rows[:n_rows] = order[:n_rows].to(torch.int32)
    count = torch.tensor([n_rows], dtype=torch.int32, device=device)
    return A, B, rows, count, rows_cap


def kernel_outputs(kind, A, B, rows, count, t_size, rows_cap, pack,
                   single_access=True):
    """(nnz, col_tabs, val_tabs, accesses) of one launch of ``kind``'s
    wrapper (the plain version on CPU tensors); nnz None for numeric."""
    args = (rows, count, A.rpt, A.col, A.val, B.rpt, B.col, B.val)
    if kind == "numeric":
        return (None, *tsh.numeric_bin_call(
            *args, t_size=t_size, rows_cap=rows_cap,
            single_access=single_access))
    return tsh.fused_bin_call(*args, t_size=t_size, rows_cap=rows_cap,
                              pack=pack, single_access=single_access)


def kernel_tables(kind, A, B, rows, count, t_size, rows_cap, pack,
                  single_access=True):
    """(col_tabs, val_tabs) of :func:`kernel_outputs`."""
    return kernel_outputs(kind, A, B, rows, count, t_size, rows_cap, pack,
                          single_access)[1:3]


def sorted_rows(cols, vals, n_valid):
    """Each valid row's table sorted by column: (cols, vals)."""
    c, order = torch.sort(cols[:n_valid], dim=1)
    return c, vals[:n_valid].gather(1, order)


def order_bound(A, B, rows, count, t_size, rows_cap, dtype):
    """3 n (u S + e) per table entry, in the plain version's sorted
    layout: the most that two summation orders of the entry's n products
    (absolute sum S) can differ by."""
    n = int(count[0])
    cpu = [x.cpu() for x in (rows, count)]
    absA, absB = (_with_val(M.to("cpu"), M.val.abs().cpu()) for M in (A, B))
    ones = [_with_val(M.to("cpu"), torch.ones_like(M.val.cpu(),
                                                   dtype=torch.float32))
            for M in (A, B)]
    c1, s = kernel_tables("fused", absA, absB, *cpu, t_size, rows_cap, 1)
    c2, k = kernel_tables("fused", *ones, *cpu, t_size, rows_cap, 1)
    _, s = sorted_rows(c1, s.float(), n)
    _, k = sorted_rows(c2, k, n)
    return 3 * k * (UNIT_ROUNDOFF[dtype] * s + SUBNORMAL_STEP[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("ordered", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("kind,t_size,pack,n_rows", CARD_CASES)
def test_cuda_16bit_kernels_match_plain(cuda_device, kind, t_size, pack,
                                        n_rows, dtype, ordered):
    """Each 16-bit kernel on each route against its plain version on the
    card: the valid rows' sorted columns exactly; values bit for bit under
    torch.use_deterministic_algorithms(True), else within the bound of two
    summation orders; fused_bin's nnz equal to the plain version's; at
    least one access a product on every valid row and none on padding;
    the launch counted on the route hash_route names."""
    A, B, rows, count, rows_cap = card_case(kind, t_size, pack, n_rows,
                                            dtype, cuda_device)
    n = int(count[0])
    pn, pc, pv, _ = kernel_outputs(kind, A.to("cpu"), B.to("cpu"),
                                   rows.cpu(), count.cpu(), t_size, rows_cap,
                                   pack)
    fn = getattr(tsh, f"{kind}_bin_call")
    rpc = (tsh.numeric_launch_geometry(t_size)[0] if kind == "numeric"
           else tsh.launch_geometry(t_size, pack)[0])
    route = tsh.rung_route(t_size, rpc, True, cuda_device)
    before = (fn.launches, fn.launches_cluster, fn.launches_global,
              fn.launches_ordered)
    mode = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(ordered)
    try:
        kn, kc, kv, ka = kernel_outputs(kind, A, B, rows, count, t_size,
                                        rows_cap, pack)
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(mode)
    assert kv.dtype == dtype
    if kind == "fused":
        assert torch.equal(kn.cpu(), pn)
    nprod = tnprod(A, B)[rows.long()].cpu().long()
    acc = ka.cpu().long()
    assert bool((acc[:n] >= nprod[:n]).all()) and not acc[n:].any()
    assert (fn.launches - before[0], fn.launches_cluster - before[1],
            fn.launches_global - before[2],
            fn.launches_ordered - before[3]) == (
        1, int(route == "cluster"), int(route == "global"), int(ordered))
    ks, kvs = sorted_rows(kc.cpu(), kv.cpu(), n)
    ps, pvs = sorted_rows(pc, pv, n)
    assert torch.equal(ks, ps)
    if ordered:
        assert torch.equal(kvs.view(torch.int16), pvs.view(torch.int16))
    else:
        bound = order_bound(A, B, rows, count, t_size, rows_cap, dtype)
        assert bool(((kvs.float() - pvs.float()).abs() <= bound).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("kind,t_size,pack,n_rows", CARD_CASES)
def test_cuda_16bit_single_access_below_check_then_cas(cuda_device, kind,
                                                       t_size, pack, n_rows,
                                                       dtype):
    """Each 16-bit kernel on each route: single access takes fewer table
    accesses than check-then-CAS on the same bin, and both build the same
    tables (sorted columns, and fused_bin's nnz)."""
    A, B, rows, count, rows_cap = card_case(kind, t_size, pack, n_rows,
                                            dtype, cuda_device)
    n = int(count[0])
    out = {sa: kernel_outputs(kind, A, B, rows, count, t_size, rows_cap,
                              pack, single_access=sa)
           for sa in (True, False)}
    torch.cuda.synchronize()
    acc = {sa: int(o[3].long().sum()) for sa, o in out.items()}
    assert acc[True] < acc[False], acc
    assert torch.equal(sorted_rows(out[True][1], out[True][2], n)[0],
                       sorted_rows(out[False][1], out[False][2], n)[0])
    if kind == "fused":
        assert torch.equal(out[True][0], out[False][0])


@pytest.mark.gpu
def test_cuda_16bit_instances_one_cas_and_no_spill(cuda_device):
    """Every 16-bit instance of the shared-memory kernels is
    slot_rows_kernel's (hash_rows_kernel has none): 0 spill bytes at its
    32 registers, a 64-bit shared-memory CAS (ATOMS.CAS.64) on its insert
    path and no CAS spin loop on a value word."""
    from repro_torch.kernels import build
    build.library("spgemm_hash")
    bodies = ("hash_rows_kernel", "hash_rows_kernel_ordered",
              "slot_rows_kernel")

    def value_type(kernel):
        return int(kernel.rstrip(">").split(",")[-1])
    lines = [x for x in build.ptxas_report("spgemm_hash")
             if x.split("<")[0] in bodies and value_type(x.split(":")[0])]
    assert lines and all(x.startswith("slot_rows_kernel<") for x in lines)
    assert len(lines) == 8, lines        # 2 disciplines x 2 modes x 2 types
    for x in lines:
        assert int(re.search(r"Used (\d+) registers", x).group(1)) <= 32, x
        assert "0 bytes spill stores, 0 bytes spill loads" in x, x
    for kernel, ops in build.sass_opcodes("spgemm_hash").items():
        if kernel.split("<")[0] in bodies and value_type(kernel):
            # (the parent's 16-bit add was a CAS loop: ATOM.E.CAS on the
            # value's 32-bit word, beside the key's ATOMS.CAS)
            assert ops.get("ATOMS.CAS.64", 0) > 0, (kernel, ops)
            assert all(op == "ATOMS.CAS.64" for op in ops if "CAS" in op), \
                (kernel, ops)


# ---------------------------------------------------------------------------
# The fixed-order value pass under stress: rows whose slots take long or
# lopsided chains of adds.  Each of a row's warps adds the products whose
# slot it owns, so these are the shapes where a wrong order would show.
# ---------------------------------------------------------------------------

STRESS_N = 96
STRESS_PATTERNS = ("one_column", "long_b_row", "dense_30")


def stress_pair(pattern, seed=11):
    """(A, B): two 96 x 96 matrices as numpy CSR triples (rpt, col, val
    float32 from a normal draw, so that another summation order gives
    other bits):
      one_column  every A row dense, every B row column 7 alone: a row's
                  96 products all go to one slot, which one warp owns;
      long_b_row  every A row one entry, every B row dense: one entry's
                  products fill the row's batches;
      dense_30    A rows of 90 entries, B rows of 30: about 28 products a
                  column, more than mono_500Hz's compression of 4.93."""
    rng = np.random.default_rng(seed)
    n = STRESS_N
    if pattern == "one_column":
        a_rows, b_rows = [np.arange(n)] * n, [np.array([7])] * n
    elif pattern == "long_b_row":
        a_rows = [np.array([(7 * i) % n]) for i in range(n)]
        b_rows = [np.arange(n)] * n
    else:
        a_rows = [rng.choice(n, 90, replace=False) for _ in range(n)]
        b_rows = [rng.choice(n, 30, replace=False) for _ in range(n)]

    def csr(rows):
        col = np.concatenate([np.sort(r) for r in rows]).astype(np.int32)
        rpt = np.concatenate([[0], np.cumsum([len(r) for r in rows])])
        return (rpt.astype(np.int32), col,
                rng.standard_normal(col.size).astype(np.float32))
    return csr(a_rows), csr(b_rows)


def _products_per_column(a, b, row):
    """The row of A B's products on each of its columns (numpy)."""
    (a_rpt, a_col, _), (b_rpt, b_col, _) = a, b
    ks = a_col[a_rpt[row]:a_rpt[row + 1]]
    cols = np.concatenate([b_col[b_rpt[k]:b_rpt[k + 1]] for k in ks])
    counts = np.bincount(cols, minlength=STRESS_N)
    return counts[counts > 0]


def _occupied_sorted(cols, vals, row):
    """A raw table row's occupied entries sorted by column: (cols, value
    bits)."""
    c = np.asarray(cols[row])
    v = np.asarray(vals[row], dtype=np.float32)
    keep = c >= 0
    order = np.argsort(c[keep], kind="stable")
    return c[keep][order], v[keep][order].view(np.int32)


@pytest.mark.parametrize("pattern", ["one_column", "dense_30"])
@pytest.mark.parametrize("kind,t_size", [("fused", 128), ("numeric", 127)])
def test_plain_matches_reference_bitwise_at_high_compression(kind, t_size,
                                                             pattern):
    """The reference's fused_bin_call / numeric_bin_call (Pallas, in
    interpret mode off the TPU, as its own tests run them) and the port's
    plain versions on rows of 16 or more products a column: nnz and
    accesses equal, and each row's occupied entries the same columns with
    the same float32 bits.  The card's fixed-order kernels are held to
    these plain versions bit for bit."""
    a, b = stress_pair(pattern)
    n_rows, rows_cap = 8, 16
    assert all(_products_per_column(a, b, i).mean() >= 16
               for i in range(n_rows))
    rows = np.zeros(rows_cap, np.int32)
    rows[:n_rows] = np.arange(n_rows)
    count = np.array([n_rows], np.int32)
    mats = (*a, *b)
    ref_fn = getattr(spgemm_hash, f"{kind}_bin_call")
    port_fn = getattr(tsh, f"{kind}_bin_call")
    want = ref_fn(jnp.asarray(rows), jnp.asarray(count),
                  *(jnp.asarray(x) for x in mats), t_size=t_size,
                  rows_cap=rows_cap, single_access=True)
    got = port_fn(torch.from_numpy(rows), torch.from_numpy(count),
                  *(torch.from_numpy(x) for x in mats), t_size=t_size,
                  rows_cap=rows_cap, single_access=True)
    got = [np.asarray(x) for x in got]
    want = [np.asarray(x) for x in want]
    if kind == "fused":
        np.testing.assert_array_equal(got[0], want[0])      # nnz
        got, want = got[1:], want[1:]
    np.testing.assert_array_equal(got[2], want[2])          # accesses
    for i in range(n_rows):
        gc, gv = _occupied_sorted(got[0], got[1], i)
        wc, wv = _occupied_sorted(want[0], want[1], i)
        np.testing.assert_array_equal(gc, wc)
        np.testing.assert_array_equal(gv, wv)


def test_ordered_shared_memory_fits_every_rung():
    """Every rung of the reference's ladders that takes the shared-memory
    route on the H100 (232,448 B a block) keeps it in the fixed-order mode:
    its tables and the value pass's stage (ordered_smem_bytes) fit (8 B an
    entry in every value type)."""
    limit = 232_448
    ladders = {
        "fused_bin": [tranges.symbolic_ladder(vmem_extended=e)
                      for e in (False, True)],
        "numeric_bin": [tranges.numeric_ladder(vmem_extended=e)
                        for e in (False, True)]}
    seen = 0
    for kind, lads in ladders.items():
        for lad in lads:
            for t_size in lad.table_sizes:
                rpc, threads = (tsh.numeric_launch_geometry(t_size)
                                if kind == "numeric_bin"
                                else tsh.launch_geometry(t_size, 1))
                if tsh.hash_route(t_size, rpc, True, limit) != "smem":
                    continue
                need = tsh.ordered_smem_bytes(t_size, rpc, threads)
                assert need <= limit, (kind, t_size, need)
                seen += 1
    assert seen > 0
    # One warp a row: no stage; W warps: 8 B a thread, W (W + 1) words of
    # counts and 4 B to align.
    assert tsh.ordered_smem_bytes(255, 8, 32) == tsh.table_bytes(255, 8,
                                                                 True)
    assert tsh.ordered_smem_bytes(8192, 1, 1024) == (
        tsh.table_bytes(8192, 1, True) + 8 * 1024 + 4 * 32 * 33 + 4)
    with pytest.raises(ValueError):
        tsh.ordered_smem_bytes(256, 4, 64)


def stress_case(pattern, dtype, device, n_rows):
    """stress_pair's matrices in ``dtype`` on ``device``, and a bin of
    their first ``n_rows`` rows with 8 rows of padding after them.
    -> (A, B, rows, count, rows_cap)."""
    mats = []
    for rpt, col, val in stress_pair(pattern):
        M = convert.csr_from_reference(rpt, col, val, (STRESS_N, STRESS_N),
                                       device=device)
        mats.append(_with_val(M, M.val.to(dtype)))
    rows_cap = n_rows + 8
    rows = torch.zeros(rows_cap, dtype=torch.int32, device=device)
    rows[:n_rows] = torch.arange(n_rows, dtype=torch.int32, device=device)
    count = torch.tensor([n_rows], dtype=torch.int32, device=device)
    return (*mats, rows, count, rows_cap)


# (kind, t_size, pack, route): one warp a row (256, packed and not), a few
# warps (numeric 1023) and 32 (8192 / 8191) on the shared-memory route,
# then the cluster and the global-memory routes.
STRESS_ROUTES = [("fused", 256, 1, "smem"), ("fused", 256, 4, "smem"),
                 ("fused", 8192, 1, "smem"), ("fused", 65536, 1, "cluster"),
                 ("fused", 262144, 1, "global"),
                 ("numeric", 1023, 1, "smem"), ("numeric", 8191, 1, "smem"),
                 ("numeric", 131072, 1, "cluster"),
                 ("numeric", 524288, 1, "global")]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pattern", STRESS_PATTERNS)
@pytest.mark.parametrize("kind,t_size,pack,route", STRESS_ROUTES)
def test_cuda_fixed_order_stress_bitwise(cuda_device, kind, t_size, pack,
                                         route, pattern, dtype):
    """The fixed-order kernel on stress_pair's rows, on each route, against
    its plain version: the valid rows' sorted columns exactly and their
    values bit for bit; the launch counted as fixed-order on the route
    named."""
    n_rows = 16 if route == "smem" else 8
    A, B, rows, count, rows_cap = stress_case(pattern, dtype, cuda_device,
                                              n_rows)
    rpc = (tsh.numeric_launch_geometry(t_size)[0] if kind == "numeric"
           else tsh.launch_geometry(t_size, pack)[0])
    assert tsh.rung_route(t_size, rpc, True, cuda_device) == route
    pc, pv = kernel_tables(kind, A.to("cpu"), B.to("cpu"), rows.cpu(),
                           count.cpu(), t_size, rows_cap, pack)
    fn = getattr(tsh, f"{kind}_bin_call")
    before = fn.launches_ordered
    mode = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        kc, kv = kernel_tables(kind, A, B, rows, count, t_size, rows_cap,
                               pack)
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(mode)
    assert fn.launches_ordered == before + 1
    ks, kvs = sorted_rows(kc.cpu(), kv.cpu(), n_rows)
    ps, pvs = sorted_rows(pc, pv, n_rows)
    assert torch.equal(ks, ps)
    bits = torch.int16 if dtype != torch.float32 else torch.int32
    assert torch.equal(kvs.view(bits), pvs.view(bits))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["fused_bin", "numeric_bin"])
def test_cuda_ordered_residency_matches_the_atomic(cuda_device, kind):
    """On every shared-memory rung of the default ladders in float32 the
    fixed-order instance (32 registers, its stage beside the tables) fits
    as many CTAs on an SM as the atomic kernel; symbolic_bin has none."""
    lad = (tranges.symbolic_ladder() if kind == "fused_bin"
           else tranges.numeric_ladder())
    for t_size in lad.table_sizes:
        rpc = (tsh.numeric_launch_geometry(t_size)[0]
               if kind == "numeric_bin" else 1)
        if tsh.rung_route(t_size, rpc, True, cuda_device) != "smem":
            continue
        assert tsh.ctas_per_sm(t_size, kernel=kind, device=cuda_device,
                               ordered=True) == tsh.ctas_per_sm(
            t_size, kernel=kind, device=cuda_device), t_size
    with pytest.raises(ValueError, match="no fixed-order"):
        tsh.ctas_per_sm(1024, kernel="symbolic_bin", device=cuda_device,
                        ordered=True)

