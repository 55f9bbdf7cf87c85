"""Port parity for the binning-histogram and block-CSR SpMM kernels (and
the symbolic oracle, `kernels/ref.symbolic_ref`).

The port's wrappers run their plain PyTorch versions on CPU tensors; they
are held against the reference's Pallas kernels (interpret mode on the
CPU) on the same numpy inputs.  The ``gpu`` tests hold the CUDA kernels
against the plain versions on the card and skip without one.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bin_rows as jbin_rows
from repro.core import numeric_ladder as jnumeric_ladder
from repro.core import random_csr as jrandom_csr
from repro.core import symbolic_ladder as jsymbolic_ladder
from repro.kernels import ref as jref
from repro.kernels.binning_pallas import binning_histogram as jhistogram
from repro.kernels.bsr_spmm import bsr_spmm as jbsr_spmm
from repro_torch.convert import csr_from_reference
from repro_torch.kernels import ref
from repro_torch.kernels.binning_histogram import binning_histogram
from repro_torch.kernels.bsr_spmm import bsr_spmm

BSR_TOL = dict(rtol=1e-4, atol=1e-4)   # tests/test_kernels_misc.py:55

LADDERS = {"symbolic": jsymbolic_ladder(1.2), "numeric": jnumeric_ladder(2.0)}


def _sizes(m, seed=0, high=30000):
    return np.random.default_rng(seed + m).integers(0, high, m,
                                                    dtype=np.int32)


@pytest.mark.parametrize("ladder", list(LADDERS))
@pytest.mark.parametrize("m", [0, 7, 256, 1000, 4096])
@pytest.mark.parametrize("block", [128, 1024])
def test_binning_histogram_matches_reference(ladder, m, block):
    lad = LADDERS[ladder]
    sizes = _sizes(m)
    hist, mx = binning_histogram(torch.from_numpy(sizes), upper=lad.upper,
                                 num_bins=lad.num_bins, block=block)
    assert hist.dtype == torch.int32 and hist.shape == (lad.num_bins,)
    assert mx.dtype == torch.int32 and mx.shape == ()
    if m:
        jh, jm = jhistogram(jnp.asarray(sizes), upper=lad.upper,
                            num_bins=lad.num_bins, block=block)
    else:
        # The Pallas kernel cannot take an empty input (its first block
        # slice is larger than the array); the reference's jnp binning
        # gives the answer: no rows, max 0.
        jb = jbin_rows(jnp.asarray(sizes), upper=lad.upper,
                       num_bins=lad.num_bins)
        jh, jm = jb.bin_size, jb.max_size
    np.testing.assert_array_equal(hist.numpy(), np.asarray(jh))
    assert int(mx) == int(jm)


def test_binning_histogram_int64_sizes_and_overflow_rung():
    lad = LADDERS["symbolic"]
    sizes = np.array([0, lad.upper[0], lad.upper[0] + 1, lad.upper[-1],
                      lad.upper[-1] + 1, 10 ** 6], dtype=np.int64)
    hist, mx = binning_histogram(torch.from_numpy(sizes), upper=lad.upper,
                                 num_bins=lad.num_bins)
    jh, jm = jhistogram(jnp.asarray(sizes.astype(np.int32)), upper=lad.upper,
                        num_bins=lad.num_bins)
    np.testing.assert_array_equal(hist.numpy(), np.asarray(jh))
    assert int(mx) == int(jm) == 10 ** 6
    assert int(hist[len(lad.upper)]) == 2     # above the last bound


@pytest.mark.parametrize("m,block", [(1000, 128), (4099, 1024), (37, 16)])
def test_binning_histogram_unsorted_bounds_match_reference(m, block):
    """A row's rung counts the bounds it exceeds, in any order of the
    bounds; ``block`` need not divide ``m``."""
    lad = LADDERS["symbolic"]
    upper = tuple(np.random.default_rng(m).permutation(lad.upper).tolist())
    assert upper != lad.upper
    sizes = _sizes(m)
    hist, mx = binning_histogram(torch.from_numpy(sizes), upper=upper,
                                 num_bins=lad.num_bins, block=block)
    jh, jm = jhistogram(jnp.asarray(sizes), upper=upper,
                        num_bins=lad.num_bins, block=block)
    np.testing.assert_array_equal(hist.numpy(), np.asarray(jh))
    assert int(mx) == int(jm)
    sorted_hist, _ = binning_histogram(torch.from_numpy(sizes),
                                       upper=lad.upper, num_bins=lad.num_bins)
    assert torch.equal(hist, sorted_hist)


def _random_bcsr(seed, nbr, nbc, bm, bk, density=0.3, every_row=True):
    """Blocks of a random block mask; ``every_row`` stores at least one
    block in each block row (the Pallas kernel leaves empty rows
    unwritten)."""
    rng = np.random.default_rng(seed)
    mask = rng.random((nbr, nbc)) < density
    if every_row:
        mask[np.arange(nbr), np.arange(nbr) % nbc] = True
    rows, cols = np.nonzero(mask)
    blocks = rng.standard_normal((len(rows), bm, bk)).astype(np.float32)
    return rows.astype(np.int32), cols.astype(np.int32), blocks


def _port_bsr(rows, cols, blocks, dense, nbr, device="cpu"):
    t = (torch.from_numpy(x).to(device) for x in (rows, cols, blocks, dense))
    return bsr_spmm(*t, n_block_rows=nbr)


@pytest.mark.parametrize("shape", [(3, 4, 8, 16, 32), (5, 2, 16, 8, 8),
                                   (2, 2, 32, 32, 64)])
def test_bsr_spmm_matches_reference(shape):
    nbr, nbc, bm, bk, n = shape
    rows, cols, blocks = _random_bcsr(sum(shape), nbr, nbc, bm, bk)
    dense = np.random.default_rng(1).standard_normal(
        (nbc * bk, n)).astype(np.float32)
    got = _port_bsr(rows, cols, blocks, dense, nbr)
    want = jbsr_spmm(jnp.asarray(rows), jnp.asarray(cols),
                     jnp.asarray(blocks), jnp.asarray(dense),
                     n_block_rows=nbr)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BSR_TOL)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_bsr_spmm_16bit_matches_reference(dtype):
    """16-bit blocks and dense: float32 sums, the output in the dense
    operand's type, as the reference's kernel (interpret mode) gives it;
    the two round the same float32 sum once, so they may differ by one
    step of the type (2^-7 / 2^-10 relative)."""
    nbr, nbc, bm, bk, n = 3, 4, 16, 16, 32
    rows, cols, blocks = _random_bcsr(41, nbr, nbc, bm, bk)
    dense = np.random.default_rng(2).standard_normal(
        (nbc * bk, n)).astype(np.float32)
    tdt = getattr(torch, dtype)
    t = [torch.from_numpy(x) for x in (rows, cols, blocks, dense)]
    got = bsr_spmm(t[0], t[1], t[2].to(tdt), t[3].to(tdt), n_block_rows=nbr)
    jdt = getattr(jnp, dtype)
    want = jbsr_spmm(jnp.asarray(rows), jnp.asarray(cols),
                     jnp.asarray(blocks).astype(jdt),
                     jnp.asarray(dense).astype(jdt), n_block_rows=nbr)
    assert got.dtype == tdt and got.shape == want.shape
    rtol = 2 ** -7 if dtype == "bfloat16" else 2 ** -10
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=rtol, atol=1e-2)


def test_bsr_spmm_with_padding_blocks():
    """Padding entries (repeat last row, zero block) contribute nothing."""
    rows = np.array([0, 0, 1, 1, 1], np.int32)
    cols = np.array([0, 1, 1, 0, 0], np.int32)
    blocks = np.stack([np.eye(8, dtype=np.float32)] * 4
                      + [np.zeros((8, 8), np.float32)])
    dense = np.random.default_rng(2).standard_normal(
        (16, 24)).astype(np.float32)
    got = _port_bsr(rows, cols, blocks, dense, 2)
    want = jbsr_spmm(jnp.asarray(rows), jnp.asarray(cols),
                     jnp.asarray(blocks), jnp.asarray(dense), n_block_rows=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BSR_TOL)


def test_bsr_spmm_empty_block_row_is_zero():
    """A block row with no block comes out zero, as in the reference's
    ``bsr_spmm_ref`` (the Pallas kernel never writes it)."""
    rows = np.array([0, 0, 2], np.int32)          # block row 1 is empty
    cols = np.array([0, 1, 1], np.int32)
    blocks = np.random.default_rng(3).standard_normal(
        (3, 8, 16)).astype(np.float32)
    dense = np.random.default_rng(4).standard_normal(
        (32, 40)).astype(np.float32)
    got = _port_bsr(rows, cols, blocks, dense, 3)
    want = jref.bsr_spmm_ref(jnp.asarray(rows), jnp.asarray(cols),
                             jnp.asarray(blocks), jnp.asarray(dense),
                             nrows_blocks=3, block_shape=(8, 16))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BSR_TOL)
    assert not got[8:16].any()


def test_bsr_spmm_ref_skips_negative_rows():
    rows = np.array([-1, 0, 1], np.int32)
    cols = np.array([0, 0, 1], np.int32)
    blocks = np.ones((3, 4, 4), np.float32)
    dense = np.ones((8, 4), np.float32)
    got = _port_bsr(rows, cols, blocks, dense, 2)
    want = jref.bsr_spmm_ref(jnp.asarray(rows), jnp.asarray(cols),
                             jnp.asarray(blocks), jnp.asarray(dense),
                             nrows_blocks=2, block_shape=(4, 4))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", [0, 1])
def test_symbolic_ref_matches_reference(seed):
    """n_nz per row of the dense product's support, as the reference's
    oracle computes it, on the reference's own random_csr matrices (one
    with cancelling values: a symbolic count the values do not reach)."""
    A = jrandom_csr(jax.random.PRNGKey(seed), 40, 30, avg_nnz_per_row=3.0)
    B = jrandom_csr(jax.random.PRNGKey(seed + 7), 30, 20,
                    avg_nnz_per_row=3.0)
    if seed:   # +-1 values: some products cancel
        sign = jnp.where(jnp.arange(B.val.shape[0]) % 2 == 0, 1.0, -1.0)
        A = dataclasses.replace(A, val=jnp.ones_like(A.val))
        B = dataclasses.replace(B, val=sign.astype(B.val.dtype))
    tA, tB = (csr_from_reference(np.asarray(M.rpt), np.asarray(M.col),
                                 np.asarray(M.val), M.shape, device="cpu")
              for M in (A, B))
    want = np.asarray(jref.symbolic_ref(A, B))
    np.testing.assert_array_equal(ref.symbolic_ref(tA, tB), want)
    if seed:
        assert (want < ref.row_nnz_from_support(tA, tB)).any()
    assert ref.symbolic_ref(tA, tB).dtype == np.int32


# ---------------------------------------------------------------------------
# The CUDA kernels against their plain versions (card only).
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("m", [0, 7, 1000, 70000])
@pytest.mark.parametrize("block", [128, 1024])
def test_binning_histogram_kernel_matches_plain(cuda_device, m, block):
    for lad in LADDERS.values():
        sizes = torch.from_numpy(_sizes(m))
        before = binning_histogram.launches
        hist, mx = binning_histogram(sizes.to(cuda_device), upper=lad.upper,
                                     num_bins=lad.num_bins, block=block)
        assert binning_histogram.launches == before + (1 if m else 0)
        want_h, want_m = ref.binning_histogram_ref(
            sizes, upper=lad.upper, num_bins=lad.num_bins)
        assert torch.equal(hist.cpu(), want_h)
        assert int(mx) == int(want_m)


def _histogram_on_card(sizes, device, *, offset=0, **kw):
    """The kernel on ``sizes`` placed ``offset`` int32s past a 16-byte
    boundary of its allocation, and the plain version on the CPU."""
    padded = np.concatenate([np.zeros(offset, np.int32), sizes])
    on_card = torch.from_numpy(padded).to(device)[offset:]
    assert on_card.data_ptr() % 16 == 4 * offset
    got = binning_histogram(on_card, **kw)
    want = ref.binning_histogram_ref(torch.from_numpy(sizes),
                                     upper=kw["upper"],
                                     num_bins=kw["num_bins"])
    return got, want


HIST_CASES = {  # m, offset, sizes, bounds, num_bins
    # every row in rung 1: each warp's rows all land on one counter
    "one-rung": (70000, 0, "rung1", "symbolic", None),
    "unaligned-start": (1001, 1, "random", "symbolic", None),
    "m%4=1": (4097, 0, "random", "numeric", None),
    "m%4=2": (4098, 2, "random", "numeric", None),
    "m%4=3": (4099, 3, "random", "numeric", None),
    "below-a-warp": (5, 3, "random", "symbolic", None),
    "unsorted-bounds": (5000, 0, "random", "shuffled", None),
    "above-the-last-bound": (3000, 1, "huge", "symbolic", None),
    "fewer-bins-than-rungs": (3000, 0, "random", "symbolic", 3),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(HIST_CASES))
def test_binning_histogram_kernel_edge_cases(cuda_device, case):
    m, offset, kind, bounds, num_bins = HIST_CASES[case]
    lad = LADDERS["numeric" if bounds == "numeric" else "symbolic"]
    upper = lad.upper
    if bounds == "shuffled":
        upper = tuple(np.random.default_rng(1).permutation(upper).tolist())
    sizes = {"random": _sizes(m),
             "rung1": np.full(m, lad.upper[0] + 1, np.int32),
             "huge": _sizes(m) + lad.upper[-1] + 1}[kind]
    kw = dict(upper=upper, num_bins=num_bins or lad.num_bins)
    (hist, mx), (want_h, want_m) = _histogram_on_card(
        sizes, cuda_device, offset=offset, **kw)
    assert hist.shape == want_h.shape and mx.shape == ()
    assert torch.equal(hist.cpu(), want_h)
    assert int(mx) == int(want_m)
    if kind == "rung1":
        assert int(hist[1]) == m
    if kind == "huge":
        assert int(hist[len(upper)]) == m


@pytest.mark.gpu
@pytest.mark.parametrize("m", [3, 4099, 200003])
def test_binning_histogram_kernel_block_changes_nothing(cuda_device, m):
    lad = LADDERS["symbolic"]
    kw = dict(upper=lad.upper, num_bins=lad.num_bins)
    outs = [_histogram_on_card(_sizes(m), cuda_device, offset=1, block=block,
                               **kw)[0] for block in (1, 100, 1024, 5000)]
    for hist, mx in outs[1:]:
        assert torch.equal(hist, outs[0][0]) and torch.equal(mx, outs[0][1])


BSR_CASES = {
    "every-row": (6, 5, 16, 16, 48, False),
    "empty-row": (6, 5, 16, 16, 48, True),
    "bm-ne-bk": (4, 3, 32, 8, 40, False),
    "n-ragged": (3, 3, 128, 128, 100, True),
    "tiny": (2, 2, 8, 8, 8, False),
    # several blocks per block row: the K loop crosses blocks and wraps
    # the bf16 kernel's ring of stages
    "64x64-multi": (4, 8, 64, 64, 192, False),
    "128x128-multi": (3, 8, 128, 128, 384, False),
    # bm and bk not multiples of the 128-row tile or the 16-deep stage; N
    # not a multiple of 4, so no output or dense row is 16-byte aligned
    "96x40-n37": (3, 4, 96, 40, 37, False),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(BSR_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_bsr_spmm_kernel_matches_plain(cuda_device, case, dtype):
    nbr, nbc, bm, bk, n, empty_row = BSR_CASES[case]
    rows, cols, blocks = _random_bcsr(7, nbr, nbc, bm, bk,
                                      every_row=not empty_row)
    if empty_row:
        keep = rows != 1
        rows, cols, blocks = rows[keep], cols[keep], blocks[keep]
    # a padding entry: the last row again, with a zero block
    rows = np.append(rows, rows[-1]).astype(np.int32)
    cols = np.append(cols, 0).astype(np.int32)
    blocks = np.concatenate([blocks, np.zeros((1, bm, bk), np.float32)])
    dense = np.random.default_rng(8).standard_normal(
        (nbc * bk, n)).astype(np.float32)
    t = [torch.from_numpy(x) for x in (rows, cols, blocks, dense)]
    t[2], t[3] = t[2].to(dtype), t[3].to(dtype)
    want = ref.bsr_spmm_ref(*t, nrows_blocks=nbr, block_shape=(bm, bk))
    before = dict(bsr_spmm.launches_by_entry)
    got = bsr_spmm(*(x.to(cuda_device) for x in t), n_block_rows=nbr)
    assert got.dtype == dtype and got.shape == want.shape
    # one launch, counted under this type's C entry point alone
    entry = {torch.float32: "bsr_spmm_f32", torch.bfloat16: "bsr_spmm_bf16",
             torch.float16: "bsr_spmm_f16"}[dtype]
    assert {k: v - before[k] for k, v in bsr_spmm.launches_by_entry.items()
            } == {k: int(k == entry) for k in before}
    # float32: sums reordered; bfloat16 / float16: one rounding of the
    # float32 sum, which may fall on either side of a step (2^-8 / 2^-11
    # relative).
    tol = {torch.float32: BSR_TOL,
           torch.bfloat16: dict(rtol=2 ** -7, atol=1e-2),
           torch.float16: dict(rtol=2 ** -10, atol=1e-2)}[dtype]
    torch.testing.assert_close(got.cpu().float(), want.float(), **tol)
    if empty_row:
        assert not got[bm:2 * bm].any()


def _bsr_on_card(rows, cols, blocks, dense, nbr, device, dense_offset=0):
    """The float32 kernel with ``dense`` placed ``dense_offset`` floats past
    a 16-byte boundary of its allocation."""
    flat = np.concatenate([np.zeros(dense_offset, np.float32),
                           dense.ravel()])
    d = torch.from_numpy(flat).to(device)[dense_offset:].view(dense.shape)
    assert d.data_ptr() % 16 == 4 * dense_offset
    return bsr_spmm(*(torch.from_numpy(x).to(device)
                      for x in (rows, cols, blocks)), d, n_block_rows=nbr)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["unaligned-dense", "rows-of-1-and-13"])
def test_bsr_spmm_f32_kernel_ragged(cuda_device, case):
    if case == "unaligned-dense":
        nbr, nbc, bm, bk, n, offset = 4, 3, 32, 24, 64, 1
        rows, cols, blocks = _random_bcsr(11, nbr, nbc, bm, bk)
    else:
        # block row 0 holds 1 block, block row 2 all 13: one call walks
        # K loops of 1 and 13 blocks
        nbr, nbc, bm, bk, n, offset = 3, 13, 128, 128, 160, 0
        rows = np.repeat(np.arange(3, dtype=np.int32), [1, 6, 13])
        cols = np.concatenate([[4], np.arange(0, 12, 2),
                               np.arange(13)]).astype(np.int32)
        blocks = np.random.default_rng(12).standard_normal(
            (len(rows), bm, bk)).astype(np.float32)
    dense = np.random.default_rng(13).standard_normal(
        (nbc * bk, n)).astype(np.float32)
    got = _bsr_on_card(rows, cols, blocks, dense, nbr, cuda_device, offset)
    want = ref.bsr_spmm_ref(*(torch.from_numpy(x) for x in
                              (rows, cols, blocks, dense)),
                            nrows_blocks=nbr, block_shape=(bm, bk))
    torch.testing.assert_close(got.cpu(), want, **BSR_TOL)


@pytest.mark.gpu
def test_bsr_spmm_f32_kernel_is_deterministic(cuda_device):
    """A fixed summation order inside a CTA: two runs, equal bits."""
    rows, cols, blocks = _random_bcsr(14, 5, 9, 128, 128, density=0.6)
    dense = np.random.default_rng(15).standard_normal(
        (9 * 128, 300)).astype(np.float32)
    first = _bsr_on_card(rows, cols, blocks, dense, 5, cuda_device)
    second = _bsr_on_card(rows, cols, blocks, dense, 5, cuda_device)
    assert torch.equal(first, second)


@pytest.mark.parametrize("args,name", [
    ("ILb1ELb0EE", "hash_rows_kernel<1,0>"),
    ("ILi8EE", "hash_rows_kernel<8>"),
    ("ILin1ELi16EE", "hash_rows_kernel<-1,16>"),
    ("", "hash_rows_kernel"),
])
def test_kernel_name_reads_template_arguments(args, name):
    """ptxas and SASS reports name each instance of a kernel template by
    its bool or int arguments."""
    from repro_torch.kernels.build import kernel_name
    ns, fn = "_GLOBAL__N__0123abcd_14_spgemm_hash_cu_5c8f1d21", \
        "hash_rows_kernel"
    assert kernel_name(f"_ZN{len(ns)}{ns}{len(fn)}{fn}{args}EvPKi") == name


@pytest.mark.parametrize("source", ["spgemm_hash", "bsr_spmm",
                                    "spgemm_hash slot", "bsr_spmm f32",
                                    "spgemm_hash cluster",
                                    "spgemm_hash ordered"])
def test_ablation_variants_edit_the_current_sources(source):
    """Every ablation build of ``repro_torch.kernels.ablate`` finds its
    anchor in today's source, and all but the baseline change it."""
    from repro_torch.kernels import ablate, build
    variants = {"spgemm_hash": ablate.HASH_VARIANTS,
                "bsr_spmm": ablate.BSR_VARIANTS,
                "spgemm_hash slot": ablate.SLOT_VARIANTS,
                "bsr_spmm f32": ablate.BSR_F32_VARIANTS,
                "spgemm_hash cluster": ablate.CLUSTER_VARIANTS,
                "spgemm_hash ordered": ablate.ORDERED_VARIANTS}[source]
    src = (build.CSRC / f"{source.split()[0]}.cu").read_text()
    edited = [edit(src) for edit in variants.values()]
    assert edited[0] == src
    assert all(e != src for e in edited[1:])
    assert len(set(edited)) == len(edited)


def test_hash_ablations_keep_to_their_kernel():
    """The HASH_VARIANTS edit hash_rows_kernel's code only (fused_bin,
    symbolic_bin), and the SLOT_VARIANTS leave it (and the insert and dump
    it calls) as they are, so each ablation prices its own kernel; every
    timed build exists."""
    from repro_torch.kernels import ablate, build
    src = (build.CSRC / "spgemm_hash.cu").read_text()
    fused = slice(src.index("__device__ __forceinline__ int insert("),
                  src.index("size_t smem_bytes("))
    slot = "// slot_rows_kernel: numeric_bin"
    for label, edit in ablate.HASH_VARIANTS.items():
        out = edit(src)
        assert out[out.index(slot):] == src[src.index(slot):], label
    for label, edit in ablate.SLOT_VARIANTS.items():
        assert edit(src)[fused] == src[fused], label
    hash_rows = ablate.SLOT_VARIANTS["hash_rows_only"](src)
    assert "return slot_dispatch(" not in hash_rows
    tables = {"hash": ablate.HASH_VARIANTS, "slot": ablate.SLOT_VARIANTS}
    timed = [*ablate.TWO_PASS_TIMED["symbolic_bin"],
             *ablate.TWO_PASS_TIMED["numeric_bin"], *ablate.PACK_TIMED]
    assert ablate.TWO_PASS_TIMED["numeric_bin"][:2] == (
        ("slot", "base"), ("slot", "hash_rows_only"))
    for group, label in timed:
        assert label in tables[group] or label == "unpacked", label


def test_cluster_ablations_keep_to_their_kernel():
    """The CLUSTER_VARIANTS edit cluster_rows_kernel's section only, and
    the hash and slot variants leave that section as it is."""
    from repro_torch.kernels import ablate, build
    src = (build.CSRC / "spgemm_hash.cu").read_text()
    marker = "// cluster_rows_kernel: the vmem_extended rungs"
    start = src.index(marker)
    end = src.index("const void* global_rows_fn()")
    for label, edit in ablate.CLUSTER_VARIANTS.items():
        out = edit(src)
        assert out[:start] == src[:start], label
        assert out.endswith(src[end:]), label
    for table in (ablate.HASH_VARIANTS, ablate.SLOT_VARIANTS):
        for label, edit in table.items():
            out = edit(src)
            assert src[start:end] in out, label


def test_ordered_ablations_keep_to_the_value_pass():
    """The ORDERED_VARIANTS edit the fixed-order value pass's section only
    (which every ORDERED instance runs, and no atomic kernel), and the
    other kernels' variants leave that section as it is."""
    from repro_torch.kernels import ablate, build
    src = (build.CSRC / "spgemm_hash.cu").read_text()
    start = src.index("// The fixed-order value pass of the ORDERED "
                      "instances.")
    end = src.index("// A row's table as keys[] and vals[] side by side")
    for label, edit in ablate.ORDERED_VARIANTS.items():
        out = edit(src)
        assert out[:start] == src[:start], label
        assert out.endswith(src[end:]), label
    for table in (ablate.HASH_VARIANTS, ablate.SLOT_VARIANTS,
                  ablate.CLUSTER_VARIANTS):
        for label, edit in table.items():
            assert src[start:end] in edit(src), label
