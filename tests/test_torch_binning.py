"""Port parity: two-pass binning (OpSparse §5.1, Algorithms 1–3)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import binning as jbin
from repro.core import binning_ranges as jbr
from repro_torch.core import binning as tbin
from repro_torch.core import binning_ranges as tbr


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _sizes(seed, m, hi):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(0, hi, size=m).astype(np.int32)
    return sizes


def _assert_binning_equal(T, J):
    for name in ("bins", "bin_size", "bin_offset", "bin_of_row"):
        t, j = getattr(T, name), getattr(J, name)
        assert t.dtype == torch.int32, name
        np.testing.assert_array_equal(_np(t), np.asarray(j), err_msg=name)
    assert int(T.max_size) == int(J.max_size)


@pytest.mark.parametrize("ladder", ["sym", "num", "tiny"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bin_rows_matches_reference(ladder, seed):
    lad = {"sym": tbr.symbolic_ladder(1.2), "num": tbr.numeric_ladder(2.0),
           "tiny": tbr.make_ladder((32, 64, 128), 1.2)}[ladder]
    sizes = _sizes(seed, 96, 2 * lad.upper[-1] + 2)
    # Every rung bound and its neighbours, so side="left" is pinned.
    edges = np.array([u + d for u in lad.upper for d in (-1, 0, 1)],
                     np.int32)
    sizes = np.concatenate([sizes, edges])
    T = tbin.bin_rows(torch.from_numpy(sizes), upper=lad.upper,
                      num_bins=lad.num_bins)
    J = jbin.bin_rows(jnp.asarray(sizes), upper=lad.upper,
                      num_bins=lad.num_bins)
    _assert_binning_equal(T, J)
    np.testing.assert_array_equal(
        _np(tbin.classify(torch.from_numpy(sizes), lad.upper)),
        np.asarray(jbin.classify(jnp.asarray(sizes), lad.upper)))


@pytest.mark.parametrize("fast", [True, False])
def test_bin_rows_for_ladder_fast_path_matches_reference(fast):
    lad = tbr.symbolic_ladder(1.2)
    hi = lad.upper[0] if fast else 3 * lad.upper[0]
    sizes = _sizes(7, 64, hi + 1)
    T = tbin.bin_rows_for_ladder(torch.from_numpy(sizes), lad)
    J = jbin.bin_rows_for_ladder(jnp.asarray(sizes),
                                 jbr.symbolic_ladder(1.2))
    _assert_binning_equal(T, J)
    T2 = tbin.bin_rows_for_ladder(torch.from_numpy(sizes), lad,
                                  allow_fast_path=False)
    J2 = jbin.bin_rows_for_ladder(jnp.asarray(sizes),
                                  jbr.symbolic_ladder(1.2),
                                  allow_fast_path=False)
    _assert_binning_equal(T2, J2)


def test_bin_rows_identity_matches_reference():
    sizes = _sizes(3, 40, 10)
    T = tbin.bin_rows_identity(torch.from_numpy(sizes), num_bins=9)
    J = jbin.bin_rows_identity(jnp.asarray(sizes), num_bins=9)
    _assert_binning_equal(T, J)


@pytest.mark.parametrize("capacity", [8, 32, 128])
def test_rows_of_bin_matches_reference(capacity):
    lad = tbr.make_ladder((32, 64, 128), 1.2)
    sizes = _sizes(11, 80, 200)
    T = tbin.bin_rows(torch.from_numpy(sizes), upper=lad.upper,
                      num_bins=lad.num_bins)
    J = jbin.bin_rows(jnp.asarray(sizes), upper=lad.upper,
                      num_bins=lad.num_bins)
    for b in range(lad.num_bins):
        tr, tc = T.rows_of_bin(b, capacity)
        jr, jc = J.rows_of_bin(b, capacity)
        np.testing.assert_array_equal(_np(tr), np.asarray(jr))
        assert int(tc) == int(jc)


def test_empty_and_all_zero_rows():
    lad = tbr.symbolic_ladder(1.2)
    sizes = np.zeros(17, np.int32)
    T = tbin.bin_rows(torch.from_numpy(sizes), upper=lad.upper,
                      num_bins=lad.num_bins)
    J = jbin.bin_rows(jnp.asarray(sizes), upper=lad.upper,
                      num_bins=lad.num_bins)
    _assert_binning_equal(T, J)
    assert T.bin_size.tolist()[0] == 17


def test_rows_per_block_matches_reference():
    for t in (16, 31, 32, 64, 127, 128, 512, 1024, 24576):
        assert tbr.rows_per_block_of(t) == jbr.rows_per_block_of(t)


# ---------------------------------------------------------------------------
# The ladders of tests/test_binning.py (the paper's Tables 1, 2 and 4, the
# sweeps, the vmem_extended ladder), each also held to the reference's.
# ---------------------------------------------------------------------------

def _same_ladder(t, j):
    assert (t.upper, t.table_sizes, t.multiplier) == (
        j.upper, j.table_sizes, j.multiplier)
    assert t.fallback_threshold() == j.fallback_threshold()


def test_paper_table1_symbolic_ranges():
    """:12, Table 1: sym_1.2x upper bounds."""
    lad = tbr.symbolic_ladder(1.2)
    assert lad.upper == (26, 426, 853, 1706, 3413, 6826, 10240, 20480)
    _same_ladder(lad, jbr.symbolic_ladder(1.2))


def test_paper_table2_numeric_ranges():
    """:18, Table 2: num_2x upper bounds 16/128/256/512/1024/2048/4096."""
    lad = tbr.numeric_ladder(2.0)
    assert lad.upper == (16, 128, 256, 512, 1024, 2048, 4096)
    _same_ladder(lad, jbr.numeric_ladder(2.0))


def test_paper_table4_sym_sweep_ranges():
    """:24, Table 4: the sym_1x and sym_1.5x range grids."""
    assert tbr.symbolic_ladder(1.0).upper == (32, 512, 1024, 2048, 4096,
                                              8192, 12288, 24576)
    assert tbr.symbolic_ladder(1.5).upper == (21, 341, 682, 1365, 2730,
                                              5461, 8192, 16384)


@pytest.mark.parametrize("mult", tbr.SYMBOLIC_SWEEP)
def test_sym_sweep_ladders_constructible(mult):
    """:81."""
    assert tbr.SYMBOLIC_SWEEP == jbr.SYMBOLIC_SWEEP
    lad = tbr.symbolic_ladder(mult)
    assert len(lad.upper) == len(tbr.SYMBOLIC_NOMINAL)
    assert all(u <= t for u, t in zip(lad.upper, lad.table_sizes))
    _same_ladder(lad, jbr.symbolic_ladder(mult))


@pytest.mark.parametrize("mult", tbr.NUMERIC_SWEEP)
def test_num_sweep_ladders_constructible(mult):
    """:88: numeric tables are nominal - 1 (the paper keeps 4 B for
    shared_offset); the ranges come from the nominal pow-2 sizes."""
    assert tbr.NUMERIC_SWEEP == jbr.NUMERIC_SWEEP
    lad = tbr.numeric_ladder(mult)
    assert len(lad.upper) == len(tbr.NUMERIC_NOMINAL)
    assert all(u <= t + 1 for u, t in zip(lad.upper, lad.table_sizes))
    _same_ladder(lad, jbr.numeric_ladder(mult))


@pytest.mark.parametrize("kind", ["symbolic", "numeric"])
def test_vmem_extended_ladder(kind):
    """:96, and the numeric extended ladder beside it."""
    lad = getattr(tbr, f"{kind}_ladder")(1.2, vmem_extended=True)
    if kind == "symbolic":
        assert lad.table_sizes[-1] == 1048576
        assert lad.fallback_threshold() == int(1048576 / 1.2)
    _same_ladder(lad, getattr(jbr, f"{kind}_ladder")(1.2,
                                                      vmem_extended=True))
