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
