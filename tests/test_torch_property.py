"""Hypothesis property tests of tests/test_property.py (`:34`, `:41`,
`:59`, `:82`, `:99`) on the port, with the reference's settings and
strategies; where a property runs a function of both packages, the port
is also held to the reference on the same draw."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

hypothesis = pytest.importorskip(
    "hypothesis", reason="property tests need the hypothesis package")
from hypothesis import HealthCheck, given, settings, strategies as st  # noqa: E402

from repro.core.binning import bin_by_id as jbin_by_id  # noqa: E402
from repro.configs.base import ArchConfig as JArchConfig  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.models.param import init_params as jinit_params  # noqa: E402
from repro_torch.configs.base import ArchConfig  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.core import (CSR, SpgemmConfig, bin_rows_for_ladder,  # noqa: E402
                              make_ladder, spgemm)
from repro_torch.core.binning import bin_by_id  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402

SETTINGS = dict(max_examples=20, deadline=None,
                suppress_health_check=[HealthCheck.too_slow])


@st.composite
def sparse_matrix(draw, max_dim=24):
    m = draw(st.integers(1, max_dim))
    n = draw(st.integers(1, max_dim))
    density = draw(st.floats(0.0, 0.5))
    seed = draw(st.integers(0, 2 ** 16))
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((m, n)).astype(np.float32)
    d[rng.random((m, n)) >= density] = 0.0
    return d


@given(sparse_matrix(), st.integers(0, 2 ** 16))
@settings(**SETTINGS)
def test_csr_dense_round_trip(d, _):
    A = CSR.from_dense(d, device="cpu")
    np.testing.assert_allclose(A.to_dense().numpy(), d)


@given(sparse_matrix(), sparse_matrix())
@settings(**SETTINGS)
def test_spgemm_matches_dense_oracle(da, db):
    k = min(da.shape[1], db.shape[0])
    da, db = da[:, :k], db[:k, :]
    if k == 0:
        return
    A, B = CSR.from_dense(da, device="cpu"), CSR.from_dense(db, device="cpu")
    res = spgemm(A, B, SpgemmConfig(method="esc"))
    np.testing.assert_allclose(res.C.to_dense().numpy(), da @ db,
                               rtol=1e-4, atol=1e-4)
    # two-phase invariant: rpt non-decreasing, nnz consistent
    rpt = res.C.rpt.numpy()
    assert (np.diff(rpt) >= 0).all()
    assert rpt[-1] == res.total_nnz


@given(st.lists(st.integers(0, 10_000), min_size=1, max_size=200))
@settings(**SETTINGS)
def test_binning_is_partition(sizes):
    """bins is always a permutation; members respect their rung ranges."""
    sizes = torch.tensor(sizes, dtype=torch.int32)
    lad = make_ladder((8, 64, 512), 1.2)
    b = bin_rows_for_ladder(sizes, lad)
    bins = b.bins.numpy()
    np.testing.assert_array_equal(np.sort(bins), np.arange(len(sizes)))
    bounds = list(lad.upper)
    bin_of = b.bin_of_row.numpy()
    for i, s in enumerate(sizes.numpy()):
        k = bin_of[i]
        lo = bounds[k - 1] if k > 0 else -1
        hi = bounds[k] if k < len(bounds) else np.inf
        assert lo < s <= hi or (s == 0 and k == 0)
    # offsets are the exclusive sum of sizes
    np.testing.assert_array_equal(
        b.bin_offset.numpy(),
        np.concatenate([[0], np.cumsum(b.bin_size.numpy())[:-1]]))


@given(st.lists(st.integers(0, 7), min_size=1, max_size=300))
@settings(**SETTINGS)
def test_bin_by_id_counting_sort(ids):
    """The MoE router invariant: stable counting sort by expert id, and
    the reference's (order, counts, offsets) exactly."""
    order, counts, offsets = bin_by_id(torch.tensor(ids, dtype=torch.int32),
                                       8)
    assert order.dtype == counts.dtype == offsets.dtype == torch.int32
    order = order.numpy()
    sorted_ids = np.asarray(ids)[order]
    assert (np.diff(sorted_ids) >= 0).all()          # grouped by expert
    np.testing.assert_array_equal(counts.numpy(),
                                  np.bincount(ids, minlength=8))
    for e in range(8):                               # stable within one
        members = order[sorted_ids == e]
        assert (np.diff(members) > 0).all()
    want = jbin_by_id(jnp.asarray(ids, jnp.int32), 8)
    for got, ref in zip((order, counts.numpy(), offsets.numpy()), want):
        np.testing.assert_array_equal(got, np.asarray(ref))


@given(st.integers(0, 2 ** 16))
@settings(max_examples=10, deadline=None)
def test_moe_conservation_no_drop(seed):
    """With capacity >= S*k, the binning dispatch == the dense one (the
    exact weighted expert mix), on the reference's weights and tokens."""
    kw = dict(name="t", family="moe", num_layers=1, d_model=16, num_heads=2,
              num_kv_heads=2, d_ff=8, vocab_size=32, num_experts=4,
              experts_per_token=2, moe_capacity_factor=16.0,
              dtype="float32")
    cfg, jcfg = ArchConfig(**kw), JArchConfig(**kw)
    jp = jinit_params(JM.moe_specs(jcfg), jax.random.PRNGKey(seed))
    jx = jax.random.normal(jax.random.PRNGKey(seed + 1), (2, 6, 16))
    p = params_from_reference(jax.device_get(jp), device="cpu")
    x = torch.from_numpy(np.array(jx))
    out, _ = M.moe(p, x, cfg)
    ref, _ = M.moe_dense_dispatch(p, x, cfg)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=2e-2,
                               atol=2e-3)
