"""Port parity: the Mamba1 and Mamba2 layers (``models/ssm.py``) and the
selective-scan oracle against the reference's.

Weights come from the reference's own ``init_params`` (``PRNGKey``),
carried across with ``convert.params_from_reference``; inputs are drawn
with numpy from a seed and given to both.  Tolerance: float32 entrywise
rtol 1e-4 / atol 1e-5, against the reference's layers and against
``ssm_scan_ref`` alike: the chunked scans (the port's doubling scan, the
reference's associative scan, the SSD dual form) sum the same terms as
the sequential oracle in another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.kernels import ref as jref
from repro.models import ssm as JS
from repro.models.param import init_params as jinit_params
from repro_torch.configs import get_arch
from repro_torch.convert import caches_from_reference, params_from_reference
from repro_torch.kernels import ref
from repro_torch.models import ssm as S

TOL = dict(rtol=1e-4, atol=1e-5)
ARCH = {1: "falcon-mamba-7b", 2: "zamba2-1.2b"}


def _close(got, want):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **TOL)


def _normal(seed, shape, scale=1.0):
    x = (np.random.default_rng(seed).standard_normal(shape)
         * scale).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def _layer(version, seed=0, **kw):
    kw.setdefault("dtype", "float32")
    jcfg = jget_arch(ARCH[version]).reduced().replace(**kw)
    cfg = get_arch(ARCH[version]).reduced().replace(**kw)
    assert cfg.mamba_version == version
    mk = JS.mamba2_specs if version == 2 else JS.mamba1_specs
    jp = jinit_params(mk(jcfg), jax.random.PRNGKey(seed))
    jp = dict(jp, A_log=jnp.asarray(np.random.default_rng(seed).uniform(
        -1.0, 1.0, jp["A_log"].shape).astype(np.float32)))
    p = params_from_reference(jax.device_get(jp), device="cpu")
    fns = (JS.mamba2, S.mamba2) if version == 2 else (JS.mamba1, S.mamba1)
    return jcfg, cfg, jp, p, fns


@pytest.mark.parametrize("version", [1, 2])
@pytest.mark.parametrize("L", [8, 21, 3])
def test_mamba_prefill_matches_reference(version, L):
    """Prefill over whole and ragged chunks (chunk 8: L = 8, 21, and a
    single short chunk), outputs and the cache (conv tail, final state);
    A_log drawn so that every channel decays at its own rate."""
    jcfg, cfg, jp, p, (jf, tf) = _layer(version)
    ju, u = _normal(1, (2, L, cfg.d_model))
    want, jc = jf(jp, ju, jcfg)
    got, c = tf(p, u, cfg)
    _close(got, want)
    _close(c.conv, jc.conv)
    _close(c.h, jc.h)


@pytest.mark.parametrize("version", [1, 2])
def test_mamba_decode_from_reference_caches(version):
    """One decode step from the reference's own prefill cache (carried
    across with caches_from_reference) equals the reference's step, and
    continues the prefill: prefill(L) + decode(1) == prefill(L + 1)."""
    jcfg, cfg, jp, p, (jf, tf) = _layer(version)
    ju, u = _normal(2, (2, 13, cfg.d_model))
    _, jc = jf(jp, ju[:, :12], jcfg)
    cache = caches_from_reference(jax.device_get(jc), device="cpu")
    want, jnew = jf(jp, ju[:, 12:], jcfg, cache=jc)
    got, new = tf(p, u[:, 12:], cfg, cache=cache)
    _close(got, want)
    _close(new.conv, jnew.conv)
    _close(new.h, jnew.h)
    full, _ = tf(p, u, cfg)
    torch.testing.assert_close(got, full[:, 12:], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("L,q", [(16, 4), (13, 4), (9, 16)])
def test_mamba1_scan_matches_the_sequential_oracle(L, q):
    """The chunked doubling scan against ssm_scan_ref (the port's and the
    reference's oracle), with decays from ~1 down to underflow: a
    cumprod-and-divide form would divide by 0 there."""
    jx, x = _normal(3, (2, L, 6))
    jdt, dt = _normal(4, (2, L, 6), 0.5)
    dt, jdt = dt.abs(), jnp.abs(jdt)
    A = -torch.from_numpy(np.geomspace(1e-3, 300.0, 6 * 4).reshape(6, 4)
                          .astype(np.float32))
    jB, B = _normal(5, (2, L, 4))
    jC, C = _normal(6, (2, L, 4))
    jD, D = _normal(7, (6,))
    y, h = S.mamba1_scan(x, dt, A, B, C, D, q)
    oracle = ref.ssm_scan_ref(x, dt, A, B, C, D)
    _close(oracle, jref.ssm_scan_ref(jx, jdt, jnp.asarray(A.numpy()), jB,
                                     jC, jD))
    torch.testing.assert_close(y, oracle, rtol=1e-4, atol=1e-5)
    assert torch.isfinite(h).all()


def test_ssm_caches_and_shapes():
    for version, h_shape in ((1, (3, 128, 16)), (2, (3, 8, 16, 16))):
        cfg = get_arch(ARCH[version]).reduced()
        c = S.init_ssm_cache(cfg, 3, torch.bfloat16, device="cpu")
        jc = JS.init_ssm_cache(jget_arch(ARCH[version]).reduced(), 3,
                               jnp.bfloat16)
        assert tuple(c.h.shape) == h_shape == jc.h.shape
        assert tuple(c.conv.shape) == jc.conv.shape
        assert c.conv.dtype == torch.bfloat16 and c.h.dtype == torch.float32
        a = S.abstract_ssm_cache(cfg, 3, torch.bfloat16)
        assert a.h.device.type == "meta" and a.h.shape == c.h.shape
