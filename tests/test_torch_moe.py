"""Port parity: ``core.binning.bin_by_id``, the configs, the parameter
specs and the MoE layer against the reference.

The MoE layer's weights come from the reference's own ``init_params``
(``PRNGKey``), carried across with ``convert.params_from_reference``; the
tokens from the reference's ``jax.random.normal``.  Tolerances: float32
within rtol 1e-4 / atol 1e-5 (the same sums in another order); bfloat16
within rtol 2e-2 / atol 2e-3 (tests/test_property.py:99's: bf16 rounds at
other places in the two frameworks' einsums and scatters).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import get_arch as jget_arch
from repro.core.binning import bin_by_id as jbin_by_id
from repro.models import moe as JM
from repro.models.param import init_params as jinit_params
from repro_torch.configs import ARCHS, get_arch
from repro_torch.convert import params_from_reference
from repro_torch.core.binning import bin_by_id
from repro_torch.models import MoE, hints
from repro_torch.models import moe as M
from repro_torch.models.param import init_params, param_count

TOL = {"float32": dict(rtol=1e-4, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-3)}


def test_configs_are_the_reference_configs():
    """The ten config modules are copies: every field of every arch, and
    ``reduced()``, as in the reference."""
    assert set(ARCHS) == set(JARCHS)
    for name in ARCHS:
        for ours, ref in ((get_arch(name), jget_arch(name)),
                          (get_arch(name).reduced(),
                           jget_arch(name).reduced())):
            assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    with pytest.raises(KeyError):
        get_arch("no-such-arch")


@pytest.mark.parametrize("shape", [(50,), (3, 50), (1, 1), (4, 257)])
def test_bin_by_id_matches_reference(shape):
    """(order, counts, offsets) equal the reference's, one group or a
    batch of groups (the reference's jax.vmap)."""
    ids = np.random.default_rng(sum(shape)).integers(
        0, 8, shape).astype(np.int32)
    got = bin_by_id(torch.from_numpy(ids), 8)
    if len(shape) == 1:
        want = jbin_by_id(jnp.asarray(ids), 8)
    else:
        want = jax.vmap(lambda i: jbin_by_id(i, 8))(jnp.asarray(ids))
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _pair(cfg_kw, seed=0, batch=(2, 24)):
    jcfg = jget_arch("olmoe-1b-7b").reduced().replace(**cfg_kw)
    cfg = get_arch("olmoe-1b-7b").reduced().replace(**cfg_kw)
    jp = jinit_params(JM.moe_specs(jcfg), jax.random.PRNGKey(seed))
    dt = jnp.bfloat16 if cfg.dtype == "bfloat16" else jnp.float32
    jx = jax.random.normal(jax.random.PRNGKey(seed + 1),
                           (*batch, cfg.d_model)).astype(dt)
    p = params_from_reference(jax.device_get(jp), device="cpu")
    x = torch.from_numpy(np.asarray(jx.astype(jnp.float32))).to(
        torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32)
    return jcfg, cfg, jp, jx, p, x


@pytest.mark.parametrize("capacity", [1.25, 16.0])
@pytest.mark.parametrize("dispatch", ["bfloat16", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_matches_reference(dtype, dispatch, capacity):
    """moe and moe_dense_dispatch against the reference's, with capacity
    drops (1.25) and without (16), and the int8 dispatch payload."""
    kw = dict(d_model=64, num_experts=8, experts_per_token=2, d_ff=32,
              moe_capacity_factor=capacity, dtype=dtype,
              moe_dispatch_dtype=dispatch)
    jcfg, cfg, jp, jx, p, x = _pair(kw)
    for jf, tf in ((JM.moe, M.moe),
                   (JM.moe_dense_dispatch, M.moe_dense_dispatch)):
        jout, jaux = jf(jp, jx, jcfg)
        out, aux = tf(p, x, cfg)
        assert out.dtype == x.dtype and out.shape == x.shape
        np.testing.assert_allclose(
            out.float().numpy(), np.asarray(jout.astype(jnp.float32)),
            **TOL[dtype])
        np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


def test_moe_module_and_params():
    """MoE's forward is moe() and dense_dispatch moe_dense_dispatch() on
    its parameters; init_params draws the specs' shapes and types from
    the generator, the same draw for the same seed."""
    cfg = get_arch("olmoe-1b-7b").reduced().replace(
        d_model=32, num_experts=4, experts_per_token=2, d_ff=16,
        dtype="float32")
    specs = M.moe_specs(cfg)
    p = init_params(specs, torch.Generator().manual_seed(3), "cpu")
    again = init_params(specs, torch.Generator().manual_seed(3), "cpu")
    for name, ps in specs.items():
        assert tuple(p[name].shape) == ps.shape
        assert p[name].dtype == ps.dtype
        assert torch.equal(p[name], again[name])
    assert param_count(specs) == sum(t.numel() for t in p.values())
    layer = MoE(cfg, p, device="cpu")
    x = torch.randn((2, 8, 32), generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        assert torch.equal(layer(x)[0], M.moe(p, x, cfg)[0])
        assert torch.equal(layer.dense_dispatch(x)[0],
                           M.moe_dense_dispatch(p, x, cfg)[0])
    with pytest.raises(ValueError):
        MoE(cfg, device="cpu")


def test_hint_is_the_identity_on_one_card():
    x = torch.zeros((2, 3, 4))
    assert hints.hint(x, hints.BATCH, None, hints.TP) is x
    with pytest.raises(ValueError):
        hints.hint(x, hints.BATCH)


def test_params_from_reference_keeps_every_value():
    """float32 and bfloat16 arrays cross value for value."""
    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
            "b": {"c": np.asarray(jnp.asarray([1.5, -2.25, 3e-3],
                                              jnp.bfloat16))}}
    out = params_from_reference(tree, device="cpu")
    assert torch.equal(out["a"], torch.arange(6.0).reshape(2, 3))
    assert out["b"]["c"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        out["b"]["c"].float().numpy(),
        np.asarray(tree["b"]["c"]).astype(np.float32))
