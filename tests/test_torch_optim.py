"""The port's AdamW against the reference's on the CPU.

``lr_schedule``, ``global_norm``, ``clip_by_global_norm`` and
``adamw_update`` on the same numpy trees, with float32 and bfloat16
parameters.  The in-place update must write the tensors it was given,
leave the gradients alone and leave no two leaves sharing storage (a
float32 parameter and its master copy included).

Tolerances: the schedule, the norm and the clip in float32 within 1e-6
relative (a sum of squares in another order); the moments and the master
weights within 1e-5 relative + 1e-6 of the leaf's largest magnitude (the
clip scale, a quotient of that norm, may sit an ulp or two away, and m
after a few steps is a sum of terms of both signs, near 0 on some
entries: 1.6e-9 off on an m entry of 2.5e-5 seen); a bfloat16 parameter within one
bfloat16 step of the reference's (the master weights it rounds may sit
either side of a rounding boundary), and float32 ones as the master.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_update as jadamw_update
from repro.optim import clip_by_global_norm as jclip
from repro.optim import global_norm as jglobal_norm
from repro.optim import init_opt_state as jinit_opt_state
from repro.optim import lr_schedule as jlr_schedule
from repro_torch.convert import params_from_reference
from repro_torch.models.param import tree_leaves
from repro_torch.optim import (AdamWConfig, OptState, adamw_update,
                               clip_by_global_norm, global_norm,
                               init_opt_state, lr_schedule)

RTOL = 1e-6
STATE_RTOL = 1e-5
CFG = dict(lr=1e-2, warmup_steps=3, total_steps=10, grad_clip=1.0)


def _tree(seed, dtype, scale=1.0):
    rng = np.random.default_rng(seed)
    shapes = {"w": (4, 8, 6), "b": (6,), "blk": {"k": (3, 5), "s": (7,)}}

    def make(node):
        if isinstance(node, dict):
            return {k: make(v) for k, v in node.items()}
        return (rng.standard_normal(node) * scale).astype(np.float32)
    arrays = make(shapes)
    jt = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), arrays)
    return jt, params_from_reference(jax.device_get(jt), device="cpu")


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      np.asarray(x, dtype=np.float32))


def _close(x, y, what):
    np.testing.assert_allclose(x, y, rtol=STATE_RTOL,
                               atol=1e-6 * float(np.abs(y).max()),
                               err_msg=what)


def _leaves_np(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves_np(tree[k])]
    return [_np(tree)]


@pytest.mark.parametrize("step", [0, 1, 2, 3, 5, 9, 10, 14])
def test_lr_schedule(step):
    want = jlr_schedule(JAdamWConfig(**CFG), jnp.int32(step))
    got = lr_schedule(AdamWConfig(**CFG), torch.tensor(step,
                                                       dtype=torch.int32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scale", [0.01, 3.0])    # below and above the clip
def test_global_norm_and_clip(dtype, scale):
    jt, t = _tree(1, jnp.float32 if dtype == "float32" else jnp.bfloat16,
                  scale)
    np.testing.assert_allclose(float(global_norm(t)),
                               float(jglobal_norm(jt)), rtol=RTOL)
    jclipped, jnorm = jclip(jt, 1.0)
    clipped, norm = clip_by_global_norm(t, 1.0)
    np.testing.assert_allclose(float(norm), float(jnorm), rtol=RTOL)
    for a, b, src in zip(_leaves_np(clipped), _leaves_np(jclipped),
                         tree_leaves(t)):
        step = 2.0 ** -8 if dtype == "bfloat16" else RTOL
        np.testing.assert_allclose(a, b, rtol=step, atol=1e-12)
    assert all(c.dtype == s.dtype for c, s in zip(tree_leaves(clipped),
                                                  tree_leaves(t)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_the_reference(dtype):
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jp, p = _tree(2, jdt)
    jopt = jinit_opt_state(jp)
    opt = init_opt_state(p)
    cfg, jcfg = AdamWConfig(**CFG), JAdamWConfig(**CFG)
    for i in range(4):
        jg, g = _tree(10 + i, jdt, scale=0.5)
        g_before = [x.clone() for x in tree_leaves(g)]
        ids = [x.data_ptr() for x in tree_leaves((p, opt.m, opt.v,
                                                  opt.master))]
        jp, jopt, jmet = jadamw_update(jp, jg, jopt, jcfg)
        p, opt, met = adamw_update(p, g, opt, cfg)
        # in place: the same storage comes back, the gradients untouched
        assert [x.data_ptr() for x in tree_leaves(
            (p, opt.m, opt.v, opt.master))] == ids
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(g),
                                                     g_before))
        assert int(opt.step) == int(jopt.step) == i + 1
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(met[k]), float(jmet[k]),
                                       rtol=RTOL)
        for name, a, b in (("m", opt.m, jopt.m), ("v", opt.v, jopt.v),
                           ("master", opt.master, jopt.master)):
            for x, y in zip(_leaves_np(a), _leaves_np(b)):
                _close(x, y, f"step {i} {name}")
        for x, y, w in zip(_leaves_np(p), _leaves_np(jp),
                           _leaves_np(jopt.master)):
            if dtype == "bfloat16":
                np.testing.assert_allclose(x, y, rtol=2.0 ** -8, atol=0)
            else:
                _close(x, w, f"step {i} params")
    assert all(x.dtype == getattr(torch, dtype) for x in tree_leaves(p))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_in_place_update_aliases_no_leaf(dtype):
    g = torch.Generator().manual_seed(0)
    p = {"a": torch.randn((5, 3), generator=g).to(dtype),
         "b": torch.randn((4,), generator=g).to(dtype)}
    opt = init_opt_state(p)
    grads = {k: torch.randn(v.shape, generator=g).to(dtype)
             for k, v in p.items()}
    p, opt, _ = adamw_update(p, grads, opt, AdamWConfig(**CFG))
    leaves = tree_leaves((p, grads, opt.m, opt.v, opt.master, opt.step))
    ptrs = [x.untyped_storage().data_ptr() for x in leaves]
    assert len(set(ptrs)) == len(ptrs)
    assert isinstance(opt, OptState)
