"""Why the port's init draws with the matrix's input axis as fan-in.

The reference's ``param._materialize`` takes a weight's first axis as its
fan-in: the layer count of a stacked weight, so at olmoe-1b-7b's depth
every stacked weight is drawn with std 1/4.  At that init the model
itself amplifies rounding: these tests run olmoe-1b-7b at its attention
width and depth (16 layers, d_model 2048, 16 heads of 128) with the
experts cut to 8 top-2 of d_ff 256 and the vocabulary to 1024, on the
reference's own weights (``PRNGKey``), carried across.

- Each of the port's blocks, given the reference's input to that block,
  equals the reference's block within float32 1e-4 in norm (the residual
  stream's entries reach ~1e3 there).
- Chained over the 16 layers, the same per-block rounding grows to
  tens of percent, and the reference's own scanned prefill differs from
  its blocks applied one at a time: the model, not the port, loses the
  digits (``-s`` prints the readings).
- With the same draws rescaled to the port's fan-in the port's prefill
  logits equal the reference's within float32 1e-4 in norm.
- Under its own init the reference itself fails its own decode check
  (prefill(s) + decode(1) against prefill(s+1), 2e-3 in float32) and the
  one the served model is held to on the card (2e-2 in norm, bfloat16);
  with the draws rescaled to the port's fan-in it passes in float32.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import layers as JL
from repro.models.model import Model as JModel
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_reference
from repro_torch.models.model import Model
from repro_torch.models.param import fan_in, tree_map

ARCH = "olmoe-1b-7b"
CUT = dict(num_experts=8, experts_per_token=2, d_ff=256, vocab_size=1024,
           moe_capacity_factor=4.0)      # E / k: no assignment dropped
N = 128                                  # prompt tokens; s = N - 1


def _tokens():
    return np.random.default_rng(0).integers(0, CUT["vocab_size"], (1, N))


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _models(dtype):
    return (JModel(jget_arch(ARCH).replace(dtype=dtype, **CUT)),
            Model(get_arch(ARCH).replace(dtype=dtype, **CUT)))


@pytest.fixture(scope="module")
def float32_run():
    jm, m = _models("float32")
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, m, jp, params_from_reference(jax.device_get(jp), device="cpu")


def _ref_gap(jm, jp, toks):
    s = toks.shape[1] - 1
    full, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, kv_cache_len=s + 1)
    _, c = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :s])},
                      kv_cache_len=s + 1)
    step, _ = jm.decode_step(jp, jnp.asarray(toks[:, s:]), c, jnp.int32(s))
    return _rel(step, full)


def _port_gap(m, p, toks):
    s = toks.shape[1] - 1
    t = torch.from_numpy(toks)
    with torch.inference_mode():
        full, _ = m.prefill(p, {"tokens": t}, kv_cache_len=s + 1)
        _, c = m.prefill(p, {"tokens": t[:, :s]}, kv_cache_len=s + 1)
        step, _ = m.decode_step(p, t[:, s:], c, s)
    return _rel(step.float().numpy(), full.float().numpy())


def _rescaled(jm, jp):
    """The reference's draws (host arrays) rescaled from its fan-in to
    the port's."""
    def rescale(ps, a):
        if ps.init != "normal":
            return a
        ref_fan = ps.shape[0] if len(ps.shape) > 1 else max(ps.shape[0], 1)
        return a * np.float32(math.sqrt(ref_fan / fan_in(ps.shape)))

    return jax.tree_util.tree_map(
        lambda ps, a: rescale(ps, np.asarray(a)), jm.param_specs(),
        jax.device_get(jp), is_leaf=lambda x: hasattr(x, "init"))


def test_blocks_equal_the_reference_under_its_init(float32_run):
    jm, m, jp, p = float32_run
    cfg = m.cfg
    h = JL.embed(jp["embed"], jnp.asarray(_tokens())).astype(jnp.float32)
    pos = jnp.arange(N)[None]
    tpos = torch.arange(N)[None]
    block = jax.jit(lambda lp, v: jm._block(lp, v, positions=pos,
                                            causal=True)[0])
    chained = torch.from_numpy(np.array(h))
    per_block = []
    with torch.inference_mode():
        for i in range(cfg.num_layers):
            lp = jax.tree_util.tree_map(lambda a: a[i], jp["layers"])
            tp = tree_map(lambda t: t[i], p["layers"])
            want = block(lp, h)
            got = m._block(tp, torch.from_numpy(np.array(h)),
                           positions=tpos, causal=True)[0]
            per_block.append(_rel(got.numpy(), want))
            chained = m._block(tp, chained, positions=tpos, causal=True)[0]
            h = want
    scanned, _, _ = jm._forward(jp, JL.embed(
        jp["embed"], jnp.asarray(_tokens())).astype(jnp.float32),
        positions=pos)
    print(f"\n{ARCH} at width, the reference's init (float32): one block "
          f"of the port against the reference's, worst {max(per_block):.3e};"
          f" 16 blocks chained {_rel(chained.numpy(), h):.3e}; the "
          f"reference's scanned prefill against its blocks one at a time "
          f"{_rel(scanned, h):.3e}; residual rms "
          f"{float(jnp.sqrt(jnp.mean(h ** 2))):.1f}")
    assert max(per_block) <= 1e-4, per_block


def test_prefill_equals_the_reference_under_the_port_fan_in(float32_run):
    """The reference's draws rescaled from its fan-in to the port's."""
    jm, m, jp, _ = float32_run
    jq = _rescaled(jm, jp)
    toks = _tokens()
    want, _ = jm.prefill(jax.tree_util.tree_map(jnp.asarray, jq),
                         {"tokens": jnp.asarray(toks)})
    with torch.inference_mode():
        got, _ = m.prefill(params_from_reference(jq, device="cpu"),
                           {"tokens": torch.from_numpy(toks)})
    rel = _rel(got.numpy(), want)
    print(f"\n{ARCH} at width, the port's fan-in (float32): prefill logits "
          f"port against reference {rel:.3e}")
    assert rel <= 1e-4


def test_reference_init_breaks_the_reference_decode_check(float32_run):
    """The reference's own gaps: over its float32 2e-3 under its own
    init, within it with the draws rescaled to the port's fan-in; over
    the card's 2e-2 in bfloat16 under its own init."""
    jm32, m32, jp32, p32 = float32_run
    toks = _tokens()
    own32 = _ref_gap(jm32, jp32, toks)
    port32 = _port_gap(m32, p32, toks)
    rescaled32 = _ref_gap(jm32, jax.tree_util.tree_map(
        jnp.asarray, _rescaled(jm32, jp32)), toks)
    jm, m = _models("bfloat16")
    jp = jm.init(jax.random.PRNGKey(0))
    own16 = _ref_gap(jm, jp, toks)
    port16 = _port_gap(m, params_from_reference(jax.device_get(jp),
                                                device="cpu"), toks)
    print(f"\n{ARCH} at width, prefill({N - 1}) + decode(1) against "
          f"prefill({N}) in norm: the reference's init: reference float32 "
          f"{own32:.3e}, bfloat16 {own16:.3e}; port float32 {port32:.3e}, "
          f"bfloat16 {port16:.3e}; the port's fan-in: reference float32 "
          f"{rescaled32:.3e}")
    assert own32 > 2e-3 and own16 > 2e-2
    assert rescaled32 <= 2e-3
