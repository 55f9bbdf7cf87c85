"""The reference's int8 weight-only serving tests on the port, and the
int8 payload against the reference's.

Weights come from the reference's own ``Model.init`` (``PRNGKey``),
carried across with ``convert.params_from_reference`` (an int8 tree
too); tokens are drawn with numpy from a seed and given to both.  The
payload, scales and dequantized weights are compared bit for bit;
bfloat16 logits of the same int8 tree in norm, ||a - b|| / ||b|| <= 2e-2,
against the reference's blocks applied one layer at a time (see
``_reference_layer_by_layer``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models.model import Model as JModel
from repro.models import layers as JL
from repro.models.quant import dequant_tree as jdequant_tree
from repro.models.quant import quantize_params as jquantize_params
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_reference
from repro_torch.models.model import Model
from repro_torch.models.param import tree_leaves
from repro_torch.models.quant import (QTensor, _scale_shape,
                                      abstract_quantized, dequant_tree,
                                      quantize_params)


def _tree_bytes(tree):
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def _weights(arch, dtype="bfloat16", seed=0):
    jcfg = jget_arch(arch).reduced().replace(dtype=dtype)
    cfg = get_arch(arch).reduced().replace(dtype=dtype)
    jp = JModel(jcfg).init(jax.random.PRNGKey(seed))
    return jcfg, cfg, jp, params_from_reference(jax.device_get(jp),
                                                device="cpu")


def _tokens(cfg, seed=1, shape=(2, 16)):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "zamba2-1.2b"])
def test_quantized_prefill_close_and_smaller(arch):
    jcfg, cfg, jp, params = _weights(arch)
    model = Model(cfg)
    qparams = quantize_params(params, min_dim=8)
    tokens = torch.from_numpy(_tokens(cfg))
    lg_full, _ = model.prefill(params, {"tokens": tokens}, kv_cache_len=20)
    lg_q, caches = model.prefill(qparams, {"tokens": tokens},
                                 kv_cache_len=20)
    # random-init logits are near-uniform, so exact argmax agreement is
    # too strict; require high correlation of the logit vectors
    a = lg_full[:, -1].float().reshape(-1).numpy()
    b = lg_q[:, -1].float().reshape(-1).numpy()
    corr = np.corrcoef(a, b)[0, 1]
    assert corr > 0.95, (arch, corr)

    # decode runs on the quantized tree
    lg2, _ = model.decode_step(qparams, tokens[:, :1], caches, 16)
    assert torch.isfinite(lg2.float()).all()

    # resident weight bytes roughly halve (int8 vs bf16 + tiny scales)
    assert _tree_bytes(qparams) < 0.6 * _tree_bytes(params)


def test_quantize_round_trip_error_bounded():
    w = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (4, 64, 32)).astype(np.float32)).to(torch.bfloat16)
    q = quantize_params({"w": w}, min_dim=8)["w"]
    assert isinstance(q, QTensor)
    assert tuple(q.scale.shape) == (4, 1, 1)   # per-matrix-slice scales
    err = (q.dequant(torch.float32) - w.float()).abs()
    amax = w.float().abs().max()
    assert float(err.max()) <= float(amax) / 127.0 + 1e-6


def test_abstract_quantized_mirrors_shapes():
    cfg = get_arch("qwen3-1.7b").reduced()
    model = Model(cfg)
    ab = abstract_quantized(model.abstract_params(), min_dim=8)
    real = quantize_params(model.init(torch.Generator().manual_seed(0),
                                      "cpu"), min_dim=8)
    ab_l, real_l = tree_leaves(ab), tree_leaves(real)
    assert len(ab_l) == len(real_l)
    for a, r in zip(ab_l, real_l):
        assert a.device.type == "meta"
        assert tuple(a.shape) == tuple(r.shape), (a.shape, r.shape)
        assert a.dtype == r.dtype


def test_quantized_moe_runs():
    """MoE under int8: top-k routing makes logits sensitive to weight
    noise at random init, so only run + finiteness is asserted here (the
    router itself stays float32 by design)."""
    _, cfg, _, params = _weights("olmoe-1b-7b")
    qparams = quantize_params(params, min_dim=8)
    lg, _ = Model(cfg).prefill(qparams,
                               {"tokens": torch.from_numpy(_tokens(cfg))},
                               kv_cache_len=20)
    assert torch.isfinite(lg.float()).all()


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "zamba2-1.2b",
                                  "llama-3.2-vision-90b"])
def test_int8_payload_equals_the_reference(arch):
    """quantize_params on the same bfloat16 weights gives the reference's
    payload and scales bit for bit, leaf for leaf, and so does the
    reference's int8 tree carried across with params_from_reference; the
    dequantized weights are the reference's bit for bit."""
    _, _, jp, params = _weights(arch)
    jq = jquantize_params(jp, min_dim=8)
    q = quantize_params(params, min_dim=8)
    carried = params_from_reference(jax.device_get(jq), device="cpu")
    n_q = 0
    for ours, theirs in zip(tree_leaves(q), tree_leaves(carried)):
        assert ours.dtype == theirs.dtype and ours.shape == theirs.shape
        assert torch.equal(ours, theirs)
        n_q += ours.dtype == torch.int8
    assert n_q > 0
    assert all(tuple(x.scale.shape) == _scale_shape(x.q.shape)
               for x in _qtensors(q))
    want = jax.device_get(jdequant_tree(jq))
    for ours, theirs in zip(tree_leaves(dequant_tree(q)),
                            tree_leaves(params_from_reference(want,
                                                              device="cpu"))):
        assert torch.equal(ours, theirs)


def _reference_layer_by_layer(jm, jtree, tokens):
    """The reference's prefill logits with its blocks applied one layer
    at a time (eagerly).  Its own prefill scans the block body, and XLA
    then fuses away some of bfloat16's intermediate roundings: the two
    differ by 1-6 % in norm on the reduced configs, so the port (torch
    rounds every op) is held to this form."""
    cfg = jm.cfg
    ep = jdequant_tree(jtree["embed"])
    x = JL.embed(ep, tokens).astype(jnp.bfloat16)
    pos = jnp.arange(tokens.shape[1])[None]
    for i in range(cfg.num_layers):
        lp = jax.tree_util.tree_map(lambda a: a[i], jtree["layers"])
        x, _, _ = jm._block(lp, x, positions=pos, causal=True)
    x = JL.rmsnorm(x[:, -1:], jtree["final_norm"], cfg.norm_eps)
    return JL.logits(ep, x)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "olmoe-1b-7b"])
def test_int8_tree_carried_across_gives_the_reference_logits(arch):
    """Prefill on the reference's int8 tree, carried across, equals the
    reference's on it (||a - b|| / ||b|| <= 2e-2; 0 on this build)."""
    jcfg, cfg, jp, _ = _weights(arch)
    jq = jquantize_params(jp, min_dim=8)
    toks = _tokens(cfg)
    want = np.asarray(_reference_layer_by_layer(
        JModel(jcfg), jq, jnp.asarray(toks)).astype(jnp.float32))
    got, _ = Model(cfg).prefill(
        params_from_reference(jax.device_get(jq), device="cpu"),
        {"tokens": torch.from_numpy(toks)})
    rel = np.linalg.norm(got.float().numpy() - want) / np.linalg.norm(want)
    assert rel <= 2e-2, rel


def _qtensors(tree):
    if isinstance(tree, QTensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _qtensors(v)]
    return []


def test_dequant_tree_materializes_one_layer():
    _, cfg, _, params = _weights("internlm2-1.8b")
    q = quantize_params(params, min_dim=8)
    layer0 = {k: (QTensor(v.q[0], v.scale[0]) if isinstance(v, QTensor)
                  else v[0]) for k, v in q["layers"]["attn"].items()}
    deq = dequant_tree(layer0)
    for k, v in deq.items():
        assert v.dtype == torch.bfloat16
        assert v.shape == params["layers"]["attn"][k][0].shape
    assert dequant_tree(params) is not params
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(dequant_tree(params)), tree_leaves(params)))
