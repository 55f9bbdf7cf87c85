"""The reference's per-architecture smoke tests on the port, and logits
parity with the reference per architecture.

Every REDUCED config of the ten architectures runs the reference's
``tests/test_models_smoke.py`` checks on the port: a forward with the
loss and its gradient through autograd (finite, wired), prefill shapes,
prefill(s) + decode(1) == prefill(s+1), and the full configs' parameter
counts.  Weights come from the reference's own ``Model.init``
(``PRNGKey``), carried across with ``convert.params_from_reference``;
tokens and features are drawn with numpy from a seed and given to both.
Each architecture's reference run is made once per module
(``ref_runs``).

Tolerances: the prefill and decode logits equal the reference's within
float32 rtol 1e-4 / atol 1e-4 entrywise.  The layers' own parity tests
hold atol 1e-5; a whole model's logit is a 64-term product of hidden
values that carry 4 to 10 layers of sums in another order, so a logit
near 0 keeps the absolute rounding of the large ones (up to 4e-5 seen on
logits of magnitude ~3; ~8e-5 on the MoE configs, whose experts' outputs
are weighted sums on top).  The decode consistency check keeps the
reference's own 2e-3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import get_arch as jget_arch
from repro.models.model import Model as JModel
from repro.models.param import param_count as jparam_count
from repro_torch.configs import ARCHS, get_arch
from repro_torch.convert import caches_from_reference, params_from_reference
from repro_torch.models.model import Model
from repro_torch.models.param import param_count, tree_leaves, tree_map

B, S = 2, 16
DECODERS = [a for a in sorted(ARCHS) if ARCHS[a].family != "encoder"]


TOL = dict(rtol=1e-4, atol=1e-4)


def _inputs(cfg, seed=0):
    """numpy inputs for both packages: tokens (B, S+1) or features and
    labels, and vision embeddings for the vlm."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.family == "encoder":
        out["features"] = rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)
        out["labels"] = rng.integers(0, cfg.vocab_size, (B, S))
        return out
    out["tokens"] = rng.integers(0, cfg.vocab_size, (B, S + 1))
    if cfg.family == "vlm":
        out["vision"] = rng.standard_normal(
            (B, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
    return out


def _jbatch(inp, s=None):
    b = {k: jnp.asarray(v) for k, v in inp.items() if k != "labels"}
    if s is not None:
        b["tokens"] = b["tokens"][:, :s]
    return b


def _tbatch(inp, s=None):
    b = {k: torch.from_numpy(np.asarray(v)) for k, v in inp.items()
         if k != "labels"}
    if s is not None:
        b["tokens"] = b["tokens"][:, :s]
    return b


@pytest.fixture(scope="module")
def ref_runs():
    """arch -> the reference's weights, inputs and logits (made once)."""
    runs = {}

    def get(arch):
        if arch in runs:
            return runs[arch]
        jcfg = jget_arch(arch).reduced().replace(dtype="float32")
        cfg = get_arch(arch).reduced().replace(dtype="float32")
        jm = JModel(jcfg)
        jp = jm.init(jax.random.PRNGKey(0))
        inp = _inputs(cfg)
        run = dict(cfg=cfg, inp=inp,
                   p=params_from_reference(jax.device_get(jp), device="cpu"))
        if cfg.family == "encoder":
            run["prefill"], _ = jm.prefill(jp, _jbatch(inp))
        else:
            run["prefill"], jc = jm.prefill(jp, _jbatch(inp, S),
                                            kv_cache_len=S + 1)
            run["caches"] = jax.device_get(jc)
            run["decode"], _ = jm.decode_step(
                jp, jnp.asarray(inp["tokens"][:, S:S + 1]), jc, jnp.int32(S))
        runs[arch] = run
        return run
    return get


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_reduced_train_step(arch, ref_runs):
    """The loss and its gradient through autograd: finite, and at least
    one gradient nonzero (the model is wired to the loss)."""
    run = ref_runs(arch)
    cfg, inp = run["cfg"], run["inp"]
    model = Model(cfg)
    params = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                      run["p"])
    leaves = tree_leaves(params)
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in inp.items()}
    loss, metrics = model.loss_fn(params, batch)
    assert np.isfinite(float(loss.detach())), (arch, float(loss.detach()))
    loss.backward()
    grads = [t.grad if t.grad is not None else torch.zeros_like(t)
             for t in leaves]
    assert all(torch.isfinite(g).all() for g in grads), arch
    assert any(float(g.abs().max()) > 0 for g in grads), arch


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_reduced_prefill_shapes_and_parity(arch, ref_runs):
    run = ref_runs(arch)
    cfg, inp, p = run["cfg"], run["inp"], run["p"]
    model = Model(cfg)
    if cfg.family == "encoder":
        logits, caches = model.prefill(p, _tbatch(inp))
        assert logits.shape == (B, S, cfg.vocab_size) and caches is None
    else:
        logits, caches = model.prefill(p, _tbatch(inp, S),
                                       kv_cache_len=S + 1)
        assert logits.shape == (B, 1, cfg.vocab_size)
        assert caches is not None
    assert torch.isfinite(logits).all()
    np.testing.assert_allclose(logits.numpy(), np.asarray(run["prefill"]),
                               **TOL)


@pytest.mark.parametrize("arch", DECODERS)
def test_reduced_decode_step_parity(arch, ref_runs):
    """A decode step from the reference's own prefill caches (carried
    across) and from the port's own prefill equals the reference's step;
    the caches passed in are left unchanged."""
    run = ref_runs(arch)
    cfg, inp, p = run["cfg"], run["inp"], run["p"]
    model = Model(cfg)
    tok = torch.from_numpy(inp["tokens"][:, S:S + 1])
    caches = caches_from_reference(run["caches"], device="cpu")
    before = [t.clone() for t in tree_leaves(caches)]
    got, new = model.decode_step(p, tok, caches, S)
    np.testing.assert_allclose(got.numpy(), np.asarray(run["decode"]),
                               **TOL)
    assert all(torch.equal(a, b) for a, b in zip(before,
                                                 tree_leaves(caches)))
    assert [t.shape for t in tree_leaves(new)] == [t.shape for t in before]
    _, own = model.prefill(p, _tbatch(inp, S), kv_cache_len=S + 1)
    again, _ = model.decode_step(p, tok, own, torch.tensor(S))
    np.testing.assert_allclose(again.numpy(), np.asarray(run["decode"]),
                               **TOL)


@pytest.mark.parametrize("arch", DECODERS)
def test_reduced_decode_step(arch, ref_runs):
    """prefill(s) + decode(1) must equal prefill(s+1) logits (the
    reference's check and tolerance)."""
    run = ref_runs(arch)
    cfg, inp, p = run["cfg"], run["inp"], run["p"]
    model = Model(cfg)
    full, _ = model.prefill(p, _tbatch(inp), kv_cache_len=S + 1)
    _, caches = model.prefill(p, _tbatch(inp, S), kv_cache_len=S + 1)
    step, _ = model.decode_step(
        p, torch.from_numpy(inp["tokens"][:, S:S + 1]), caches, S)
    np.testing.assert_allclose(step.numpy(), full.numpy(), rtol=2e-3,
                               atol=2e-3)


def test_param_counts_full_configs():
    """Full-config parameter counts in the reference's ranges, and equal
    to the reference's spec counts."""
    expected = {
        "falcon-mamba-7b": (6e9, 9e9),
        "hubert-xlarge": (0.7e9, 1.3e9),
        "qwen3-1.7b": (1.3e9, 2.5e9),
        "minitron-4b": (3.5e9, 6e9),
        "internlm2-1.8b": (1.4e9, 2.5e9),
        "codeqwen1.5-7b": (6e9, 8.5e9),
        "zamba2-1.2b": (0.9e9, 1.7e9),
        "olmoe-1b-7b": (6e9, 8e9),
        "qwen3-moe-30b-a3b": (28e9, 33e9),
        "llama-3.2-vision-90b": (80e9, 100e9),
    }
    assert set(expected) == set(ARCHS) == set(JARCHS)
    for name, (lo, hi) in expected.items():
        n = param_count(Model(get_arch(name)).param_specs())
        assert lo <= n <= hi, f"{name}: {n/1e9:.2f}B not in [{lo}, {hi}]"
        assert n == jparam_count(JModel(jget_arch(name)).param_specs())


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_abstract_params_and_caches_mirror_the_reference(arch):
    """abstract_params and init_caches(abstract=True) give the
    reference's shapes and types, leaf for leaf, on the meta device."""
    cfg, jcfg = get_arch(arch).reduced(), jget_arch(arch).reduced()
    ours = tree_leaves(Model(cfg).abstract_params())
    ref = jax.tree_util.tree_leaves(JModel(jcfg).abstract_params())
    assert len(ours) == len(ref)
    by_shape = sorted((tuple(a.shape), str(a.dtype).replace("torch.", ""))
                      for a in ours)
    assert by_shape == sorted((tuple(a.shape), str(a.dtype)) for a in ref)
    assert all(a.device.type == "meta" for a in ours)
    if cfg.is_encoder:
        return
    c = tree_leaves(Model(cfg).init_caches(3, 20, abstract=True))
    jc = jax.tree_util.tree_leaves(JModel(jcfg).init_caches(3, 20,
                                                            abstract=True))
    assert [tuple(a.shape) for a in c] == [tuple(a.shape) for a in jc]
