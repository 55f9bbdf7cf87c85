"""Port parity: the transformer layer library (``models/layers.py``) and
the attention oracle against the reference's.

Weights come from the reference's own ``init_params`` (``PRNGKey``),
carried across with ``convert.params_from_reference``; inputs are drawn
with numpy from a seed and given to both.  Tolerance: float32 entrywise
rtol 1e-4 / atol 1e-5 (the same sums in another order), except where a
case says why it needs more.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.kernels import ref as jref
from repro.models import layers as JL
from repro.models.param import init_params as jinit_params
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_reference
from repro_torch.kernels import ref
from repro_torch.models import layers as L

TOL = dict(rtol=1e-4, atol=1e-5)


def _close(got, want, **tol):
    np.testing.assert_allclose(
        got.detach().float().numpy(), np.asarray(want, np.float32),
        **(tol or TOL))


def _pair(arch="qwen3-1.7b", **kw):
    kw.setdefault("dtype", "float32")
    return (jget_arch(arch).reduced().replace(**kw),
            get_arch(arch).reduced().replace(**kw))


def _weights(jspecs, seed=0):
    jp = jinit_params(jspecs, jax.random.PRNGKey(seed))
    return jp, params_from_reference(jax.device_get(jp), device="cpu")


def _normal(seed, shape):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_reference(dtype):
    jx, x = _normal(0, (2, 5, 64))
    js, s = _normal(1, (64,))
    if dtype == "bfloat16":
        jx, x = jx.astype(jnp.bfloat16), x.to(torch.bfloat16)
        tol = dict(rtol=2 ** -8, atol=1e-5)   # one bfloat16 rounding apart
    else:
        tol = TOL
    got = L.rmsnorm(x, s, 1e-5)
    assert got.dtype == x.dtype
    _close(got, JL.rmsnorm(jx, js, 1e-5).astype(jnp.float32), **tol)


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_matches_reference_up_to_position_511(theta):
    """Positions 0..511 with the frequencies in float32, as the
    reference: at 511 an angle off by the float64 log's difference would
    show."""
    jx, x = _normal(2, (1, 512, 2, 64))
    pos = np.arange(512)[None]
    got = L.rope(x, torch.from_numpy(pos), theta)
    want = JL.rope(jx, jnp.asarray(pos), theta)
    _close(got, want)


def _attn_pair(**kw):
    jcfg, cfg = _pair(**kw)
    jp, p = _weights(JL.attention_specs(jcfg))
    return jcfg, cfg, jp, p


ATTN_CASES = {
    "mha": dict(arch="internlm2-1.8b"),
    "gqa_qknorm": dict(arch="qwen3-1.7b"),           # kv 4 -> 1 head, qk-norm
    "gqa": dict(arch="codeqwen1.5-7b", num_kv_heads=2),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_attention_full_and_prefill_match_reference(case):
    """Full-sequence causal and non-causal attention, and prefill's cache
    padded to kv_cache_len."""
    jcfg, cfg, jp, p = _attn_pair(**ATTN_CASES[case])
    jx, x = _normal(3, (2, 12, cfg.d_model))
    pos = np.arange(12)[None]
    for causal in (True, False):
        want, jc = JL.attention(jp, jx, jcfg, positions=jnp.asarray(pos),
                                causal=causal, return_kv=True,
                                kv_cache_len=16)
        got, c = L.attention(p, x, cfg, positions=torch.from_numpy(pos),
                             causal=causal, return_kv=True, kv_cache_len=16)
        _close(got, want)
        assert c.k.shape == (2, 16, cfg.num_kv_heads, cfg.resolved_head_dim)
        _close(c.k, jc.k)
        _close(c.v, jc.v)


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
@pytest.mark.parametrize("per_slot", [False, True])
def test_attention_decode_matches_reference(case, per_slot):
    """Decode at one position for every slot (an int) or per slot (a (B,)
    vector): new caches equal the reference's, the ones passed in are
    left unchanged."""
    jcfg, cfg, jp, p = _attn_pair(**ATTN_CASES[case])
    kvh, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    jk, k = _normal(4, (3, 10, kvh, hd))
    jv, v = _normal(5, (3, 10, kvh, hd))
    jx, x = _normal(6, (3, 1, cfg.d_model))
    pos = np.array([7, 3, 9]) if per_slot else np.array(6)
    jcache = JL.AttnCache(k=jk, v=jv)
    cache = L.AttnCache(k=k.clone(), v=v.clone())
    jpos = jnp.asarray(pos, jnp.int32)
    tpos = torch.from_numpy(pos) if per_slot else int(pos)
    positions = np.broadcast_to(pos.reshape(-1), (3,))[:, None]
    want, jnew = JL.attention(jp, jx, jcfg, positions=jnp.asarray(positions),
                              cache=jcache, cache_pos=jpos)
    got, new = L.attention(p, x, cfg, positions=torch.from_numpy(
        positions.copy()), cache=cache, cache_pos=tpos)
    _close(got, want)
    _close(new.k, jnew.k)
    _close(new.v, jnew.v)
    assert torch.equal(cache.k, k) and torch.equal(cache.v, v)


def test_attention_cross_modes_match_reference():
    """Cross-attention from kv_x (no mask, no RoPE), then the static cache
    it returns attended at decode."""
    jcfg, cfg = _pair("llama-3.2-vision-90b")
    jp, p = _weights(JL.attention_specs(jcfg, cross=True))
    jx, x = _normal(7, (2, 5, cfg.d_model))
    jvis, vis = _normal(8, (2, cfg.vision_tokens, cfg.d_model))
    pos = np.arange(5)[None]
    want, jc = JL.attention(jp, jx, jcfg, positions=jnp.asarray(pos),
                            causal=False, kv_x=jvis, return_kv=True)
    got, c = L.attention(p, x, cfg, positions=torch.from_numpy(pos),
                         causal=False, kv_x=vis, return_kv=True)
    _close(got, want)
    _close(c.k, jc.k)
    jstep, jsame = JL.attention(jp, jx[:, :1], jcfg,
                                positions=jnp.asarray(pos[:, :1]),
                                causal=False, cache=jc, cache_pos=None)
    step, same = L.attention(p, x[:, :1], cfg,
                             positions=torch.from_numpy(pos[:, :1].copy()),
                             causal=False, cache=c, cache_pos=None)
    _close(step, jstep)
    assert same is c


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk,qb,kb", [(16, 16, 4, 4), (13, 13, 4, 8),
                                         (7, 11, 8, 4)])
def test_blocked_attention_matches_unblocked_and_oracles(causal, sq, sk, qb,
                                                         kb):
    """Small blocks with ragged tails: the blocked form against the
    reference's blocked form, and against the unblocked oracle (the
    port's, itself held to the reference's) where the two masks agree:
    the blocked causal mask compares absolute positions, the oracle's
    aligns the last query with the last key, the same when Sq == Sk (GQA:
    4 query heads over 2 KV heads)."""
    jq, q = _normal(9, (2, sq, 4, 16))
    jk, k = _normal(10, (2, sk, 2, 16))
    jv, v = _normal(11, (2, sk, 2, 16))
    scale = 16 ** -0.5
    got = L._blocked_attention(q, k, v, causal=causal, scale=scale,
                               q_block=qb, k_block=kb)
    want = JL._blocked_attention(jq, jk, jv, causal=causal, scale=scale,
                                 q_block=qb, k_block=kb)
    _close(got, want)
    oracle = ref.attention_ref(q, k, v, causal=causal, scale=scale)
    _close(oracle, jref.attention_ref(jq, jk, jv, causal=causal,
                                      scale=scale))
    if sq == sk or not causal:
        _close(got, oracle.reshape(2, sq, 64).numpy())


def test_long_sequence_takes_the_blocked_path():
    """Above BLOCKED_ATTN_THRESHOLD tokens attention runs blocked, and
    equals the unblocked oracle."""
    jcfg, cfg = _pair("internlm2-1.8b", num_heads=2, num_kv_heads=2,
                      d_model=32, attn_q_block=2048, attn_k_block=2048)
    jp, p = _weights(JL.attention_specs(jcfg))
    s = L.BLOCKED_ATTN_THRESHOLD + 100
    _, x = _normal(12, (1, s, cfg.d_model))
    pos = torch.arange(s)[None]
    got, _ = L.attention(p, x, cfg, positions=pos)
    q = L.rope(L._split_heads(x @ p["wq"], 2, 16), pos, cfg.rope_theta)
    k = L.rope(L._split_heads(x @ p["wk"], 2, 16), pos, cfg.rope_theta)
    v = L._split_heads(x @ p["wv"], 2, 16)
    want = ref.attention_ref(q, k, v).reshape(1, s, 32) @ p["wo"]
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("arch,mlp_type", [("qwen3-1.7b", "swiglu"),
                                           ("hubert-xlarge", "gelu")])
def test_mlp_matches_reference(arch, mlp_type):
    """swiglu and gelu (the tanh form, jax.nn.gelu's default)."""
    jcfg, cfg = _pair(arch)
    assert cfg.mlp_type == mlp_type
    jp, p = _weights(JL.mlp_specs(jcfg))
    jx, x = _normal(13, (2, 6, cfg.d_model))
    _close(L.mlp(p, x, cfg), JL.mlp(jp, jx, jcfg))


def test_embed_logits_and_chunked_xent_match_reference():
    jcfg, cfg = _pair("qwen3-1.7b")
    jp, p = _weights(JL.embed_specs(jcfg))
    toks = np.random.default_rng(14).integers(0, cfg.vocab_size, (2, 8))
    _close(L.embed(p, torch.from_numpy(toks)),
           JL.embed(jp, jnp.asarray(toks)))
    jx, x = _normal(15, (2, 8, cfg.d_model))
    _close(L.logits(p, x), JL.logits(jp, jx))
    mask = np.random.default_rng(16).random((2, 8)) > 0.3
    for m in (None, mask):
        want = JL.chunked_softmax_xent(
            jp, jx, jnp.asarray(toks), chunk=4,
            label_mask=None if m is None else jnp.asarray(m))
        got = L.chunked_softmax_xent(
            p, x, torch.from_numpy(toks), chunk=4,
            label_mask=None if m is None else torch.from_numpy(m))
        _close(got, want)
