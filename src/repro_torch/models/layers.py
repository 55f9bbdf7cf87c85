"""Transformer layer library: norms, RoPE, GQA attention with its KV
cache, MLPs, embeddings and a chunked cross-entropy.

The counterpart of ``repro/models/layers.py``: pure functions over
parameter dicts built from ``param.ParamSpec`` trees, computing in the
config's type (bfloat16 by default) while norms, softmax and the loss
accumulate in float32.  No TPU kernel lies behind any of them; the
reference writes jnp and the port torch ops, in the reference's order of
operations: masks are ``-1e30`` (not ``-inf``), the softmax runs in
float32 and is cast back to the activations' type before the product
with V (``F.scaled_dot_product_attention`` rounds at other places), RoPE's
frequencies are computed in float32, and gelu is the tanh form that
``jax.nn.gelu`` defaults to.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig

from .hints import BATCH, TP, hint
from .param import spec

NEG_INF = -1e30     # the reference's mask value


def _dt(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def silu(x: torch.Tensor) -> torch.Tensor:
    """x * (1 / (1 + exp(-x))), each step rounded to x's type, as XLA
    lowers ``jax.nn.silu`` (``F.silu`` rounds once: a bfloat16 step away
    on a third of the entries)."""
    return x * (1 / (1 + torch.exp(-x)))


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm(x, scale, eps=1e-5):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


def rmsnorm_spec(d, name="scale"):
    return {name: spec((d,), (None,), init="ones", dtype=torch.float32)}


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: broadcastable to (..., S).

    The frequencies are exp(-log(theta) * i / half) in float32 on x's
    device, log included, as the reference computes them (a float64 log
    moves the angle at position 511 by a visible amount)."""
    hd = x.shape[-1]
    half = hd // 2
    log_theta = torch.full((), theta, dtype=torch.float32,
                           device=x.device).log()
    freqs = torch.exp(-log_theta * torch.arange(
        half, dtype=torch.float32, device=x.device) / half)
    angles = positions[..., None].float() * freqs        # (..., S, half)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA, optional qk-norm, optional KV cache)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class AttnCache:
    k: torch.Tensor       # (B, S_max, kvH, hd)
    v: torch.Tensor


def attention_specs(cfg: ArchConfig, *, cross: bool = False):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kvh = cfg.num_heads, cfg.num_kv_heads
    dt = _dt(cfg)
    s = {
        "wq": spec((d, h * hd), ("embed", "qkv"), dtype=dt),
        "wk": spec((d, kvh * hd), ("embed", "kv"), dtype=dt),
        "wv": spec((d, kvh * hd), ("embed", "kv"), dtype=dt),
        "wo": spec((h * hd, d), ("qkv", "embed"), dtype=dt),
    }
    if cfg.qk_norm and not cross:
        s["q_norm"] = spec((hd,), (None,), init="ones", dtype=torch.float32)
        s["k_norm"] = spec((hd,), (None,), init="ones", dtype=torch.float32)
    return s


def _split_heads(x, n, hd):
    b, s, _ = x.shape
    return x.reshape(b, s, n, hd)


def _repeat_kv(k, h):
    """Repeat KV heads up to ``h`` query heads (one head dim of size h)."""
    kvh = k.shape[2]
    if kvh == h:
        return k
    return hint(torch.repeat_interleave(k, h // kvh, dim=2),
                BATCH, None, TP, None)


def _gqa_scores(q, k, scale):
    """q: (B,Sq,H,hd), k: (B,Sk,kvH,hd) -> (B,H,Sq,Sk)."""
    k = _repeat_kv(k, q.shape[2])
    return torch.einsum("bqhd,bkhd->bhqk", q, k) * scale


def _gqa_out(probs, v):
    b, h, sq, sk = probs.shape
    v = _repeat_kv(v, h)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    return out.reshape(b, sq, h * v.shape[-1])


def _softmax(scores, dtype):
    return torch.softmax(scores.float(), dim=-1).to(dtype)


def _blocked_attention(q, k, v, *, causal: bool, scale: float,
                       q_block: int = 1024, k_block: int = 1024):
    """Flash-style blocked attention: loops over query blocks and, inside,
    key blocks with a running max, sum and accumulator in float32, so no
    (Sq, Sk) score matrix forms.  Ragged tails are padded up to a block
    multiple; padded keys are masked out, padded queries sliced off.

    q: (B,Sq,H,hd); k/v: (B,Sk,kvH,hd) (repeated to H inside).
    """
    b, sq, h, hd = q.shape
    k = _repeat_kv(k, h)
    v = _repeat_kv(v, h)
    sk = k.shape[1]
    qb = min(q_block, sq)
    kb = min(k_block, sk)
    sq_real, sk_real = sq, sk
    q_pad, k_pad = (-sq) % qb, (-sk) % kb
    if q_pad:
        q = F.pad(q, (0, 0, 0, 0, 0, q_pad))
        sq += q_pad
    if k_pad:
        k = F.pad(k, (0, 0, 0, 0, 0, k_pad))
        v = F.pad(v, (0, 0, 0, 0, 0, k_pad))
        sk += k_pad
    nq, nk = sq // qb, sk // kb
    dev = q.device
    outs = []
    for iq in range(nq):
        qi = q[:, iq * qb:(iq + 1) * qb]
        m = torch.full((b, h, qb), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((b, h, qb), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, h, qb, hd), dtype=torch.float32, device=dev)
        qpos = iq * qb + torch.arange(qb, device=dev)
        for jk in range(nk):
            kj = k[:, jk * kb:(jk + 1) * kb]
            vj = v[:, jk * kb:(jk + 1) * kb]
            s = torch.einsum("bqhd,bkhd->bhqk", qi, kj).float() * scale
            kpos = jk * kb + torch.arange(kb, device=dev)
            msk = (kpos < sk_real)[None, :]
            if causal:
                msk = msk & (qpos[:, None] >= kpos[None, :])
            s = s.masked_fill(~msk[None, None], NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            corr = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p.to(qi.dtype), vj).float()
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.transpose(1, 2).to(q.dtype))          # (B,qb,H,hd)
    out = torch.cat(outs, dim=1).reshape(b, sq, h * hd)
    return out[:, :sq_real]


BLOCKED_ATTN_THRESHOLD = 4096  # use flash-style blocking only above 4k


def _pos_vec(pos, b: int, device) -> torch.Tensor:
    """Per-slot positions (B,) int64 on ``device`` from an int, a ()
    tensor or a (B,) tensor; an int is filled in on the device (no
    host-to-device copy)."""
    if isinstance(pos, torch.Tensor):
        pos = pos.to(device=device, dtype=torch.int64)
        return pos.reshape(-1).expand(b) if pos.dim() else pos.expand(b)
    return torch.full((b,), int(pos), dtype=torch.int64, device=device)


def attention(p, x, cfg: ArchConfig, *, positions, causal: bool = True,
              cache: Optional[AttnCache] = None,
              cache_pos=None,
              kv_x: Optional[torch.Tensor] = None,
              return_kv: bool = False,
              kv_cache_len: Optional[int] = None,
              use_rope: bool = True, cache_in_place: bool = False):
    """Self- or cross-attention.

    Modes:
      * full-sequence (train / prefill): ``cache=None``.  With
        ``return_kv=True`` also returns an ``AttnCache`` padded to
        ``kv_cache_len`` (prefill).
      * decode: ``cache`` + ``cache_pos`` given, x has S=1; k/v written at
        ``cache_pos`` (an int, a () or a (B,) tensor: per-slot positions)
        into NEW cache tensors, the ones passed in left unchanged, or with
        ``cache_in_place`` into the tensors passed in (the reference's
        donated caches); attends over positions <= cache_pos.
      * static-cache cross-attention: ``cache`` given, ``cache_pos=None``:
        attends over the whole cache, no update (vision KV at decode).
      * cross-attention from ``kv_x`` (no causal mask, no RoPE).
    """
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    scale = hd ** -0.5

    q = hint(_split_heads(x @ p["wq"], h, hd), BATCH, None, TP, None)
    if cfg.qk_norm and "q_norm" in p:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
    if use_rope and kv_x is None:
        q = rope(q, positions, cfg.rope_theta)

    if cache is not None and cache_pos is None:
        # Static cache (cross-attention at decode): full visibility.
        scores = _gqa_scores(q, cache.k, scale)
        out = _gqa_out(_softmax(scores, x.dtype), cache.v)
        return out @ p["wo"], cache

    src = kv_x if kv_x is not None else x
    k = _split_heads(src @ p["wk"], kvh, hd)
    v = _split_heads(src @ p["wv"], kvh, hd)
    if cfg.qk_norm and "k_norm" in p:
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    if use_rope and kv_x is None:
        k = rope(k, positions, cfg.rope_theta)

    if cache is not None:
        # Decode: this token's k/v at each slot's position, written out of
        # place (the reference's functional .at[].set) or in place.
        b = x.shape[0]
        pos_vec = _pos_vec(cache_pos, b, x.device)
        idx = (torch.arange(b, device=x.device), pos_vec)
        k_new, v_new = k[:, 0].to(cache.k.dtype), v[:, 0].to(cache.v.dtype)
        if cache_in_place:
            k_cache = cache.k.index_put_(idx, k_new)
            v_cache = cache.v.index_put_(idx, v_new)
        else:
            k_cache = cache.k.index_put(idx, k_new)
            v_cache = cache.v.index_put(idx, v_new)
        scores = _gqa_scores(q, k_cache, scale)
        keymask = (torch.arange(k_cache.shape[1], device=x.device)[None, :]
                   <= pos_vec[:, None])
        scores = scores.masked_fill(~keymask[:, None, None, :], NEG_INF)
        out = _gqa_out(_softmax(scores, x.dtype), v_cache)
        return out @ p["wo"], AttnCache(k=k_cache, v=v_cache)

    sq, sk = q.shape[1], k.shape[1]
    if max(sq, sk) > BLOCKED_ATTN_THRESHOLD:
        out = _blocked_attention(q, k, v, causal=causal and kv_x is None,
                                 scale=scale, q_block=cfg.attn_q_block,
                                 k_block=cfg.attn_k_block)
    else:
        scores = _gqa_scores(q, k, scale)                   # (B,H,Sq,Sk)
        if causal and kv_x is None:
            mask = torch.ones((sq, sk), dtype=torch.bool,
                              device=x.device).tril(diagonal=sk - sq)
            scores = scores.masked_fill(~mask[None, None], NEG_INF)
        out = _gqa_out(_softmax(scores, x.dtype), v)

    new_cache = None
    if return_kv:
        pad_to = kv_cache_len or sk
        if pad_to > sk:
            k = F.pad(k, (0, 0, 0, 0, 0, pad_to - sk))
            v = F.pad(v, (0, 0, 0, 0, 0, pad_to - sk))
        new_cache = AttnCache(k=k, v=v)
    return out @ p["wo"], new_cache


def init_attn_cache(cfg: ArchConfig, batch: int, max_len: int, dtype,
                    device="cuda"):
    """A zero cache of ``max_len`` positions (``device="meta"``: shapes
    only, the reference's ``abstract=True``)."""
    kvh, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    shape = (batch, max_len, kvh, hd)
    return AttnCache(k=torch.zeros(shape, dtype=dtype, device=device),
                     v=torch.zeros(shape, dtype=dtype, device=device))


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def mlp_specs(cfg: ArchConfig, d_ff: Optional[int] = None):
    d = cfg.d_model
    f = d_ff if d_ff is not None else cfg.d_ff
    dt = _dt(cfg)
    if cfg.mlp_type == "swiglu":
        return {
            "w_gate": spec((d, f), ("embed", "mlp"), dtype=dt),
            "w_up": spec((d, f), ("embed", "mlp"), dtype=dt),
            "w_down": spec((f, d), ("mlp", "embed"), dtype=dt),
        }
    return {
        "w_up": spec((d, f), ("embed", "mlp"), dtype=dt),
        "w_down": spec((f, d), ("mlp", "embed"), dtype=dt),
    }


def mlp(p, x, cfg: ArchConfig):
    if cfg.mlp_type == "swiglu":
        h = silu(x @ p["w_gate"]) * (x @ p["w_up"])
    else:
        h = F.gelu(x @ p["w_up"], approximate="tanh")
    h = hint(h, BATCH, None, TP)
    return h @ p["w_down"]


# ---------------------------------------------------------------------------
# Embedding + LM head + chunked cross-entropy
# ---------------------------------------------------------------------------

def embed_specs(cfg: ArchConfig):
    dt = _dt(cfg)
    return {
        "embedding": spec((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                          dtype=dt, scale=1.0),
        "head": spec((cfg.d_model, cfg.vocab_size), ("embed", "vocab"),
                     dtype=dt),
    }


def embed(p, tokens):
    return F.embedding(tokens.long(), p["embedding"])


def logits(p, x):
    return x @ p["head"]


def _xent_chunk(head, xc, lc, mc):
    """One chunk's summed token NLL and its count of labelled tokens."""
    lg = hint((xc @ head).float(), BATCH, None, TP)
    lse = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, lc.long()[..., None])[..., 0]
    nll = torch.where(mc, lse - gold, torch.zeros_like(lse))
    return nll.sum(), mc.sum()


def chunked_softmax_xent(p, x, labels, *, chunk: int = 512,
                         label_mask=None) -> torch.Tensor:
    """Mean token cross-entropy over sequence chunks, so the (B, S, V)
    logits tensor never forms whole: each chunk runs under a checkpoint
    (the reference's ``jax.checkpoint``), so its float32 logits are not
    kept for the backward, which recomputes them a chunk at a time (peak
    one (B, chunk, V) block)."""
    b, s, d = x.shape
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")
    head = p["head"]
    if label_mask is None:
        label_mask = torch.ones((b, s), dtype=torch.bool, device=x.device)
    remat = torch.is_grad_enabled()
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.int64, device=x.device)
    for c in range(0, s, chunk):
        args = (head, x[:, c:c + chunk], labels[:, c:c + chunk],
                label_mask[:, c:c + chunk])
        nll, n = (checkpoint(_xent_chunk, *args, use_reentrant=False)
                  if remat else _xent_chunk(*args))
        tot = tot + nll
        cnt = cnt + n
    return tot / torch.clamp(cnt, min=1)
