"""Mamba1 (selective scan) and Mamba2 (SSD, chunked dual form) layers.

The counterpart of ``repro/models/ssm.py``, chunked over time as the
reference is: a loop over chunks carries the SSM state, and each chunk's
work is computed in parallel inside it.

  * Mamba1: per-channel state (d_inner, N).  In-chunk: the linear
    recurrence h_t = dA_t * h_{t-1} + dBx_t as a log-depth doubling scan
    (Hillis-Steele) over the chunk's prefix products and sums, the torch
    form of the reference's ``jax.lax.associative_scan``.  It multiplies
    decays and never divides by one (a decay may underflow to 0).
  * Mamba2: per-head scalar decay (SSD).  In-chunk: the quadratic dual
    form (masked, attention-like products) plus the carried state.

Decode is a single-step state update.  No TPU kernel lies behind either
layer: the reference writes jnp (``kernels/ref.py::ssm_scan_ref`` is its
sequential oracle) and the port torch ops.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch.nn import functional as F

from repro_torch.configs.base import ArchConfig

from .hints import BATCH, TP, hint
from .layers import silu
from .param import spec


@dataclasses.dataclass
class SSMCache:
    conv: torch.Tensor  # (B, K-1, d_inner): the causal conv's tail
    h: torch.Tensor     # mamba1: (B, d_inner, N); mamba2: (B, nH, P, N)


# ---------------------------------------------------------------------------
# Shared: causal depthwise conv (kernel K) as shift-and-sum
# ---------------------------------------------------------------------------

def _causal_conv(x, w, b, tail: Optional[torch.Tensor] = None):
    """x: (B, L, D); w: (K, D); returns (B, L, D) and the new tail.

    tail: (B, K-1, D) previous inputs (decode/prefill continuation).
    """
    k = w.shape[0]
    if tail is None:
        tail = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                           device=x.device)
    ext = torch.cat([tail, x], dim=1)                 # (B, L+K-1, D)
    out = sum(ext[:, i:i + x.shape[1], :] * w[i][None, None, :]
              for i in range(k))
    new_tail = ext[:, -(k - 1):, :]
    return out + b[None, None, :], new_tail


def _pad_chunks(q: int, x, dt, Bmat, Cmat):
    """Pad the time axis to a multiple of ``q`` with IDENTITY transitions:
    dt=0 gives dA=exp(0)=1 and dBx=0, so the carried state is untouched by
    padded steps; padded outputs are sliced off by the caller."""
    L = x.shape[1]
    pad = (-L) % q
    if pad:
        def padt(t):
            return F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
        x, dt, Bmat, Cmat = map(padt, (x, dt, Bmat, Cmat))
    return x, dt, Bmat, Cmat, (L + pad) // q


def _chunks(t, bsz, nc, q):
    """(B, nc*q, ...) -> (nc, B, q, ...)."""
    return t.reshape(bsz, nc, q, *t.shape[2:]).transpose(0, 1)


# ---------------------------------------------------------------------------
# Mamba1
# ---------------------------------------------------------------------------

def mamba1_specs(cfg: ArchConfig):
    d, di, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
    dt_rank = max(d // 16, 1)
    k = cfg.ssm_conv
    bt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    return {
        "in_proj": spec((d, 2 * di), ("embed", "inner"), dtype=bt),
        "conv_w": spec((k, di), (None, "inner"), dtype=bt, scale=0.5),
        "conv_b": spec((di,), ("inner",), init="zeros", dtype=bt),
        "x_proj": spec((di, dt_rank + 2 * n), ("inner", None), dtype=bt),
        "dt_proj": spec((dt_rank, di), (None, "inner"), dtype=bt),
        "dt_bias": spec((di,), ("inner",), init="zeros", dtype=torch.float32),
        "A_log": spec((di, n), ("inner", None), init="zeros",
                      dtype=torch.float32),
        "D": spec((di,), ("inner",), init="ones", dtype=torch.float32),
        "out_proj": spec((di, d), ("inner", "embed"), dtype=bt),
    }


def _mamba1_scan_chunk(h, dA, dBx, C):
    """One chunk: h (B,D,N); dA/dBx (B,Q,D,N); C (B,Q,N) -> (h', y).

    The prefixes (a_t, b_t) of the pairs (dA_t, dBx_t) under
    (a1, b1) o (a2, b2) = (a1 a2, a2 b1 + b2), by doubling: after the
    step of offset d each t holds the combination of steps t-2d+1..t."""
    a, b = dA, dBx
    q = a.shape[1]
    d = 1
    while d < q:
        a_new = a.clone()
        b_new = b.clone()
        a_new[:, d:] = a[:, :-d] * a[:, d:]
        b_new[:, d:] = a[:, d:] * b[:, :-d] + b[:, d:]
        a, b = a_new, b_new
        d *= 2
    hs = a * h[:, None] + b                               # (B,Q,D,N)
    y = torch.einsum("bqdn,bqn->bqd", hs, C)
    return hs[:, -1], y


def mamba1(p, u, cfg: ArchConfig, cache: Optional[SSMCache] = None
           ) -> Tuple[torch.Tensor, Optional[SSMCache]]:
    """u: (B, L, d_model).  cache given => decode (L == 1)."""
    d, di, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
    dt_rank = max(d // 16, 1)
    bsz, L, _ = u.shape

    xz = u @ p["in_proj"]
    x, z = torch.chunk(xz, 2, dim=-1)
    x = hint(x, BATCH, None, TP)
    z = hint(z, BATCH, None, TP)
    tail = cache.conv if cache is not None else None
    x, new_tail = _causal_conv(x, p["conv_w"], p["conv_b"], tail)
    x = silu(x)

    proj = x @ p["x_proj"]
    dt_raw = proj[..., :dt_rank]
    Bmat = proj[..., dt_rank:dt_rank + n].float()
    Cmat = proj[..., dt_rank + n:].float()
    dt = hint(F.softplus((dt_raw @ p["dt_proj"]).float() + p["dt_bias"]),
              BATCH, None, TP)
    A = -torch.exp(p["A_log"])                           # (D, N)
    xf = x.float()

    if cache is not None:                                # decode: one step
        dA = torch.exp(dt[:, 0, :, None] * A[None])      # (B,D,N)
        dBx = (dt[:, 0, :, None] * Bmat[:, 0, None, :]
               * xf[:, 0, :, None])
        h = cache.h * dA + dBx
        y = torch.einsum("bdn,bn->bd", h, Cmat[:, 0])[:, None]
        y = y + xf * p["D"][None, None]
        out = (y.to(u.dtype) * silu(z)) @ p["out_proj"]
        return out, SSMCache(conv=new_tail, h=h)

    y, h = mamba1_scan(xf, dt, A, Bmat, Cmat, p["D"],
                       min(cfg.ssm_chunk, L))
    out = (y.to(u.dtype) * silu(z)) @ p["out_proj"]
    return out, SSMCache(conv=new_tail, h=h)


def mamba1_scan(x, dt, A, Bmat, Cmat, D, q: int):
    """The selective scan of :func:`mamba1`'s prefill, chunked by ``q``:
    x, dt (B,L,D); A (D,N); Bmat, Cmat (B,L,N); D (D,) -> (y (B,L,D), the
    final state (B,D,N)).  ``kernels.ref.ssm_scan_ref`` computes the same
    y step by step."""
    bsz, L, di = x.shape
    # Ragged tail: pad with identity transitions (dt=0 -> dA=1, dBx=0).
    xp, dt, Bmat, Cmat, nc = _pad_chunks(q, x, dt, Bmat, Cmat)
    xs, dts, bs, cs = (_chunks(t, bsz, nc, q) for t in (xp, dt, Bmat, Cmat))
    h = torch.zeros((bsz, di, A.shape[1]), dtype=torch.float32,
                    device=x.device)
    ys = []
    for c in range(nc):
        dA = torch.exp(dts[c][..., None] * A[None, None])    # (B,Q,D,N)
        dBx = dts[c][..., None] * bs[c][:, :, None, :] * xs[c][..., None]
        h, y = _mamba1_scan_chunk(h, dA, dBx, cs[c])
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :L]
    return y + x * D[None, None], h


# ---------------------------------------------------------------------------
# Mamba2 (SSD)
# ---------------------------------------------------------------------------

def mamba2_specs(cfg: ArchConfig):
    d, di, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
    nh = di // cfg.ssm_head_dim
    k = cfg.ssm_conv
    bt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    return {
        "in_proj": spec((d, 2 * di), ("embed", "inner"), dtype=bt),
        "conv_w": spec((k, di), (None, "inner"), dtype=bt, scale=0.5),
        "conv_b": spec((di,), ("inner",), init="zeros", dtype=bt),
        "bc_proj": spec((di, 2 * n), ("inner", None), dtype=bt),
        "dt_proj": spec((di, nh), ("inner", "ssm_heads"), dtype=bt),
        "dt_bias": spec((nh,), ("ssm_heads",), init="zeros",
                        dtype=torch.float32),
        "A_log": spec((nh,), ("ssm_heads",), init="zeros",
                      dtype=torch.float32),
        "D": spec((nh,), ("ssm_heads",), init="ones", dtype=torch.float32),
        "out_proj": spec((di, d), ("inner", "embed"), dtype=bt),
    }


def _mamba2_chunk(h, xq, dtq, bq, cq, a):
    """One SSD chunk: h (B,nh,P,N); xq (B,Q,nh,P); dtq (B,Q,nh); bq/cq
    (B,Q,N) -> (h', y (B,Q,nh,P))."""
    q = xq.shape[1]
    la = dtq * a[None, None]                             # (B,Q,nh) log-decay
    cum = torch.cumsum(la, dim=1)                        # (B,Q,nh)
    # Intra-chunk dual form: masked attention-like product.
    g = torch.einsum("bqn,bsn->bqs", cq, bq)             # (B,Q,Q)
    dec = torch.exp(cum[:, :, None] - cum[:, None, :])   # (B,Q,S,nh)
    tri = torch.ones((q, q), dtype=torch.bool, device=xq.device).tril()
    mmat = torch.where(tri[None, :, :, None], g[..., None] * dec
                       * dtq[:, None], torch.zeros((), device=xq.device))
    y_intra = torch.einsum("bqsh,bshp->bqhp", mmat, xq)
    # Inter-chunk: contribution of the carried state.
    y_inter = torch.einsum("bqn,bhpn->bqhp", cq, h) * \
        torch.exp(cum)[..., None]
    # State update.
    tail_dec = torch.exp(cum[:, -1:, :] - cum)           # (B,Q,nh)
    dbx = torch.einsum("bsh,bsn,bshp->bhpn", tail_dec * dtq, bq, xq)
    h = h * torch.exp(cum[:, -1])[:, :, None, None] + dbx
    return h, y_intra + y_inter


def mamba2(p, u, cfg: ArchConfig, cache: Optional[SSMCache] = None
           ) -> Tuple[torch.Tensor, Optional[SSMCache]]:
    d, di, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
    ph = cfg.ssm_head_dim
    nh = di // ph
    bsz, L, _ = u.shape

    xz = u @ p["in_proj"]
    x, z = torch.chunk(xz, 2, dim=-1)
    x = hint(x, BATCH, None, TP)
    z = hint(z, BATCH, None, TP)
    tail = cache.conv if cache is not None else None
    x, new_tail = _causal_conv(x, p["conv_w"], p["conv_b"], tail)
    x = silu(x)

    bc = x @ p["bc_proj"]
    Bmat = bc[..., :n].float()                           # (B,L,N)
    Cmat = bc[..., n:].float()
    dt = F.softplus((x @ p["dt_proj"]).float() + p["dt_bias"])  # (B,L,nh)
    a = -torch.exp(p["A_log"])                           # (nh,)
    xh = hint(x.float().reshape(bsz, L, nh, ph), BATCH, None, TP, None)

    if cache is not None:                                # decode step
        dtq = dt[:, 0]                                   # (B,nh)
        da = torch.exp(dtq * a[None])                    # (B,nh)
        dBx = torch.einsum("bh,bn,bhp->bhpn", dtq, Bmat[:, 0], xh[:, 0])
        h = cache.h * da[..., None, None] + dBx
        y = torch.einsum("bhpn,bn->bhp", h, Cmat[:, 0])
        y = y + xh[:, 0] * p["D"][None, :, None]
        y = y.reshape(bsz, 1, di)
        out = (y.to(u.dtype) * silu(z)) @ p["out_proj"]
        return out, SSMCache(conv=new_tail, h=h)

    q = min(cfg.ssm_chunk, L)
    xh, dt, Bmat, Cmat, nc = _pad_chunks(q, xh, dt, Bmat, Cmat)
    xs, dts, bs, cs = (_chunks(t, bsz, nc, q) for t in (xh, dt, Bmat, Cmat))
    h = torch.zeros((bsz, nh, ph, n), dtype=torch.float32, device=u.device)
    ys = []
    for c in range(nc):
        h, y = _mamba2_chunk(h, xs[c], dts[c], bs[c], cs[c], a)
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :L]
    y = y + xh[:, :L] * p["D"][None, None, :, None]
    y = y.reshape(bsz, L, di)
    out = (y.to(u.dtype) * silu(z)) @ p["out_proj"]
    return out, SSMCache(conv=new_tail, h=h)


def _ssm_shapes(cfg: ArchConfig, batch: int):
    di, n = cfg.d_inner, cfg.ssm_state
    if cfg.mamba_version == 2:
        h = (batch, di // cfg.ssm_head_dim, cfg.ssm_head_dim, n)
    else:
        h = (batch, di, n)
    return (batch, cfg.ssm_conv - 1, di), h


def init_ssm_cache(cfg: ArchConfig, batch: int, dtype, device="cuda"):
    conv, h = _ssm_shapes(cfg, batch)
    return SSMCache(conv=torch.zeros(conv, dtype=dtype, device=device),
                    h=torch.zeros(h, dtype=torch.float32, device=device))


def abstract_ssm_cache(cfg: ArchConfig, batch: int, dtype):
    """The cache's shapes and types as ``meta`` tensors."""
    return init_ssm_cache(cfg, batch, dtype, device="meta")
