"""Closed-form roofline terms per (arch x shape x mesh) cell.

The counterpart of ``repro/launch/analytic.py``: the same FLOP, byte and
collective forms, derived from the model's math (every matrix product is
enumerable) and from the sharding policy of ``launch/sharding.py``.  The
mesh and the hardware are parameters: the default is one H100
(chips = tp = dp = 1), and the reference's 16x16 and 2x16x16 meshes are
``mesh.make_production_mesh(multi_pod=...)``.  On one chip there are no
links, so the collective bytes are 0 there.  All outputs are PER-CHIP
quantities except ``model_flops``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.configs.base import ArchConfig
from repro_torch.models.model import Model

from .mesh import ONE_CARD, Mesh
from .roofline import H100, Hardware, model_flops_params
from .shapes import SHAPES

BF16 = 2
F32 = 4


@dataclasses.dataclass
class AnalyticTerms:
    flops_issued: float     # per chip, incl. backward + remat recompute
    model_flops: float      # GLOBAL 6·N_active·D (train) / 2·N·D (serve)
    hbm_bytes: float        # per chip
    ici_bytes: float        # per chip, over the links
    chips: int
    notes: Dict[str, float]
    hw: Hardware = H100

    @property
    def t_compute(self):
        return self.flops_issued / self.hw.peak_flops

    @property
    def t_memory(self):
        return self.hbm_bytes / self.hw.hbm_bw

    @property
    def t_collective(self):
        return self.ici_bytes / self.hw.link_bw

    @property
    def step_time(self):
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def bottleneck(self):
        t = {"compute": self.t_compute, "memory": self.t_memory,
             "collective": self.t_collective}
        return max(t, key=t.get)

    @property
    def mfu(self):
        """MODEL_FLOPS / (chips · peak · step_time)."""
        st = self.step_time
        return (self.model_flops / (self.chips * self.hw.peak_flops * st)
                if st else 0)

    @property
    def useful_ratio(self):
        tot = self.flops_issued * self.chips
        return self.model_flops / tot if tot else 0


# -- forward FLOPs per TOKEN (global math, one layer) ------------------------

def _attn_flops_token(cfg: ArchConfig, s_att: float) -> float:
    h, hd, kvh, d = (cfg.num_heads, cfg.resolved_head_dim,
                     cfg.num_kv_heads, cfg.d_model)
    proj = 2 * d * (h + 2 * kvh) * hd + 2 * h * hd * d
    scores = 4 * s_att * h * hd          # QK^T + PV
    return proj + scores


def _mlp_flops_token(cfg: ArchConfig) -> float:
    if cfg.mlp_type == "none":
        return 0
    mults = 3 if cfg.mlp_type == "swiglu" else 2
    return 2 * mults * cfg.d_model * cfg.d_ff


def _moe_flops_token(cfg: ArchConfig) -> float:
    router = 2 * cfg.d_model * cfg.num_experts
    expert = 2 * 3 * cfg.d_model * cfg.d_ff
    return router + cfg.experts_per_token * cfg.moe_capacity_factor * expert


def _mamba1_flops_token(cfg: ArchConfig) -> float:
    d, di, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
    dtr = max(d // 16, 1)
    proj = 2 * d * 2 * di + 2 * di * (dtr + 2 * n) + 2 * dtr * di \
        + 2 * di * d
    conv = 2 * cfg.ssm_conv * di
    scan = 10 * di * n                  # dA, dBx, state update, y=C·h
    return proj + conv + scan


def _mamba2_flops_token(cfg: ArchConfig) -> float:
    d, di, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
    nh = di // cfg.ssm_head_dim
    q = cfg.ssm_chunk
    proj = 2 * d * 2 * di + 2 * di * 2 * n + 2 * di * nh + 2 * di * d
    conv = 2 * cfg.ssm_conv * di
    # SSD dual form per token: intra-chunk (Q-window attention-like) +
    # state carry terms.
    ssd = 2 * q * n + q * nh + 2 * q * di / 2 + 4 * di * n
    return proj + conv + ssd


def head_flops_token(cfg: ArchConfig) -> float:
    """The LM head's (or the encoder head's) FLOPs for one position."""
    return 2 * cfg.d_model * cfg.vocab_size


def forward_flops_per_token(cfg: ArchConfig, s_att: float) -> float:
    """One-token forward FLOPs through the whole stack (+head)."""
    L = cfg.num_layers
    if cfg.family in ("dense", "encoder"):
        per_layer = _attn_flops_token(cfg, s_att) + _mlp_flops_token(cfg)
        body = L * per_layer
    elif cfg.family == "moe":
        per_layer = _attn_flops_token(cfg, s_att) + _moe_flops_token(cfg)
        body = L * per_layer
    elif cfg.family == "ssm":
        body = L * _mamba1_flops_token(cfg)
    elif cfg.family == "hybrid":
        n_shared = cfg.num_layers // cfg.attn_every
        body = (L * _mamba2_flops_token(cfg)
                + n_shared * (_attn_flops_token(cfg, s_att)
                              + _mlp_flops_token(cfg)))
    elif cfg.family == "vlm":
        n_cross = cfg.num_layers // cfg.cross_attn_every
        n_self = cfg.num_layers - n_cross
        cross = (_attn_flops_token(cfg, cfg.vision_tokens)
                 + _mlp_flops_token(cfg))
        body = (n_self * (_attn_flops_token(cfg, s_att)
                          + _mlp_flops_token(cfg)) + n_cross * cross)
    else:
        raise ValueError(cfg.family)
    return body + head_flops_token(cfg)


_REMAT_MULT = {  # train total / forward: 1 fwd + 2 bwd + remat recompute
    "dense": 4.0, "encoder": 4.0, "moe": 4.0, "ssm": 4.0,
    "hybrid": 5.0, "vlm": 5.0,   # nested sqrt-L remat: one extra forward
}


# -- cache bytes -------------------------------------------------------------

def cache_bytes_global(cfg: ArchConfig, batch: int, seq: int) -> float:
    if cfg.family in ("dense", "moe", "encoder"):
        n_attn = cfg.num_layers
    elif cfg.family == "ssm":
        n_attn = 0
    elif cfg.family == "hybrid":
        n_attn = cfg.num_layers // cfg.attn_every
    elif cfg.family == "vlm":
        n_attn = cfg.num_layers      # self (4/5) + cross (vt) ~ upper bound
    attn = n_attn * 2 * batch * seq * cfg.num_kv_heads * \
        cfg.resolved_head_dim * BF16
    ssm = 0
    if cfg.ssm_state:
        di = cfg.d_inner
        if cfg.mamba_version == 2:
            state = (di // cfg.ssm_head_dim) * cfg.ssm_head_dim * \
                cfg.ssm_state
        else:
            state = di * cfg.ssm_state
        ssm = cfg.num_layers * batch * (state * F32
                                        + (cfg.ssm_conv - 1) * di * BF16)
    return attn + ssm


def _cache_shards(cfg: ArchConfig, batch: int, seq: int, dp: int,
                  tp: int) -> float:
    """How many ways the cache divides under the cache_pspecs policy."""
    shards = 1.0
    if batch % dp == 0 and batch >= dp:
        shards *= dp
    elif seq % dp == 0:      # B=1 long-context: sequence over data
        shards *= dp
    kvh = cfg.num_kv_heads
    if kvh and kvh % tp == 0 and kvh >= tp:
        shards *= tp
    elif seq % tp == 0:
        shards *= tp
    return shards


# -- the main entry ----------------------------------------------------------

def _reduces_per_layer(cfg: ArchConfig) -> float:
    """TP activation reductions per layer: Megatron counts 2 (attn out +
    mlp out); Mamba blocks have ONE row-parallel out_proj."""
    if cfg.family == "ssm":
        return 1.0
    if cfg.family == "hybrid":
        return (cfg.num_layers + 2 * (cfg.num_layers // cfg.attn_every)) \
            / cfg.num_layers
    return 2.0


def analytic_cell(cfg: ArchConfig, shape_name: str, *,
                  mesh: Mesh = ONE_CARD, microbatches: int = 4,
                  gather_once: bool = False, batch: Optional[int] = None,
                  hw: Hardware = H100) -> AnalyticTerms:
    """The cell's terms on ``mesh`` (one H100 by default) at ``batch``
    sequences (the cell's global batch by default).  ``gather_once`` and
    the cfg knobs (moe_dispatch_dtype, attn_q_block) are the reference's
    optimization levers; the defaults are its baseline."""
    cell = SHAPES[shape_name]
    tp = mesh.shape["model"]
    chips = mesh.size
    dp = chips // tp
    multi_pod = "pod" in mesh.axis_names
    links = chips > 1
    B, S = batch or cell.global_batch, cell.seq_len
    model = Model(cfg)
    n = model_flops_params(cfg, model.param_specs())
    W = n["total"] * BF16                      # param bytes (bf16)
    d = cfg.d_model
    V = cfg.vocab_size
    qb = cfg.attn_q_block
    disp_bytes = 1 if cfg.moe_dispatch_dtype == "int8" else BF16
    red = _reduces_per_layer(cfg)

    if cell.kind == "train":
        D = B * S
        s_att = S / 2                          # causal average
        fwd = forward_flops_per_token(cfg, s_att) * D
        issued = fwd * _REMAT_MULT[cfg.family] / chips
        model_fl = 6 * n["active"] * D

        mb = microbatches
        b_dev = B / dp / mb                    # sequences per chip per mb
        act = b_dev * S * d * BF16             # one residual tensor
        L = cfg.num_layers
        fsdp = 2 * (W / tp) if gather_once else mb * 3 * (W / tp)
        hbm = (
            fsdp                               # gathered-weight traffic
            + 2 * (W + 12 * n["total"]) / chips  # optimizer update
            + mb * L * 8 * act                 # per-layer activation traffic
            + 3 * (B / dp) * S * (V / tp) * F32  # chunked logits f+recompute
        )
        if S > 4096:                           # blocked attention KV re-reads
            hbm += mb * L * (S / qb) * b_dev * S * cfg.num_kv_heads * \
                cfg.resolved_head_dim * BF16 * 2
        ici = (
            fsdp                               # FSDP gathers + grad RS
            + mb * L * red * act               # TP activation reductions
        )
        if cfg.num_experts:
            cap_buf = (b_dev * S * cfg.experts_per_token
                       * cfg.moe_capacity_factor * d * disp_bytes)
            ici += mb * L * 2 * cap_buf        # EP dispatch/combine
            hbm += mb * L * 4 * cap_buf
        if multi_pod:
            ici += W / tp                      # cross-pod grad reduction
        notes = {"tokens": D, "fwd_flops_global": fwd}
        return AnalyticTerms(issued, model_fl, hbm, ici if links else 0.0,
                             chips, notes, hw)

    if cell.kind == "prefill":
        D = B * S
        s_att = S / 2
        fwd = forward_flops_per_token(cfg, s_att) * D
        issued = fwd / chips
        model_fl = 2 * n["active"] * D
        b_dev = B / dp
        act = b_dev * S * d * BF16
        L = cfg.num_layers
        cache = cache_bytes_global(cfg, B, S) / _cache_shards(
            cfg, B, S, dp, tp)
        hbm = (W / tp + L * 8 * act + cache
               + (S / qb) * L * b_dev * S * cfg.num_kv_heads
               * cfg.resolved_head_dim * BF16 * 2
               + b_dev * (V / tp) * F32)
        ici = L * red * act + cache            # TP reductions + cache layout
        if cfg.num_experts:
            cap_buf = (b_dev * S * cfg.experts_per_token
                       * cfg.moe_capacity_factor * d * disp_bytes)
            ici += L * 2 * cap_buf
            hbm += L * 4 * cap_buf
        return AnalyticTerms(issued, model_fl, hbm, ici if links else 0.0,
                             chips, {"tokens": D}, hw)

    # decode: one token per sequence against a seq_len cache
    D = B
    s_att = S
    fwd = forward_flops_per_token(cfg, s_att) * D
    issued = fwd / chips
    model_fl = 2 * n["active"] * D
    cache = cache_bytes_global(cfg, B, S) / _cache_shards(cfg, B, S, dp, tp)
    act = max(B / dp, 1) * d * BF16
    L = cfg.num_layers
    hbm = W / tp + cache + L * 8 * act + max(B / dp, 1) * (V / tp) * F32
    ici = L * red * act + max(B / dp, 1) * (V / tp) * F32
    if cfg.num_experts:
        cap = max(8, B / dp * cfg.experts_per_token
                  * cfg.moe_capacity_factor)
        ici += L * 2 * cap * d * BF16
    return AnalyticTerms(issued, model_fl, hbm, ici if links else 0.0, chips,
                         {"tokens": D, "cache_bytes_chip": cache}, hw)
