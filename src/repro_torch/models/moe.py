"""Mixture-of-Experts layer whose token dispatch IS the OpSparse binning.

The counterpart of ``repro/models/moe.py``.  Routing T tokens x top-k to E
experts is the paper's two-pass binning problem: a histogram of per-expert
counts, their exclusive sum, and a stable counting sort of the assignment
ids into one flat array (``core.binning.bin_by_id``).  Dispatch and
combine are then gathers and scatters rather than the dense one-hot
einsums of GShard-style layers; the dense form is kept as
:func:`moe_dense_dispatch` and timed against the binning one in
``benchmarks/torch/bench_moe_dispatch.py``.

No TPU kernel lies behind either: the reference leaves the binning, the
gathers and scatters and the three expert einsums to XLA, and the port
leaves them to torch ops (the expert FFN is three ``einsum`` matrix
products on an (E, C, d) capacity buffer).  Both functions keep the
reference's layout: ``x`` is (B, S, d), and each sequence is one dispatch
group with its own capacity.  :class:`MoE` holds the parameters as an
``nn.Module`` whose ``forward`` is :func:`moe` and ``dense_dispatch``
:func:`moe_dense_dispatch`.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core.binning import bin_by_id

from .hints import BATCH, TP, hint
from .param import init_params, spec


def moe_specs(cfg: ArchConfig):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    return {
        "router": spec((d, e), ("embed", None), dtype=torch.float32),
        "w_gate": spec((e, d, f), ("experts", "embed", "expert_mlp"),
                       dtype=dt),
        "w_up": spec((e, d, f), ("experts", "embed", "expert_mlp"), dtype=dt),
        "w_down": spec((e, f, d), ("experts", "expert_mlp", "embed"),
                       dtype=dt),
    }


def _capacity(cfg: ArchConfig, tokens: int) -> int:
    cap = int(tokens * cfg.experts_per_token * cfg.moe_capacity_factor
              / cfg.num_experts)
    return max(8, -(-cap // 8) * 8)  # a multiple of 8, as the reference


def route(p, x_flat: torch.Tensor, cfg: ArchConfig):
    """Router: top-k experts, their normalized weights (T, k), and the
    Switch-style load-balance loss E * sum_e fraction_e * mean_prob_e."""
    logits = x_flat.float() @ p["router"]                   # (T, E)
    probs = torch.softmax(logits, dim=-1)
    weights, experts = torch.topk(probs, cfg.experts_per_token, dim=-1)
    weights = weights / weights.sum(-1, keepdim=True).clamp(min=1e-9)
    e = cfg.num_experts
    counts = F.one_hot(experts.reshape(-1), e).sum(0).float()
    frac = counts / counts.sum().clamp(min=1.0)
    aux = e * torch.sum(frac * probs.mean(0))
    return weights, experts.to(torch.int32), aux


def _ffn(p, hidden: torch.Tensor, prefix: str) -> torch.Tensor:
    """The experts' swiglu FFN on a capacity buffer ``prefix`` + "cd".
    silu is x * 1 / (1 + exp(-x)) with each step rounded to the value
    type, as the reference's ``jax.nn.silu`` is lowered by XLA (its
    logistic is exp, add and divide in the value type); ``F.silu`` and
    ``torch.sigmoid`` round once, a bfloat16 step away on a third of the
    entries."""
    h = torch.einsum(f"{prefix}cd,edf->{prefix}cf", hidden, p["w_gate"])
    gate = h * (1 / (1 + torch.exp(-h)))
    up = torch.einsum(f"{prefix}cd,edf->{prefix}cf", hidden, p["w_up"])
    return torch.einsum(f"{prefix}cf,efd->{prefix}cd", gate * up,
                        p["w_down"])


def moe(p, x: torch.Tensor, cfg: ArchConfig
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out, aux_loss).  Group-local binning dispatch.

    Each sequence is a dispatch group: ``bin_by_id`` bins its S*k
    assignments by expert, and each expert keeps the first ``_capacity``
    of them (the rest are dropped, as in the reference).  With
    ``cfg.moe_dispatch_dtype == "int8"`` the dispatched payload is
    quantized per token to int8 with one float32 scale a slot, and
    dequantized before the experts.
    """
    b, s, d = x.shape
    k, e = cfg.experts_per_token, cfg.num_experts
    cap = _capacity(cfg, s)                                 # per group
    dev = x.device
    x = hint(x, BATCH, None, None)

    weights, experts, aux = route(p, x.reshape(b * s, d), cfg)
    weights = weights.reshape(b, s, k)
    assign = experts.reshape(b, s * k)                      # (B, S*k)

    # The OpSparse two-pass binning, one instance per group.
    order, _, offsets = bin_by_id(assign, e)
    order_l = order.long()
    sorted_e = torch.gather(assign, 1, order_l).long()
    pos_in_e = (torch.arange(s * k, dtype=torch.int32, device=dev)[None]
                - torch.gather(offsets, 1, sorted_e))
    keep = pos_in_e < cap                                   # capacity drop
    slot = torch.where(keep, sorted_e * cap + pos_in_e, e * cap)  # int64
    token_of = order_l // k                                 # (B, S*k) < S

    # Dispatch: a group-local gather, then a scatter into (B, E*C, d); the
    # dropped assignments go to one dump row past the buffer.
    gathered = torch.gather(x, 1, token_of[..., None].expand(b, s * k, d))
    group = torch.arange(b, device=dev)[:, None].expand(b, s * k)
    quant = cfg.moe_dispatch_dtype == "int8"
    if quant:
        g32 = gathered.float()
        g_scale = (g32.abs().amax(-1, keepdim=True) / 127.0).clamp(
            min=1e-12)
        gathered = torch.clamp(torch.round(g32 / g_scale), -127,
                               127).to(torch.int8)
        scale_buf = torch.zeros((b, e * cap + 1, 1), dtype=torch.float32,
                                device=dev)
        scale_buf[group, slot] = g_scale
    buf = torch.zeros((b, e * cap + 1, d), dtype=gathered.dtype, device=dev)
    buf[group, slot] = gathered
    hidden = hint(buf[:, :e * cap].reshape(b, e, cap, d), BATCH, TP, None,
                  None)
    if quant:
        scales = scale_buf[:, :e * cap].reshape(b, e, cap, 1)
        hidden = (hidden.float() * scales).to(x.dtype)

    out_buf = _ffn(p, hidden, "be")
    out_flat = hint(out_buf.reshape(b, e * cap, d), BATCH, None, None)

    # Combine: each assignment's output, weighted, summed into its token.
    safe_slot = slot.clamp(max=e * cap - 1)
    contrib = torch.gather(out_flat, 1, safe_slot[..., None].expand(
        b, s * k, d))
    contrib = torch.where(keep[..., None], contrib,
                          torch.zeros((), dtype=contrib.dtype, device=dev))
    w_sorted = torch.gather(weights.reshape(b, s * k), 1,
                            order_l)[..., None].to(x.dtype)
    out = torch.zeros((b, s, d), dtype=x.dtype, device=dev)
    out.scatter_add_(1, token_of[..., None].expand(b, s * k, d),
                     contrib * w_sorted)
    return hint(out, BATCH, None, None), aux


def moe_dense_dispatch(p, x: torch.Tensor, cfg: ArchConfig
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dense one-hot dispatch (GShard-style einsums) over all B*S
    tokens as one group: the baseline the binning dispatch is timed
    against."""
    b, s, d = x.shape
    t = b * s
    k, e = cfg.experts_per_token, cfg.num_experts
    cap = _capacity(cfg, t)
    x_flat = x.reshape(t, d)
    weights, experts, aux = route(p, x_flat, cfg)

    onehot_i = F.one_hot(experts.long(), e)                 # (T, k, E)
    onehot = onehot_i.float()
    # The rank of each (token, slot) within its expert, counted over the
    # flattened (T*k) assignments so that two slots never collide (an
    # integer cumsum: exact, and allowed in torch's deterministic mode).
    flat = onehot_i.reshape(t * k, e)
    pos_f = (torch.cumsum(flat, 0) - flat).float()
    pos = torch.einsum("tke,tke->tk", pos_f.reshape(t, k, e), onehot)
    keep = pos < cap
    pos_oh = F.one_hot(torch.where(keep, pos, float(cap)).long(),
                       cap + 1)[..., :cap].float()          # (T, k, C)
    disp = torch.einsum("tke,tkc->tec", onehot, pos_oh)     # (T, E, C)
    hidden = torch.einsum("tec,td->ecd", disp, x_flat.float()).to(x.dtype)
    out_buf = _ffn(p, hidden, "e")
    # The weights ride on the one-hot, so no (T, k, E, C) product forms.
    comb = torch.einsum("tke,tkc->tec", onehot * weights.float()[..., None],
                        pos_oh)
    out = torch.einsum("tec,ecd->td", comb, out_buf.float())
    return out.to(x.dtype).reshape(b, s, d), aux


class MoE(nn.Module):
    """One MoE layer of ``cfg``'s width: the parameters of
    :func:`moe_specs` as ``nn.Parameter``s; ``forward`` is the binning
    dispatch (:func:`moe`), ``dense_dispatch`` the dense one
    (:func:`moe_dense_dispatch`).  Parameters come from ``params`` (for
    example ``convert.params_from_reference``) or are drawn from
    ``generator``."""

    def __init__(self, cfg: ArchConfig,
                 params: Optional[Dict[str, torch.Tensor]] = None, *,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        self.cfg = cfg
        if params is None:
            if generator is None:
                raise ValueError("MoE needs params or a generator")
            params = init_params(moe_specs(cfg), generator, device)
        for name in moe_specs(cfg):
            self.register_parameter(name, nn.Parameter(
                params[name].to(device)))

    def params(self) -> Dict[str, torch.Tensor]:
        return {name: getattr(self, name) for name in moe_specs(self.cfg)}

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return moe(self.params(), x, self.cfg)

    def dense_dispatch(self, x: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        return moe_dense_dispatch(self.params(), x, self.cfg)
