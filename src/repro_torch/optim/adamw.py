"""AdamW with float32 master weights + global-norm clipping.

The counterpart of ``repro/optim/adamw.py``, with its formulas and its
rounding: the math runs in float32 (the clipped gradient is rounded to
the gradient's type first, as the reference's clip casts back), and the
new master weight is cast to the parameter's type.  Where the reference
returns new trees, :func:`adamw_update` writes ``m``, ``v``, ``master``
and the parameters in place, leaf by leaf, through two float32 scratch
tensors of the leaf's size: at olmoe-1b-7b's width a whole-tree update
would hold five float32 copies of the largest leaf (4.29 GB each) at
once.  The scalars (learning rate, bias corrections, clip scale) stay
0-d tensors on the parameters' device, so an update reads nothing back
to the host.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.models.param import tree_leaves, tree_map

Tree = Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


class OptState(NamedTuple):
    m: Tree               # float32, the parameters' tree
    v: Tree               # float32
    master: Tree          # float32 master copy of the (bfloat16) params
    step: torch.Tensor    # () int32


def init_opt_state(params: Tree) -> OptState:
    """Zero moments and a float32 copy of every parameter (a copy even
    where the parameter is float32), on the parameters' device."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    return OptState(
        m=tree_map(zeros, params),
        v=tree_map(zeros, params),
        master=tree_map(
            lambda p: p.detach().to(torch.float32, copy=True), params),
        step=torch.zeros((), dtype=torch.int32,
                         device=tree_leaves(params)[0].device),
    )


def abstract_opt_state(abstract_p: Tree) -> OptState:
    """The state's shapes and types as ``meta`` tensors."""
    f32 = lambda p: torch.empty(p.shape, dtype=torch.float32,  # noqa: E731
                                device="meta")
    return OptState(m=tree_map(f32, abstract_p), v=tree_map(f32, abstract_p),
                    master=tree_map(f32, abstract_p),
                    step=torch.empty((), dtype=torch.int32, device="meta"))


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup -> cosine decay to min_lr_ratio, in float32."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0,
                       1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of
    squares."""
    leaves = tree_leaves(tree)
    total = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for leaf in leaves:
        total = total + torch.sum(torch.square(leaf.to(torch.float32)))
    return torch.sqrt(total)


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads: Tree, max_norm: float
                        ) -> Tuple[Tree, torch.Tensor]:
    """(grads scaled to a global norm of at most ``max_norm``, each in its
    own type; the norm before clipping).  New tensors: the update itself
    clips leaf by leaf instead."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype),
                    grads), norm


@torch.no_grad()
def adamw_update(params: Tree, grads: Tree, state: OptState,
                 cfg: AdamWConfig) -> Tuple[Tree, OptState,
                                            Dict[str, torch.Tensor]]:
    """One AdamW step.  ``params``, ``state.m``, ``state.v`` and
    ``state.master`` are updated in place and returned; ``grads`` is
    left as it is.  Per leaf, with g the clipped gradient in float32:
    m = b1 m + (1 - b1) g; v = b2 v + (1 - b2) g g; w = w - lr (m / bc1
    / (sqrt(v / bc2) + eps) + wd w); p = w in p's type."""
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.grad_clip)
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                     device=stepf.device), stepf)
    bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                     device=stepf.device), stepf)

    flat_p = tree_leaves(params)
    flat_g = tree_leaves(grads)
    if len(flat_g) != len(flat_p):
        raise ValueError(f"{len(flat_g)} gradients for {len(flat_p)} "
                         "parameters")
    for p, g, m, v, w in zip(flat_p, flat_g, tree_leaves(state.m),
                             tree_leaves(state.v),
                             tree_leaves(state.master)):
        a = g.to(torch.float32, copy=True)
        a.mul_(scale)
        if g.dtype != torch.float32:        # the clip's cast back
            a.copy_(a.to(g.dtype))
        m.mul_(b1)
        t = torch.mul(a, 1 - b1)
        m.add_(t)
        v.mul_(b2)
        torch.mul(a, 1 - b2, out=t)
        t.mul_(a)
        v.add_(t)
        torch.div(m, bc1, out=a)            # mh
        torch.div(v, bc2, out=t)            # vh
        t.sqrt_().add_(cfg.eps)
        a.div_(t)
        torch.mul(w, cfg.weight_decay, out=t)
        a.add_(t).mul_(lr)
        w.sub_(a)
        p.copy_(w)
        del a, t
    new_state = OptState(state.m, state.v, state.master, step)
    return params, new_state, {"grad_norm": gnorm, "lr": lr}
