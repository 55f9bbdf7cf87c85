"""Gradient compression with error feedback.

The counterpart of ``repro/train/compression.py``: int8 symmetric
quantization of gradients before the data-parallel reduction, one
float32 scale per tensor, and an error-feedback accumulator that adds
each step's quantization residual into the next (the 1-bit Adam / EF-SGD
construction).  :func:`compressed_psum` is the reduction over a
``torch.distributed`` group: the scale is maxed across ranks first, so
every rank quantizes onto the same grid, and the int8 payload is summed
as int32 (exact up to 2^23 ranks), then divided by the group's size.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.models.param import tree_leaves, tree_map

Tree = Any


def _scale(target: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.max(torch.abs(target)) / 127.0, min=1e-12)


def quantize(g: torch.Tensor, err: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (q int8, scale float32 scalar, new_err).  Error feedback:
    quantize (g + err); the residual becomes the next step's err."""
    target = g.to(torch.float32) + err
    scale = _scale(target)
    q = torch.clamp(torch.round(target / scale), -127, 127).to(torch.int8)
    new_err = target - q.to(torch.float32) * scale
    return q, scale, new_err


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def init_error_state(grads: Tree) -> Tree:
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)


def _unzip(grads: Tree, outs) -> Tuple[Tree, ...]:
    """Trees like ``grads``, one for each position of the per-leaf
    tuples ``outs``."""
    def like(leaves):
        it = iter(leaves)
        return tree_map(lambda _: next(it), grads)
    return tuple(like([o[j] for o in outs]) for j in range(len(outs[0])))


def compress_tree(grads: Tree, err_state: Tree):
    """Quantize a whole gradient tree; returns (q_tree, scale_tree,
    new_err)."""
    outs = [quantize(g, e) for g, e in zip(tree_leaves(grads),
                                           tree_leaves(err_state))]
    return _unzip(grads, outs)


def decompress_tree(q_tree: Tree, scale_tree: Tree) -> Tree:
    return tree_map(dequantize, q_tree, scale_tree)


def compressed_psum(grads: Tree, err_state: Tree,
                    group: Optional[dist.ProcessGroup] = None):
    """The int8-payload mean of ``grads`` over ``group`` (the default
    group when None) -> (mean grads in each gradient's type, new_err)."""
    n = dist.get_world_size(group)

    def one(g, e):
        target = g.to(torch.float32) + e
        scale = _scale(target)
        dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
        q = torch.clamp(torch.round(target / scale), -127, 127)
        new_err = target - q * scale
        total = q.to(torch.int32)
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
        mean = total.to(torch.float32) * scale / torch.tensor(
            n, dtype=torch.float32, device=total.device)
        return mean.to(g.dtype), new_err

    outs = [one(g, e) for g, e in zip(tree_leaves(grads),
                                      tree_leaves(err_state))]
    return _unzip(grads, outs)
