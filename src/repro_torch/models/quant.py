"""Int8 weight-only quantization for serving (post-training).

The counterpart of ``repro/models/quant.py``.  Weight matrices in
bfloat16 are stored as int8 with a float32 scale per trailing matrix
slice, which more than halves the resident bytes and the bytes a decode
step reads.  ``Model`` dequantizes one layer at a time inside its layer
loop (:func:`dequant_tree` on the layer's slice), so only one layer's
bfloat16 weights are live at a time.

The payload is the reference's bit for bit: the same float32 division
and clipping, and ``torch.round`` rounds half to even as ``jnp.round``
does.  A stacked layer parameter's scales keep its leading layer (and
expert) axes, so the model's layer loop slices them with the payload.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from .param import tree_map

Tree = Any


@dataclasses.dataclass
class QTensor:
    q: torch.Tensor          # int8 payload
    scale: torch.Tensor      # float32, broadcastable to q.shape

    @property
    def shape(self):
        return self.q.shape

    def dequant(self, dtype=torch.bfloat16) -> torch.Tensor:
        return (self.q.float() * self.scale).to(dtype)


def _scale_shape(shape):
    """One scale per trailing MATRIX slice: (L, E, d, f) -> (L, E, 1, 1).
    Keeps stacked-layer and expert weights on independent grids; a 2-D
    weight has one scalar scale."""
    if len(shape) > 2:
        return tuple(shape[:-2]) + (1, 1)
    return ()


MIN_DIM = 128   # quantize only true weight matrices (both trailing dims
                # >= MIN_DIM): stacked biases and conv taps stay as they are


def _quantizable(x, min_dim: int = MIN_DIM) -> bool:
    return (isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16
            and x.dim() >= 2 and x.shape[-1] >= min_dim
            and x.shape[-2] >= min_dim)


def _quantize(x: torch.Tensor) -> QTensor:
    xf = x.float()
    stacked = x.dim() > 2
    if stacked:
        amax = xf.abs().amax(dim=(-2, -1), keepdim=True)
    else:
        amax = xf.abs().amax()
    scale = torch.clamp(amax / 127.0, min=1e-12)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return QTensor(q=q, scale=scale.float())


def quantize_params(params: Tree, min_dim: int = MIN_DIM) -> Tree:
    """Quantize the weight-matrix bfloat16 leaves to int8 (symmetric, one
    scale per trailing matrix slice); every other leaf is kept as is."""
    return tree_map(lambda x: _quantize(x) if _quantizable(x, min_dim)
                    else x, params)


def abstract_quantized(abstract_params: Tree,
                       min_dim: int = MIN_DIM) -> Tree:
    """The quantized tree's shapes and types as ``meta`` tensors, from the
    tree of :func:`repro_torch.models.param.abstract_params`."""
    def one(x):
        if not _quantizable(x, min_dim):
            return x
        return QTensor(
            q=torch.empty(x.shape, dtype=torch.int8, device="meta"),
            scale=torch.empty(_scale_shape(x.shape), dtype=torch.float32,
                              device="meta"))
    return tree_map(one, abstract_params)


def quant_pspecs(pspecs: Tree, abstract_params: Tree) -> Tree:
    """Partition specs for the quantized tree, from the specs of the
    bfloat16 tree and its ``meta`` tensors: the payload keeps the
    original spec, the scales are replicated (tiny)."""
    from repro_torch.launch.sharding import PartitionSpec as P

    def one(spec, x):
        if not _quantizable(x):
            return spec
        n_scale = len(_scale_shape(x.shape))
        return QTensor(q=spec, scale=P(*([None] * n_scale)))

    return tree_map(one, pspecs, abstract_params)


def dequant_tree(p: Tree, dtype=torch.bfloat16) -> Tree:
    """Materialize the weights of one layer slice in ``dtype`` (no-op
    without QTensors)."""
    return tree_map(lambda x: x.dequant(dtype) if isinstance(x, QTensor)
                    else x, p, is_leaf=lambda x: isinstance(x, QTensor))
