"""The assigned input-shape cells and their abstract inputs.

The counterpart of ``repro/launch/shapes.py``.  ``train_4k`` runs the
train step, ``prefill_32k`` the prefill step, ``decode_32k`` and
``long_500k`` the decode step (one new token against a ``seq_len``
cache).  Encoder archs have no decode step; archs with full attention
skip ``long_500k``.  The abstract inputs are tensors on the ``meta``
device: the reference's shapes and types, no storage.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.model import Model


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str            # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524288, 1),
}


def cells_for(cfg: ArchConfig) -> List[str]:
    cells = ["train_4k", "prefill_32k"]
    if cfg.is_encoder:
        return cells                   # encoder-only: no decode step
    cells.append("decode_32k")
    if cfg.sub_quadratic:
        cells.append("long_500k")      # quadratic-attention archs skip
    return cells


def _dt(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def abstract_batch(cfg: ArchConfig, cell: ShapeCell,
                   batch: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Train/prefill batch as ``meta`` tensors, ``batch`` sequences (the
    cell's global batch by default)."""
    b, s = batch or cell.global_batch, cell.seq_len
    if cfg.is_encoder:
        out = {"features": _meta((b, s, cfg.d_model), _dt(cfg))}
        if cell.kind == "train":
            out["labels"] = _meta((b, s), torch.int32)
        return out
    s_tok = s + 1 if cell.kind == "train" else s
    out = {"tokens": _meta((b, s_tok), torch.int32)}
    if cfg.family == "vlm":
        out["vision"] = _meta((b, cfg.vision_tokens, cfg.d_model), _dt(cfg))
    return out


def abstract_decode_inputs(cfg: ArchConfig, cell: ShapeCell,
                           batch: Optional[int] = None):
    """(token, caches, pos) as ``meta`` tensors for a decode cell: one new
    token a sequence with a ``seq_len`` cache."""
    b, s = batch or cell.global_batch, cell.seq_len
    caches = Model(cfg).init_caches(b, s, abstract=True)
    return _meta((b, 1), torch.int32), caches, _meta((), torch.int32)


def tokens_per_step(cfg: ArchConfig, cell: ShapeCell,
                    batch: Optional[int] = None) -> int:
    b = batch or cell.global_batch
    if cell.kind == "decode":
        return b
    return b * cell.seq_len
