"""Roofline terms of a step, from the operations and bytes it issues.

The counterpart of ``repro/launch/roofline.py``, for one NVIDIA H100:

    compute    = FLOPs      / (chips * 989e12  bf16 FLOP/s)
    memory     = bytes      / (chips * 3.35e12 B/s HBM)
    collective = coll_bytes / (chips * 450e9   B/s NVLink, one direction)

The reference reads FLOPs and bytes from XLA's ``cost_analysis()`` and
parses collective bytes out of the compiled HLO text.  The port runs the
step under two dispatch modes instead (:func:`count_step`): PyTorch's
``FlopCounterMode`` for the FLOPs of the matrix products, and
:class:`ByteCounterMode`, which adds up every op's input and output bytes
(XLA's "bytes accessed" convention).  Each op is counted alone, as if
nothing were fused or cached, so the bytes are an upper bound of what the
card must move.  On one card there are no collectives: their bytes are 0.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Tuple

import torch
from torch.utils._pytree import tree_flatten
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.models.param import ParamSpec, tree_map

COLLECTIVE_OPS = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)


@dataclasses.dataclass(frozen=True)
class Hardware:
    """One chip's peaks: dense FLOP/s, HBM bytes/s, link bytes/s (one
    direction) and memory bytes."""
    name: str
    peak_flops: float          # bf16, tensor cores
    hbm_bw: float
    link_bw: float
    memory_bytes: float
    peak_fp32: float = 0.0     # float32 outside the tensor cores


# NVIDIA H100 SXM5 data sheet, dense (no sparsity), at its 700 W limit:
# 989 TFLOP/s bf16, 67 TFLOP/s float32, 80 GB of HBM3 at 3.35 TB/s,
# NVLink 900 GB/s both directions together.
H100 = Hardware(name="H100 SXM (data sheet, 700 W)", peak_flops=989e12,
                hbm_bw=3.35e12, link_bw=450e9, memory_bytes=80e9,
                peak_fp32=67e12)


# ---------------------------------------------------------------------------
# Counting a step
# ---------------------------------------------------------------------------

aten = torch.ops.aten
# Ops that move no data: allocation, aliasing and metadata.
_FREE = {aten.empty.memory_format, aten.empty_strided.default,
         aten.empty_like.default, aten.new_empty.default,
         aten.new_empty_strided.default, aten._unsafe_view.default,
         aten.lift_fresh.default, aten.set_.source_Storage_storage_offset,
         aten.resize_.default}
# In-place writes that overwrite the target without reading it.
_OVERWRITE = {aten.copy_.default, aten.fill_.Scalar, aten.fill_.Tensor,
              aten.zero_.default, aten.normal_.default,
              aten.uniform_.default}
# In-place updates of a slice (XLA's dynamic-update-slice): the update is
# read and written, the rest of the target is not touched.
_UPDATE = {aten.index_put_.default, aten._index_put_impl_.default}


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def op_bytes(func, args, kwargs, out) -> int:
    """The bytes one op reads and writes, counted alone."""
    if func in _FREE or func.is_view:
        return 0
    ins = _tensors((args, kwargs))
    if func in _UPDATE:
        values = args[2]
        return 2 * _nbytes(values) + sum(
            _nbytes(t) for t in _tensors(args[1]))
    if func in _OVERWRITE:
        ins = ins[1:]
    return sum(_nbytes(t) for t in ins) + sum(
        _nbytes(t) for t in _tensors(out))


class ByteCounterMode(TorchDispatchMode):
    """Adds up :func:`op_bytes` of every op dispatched inside it, in
    ``total`` and by op name in ``by_op``."""

    def __init__(self):
        super().__init__()
        self.total = 0
        self.by_op: Dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        n = op_bytes(func, args, kwargs, out)
        if n:
            self.total += n
            name = func.overloadpacket.__name__
            self.by_op[name] = self.by_op.get(name, 0) + n
        return out


def count_step(fn: Callable, *args, **kwargs) -> Tuple[Any, int, int]:
    """(fn's result, its FLOPs, its bytes): ``fn(*args, **kwargs)`` run
    under ``FlopCounterMode`` and :class:`ByteCounterMode`.  On ``meta``
    tensors nothing is computed; the counts are the same as on the
    card's tensors of the same shapes."""
    with FlopCounterMode(display=False) as flops, ByteCounterMode() as nb:
        out = fn(*args, **kwargs)
    return out, int(flops.get_total_flops()), int(nb.total)


# ---------------------------------------------------------------------------
# Terms
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RooflineTerms:
    """Per-chip quantities: FLOPs, bytes and collective bytes of one
    chip's share of the step; ``model_flops`` is global."""

    flops: float               # per-chip FLOPs
    hbm_bytes: float           # per-chip bytes accessed
    coll_bytes: float          # per-chip collective operand bytes
    chips: int
    coll_by_type: Dict[str, int]
    model_flops: float = 0.0   # GLOBAL 6·N·D (train) / 2·N·D (serve)
    hw: Hardware = H100

    @property
    def t_compute(self) -> float:
        return self.flops / self.hw.peak_flops

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / self.hw.hbm_bw

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / self.hw.link_bw

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def step_time(self) -> float:
        """Roofline-optimistic step time: the largest of the three terms
        (perfect overlap)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / all issued FLOPs: remat and padding waste."""
        total = self.flops * self.chips
        return self.model_flops / total if total else 0.0

    def mfu(self, seconds: float) -> float:
        """MODEL_FLOPS / (chips · peak · ``seconds``)."""
        if not seconds:
            return 0.0
        return self.model_flops / (self.chips * self.hw.peak_flops * seconds)

    @property
    def mfu_roofline(self) -> float:
        """The utilization on useful math that the roofline step time
        implies."""
        return self.mfu(self.step_time)

    def to_json(self) -> Dict:
        return {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "coll_bytes": self.coll_bytes, "chips": self.chips,
            "coll_by_type": self.coll_by_type,
            "model_flops": self.model_flops,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "step_time_s": self.step_time,
            "useful_flops_ratio": self.useful_flops_ratio,
            "mfu_roofline": self.mfu_roofline,
            "hardware": self.hw.name,
        }


def terms_from_counts(flops: float, hbm_bytes: float, *, chips: int = 1,
                      model_flops: float = 0.0,
                      hw: Hardware = H100) -> RooflineTerms:
    """The terms of a step counted by :func:`count_step` on one card (no
    collective)."""
    return RooflineTerms(
        flops=float(flops), hbm_bytes=float(hbm_bytes), coll_bytes=0.0,
        chips=chips, coll_by_type={k: 0 for k in COLLECTIVE_OPS},
        model_flops=model_flops, hw=hw)


# -- model FLOPs (6·N·D convention, non-embedding, MoE-active) -------------

def _count(specs, pred) -> int:
    sizes = []
    tree_map(lambda ps: sizes.append(math.prod(ps.shape) if pred(ps) else 0),
             specs, is_leaf=lambda x: isinstance(x, ParamSpec))
    return sum(sizes)


def model_flops_params(cfg, specs) -> Dict[str, float]:
    """N_total, N_nonemb (no vocab-axis params), N_active (MoE top-k)."""
    total = _count(specs, lambda ps: True)
    emb = _count(specs, lambda ps: "vocab" in ps.axes)
    expert = _count(specs, lambda ps: "experts" in ps.axes)
    nonemb = total - emb
    active = nonemb
    if cfg.num_experts:
        active = nonemb - expert * (1 - cfg.experts_per_token
                                    / cfg.num_experts)
    return {"total": float(total), "nonemb": float(nonemb),
            "active": float(active)}


def model_flops_for_cell(cfg, specs, kind: str, tokens: int) -> float:
    n = model_flops_params(cfg, specs)["active"]
    mult = 6.0 if kind == "train" else 2.0
    return mult * n * tokens
