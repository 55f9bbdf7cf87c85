"""Parameter specs: one source of truth for shapes, dtypes and the
reference's logical axes.

A model builds a tree (nested dicts) of :class:`ParamSpec`;
:func:`init_params` materializes it with an explicit ``torch.Generator``.
The reference draws from ``jax.random`` keys, which torch cannot
reproduce: to run the two packages on the same weights, carry the
reference's arrays across with ``repro_torch.convert.params_from_reference``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    dtype: torch.dtype
    axes: Tuple[Optional[str], ...]   # logical axis name per dim (or None)
    init: str = "normal"              # "normal" | "zeros" | "ones"
    scale: float = 1.0                # stddev multiplier for "normal"

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             "differ in length")


def spec(shape, axes, dtype=torch.bfloat16, init="normal",
         scale=1.0) -> ParamSpec:
    return ParamSpec(tuple(int(s) for s in shape), dtype, tuple(axes), init,
                     scale)


def _materialize(ps: ParamSpec, generator: torch.Generator,
                 device) -> torch.Tensor:
    if ps.init == "zeros":
        return torch.zeros(ps.shape, dtype=ps.dtype, device=device)
    if ps.init == "ones":
        return torch.ones(ps.shape, dtype=ps.dtype, device=device)
    fan_in = ps.shape[0] if len(ps.shape) > 1 else max(ps.shape[0], 1)
    std = ps.scale / math.sqrt(fan_in)
    x = torch.randn(ps.shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    return (x * std).to(device=device, dtype=ps.dtype)


def _leaves(specs, prefix=()):
    if isinstance(specs, ParamSpec):
        yield prefix, specs
    else:
        for k in sorted(specs):
            yield from _leaves(specs[k], prefix + (k,))


def init_params(specs, generator: torch.Generator, device="cuda") -> Any:
    """Materialize a spec tree into tensors on ``device``: normal leaves
    are N(0, 1) * scale / sqrt(fan_in) in float32 from ``generator`` (in
    sorted key order, on the generator's device), then cast."""
    def build(node):
        if isinstance(node, ParamSpec):
            return _materialize(node, generator, device)
        return {k: build(node[k]) for k in sorted(node)}
    return build(specs)


def param_count(specs) -> int:
    return sum(math.prod(ps.shape) for _, ps in _leaves(specs))
