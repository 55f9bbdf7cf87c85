"""Parameter specs: one source of truth for shapes, dtypes and the
reference's logical axes.

A model builds a tree (nested dicts) of :class:`ParamSpec`;
:func:`init_params` materializes it with an explicit ``torch.Generator``
and :func:`abstract_params` gives its shapes and types as tensors on the
``meta`` device (no storage).  :func:`tree_map` and :func:`tree_leaves`
walk the trees the models pass around: nested dicts, tuples and lists of
tensors, and the dataclasses that hold tensors (caches, ``QTensor``).
The reference draws from ``jax.random`` keys, which torch cannot
reproduce: to run the two packages on the same weights, carry the
reference's arrays across with ``repro_torch.convert.params_from_reference``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, List, Optional, Tuple

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
    std = ps.scale / math.sqrt(fan_in(ps.shape))
    x = torch.randn(ps.shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    return (x * std).to(device=device, dtype=ps.dtype)


def fan_in(shape) -> int:
    """A weight's fan-in: its matrix's input axis, the second to last
    (the first axis of a 1-D leaf).  The reference takes the first axis,
    the same for a 2-D weight but the layer count for a stacked one and
    the expert count for an expert weight.  At olmoe-1b-7b's width that
    rule draws every stacked weight with std 1/4, so that bfloat16
    attention scores reach the hundreds and prefill(s) + decode(1) stops
    agreeing with prefill(s+1) (``benchmarks/torch/lm_init_scale.py``
    measures both rules).  Weights carried from the reference are its
    own."""
    if len(shape) > 1:
        return shape[-2]
    return max(shape[0], 1)


def _leaves(specs, prefix=()):
    if isinstance(specs, ParamSpec):
        yield prefix, specs
    else:
        for k in sorted(specs):
            yield from _leaves(specs[k], prefix + (k,))


def init_params(specs, generator: torch.Generator, device="cuda") -> Any:
    """Materialize a spec tree into tensors on ``device``: normal leaves
    are N(0, 1) * scale / sqrt(:func:`fan_in`) in float32 from
    ``generator`` (in sorted key order, on the generator's device), then
    cast."""
    def build(node):
        if isinstance(node, ParamSpec):
            return _materialize(node, generator, device)
        return {k: build(node[k]) for k in sorted(node)}
    return build(specs)


def abstract_params(specs) -> Any:
    """The spec tree as empty tensors on the ``meta`` device: shapes and
    types with no storage (the reference's ShapeDtypeStruct tree), keys in
    :func:`init_params`' order."""
    def build(node):
        if isinstance(node, ParamSpec):
            return torch.empty(node.shape, dtype=node.dtype, device="meta")
        return {k: build(node[k]) for k in sorted(node)}
    return build(specs)


def tree_map(fn: Callable, tree, *rest, is_leaf: Optional[Callable] = None):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``, trees of the same structure): dicts, tuples (NamedTuples
    too) and lists are walked, as are the fields of a dataclass instance; None stays None.
    ``is_leaf(node)`` true stops the walk at ``node``."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        items = [tree_map(fn, *xs, is_leaf=is_leaf)
                 for xs in zip(tree, *rest)]
        if hasattr(tree, "_fields"):            # a NamedTuple
            return type(tree)(*items)
        return type(tree)(items)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name),
                             *(getattr(r, f.name) for r in rest),
                             is_leaf=is_leaf)
            for f in dataclasses.fields(tree)})
    return fn(tree, *rest)


def tree_leaves(tree) -> List[Any]:
    """The leaves of ``tree`` (None is no leaf) in :func:`tree_map`'s
    order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in tree_leaves(v)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [x for f in dataclasses.fields(tree)
                for x in tree_leaves(getattr(tree, f.name))]
    return [tree]


def param_count(specs) -> int:
    return sum(math.prod(ps.shape) for _, ps in _leaves(specs))
