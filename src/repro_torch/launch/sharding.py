"""Sharding policies: logical-axis rules -> shape-checked partition specs.

The counterpart of ``repro/launch/sharding.py``, with the same rules and
checks.  Modes:
  * train: FSDP(+pod) x TP.  Params and optimizer state shard over the
    data axes (the 'embed' logical axis) and the model axis (vocab,
    heads, ffn, experts, ssm inner).
  * serve: TP only.  Params are replicated over the data axes, the batch
    shards over them.

Every assignment is checked for divisibility against the mesh (hubert's
vocab of 504 does not split 16 ways, so it stays whole) and a mesh axis
used twice in one spec is dropped the second time.  A spec is a
:class:`PartitionSpec`: one entry a dimension, an axis name, a tuple of
them or None.  On the one-card mesh every axis has size 1, so the specs
name axes and every tensor is whole all the same (:func:`to_named`).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import AttnCache
from repro_torch.models.param import ParamSpec, tree_map
from repro_torch.models.ssm import SSMCache

from .mesh import Mesh, data_axes

Tree = Any


class PartitionSpec:
    """One entry a dimension: a mesh axis name, a tuple of names, or None
    (that dimension is whole).  ``tuple(spec)`` gives the entries.  Not a
    tuple itself, so ``tree_map`` and ``tree_leaves`` take a spec as one
    leaf."""
    __slots__ = ("entries",)

    def __init__(self, *entries):
        self.entries = tuple(entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other) -> bool:
        return (isinstance(other, PartitionSpec)
                and self.entries == other.entries)

    def __hash__(self) -> int:
        return hash(self.entries)

    def __repr__(self) -> str:
        return f"P{self.entries!r}"


P = PartitionSpec


def _axis_size(mesh: Mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        return mesh.shape[axes]
    return math.prod(mesh.shape[a] for a in axes)


def _fsdp(mesh: Mesh):
    dp = data_axes(mesh)
    return dp if len(dp) > 1 else dp[0]


def train_rules(mesh: Mesh) -> Dict[str, Any]:
    return {
        "vocab": "model", "embed": _fsdp(mesh), "qkv": "model",
        "kv": "model", "mlp": "model", "inner": "model",
        "ssm_heads": "model", "experts": "model", "expert_mlp": None,
        "layers": None,
    }


def serve_rules(mesh: Mesh) -> Dict[str, Any]:
    return {
        "vocab": "model", "embed": None, "qkv": "model", "kv": "model",
        "mlp": "model", "inner": "model", "ssm_heads": "model",
        "experts": "model", "expert_mlp": None, "layers": None,
    }


def checked_pspec(shape, axes, rules, mesh: Mesh) -> PartitionSpec:
    """Apply ``rules`` with the divisibility and duplicate-axis checks."""
    used = set()
    out = []
    for dim, logical in zip(shape, axes):
        assign = rules.get(logical) if logical is not None else None
        if assign is None:
            out.append(None)
            continue
        names = (assign,) if isinstance(assign, str) else tuple(assign)
        if any(n in used for n in names) or dim % _axis_size(mesh, names):
            out.append(None)
            continue
        used.update(names)
        out.append(assign)
    return P(*out)


def param_pspecs(specs: Tree, rules, mesh: Mesh) -> Tree:
    return tree_map(lambda ps: checked_pspec(ps.shape, ps.axes, rules, mesh),
                    specs, is_leaf=lambda x: isinstance(x, ParamSpec))


class NamedSharding:
    """A spec placed on a mesh: dimension i splits into as many shards as
    the mesh axes of ``spec[i]`` have devices.  A leaf to ``tree_map``."""

    def __init__(self, mesh: Mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = spec

    def shard_shape(self, shape) -> Tuple[int, ...]:
        """The shape of one device's shard of a ``shape`` tensor."""
        spec = tuple(self.spec) + (None,) * (len(shape) - len(self.spec))
        return tuple(d // _axis_size(self.mesh, a)
                     for d, a in zip(shape, spec))


def to_named(tree: Tree, mesh: Mesh) -> Tree:
    """Each spec of ``tree`` placed on ``mesh``.  On the one-card mesh
    every axis has size 1: every shard is the whole tensor, on the one
    card."""
    return tree_map(lambda p: NamedSharding(mesh, p), tree)


def constrain(tree: Tree, specs: Tree) -> Tree:
    """``tree`` laid out as ``specs`` say (the reference's
    ``with_sharding_constraint``).  On one card every tensor is whole, so
    this is ``tree`` itself, once each spec is checked against its
    tensor's rank."""
    def check(spec, x):
        if len(spec) > x.dim():
            raise ValueError(f"spec {spec} for a tensor of shape "
                             f"{tuple(x.shape)}")
    tree_map(check, specs, tree)
    return tree


# ---------------------------------------------------------------------------
# Batch / cache shardings
# ---------------------------------------------------------------------------

def batch_pspecs(cfg: ArchConfig, batch: Dict[str, Any], mesh: Mesh,
                 global_batch: int) -> Dict[str, PartitionSpec]:
    dp = _fsdp(mesh)
    b_axis = dp if global_batch % _axis_size(mesh, dp) == 0 else None
    return {k: P(b_axis, *([None] * (len(v.shape) - 1)))
            for k, v in batch.items()}


def cache_pspecs(cfg: ArchConfig, caches: Tree, mesh: Mesh, *,
                 global_batch: int, seq_len: int) -> Tree:
    """Shape-checked cache specs.

    Per KV cache: the batch over the data axes; the KV heads over 'model'
    when they divide, else the sequence axis over 'model'.  For B = 1
    long-context decode the sequence axis also shards over 'data'
    (sequence parallelism).  SSM states shard their channel or head dim
    over 'model'.
    """
    dp = _fsdp(mesh)
    dp_size = _axis_size(mesh, dp)
    model_size = mesh.shape["model"]
    b_axis = dp if global_batch % dp_size == 0 and global_batch >= dp_size \
        else None
    kvh = cfg.num_kv_heads

    def attn_leaf(leaf_shape) -> PartitionSpec:
        lead = len(leaf_shape) - 4
        kv_ok = kvh % model_size == 0 and kvh >= model_size
        s_axis = None
        kv_axis = "model" if kv_ok else None
        if not kv_ok and leaf_shape[-3] % model_size == 0:
            s_axis = "model"
        seq_data = None
        if b_axis is None and leaf_shape[-3] % dp_size == 0 \
                and s_axis != dp and dp != "model":
            seq_data = dp   # B=1: sequence parallelism over data
        s_final = s_axis if s_axis else seq_data
        return P(*([None] * lead), b_axis, s_final, kv_axis, None)

    def ssm_leaves(c: SSMCache) -> SSMCache:
        conv_lead = len(c.conv.shape) - 3
        h_lead = len(c.h.shape) - (4 if cfg.mamba_version == 2 else 3)
        di_ok = "model" if cfg.d_inner % model_size == 0 else None
        conv_p = P(*([None] * conv_lead), b_axis, None, di_ok)
        if cfg.mamba_version == 2:
            nh = cfg.d_inner // cfg.ssm_head_dim
            nh_ok = "model" if nh % model_size == 0 else None
            h_p = P(*([None] * h_lead), b_axis, nh_ok, None, None)
        else:
            h_p = P(*([None] * h_lead), b_axis, di_ok, None)
        return SSMCache(conv=conv_p, h=h_p)

    def map_cache(c):
        if isinstance(c, AttnCache):
            return AttnCache(k=attn_leaf(c.k.shape), v=attn_leaf(c.v.shape))
        if isinstance(c, SSMCache):
            return ssm_leaves(c)
        raise TypeError(type(c))

    return tree_map(map_cache, caches,
                    is_leaf=lambda x: isinstance(x, (AttnCache, SSMCache)))
