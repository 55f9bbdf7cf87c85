"""Activation sharding hints, on one card.

The reference pins each activation's batch dim to the data axes and its
heads, ffn or experts to the model axis of a TPU mesh
(``jax.lax.with_sharding_constraint``).  The port runs on one H100, with
no mesh to shard over, so :func:`hint` is the identity: it keeps the
reference's call sites (and their axis names) readable in the port and
changes nothing.
"""
from __future__ import annotations

BATCH = ("pod", "data")   # logical batch axes
TP = "model"              # tensor-parallel axis
SEQ = "data"              # sequence-parallel axis (long-context decode)


def hint(x, *axes):
    """``x`` itself: on one card there is no mesh to place it on.  One
    axis name (or None) a dimension, as in the reference."""
    if len(axes) != x.dim():
        raise ValueError(f"{len(axes)} axes for a tensor of shape "
                         f"{tuple(x.shape)}")
    return x
