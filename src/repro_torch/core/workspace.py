"""Shape buckets (the port's copy of ``repro.core.workspace.next_bucket``).

The arena, leases and workspace layouts of the reference wait for a later
slice; the hash schedule and the capacity buckets need only this.
"""
from __future__ import annotations


def next_bucket(n: int, *, minimum: int = 16) -> int:
    """Pow-2 shape bucket: bounds padding waste (<2x) and the number of
    distinct static shapes a plan can take.

    The ONE shared copy: storage/capacity buckets, the hash drivers'
    per-rung row-count buckets (``minimum=8``) and the engine's
    progressive allocation all bucket through here.
    """
    b = minimum
    while b < n:
        b <<= 1
    return b
