"""Row-block partitioning: one plan, N shards.

A port of ``repro/engine/partition.py``.  SpGEMM splits into independent
row-block sub-products, C[lo:hi] = A[lo:hi] · B.  A sharded plan carries a
:class:`ShardSpec`: N contiguous row blocks of A whose cumulative flop
estimates (``core/analysis.row_flops``) are even, with each block's row
count and slice storage bucketed to pow-2, so the shards' sub-problems land
on stable plan signatures and hit the plan cache (two shards with the same
buckets share ONE sub-plan and its pipeline).

The spec is learned on the cold call (the one host read of the whole flop
vector) and then pinned: steady traffic in the same shape bucket reuses
the bounds, so the shard signatures never move.  A shard whose slice
outgrows its storage bucket grows that shard's bucket alone, monotonically.

The reference places shards on the data axis of a JAX mesh.  The port has
no mesh: ``devices`` is a sequence of ``torch.device`` and shards are
placed on it round-robin, so on one card every shard lands on that card.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.workspace import next_bucket


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """Learned row-block partition of A for one plan signature.

    bounds       n_shards+1 row boundaries (bounds[0]=0, bounds[-1]=M);
                 contiguous blocks balanced by cumulative flop estimate.
    row_buckets  pow-2 padded row count per shard: the nrows of the
                 shard's A slice (padding rows are empty).
    cap_buckets  pow-2 col/val storage capacity per shard slice.
    """

    bounds: Tuple[int, ...]
    row_buckets: Tuple[int, ...]
    cap_buckets: Tuple[int, ...]

    @property
    def n_shards(self) -> int:
        return len(self.row_buckets)

    def rows(self, s: int) -> int:
        """Real (unpadded) row count of shard ``s``."""
        return self.bounds[s + 1] - self.bounds[s]

    def with_cap_bucket(self, s: int, cap: int) -> "ShardSpec":
        """Grown spec: shard ``s``'s storage bucket raised to ``cap``.
        Only that shard's signature moves; the other shards' sub-plans
        and pipelines are untouched."""
        caps = list(self.cap_buckets)
        caps[s] = max(caps[s], next_bucket(max(int(cap), 1)))
        return dataclasses.replace(self, cap_buckets=tuple(caps))

    def union(self, other: "ShardSpec") -> "ShardSpec":
        """Elementwise-max storage buckets over an identical partition
        (specs only ever grow, as in cache merges).  Specs with different
        bounds are not comparable; keep ``self``."""
        if (other.bounds != self.bounds
                or other.row_buckets != self.row_buckets):
            return self
        return dataclasses.replace(self, cap_buckets=tuple(
            max(a, b) for a, b in zip(self.cap_buckets, other.cap_buckets)))


# A shard below this many rows cannot be cut further without empty blocks;
# the adaptive policy (engine/autotune) clamps its shard count with it.
MIN_SHARD_ROWS = 2


def clamp_shards(nrows: int, n: int) -> int:
    """Feasible shard count for an ``nrows``-row A: at least 1, at most
    one shard per ``MIN_SHARD_ROWS`` rows."""
    return max(1, min(int(n), max(int(nrows) // MIN_SHARD_ROWS, 1)))


def balanced_bounds(weights: np.ndarray, n_shards: int) -> Tuple[int, ...]:
    """Contiguous row-block boundaries balancing cumulative ``weights``.

    Greedy prefix cuts at each multiple of total/n: block s ends at the
    first row whose cumulative weight reaches s·total/n, so no block
    exceeds total/n + max(row weight).  A zero total falls back to an even
    row split.  Every shard keeps at least one row while rows remain.
    """
    m = int(len(weights))
    n = max(1, min(int(n_shards), m if m else 1))
    if m == 0:
        return (0,) * (n + 1)
    cum = np.cumsum(np.asarray(weights, dtype=np.int64))
    total = int(cum[-1])
    bounds = [0]
    for s in range(1, n):
        if total > 0:
            cut = int(np.searchsorted(cum, total * s / n, side="left")) + 1
        else:
            cut = (m * s) // n
        # Monotone, and leave >= 1 row for each remaining shard.
        cut = max(bounds[-1] + 1, min(cut, m - (n - s)))
        bounds.append(cut)
    bounds.append(m)
    return tuple(bounds)


# Slice-storage buckets carry headroom over the cold call's observed nnz:
# same-signature traffic jitters within its pow-2 bucket, and a padded
# slice costs far less than the bucket grow (sub-plan re-specialization
# and a redo) an overflow costs.
_SLICE_HEADROOM = 2.0


def plan_shards(rpt: np.ndarray, flops: np.ndarray, n_shards: int, *,
                headroom: float = _SLICE_HEADROOM,
                telemetry=None) -> ShardSpec:
    """A :class:`ShardSpec` from host row pointers and the per-row flop
    estimate (``core/analysis.row_flops``).

    ``telemetry`` (anything with ``.event``) records the pinned partition
    as ``partition.planned``: the one decision of a sharded plan."""
    rpt = np.asarray(rpt, dtype=np.int64)
    bounds = balanced_bounds(flops, n_shards)
    row_buckets = tuple(
        next_bucket(max(bounds[s + 1] - bounds[s], 1), minimum=1)
        for s in range(len(bounds) - 1))
    cap_buckets = tuple(
        next_bucket(max(int((rpt[bounds[s + 1]] - rpt[bounds[s]])
                            * headroom), 1))
        for s in range(len(bounds) - 1))
    if telemetry is not None:
        telemetry.event("partition.planned", n_shards=len(row_buckets),
                        bounds=bounds, cap_buckets=cap_buckets)
    return ShardSpec(bounds=bounds, row_buckets=row_buckets,
                     cap_buckets=cap_buckets)


def data_axis_devices(devices: Sequence) -> Tuple[torch.device, ...]:
    """The devices shards may land on, as a tuple of ``torch.device`` (a
    CUDA device without an index names the current card)."""
    out = []
    for d in devices:
        dev = torch.device(d)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        out.append(dev)
    if not out:
        raise ValueError("no devices to place shards on")
    return tuple(out)


def shard_devices(devices: Sequence, n_shards: int) -> tuple:
    """Round-robin shard -> device placement (replicated B, row-sharded
    A)."""
    devs = data_axis_devices(devices)
    return tuple(devs[s % len(devs)] for s in range(n_shards))
