"""Execution plans: everything derivable about a SpGEMM call BEFORE data.

An :class:`SpgemmPlan` captures the static configuration of a call (the
ladder pair, the accumulator method, the pow-2 capacity buckets, and for
the hash method the per-rung launch schedule) keyed by *signatures* of
the operands, so every request landing in the same shape bucket shares
one plan and its steady-state pipeline.

Plans are progressive (Liu & Vinter-style ahead-of-time allocation): a
fresh plan has no product/nnz buckets (they depend on data); the first
execution *learns* them and :meth:`SpgemmPlan.with_capacities` produces
the specialized plan that steady-state traffic runs against.  The
adaptive-policy state rides on the plan as ``policy``,
:meth:`SpgemmPlan.workspace_spec` is the size class of the arena lease its
steady state takes, and a sharded plan (``config.shards > 1``) carries the
learned row-block partition as ``shard_spec``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.core.binning_ranges import BinLadder
from repro_torch.core.csr import CSR
from repro_torch.core.spgemm import SpgemmConfig
from repro_torch.core.workspace import LeaseSpec, WorkspacePlan, next_bucket

from .autotune import PolicyState
from .partition import ShardSpec


@dataclasses.dataclass(frozen=True)
class MatrixSig:
    """Shape/nnz-bucket signature of one CSR operand: two matrices with
    the same signature present the same shapes after padding ``col``/
    ``val`` to ``cap_bucket``."""

    nrows: int
    ncols: int
    cap_bucket: int     # pow-2 bucket of the col/val storage capacity
    dtype: str          # value dtype name, as numpy spells it ("float32")

    @classmethod
    def of(cls, M: CSR) -> "MatrixSig":
        return cls(nrows=M.nrows, ncols=M.ncols,
                   cap_bucket=next_bucket(M.capacity),
                   dtype=str(M.val.dtype).removeprefix("torch."))


PlanKey = Tuple[MatrixSig, MatrixSig, SpgemmConfig]


@dataclasses.dataclass(frozen=True)
class HashSchedule:
    """Learned launch schedule for the hash method (§5.1, §5.5).

    The paper's per-call host decision (which bin kernels to launch, with
    how many rows each) becomes part of the specialized plan: a pow-2
    row-count bucket per rung of each ladder (last entry = the ESC
    fallback rung; 0 = rung absent) plus one pow-2 capacity for the
    fallback rung's sub-product expansions, shared by both phases.  With
    these fixed, the steady state never reads the device before finalize;
    finalize verifies the actual bin sizes fit and grows the schedule
    (monotonically, via :meth:`union`) on overflow.
    """

    sym_row_buckets: Tuple[int, ...]
    num_row_buckets: Tuple[int, ...]
    fall_prod_bucket: int

    def union(self, other: "HashSchedule") -> "HashSchedule":
        """Elementwise max: schedules only ever grow."""
        return HashSchedule(
            sym_row_buckets=tuple(
                max(a, b) for a, b in zip(self.sym_row_buckets,
                                          other.sym_row_buckets)),
            num_row_buckets=tuple(
                max(a, b) for a, b in zip(self.num_row_buckets,
                                          other.num_row_buckets)),
            fall_prod_bucket=max(self.fall_prod_bucket,
                                 other.fall_prod_bucket),
        )

    def admits(self, sym_bin_sizes, num_bin_sizes, sym_fall_prod: int,
               num_fall_prod: int) -> bool:
        """Whether a run's observed bin metadata fit the schedule it was
        dispatched with (rows beyond a bucket, or fallback products beyond
        their capacity, were truncated)."""
        return (
            self.admits_fused(sym_bin_sizes, sym_fall_prod)
            and all(int(s) <= b for s, b in zip(num_bin_sizes,
                                                self.num_row_buckets))
            and int(num_fall_prod) <= self.fall_prod_bucket)

    def admits_fused(self, sym_bin_sizes, sym_fall_prod: int) -> bool:
        """Fused-pipeline admission: the one table build is scheduled off
        the SYMBOLIC ladder alone, so only it is verified."""
        return (
            all(int(s) <= b for s, b in zip(sym_bin_sizes,
                                            self.sym_row_buckets))
            and int(sym_fall_prod) <= self.fall_prod_bucket)


@dataclasses.dataclass(frozen=True)
class SpgemmPlan:
    """Immutable pre-data execution plan for one (A_sig, B_sig, config).

    Derivable before data: the signatures, the config and both ladders.
    Learned on the first execution: ``prod_bucket`` / ``nnz_bucket``
    (pow-2 capacities of the product expansion and of C) and, for the
    hash method, ``hash_schedule``; for a sharded plan, ``shard_spec``
    (the row-block partition, balanced by cumulative flop estimate on the
    cold call).  ``policy`` is the adaptive-policy state
    (``engine/autotune``: the hash headroom, the AUTO_SHARDS decision):
    updated without dropping the pipeline and persisted by
    ``PlanCache.dump/load``.  ``sym_workspace`` and
    ``num_workspace`` are the fused metadata layouts of the two binnings
    (§5.3), derived from (M, NUM_BIN) alone.
    """

    a_sig: MatrixSig
    b_sig: MatrixSig
    config: SpgemmConfig
    sym_ladder: BinLadder
    num_ladder: BinLadder
    sym_workspace: WorkspacePlan
    num_workspace: WorkspacePlan
    prod_bucket: Optional[int] = None
    nnz_bucket: Optional[int] = None
    hash_schedule: Optional[HashSchedule] = None
    shard_spec: Optional[ShardSpec] = None
    policy: Optional[PolicyState] = None

    @property
    def signature(self) -> PlanKey:
        return (self.a_sig, self.b_sig, self.config)

    @property
    def is_specialized(self) -> bool:
        """True once everything the steady state needs is learned: the
        capacity buckets, plus the launch schedule for hash plans.  A
        sharded parent plan needs only its partition: the capacities live
        on the shards' sub-plans."""
        if self.config.shards > 1:
            return self.shard_spec is not None
        caps = self.prod_bucket is not None and self.nnz_bucket is not None
        if self.config.method == "hash":
            return caps and self.hash_schedule is not None
        return caps

    def with_capacities(self, prod_bucket: int,
                        nnz_bucket: int) -> "SpgemmPlan":
        return dataclasses.replace(self, prod_bucket=int(prod_bucket),
                                   nnz_bucket=int(nnz_bucket))

    def with_hash_schedule(self, schedule: HashSchedule) -> "SpgemmPlan":
        return dataclasses.replace(self, hash_schedule=schedule)

    def with_shard_spec(self, spec: ShardSpec) -> "SpgemmPlan":
        """Plan with a learned (or per-shard grown) row-block partition."""
        return dataclasses.replace(self, shard_spec=spec)

    def with_policy(self, state: PolicyState) -> "SpgemmPlan":
        """Plan carrying updated adaptive-policy state (same signature and
        shapes: the cached pipeline stays valid)."""
        return dataclasses.replace(self, policy=state)

    def admits(self, A: CSR, B: CSR) -> bool:
        """Whether (A, B) land in this plan's shape buckets."""
        return MatrixSig.of(A) == self.a_sig and MatrixSig.of(B) == self.b_sig

    def workspace_spec(self) -> Optional[LeaseSpec]:
        """Size class of the arena lease this plan's steady state takes, or
        ``None`` when the plan has nothing leasable: not yet specialized,
        a sharded parent (leases live on the shards' sub-plans), or a hash
        plan whose fallback rung is statically absent
        (``fall_prod_bucket == 0``: nothing to expand).

        ESC leases the product expansion (row ids + col ids as one int32
        buffer, values apart); hash plans lease the fallback rung's
        sub-expansion with the same 2:1 int32:value cell split.  Both
        phases of a two-pass hash plan share ONE lease: the shared
        ``fall_prod_bucket`` makes that sound."""
        if not self.is_specialized or self.config.shards > 1:
            return None
        dtype = self.a_sig.dtype
        if self.config.method == "hash":
            fall = self.hash_schedule.fall_prod_bucket
            if not fall:
                return None
            return LeaseSpec(i32_cells=2 * fall, val_cells=fall,
                             val_dtype=dtype)
        return LeaseSpec(i32_cells=2 * self.prod_bucket,
                         val_cells=self.prod_bucket, val_dtype=dtype)


def plan(a_sig: MatrixSig, b_sig: MatrixSig,
         config: SpgemmConfig = SpgemmConfig()) -> SpgemmPlan:
    """The pre-data plan for a signature pair; buckets stay unlearned."""
    if a_sig.ncols != b_sig.nrows:
        # The reference asserts; raised explicitly so it holds under -O.
        raise AssertionError((a_sig, b_sig))
    if config.method not in ("esc", "hash"):
        raise ValueError(f"unknown method {config.method!r}")
    if config.plan_mode not in ("exact", "estimate"):
        raise ValueError(
            f"unknown plan_mode {config.plan_mode!r} "
            "(expected 'exact' or 'estimate')")
    sym_ladder, num_ladder = config.ladders()
    return SpgemmPlan(
        a_sig=a_sig, b_sig=b_sig, config=config,
        sym_ladder=sym_ladder, num_ladder=num_ladder,
        sym_workspace=WorkspacePlan(a_sig.nrows, sym_ladder.num_bins),
        num_workspace=WorkspacePlan(a_sig.nrows, num_ladder.num_bins))


def plan_key(A: CSR, B: CSR, config: SpgemmConfig) -> PlanKey:
    """Cache key for a concrete request: signatures, not arrays."""
    return (MatrixSig.of(A), MatrixSig.of(B), config)
