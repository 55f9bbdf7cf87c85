"""The OpSparse two-phase SpGEMM API (paper Fig. 2).

Six steps, as in the reference package:

  step1 SETUP      n_prod per row, written into the C.rpt storage (§5.3).
  step2 SYM-BIN    binning on n_prod (sym ladder, default 1.2x ranges).
  step3 SYMBOLIC   n_nz per row via per-bin hash kernels or the ESC
                   accumulator; the result overwrites the same rpt buffer.
  step4 ALLOC      total n_nz -> host; rpt = exclusive sum; C.col / C.val
                   capacity chosen (pow-2 bucket).
  step5 NUM-BIN    binning on n_nz (num ladder, default 2x ranges).
  step6 NUMERIC    fill C.col/C.val, rows sorted by column.

The flow lives in ``repro_torch.engine.executor``; ``spgemm()`` is a thin
plan-then-execute wrapper over the process-wide engine.  Repeat calls whose
operands land in the same shape bucket reuse a cached plan and skip the
cold steps.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from .binning import Binning
from .binning_ranges import BinLadder, numeric_ladder, symbolic_ladder
from .csr import CSR


@dataclasses.dataclass(frozen=True)
class SpgemmConfig:
    """The reference's config, field for field and with its defaults.

    ``interpret`` has no effect here: a kernel wrapper runs its plain
    version on CPU tensors and its CUDA kernel on CUDA tensors.
    ``shards`` other than 1 and ``plan_mode="estimate"`` wait for later
    slices of the port and are refused by the planner.
    """

    method: str = "esc"              # "esc" | "hash"
    sym_multiplier: float = 1.2      # paper's sym_1.2x
    num_multiplier: float = 2.0      # paper's num_2x
    vmem_extended: bool = False      # reference's TPU ladder extension
    hash_single_access: bool = True  # §5.2 single-access vs multi-access
    fuse_esc: bool = False           # single-expansion ESC
    fuse_numeric: bool = True        # hash: one-build symbolic->numeric
    row_packing: bool = False        # hash: several small rows per block
    interpret: Optional[bool] = None
    timing: bool = False             # per-step wall-clock (benchmarks)
    shards: int = 1
    plan_mode: str = "exact"         # "exact" | "estimate"

    def ladders(self) -> tuple[BinLadder, BinLadder]:
        return (symbolic_ladder(self.sym_multiplier,
                                vmem_extended=self.vmem_extended),
                numeric_ladder(self.num_multiplier,
                               vmem_extended=self.vmem_extended))


@dataclasses.dataclass
class SpgemmResult:
    C: CSR
    total_nprod: int
    total_nnz: int
    sym_binning: Optional[Binning]
    num_binning: Optional[Binning]
    timings: Dict[str, float]

    @property
    def compression_ratio(self) -> float:
        return self.total_nprod / max(self.total_nnz, 1)


def spgemm(A: CSR, B: CSR, config: SpgemmConfig = SpgemmConfig()
           ) -> SpgemmResult:
    """C = A · B in CSR, two-phase, binned, statically bucketed.

    Runs where the operands live, through the shared
    :class:`repro_torch.engine.SpgemmEngine`: the call is planned against
    the operands' shape-bucket signatures, and repeat signatures go
    straight to the plan's steady-state pipeline.
    """
    if A.ncols != B.nrows:
        raise ValueError(f"inner dimensions differ: {A.shape} @ {B.shape}")
    # Imported here: core is the engine's substrate, so the import points
    # engine -> core at module-load time and core -> engine only here.
    from repro_torch.engine.executor import default_engine
    return default_engine().execute(A, B, config)


def spgemm_reference(A: CSR, B: CSR) -> torch.Tensor:
    """Dense oracle (tests): to_dense(A) @ to_dense(B)."""
    return A.to_dense() @ B.to_dense()
