"""OpSparse core in PyTorch: two-phase, binned, row-wise SpGEMM.

Public API:
  CSR, random_csr            — sparse container + synthetic generator
  spgemm, SpgemmConfig       — the paper's two-phase pipeline (Fig. 2)
  bin_rows_for_ladder        — two-pass binning (§5.1)
  symbolic_ladder/numeric_ladder — bin ladders + range selection (§5.7)
"""
from .csr import CSR, gather_rows, random_csr, resolve_device
from .binning import (Binning, bin_by_id, bin_rows, bin_rows_for_ladder,
                      bin_rows_identity, classify)
from .binning_ranges import (BinLadder, make_ladder, numeric_ladder,
                             symbolic_ladder, SYMBOLIC_SWEEP, NUMERIC_SWEEP)
from .analysis import (compression_ratio, exclusive_sum_in_place,
                       nprod_into_rpt, nprod_per_entry, row_flops,
                       total_nprod)
from .spgemm import (AUTO_SHARDS, SpgemmConfig, SpgemmResult, spgemm,
                     spgemm_reference)
from .workspace import next_bucket
from .faults import FaultPlan, FaultSpec, InjectedFault
from . import esc

__all__ = [
    "CSR", "gather_rows", "random_csr", "resolve_device", "Binning",
    "bin_by_id", "bin_rows", "bin_rows_for_ladder", "bin_rows_identity", "classify",
    "BinLadder", "make_ladder", "numeric_ladder", "symbolic_ladder",
    "SYMBOLIC_SWEEP", "NUMERIC_SWEEP", "compression_ratio",
    "exclusive_sum_in_place", "nprod_into_rpt", "nprod_per_entry",
    "row_flops", "total_nprod", "AUTO_SHARDS", "SpgemmConfig", "SpgemmResult", "spgemm",
    "spgemm_reference", "next_bucket", "esc",
    "FaultPlan", "FaultSpec", "InjectedFault",
]
