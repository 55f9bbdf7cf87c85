"""Dense oracles for the SpGEMM paths (tests and checks only)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.csr import CSR


def spgemm_dense_ref(A: CSR, B: CSR) -> torch.Tensor:
    """Dense oracle for any SpGEMM path."""
    return A.to_dense() @ B.to_dense()


def row_nnz_from_support(A: CSR, B: CSR) -> np.ndarray:
    """Structural n_nz per row (counts symbolic support even where values
    cancel numerically, as the hash and ESC symbolic phases do)."""
    a = (A.to_dense() != 0).cpu().numpy().astype(np.int64)
    b = (B.to_dense() != 0).cpu().numpy().astype(np.int64)
    return ((a @ b) > 0).sum(axis=1).astype(np.int32)
