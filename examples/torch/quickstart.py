"""Quickstart: the port's SpGEMM public API, on the card by default.

The same matrices as ``examples/quickstart.py`` (the reference's
``PRNGKey(0)`` and ``PRNGKey(1)`` draws, ``prng_key_seed``) and the same
dense-oracle check.

Run:  PYTHONPATH=src python examples/torch/quickstart.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.core import SpgemmConfig, random_csr, spgemm
from repro_torch.core.csr import prng_key_seed

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default="cuda")
device = ap.parse_args().device

# A sparse matrix with a heavy-tailed row distribution (webbase-like).
A = random_csr(prng_key_seed(0), 2000, 2000, avg_nnz_per_row=8.0,
               max_nnz_per_row=200, distribution="powerlaw", device=device)

# C = A @ A, the paper's benchmark computation: two-phase, binned.
result = spgemm(A, A, SpgemmConfig(method="esc", timing=True))
C = result.C

print(f"A: {A.shape}, nnz={int(A.nnz())}, device={A.device}")
print(f"C = A@A: nnz={result.total_nnz}, intermediate products="
      f"{result.total_nprod}, compression ratio={result.compression_ratio:.2f}")
print("per-step timings (ms):",
      {k: round(v * 1e3, 2) for k, v in result.timings.items()})
print("symbolic bin sizes:", result.sym_binning.bin_size.cpu().numpy())
print("numeric  bin sizes:", result.num_binning.bin_size.cpu().numpy())

# Verify against the dense oracle on a small matrix.
small = random_csr(prng_key_seed(1), 64, 64, avg_nnz_per_row=4.0,
                   device=device)
res = spgemm(small, small)
dense = small.to_dense().cpu().numpy()
np.testing.assert_allclose(res.C.to_dense().cpu().numpy(), dense @ dense,
                           rtol=1e-5, atol=1e-5)
print("dense-oracle check: OK")
