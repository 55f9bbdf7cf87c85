"""OpSparse in PyTorch and CUDA for NVIDIA Hopper: a port of ``repro``.

The reference package ``repro`` (JAX, Pallas kernels for a TPU) stays the
reference; this package mirrors its layout and names.  It imports torch and
numpy only.  Entry points build on the card unless the caller asks for the
CPU, and ``spgemm`` runs where its operands live: on CUDA tensors the
kernels are the hand-written ones in ``kernels/csrc``, on CPU tensors
their plain PyTorch versions.
"""
from .core import (AUTO_SHARDS, CSR, SpgemmConfig, SpgemmResult,
                   random_csr, spgemm, spgemm_reference)
from .convert import csr_from_reference, csr_to_numpy

__all__ = ["AUTO_SHARDS", "CSR", "SpgemmConfig", "SpgemmResult", "random_csr", "spgemm",
           "spgemm_reference", "csr_from_reference", "csr_to_numpy"]
