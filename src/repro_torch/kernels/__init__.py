"""Kernel layer of the port: hand-written CUDA kernels for Hopper.

``spgemm_hash`` holds the three per-bin hash-table kernels and their plain
PyTorch versions; ``build`` compiles ``csrc/*.cu`` with ``nvcc`` at first
use; ``ref`` holds dense oracles.  A wrapper launches its kernel for CUDA
tensors and runs its plain version for CPU tensors.
"""
