"""Kernel layer of the port: hand-written CUDA kernels for Hopper.

``spgemm_hash`` holds the three per-bin hash-table kernels and their plain
PyTorch versions, ``binning_histogram`` the binning pass-1 kernel and
``bsr_spmm`` the block-CSR x dense kernel; ``segment_sum`` and
``scatter`` the kernels of the ESC's in-order sums and of the dump-slot
writes; ``ref`` holds the plain versions of
``binning_histogram`` and ``bsr_spmm`` and dense oracles; ``build`` compiles
``csrc/*.cu`` with ``nvcc`` at first use.  A wrapper launches its kernel
for CUDA tensors and runs its plain version for CPU tensors.
"""
