"""OpSparse in PyTorch and CUDA for NVIDIA Hopper: a port of ``repro``.

The reference package ``repro`` (JAX, Pallas kernels for a TPU) stays the
reference; this package mirrors its layout and names.  It imports torch and
numpy only.  Entry points build on the card unless the caller asks for the
CPU, and ``spgemm`` runs where its operands live: on CUDA tensors the
kernels are the hand-written ones in ``kernels/csrc``, on CPU tensors
their plain PyTorch versions.
"""
import importlib

_EXPORTS = {
    "AUTO_SHARDS": "core", "CSR": "core", "SpgemmConfig": "core",
    "SpgemmResult": "core", "random_csr": "core", "spgemm": "core",
    "spgemm_reference": "core", "csr_from_reference": "convert",
    "csr_to_numpy": "convert",
}
__all__ = list(_EXPORTS)


def __getattr__(name):
    """The public names, imported on first use, so that a subpackage that
    needs no torch (``python -m repro_torch.analysis_static``) loads
    without it."""
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f".{_EXPORTS[name]}", __name__),
                    name)
    globals()[name] = value
    return value
