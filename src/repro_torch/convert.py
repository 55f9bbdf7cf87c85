"""Carry CSR data across the two packages as numpy arrays.

The reference package (JAX) and the port share no code; tests and tools
move operands, parameters and results between them as host arrays.
Matrices play the part here that weights play in a model port; the MoE
layer's weights cross with :func:`params_from_reference`.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core.csr import CSR, Device, resolve_device


def csr_from_reference(rpt, col, val, shape, *,
                       device: Device = "cuda") -> CSR:
    """The port's CSR from the reference's ``rpt``/``col``/``val`` arrays
    (numpy, storage padding included) and its shape."""
    return CSR.from_numpy(np.asarray(rpt), np.asarray(col), np.asarray(val),
                          shape, device=device)


def csr_to_numpy(C: CSR) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                  Tuple[int, int]]:
    """``(rpt, col, val, shape)`` on the host: the arguments of
    :func:`csr_from_reference`, so the round trip is exact."""
    rpt, col, val = C.to_numpy()
    return rpt, col, val, C.shape


def params_from_reference(tree, device: Device = "cuda"):
    """The reference's parameter tree (nested dicts of numpy arrays, as
    ``jax.device_get`` returns them) as torch tensors on ``device``, value
    for value.  bfloat16 arrays (numpy's ``ml_dtypes`` type, which torch
    does not read) cross as float32, which holds them exactly, and are
    cast back."""
    if isinstance(tree, dict):
        return {k: params_from_reference(v, device) for k, v in tree.items()}
    arr = np.asarray(tree)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=resolve_device(device), dtype=torch.bfloat16)
    return torch.from_numpy(arr.copy()).to(resolve_device(device))
