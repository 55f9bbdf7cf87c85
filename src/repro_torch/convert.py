"""Carry CSR data across the two packages as numpy arrays.

The reference package (JAX) and the port share no code; tests and tools
move operands, parameters and results between them as host arrays.
Matrices play the part here that weights play in a model port; a
model's weights (int8 ones too) cross with :func:`params_from_reference`
and its decode caches with :func:`caches_from_reference`, so that a
decode step can start from the reference's own state.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core.csr import CSR, Device, resolve_device
from repro_torch.models.layers import AttnCache
from repro_torch.models.quant import QTensor
from repro_torch.models.ssm import SSMCache


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


def _tensor(arr, device: Device) -> torch.Tensor:
    """One host array as a tensor on ``device``, value for value.
    bfloat16 arrays (numpy's ``ml_dtypes`` type, which torch does not
    read) cross as float32, which holds them exactly, and are cast back."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=resolve_device(device), dtype=torch.bfloat16)
    return torch.from_numpy(arr.copy()).to(resolve_device(device))


def params_from_reference(tree, device: Device = "cuda"):
    """The reference's parameter tree (nested dicts of numpy arrays, as
    ``jax.device_get`` returns them) as torch tensors on ``device``, value
    for value.  The reference's int8 leaves (``repro.models.quant.QTensor``,
    an object with ``q`` and ``scale``) become the port's ``QTensor``."""
    if isinstance(tree, dict):
        return {k: params_from_reference(v, device) for k, v in tree.items()}
    if hasattr(tree, "q") and hasattr(tree, "scale"):
        return QTensor(q=_tensor(tree.q, device),
                       scale=_tensor(tree.scale, device))
    return _tensor(tree, device)


def caches_from_reference(tree, device: Device = "cuda"):
    """The reference's decode caches (``AttnCache`` with ``k``/``v``,
    ``SSMCache`` with ``conv``/``h``, and the hybrid's and vlm's tuples of
    them, as ``jax.device_get`` returns them) as the port's, on
    ``device``, value for value."""
    if tree is None:
        return None
    if isinstance(tree, (tuple, list)):
        return tuple(caches_from_reference(t, device) for t in tree)
    if hasattr(tree, "k") and hasattr(tree, "v"):
        return AttnCache(k=_tensor(tree.k, device), v=_tensor(tree.v, device))
    if hasattr(tree, "conv") and hasattr(tree, "h"):
        return SSMCache(conv=_tensor(tree.conv, device),
                        h=_tensor(tree.h, device))
    raise TypeError(f"not a reference cache: {type(tree).__name__}")
