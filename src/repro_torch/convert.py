"""Carry CSR data across the two packages as numpy arrays.

The reference package (JAX) and the port share no code; tests and tools
move operands and results between them as host arrays.  Matrices play the
part here that weights play in a model port.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from repro_torch.core.csr import CSR, Device


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
