"""The public drivers of the hash kernels, re-exported (the reference's
``kernels/ops.py``)."""
from __future__ import annotations

from . import spgemm_hash
from .spgemm_hash import (host_schedule, numeric_bin_call, numeric_binned,
                          numeric_scheduled, symbolic_bin_call,
                          symbolic_binned, symbolic_scheduled)

__all__ = [
    "spgemm_hash", "symbolic_bin_call", "numeric_bin_call",
    "symbolic_binned", "numeric_binned",
    "symbolic_scheduled", "numeric_scheduled", "host_schedule",
]
