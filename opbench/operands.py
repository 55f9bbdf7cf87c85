"""The cell's operand A, made from the configuration and ``--seed``.

The structure is the configuration's Table-3 matrix (``matrices.py``),
the same in every run: it is drawn once per checkout and kept under
``build/opbench/`` at the checkout's root, under a name that carries a
hash of everything it is drawn from.  The values are drawn from the seed,
standard normal, on the device; so the work does not move with the seed.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from pathlib import Path
from typing import Tuple

import numpy as np
import torch

from .matrices import table3_structure

ROOT = Path(__file__).resolve().parents[1]
CACHE_DIR = ROOT / "build" / "opbench"
STRUCTURE_KEYS = ("matrix", "rows", "avg_nnz_per_row", "max_nnz_per_row",
                  "distribution", "window")

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class Operand:
    """A square CSR operand on its device (rpt, col int32; val in the
    configuration's type)."""
    rpt: torch.Tensor
    col: torch.Tensor
    val: torch.Tensor
    n: int

    @property
    def nnz(self) -> int:
        return int(self.col.shape[0])


def base_structure(config: dict) -> Tuple[np.ndarray, np.ndarray]:
    """``(rpt, col)`` of the configuration's matrix, drawn once per
    checkout."""
    args = [config[k] for k in STRUCTURE_KEYS]
    digest = hashlib.sha256(json.dumps(args).encode()).hexdigest()[:16]
    path = CACHE_DIR / f"{config['matrix']}-{config['rows']}-{digest}.npz"
    if path.exists():
        with np.load(path) as f:
            return f["rpt"], f["col"]
    rpt, col = table3_structure(*args)
    CACHE_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp.npz")
    np.savez(tmp, rpt=rpt, col=col)
    os.replace(tmp, path)
    return rpt, col


def make_operand(config: dict, seed: int, device: torch.device) -> Operand:
    """The configuration's A for run ``seed`` on ``device``."""
    rpt_h, col_h = base_structure(config)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2 ** 63)
    val = torch.randn(col_h.shape[0], generator=gen, device=device,
                      dtype=torch.float32).to(DTYPES[config["dtype"]])
    return Operand(rpt=torch.from_numpy(rpt_h).to(device),
                   col=torch.from_numpy(col_h).to(device), val=val,
                   n=int(config["rows"]))
