"""Build loader for the port's hand-written CUDA kernels.

At first use each ``csrc/*.cu`` source is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, under
``build/repro_torch/`` at the root of the checkout, and bound with
``ctypes``.  The library's name carries a hash of its source, so an edited
kernel is rebuilt and an unchanged one is loaded as built.  All sources
compile in parallel, one ``nvcc`` each.  A failed build raises: the port
has no fallback for CUDA tensors.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures of every entry point, by source: pointers and the stream are
# c_void_p (ctypes would cut a pointer passed as a plain int), sizes c_int.
SIGNATURES: Dict[str, Dict[str, Tuple]] = {
    "spgemm_hash": {
        "hash_max_smem_bytes": (_P,),
        "symbolic_bin": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P,
                         _P),
        "numeric_bin": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P,
                        _P, _P, _P),
        "fused_bin": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P,
                      _P, _P, _P, _P),
    },
}

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_LOG: Dict[str, str] = {}      # compiler output (ptxas -v) by source


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_all() -> float:
    """Compile every source whose library is missing, all ``nvcc`` runs
    started together, and bind them.  Returns the seconds it took."""
    t0 = time.perf_counter()
    with _LOCK:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name in SIGNATURES:
            if name in _LIBS:
                continue
            so = _target(name)
            if so.exists():
                continue
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, so)
        failed = []
        for name, (proc, tmp, so) in procs.items():
            out, _ = proc.communicate()
            BUILD_LOG[name] = out
            if proc.returncode != 0:
                failed.append(f"{name}.cu (exit {proc.returncode}):\n{out}")
            else:
                os.replace(tmp, so)
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        for name, sig in SIGNATURES.items():
            if name not in _LIBS:
                lib = ctypes.CDLL(str(_target(name)))
                for fn, argtypes in sig.items():
                    getattr(lib, fn).argtypes = list(argtypes)
                    getattr(lib, fn).restype = ctypes.c_int
                _LIBS[name] = lib
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The bound library of ``csrc/<name>.cu``, built at first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all()
        lib = _LIBS[name]
    return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero CUDA error code returned by an entry point."""
    if err != 0:
        raise RuntimeError(f"{what} failed with CUDA error {err}")
