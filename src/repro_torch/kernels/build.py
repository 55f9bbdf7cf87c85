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
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_U = ctypes.c_uint
# C signatures of every entry point, by source: pointers and the stream are
# c_void_p (ctypes would cut a pointer passed as a plain int), sizes c_int.
SIGNATURES: Dict[str, Dict[str, Tuple]] = {
    "spgemm_hash": {
        "hash_max_smem_bytes": (_P,),
        "hash_ctas_per_sm": (_I, _I, _I, _I, _I, _P),
        "symbolic_bin": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P,
                         _P),
        "numeric_bin": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                        _U, _I, _U, _P, _P, _P, _P),
        "fused_bin": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P,
                      _P, _P, _P, _P),
        "numeric_bin_ordered": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                _I, _I, _U, _I, _U, _P, _P, _P, _P),
        "fused_bin_ordered": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                              _I, _P, _P, _P, _P, _P),
        "hash_global_ctas_per_sm": (_I, _I, _I, _P),
        "hash_bin_global": (_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                            _P, _P, _P, _P, _P),
        "hash_bin_global_ordered": (_I, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                    _I, _I, _P, _P, _P, _P, _P),
        "hash_cluster_occupancy": (_I, _I, _I, _I, _I, _P),
        "hash_bin_cluster": (_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                             _I, _I, _P, _P, _P, _P, _P),
        "hash_bin_cluster_ordered": (_I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                                     _I, _I, _I, _I, _P, _P, _P, _P, _P),
    },
    "binning_histogram": {
        "binning_histogram": (_P, _L, _I, _P, _I, _I, _P, _P, _P),
    },
    "scatter": {
        "scatter_kept": (_P, _P, _P, _L, _L, _I, _P),
        "count_into": (_P, _P, _P, _L, _L, _P),
    },
    "segment_sum": {
        "segment_sum": (_P, _P, _L, _L, _P, _I, _P),
    },
    "bsr_spmm": {
        "bsr_spmm_f32": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
        "bsr_spmm_bf16": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
        "bsr_spmm_f16": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
        "bsr_spmm_f32_occupancy": (_P, _P),
        "bsr_spmm_bf16_occupancy": (_P, _P),
        "bsr_spmm_f16_occupancy": (_P, _P),
    },
}
# The hash kernels' entry points of the 16-bit value types: the float32
# ones' signatures under the suffixes _bf16 and _f16.
VALUE_SUFFIXES = ("_bf16", "_f16")
SIGNATURES["spgemm_hash"].update({
    fn + suffix: sig
    for fn, sig in list(SIGNATURES["spgemm_hash"].items())
    if fn not in ("hash_max_smem_bytes", "symbolic_bin")
    for suffix in VALUE_SUFFIXES})

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_LOG: Dict[str, str] = {}      # compiler output (ptxas -v) by source,
                                    # kept as <library>.log beside it


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
                log = so.with_suffix(".log")
                BUILD_LOG[name] = log.read_text() if log.exists() else ""
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
                so.with_suffix(".log").write_text(out)
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


def kernel_name(mangled: str) -> str:
    """Readable name of a kernel in a (possibly anonymous) namespace, from
    its mangled symbol (``hash_rows_kernel<1,0>``, with bool or int
    template arguments), else the symbol."""
    m = re.match(r"_ZN(\d+)", mangled)
    if not m:
        return mangled
    pos = m.end() + int(m.group(1))             # past the namespace
    m = re.match(r"(\d+)", mangled[pos:])
    if not m:
        return mangled
    start = pos + m.end()
    end = start + int(m.group(1))
    name = mangled[start:end]
    args = re.match(r"I((?:L[bi]n?\d+E)+)E", mangled[end:])
    if args:
        name += "<" + ",".join(
            a.replace("n", "-")
            for a in re.findall(r"L[bi](n?\d+)E", args.group(1))) + ">"
    return name


def ptxas_report(name: str) -> List[str]:
    """``ptxas -v`` of one source's last build, one line per kernel:
    its registers, barriers, static shared memory, stack and spills."""
    return ptxas_lines(BUILD_LOG.get(name, ""))


def ptxas_lines(log: str) -> List[str]:
    """:func:`ptxas_report` of one ``nvcc`` run's output."""
    out, kernel, info = [], None, {}
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            kernel = kernel_name(m.group(1))
        elif kernel and "spill" in line:
            info[kernel] = line.strip()
        elif kernel and "Used" in line:
            used = line.split(":", 1)[-1].strip()
            out.append(f"{kernel}: {used}; {info.get(kernel, '')}")
            kernel = None
    return out


def library(name: str) -> ctypes.CDLL:
    """The bound library of ``csrc/<name>.cu``, built at first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all()
        lib = _LIBS[name]
    return lib


def sass_opcodes(name: str) -> Dict[str, Dict[str, int]]:
    """Per kernel of the built ``csrc/<name>.cu``, how many SASS
    instructions it holds of each opcode (``cuobjdump -sass``)."""
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(exe).exists():
        raise RuntimeError("cuobjdump not found")
    sass = subprocess.run([exe, "-sass", str(_target(name))],
                          capture_output=True, text=True, check=True).stdout
    ops: Dict[str, Dict[str, int]] = {}
    kernel = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            kernel = kernel_name(m.group(1))
            ops[kernel] = {}
            continue
        m = re.search(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Za-z0-9_.]*)",
                      line)
        if kernel and m:
            ops[kernel][m.group(1)] = ops[kernel].get(m.group(1), 0) + 1
    return ops


def check(err: int, what: str) -> None:
    """Raise on a non-zero CUDA error code returned by an entry point."""
    if err != 0:
        raise RuntimeError(f"{what} failed with CUDA error {err}")
