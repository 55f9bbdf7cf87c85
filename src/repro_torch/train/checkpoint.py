"""Atomic, asynchronous checkpoints in the reference's on-disk format,
restorable onto any device.

The counterpart of ``repro/train/checkpoint.py``, format for format:

Layout per step:  <dir>/step_0000123/
    manifest.json      keys, shapes, dtypes, step, extra (the data state)
    arrays.npz         the leaves as ``a0.npy``, ``a1.npy``, ... in key
                       order

Keys are the paths ``jax.tree_util.tree_flatten_with_path`` gives the
same tree, joined by "/": a dict key as itself (dicts in sorted key
order, as JAX flattens them), a NamedTuple field as ".name", a sequence
index as its number; ``TrainState``'s embedding is ``.params/embed/
embedding``, its first moment's ``.opt/.m/embed/embedding``.  A bfloat16
leaf is written as the reference's ``np.savez`` writes one: 2-byte
records under the descriptor ``<V2`` (numpy has no bfloat16 of its own),
its type in the manifest's ``dtypes``.  :func:`restore` reads the type
from there, so the reference's bfloat16 checkpoints restore here (the
reference cannot restore them itself: ``jax.device_put`` rejects a
``V2`` array), and a float32 or int32 checkpoint written here restores in
the reference.

Commit protocol: write into ``<dir>/tmp_<step>``, fsync, then atomic
``rename`` to ``step_<n>``, so a preempted writer never leaves a
readable half-checkpoint; ``keep`` bounds the checkpoints retained.

Elastic restore: leaves load on the host and move to the device asked
for (by default each template leaf's own), so a checkpoint taken on the
card restores on the CPU and back.
"""
from __future__ import annotations

import json
import os
import shutil
import zipfile
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.csr import Device, resolve_device
from repro_torch.models.param import tree_map

Tree = Any

_MANIFEST = "manifest.json"
_ARRAYS = "arrays.npz"
_BF16_DESCR = "<V2"          # what np.savez writes for a bfloat16 array


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten_with_paths(tree: Tree, prefix: Tuple[str, ...] = ()
                        ) -> List[Tuple[str, Any]]:
    """(key, leaf) pairs in ``jax.tree_util.tree_flatten_with_path``'s
    order and spelling (None is no leaf) for trees of dicts, NamedTuples,
    tuples and lists of tensors."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kl for k in sorted(tree)
                for kl in _flatten_with_paths(tree[k], prefix + (str(k),))]
    if _is_namedtuple(tree):
        return [kl for f in tree._fields
                for kl in _flatten_with_paths(getattr(tree, f),
                                              prefix + ("." + f,))]
    if isinstance(tree, (tuple, list)):
        return [kl for i, v in enumerate(tree)
                for kl in _flatten_with_paths(v, prefix + (str(i),))]
    return [("/".join(prefix), tree)]


def _unflatten(template: Tree, leaves) -> Tree:
    """``template`` with its leaves replaced by the values of the iterator
    ``leaves``, taken in :func:`_flatten_with_paths`' order (dicts keep
    their own key order)."""
    if template is None:
        return None
    if isinstance(template, dict):
        vals = {k: _unflatten(template[k], leaves) for k in sorted(template)}
        return {k: vals[k] for k in template}
    if _is_namedtuple(template):
        return type(template)(*(_unflatten(getattr(template, f), leaves)
                                for f in template._fields))
    if isinstance(template, (tuple, list)):
        return type(template)(_unflatten(v, leaves) for v in template)
    return next(leaves)


def _host_array(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array (bfloat16 as its 16-bit patterns)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def _write_npz(path: Path, arrays: List[np.ndarray],
               dtypes: List[str]) -> None:
    """``np.savez(path, a0=..., a1=...)`` record for record, bfloat16 leaves
    under the reference's ``<V2`` descriptor."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for i, (arr, dt) in enumerate(zip(arrays, dtypes)):
            with zf.open(f"a{i}.npy", "w", force_zip64=True) as f:
                if dt == "bfloat16":
                    np.lib.format.write_array_header_1_0(f, {
                        "descr": _BF16_DESCR, "fortran_order": False,
                        "shape": arr.shape})
                    f.write(arr.tobytes())
                else:
                    np.lib.format.write_array(f, arr)


def save(ckpt_dir: str | Path, step: int, state: Tree,
         extra: Optional[Dict] = None, *, keep: int = 3) -> Path:
    """Synchronous atomic checkpoint write."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    tmp = ckpt_dir / f"tmp_{step:07d}"
    final = ckpt_dir / f"step_{step:07d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()

    flat = _flatten_with_paths(state)
    dtypes = [_dtype_name(leaf) for _, leaf in flat]
    arrays = [_host_array(leaf) for _, leaf in flat]
    _write_npz(tmp / _ARRAYS, arrays, dtypes)
    manifest = {
        "step": step,
        "keys": [k for k, _ in flat],
        "shapes": [list(a.shape) for a in arrays],
        "dtypes": dtypes,
        "extra": extra or {},
    }
    (tmp / _MANIFEST).write_text(json.dumps(manifest))
    with open(tmp / _MANIFEST) as f:
        os.fsync(f.fileno())
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)                       # atomic commit
    _gc(ckpt_dir, keep)
    return final


class AsyncCheckpointer:
    """Background-thread writer: the snapshot is taken on the caller and
    is a copy that nothing else shares (a clone on the CPU, a
    device-to-host copy from the card), so the in-place train steps that
    follow cannot reach it; serialization and IO overlap them."""

    def __init__(self, ckpt_dir: str | Path, keep: int = 3):
        self.ckpt_dir = Path(ckpt_dir)
        self.keep = keep
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._last: Optional[Future] = None

    def save(self, step: int, state: Tree,
             extra: Optional[Dict] = None) -> Future:
        self.wait()
        host_state = tree_map(                # before the next mutation
            lambda t: t.detach().to("cpu", copy=True), state)
        self._last = self._pool.submit(save, self.ckpt_dir, step,
                                       host_state, extra, keep=self.keep)
        return self._last

    def wait(self):
        if self._last is not None:
            self._last.result()
            self._last = None


def latest_step(ckpt_dir: str | Path) -> Optional[int]:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in ckpt_dir.glob("step_*")]
    return max(steps) if steps else None


def _tensor(arr: np.ndarray, dtype: str, device: torch.device
            ) -> torch.Tensor:
    if dtype == "bfloat16":        # 2-byte records: the 16-bit patterns
        t = torch.from_numpy(np.require(arr, requirements="C").view(np.int16))
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.require(arr, requirements="C")).to(device)


def restore(ckpt_dir: str | Path, template: Tree, *,
            step: Optional[int] = None, device: Optional[Device] = None):
    """Restore into the structure of ``template`` -> (state, extra).  Each
    leaf goes to ``device`` if given (the elastic reshard: another device
    than the one that saved it), else to its template leaf's device (the
    card for a ``meta`` template)."""
    ckpt_dir = Path(ckpt_dir)
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = ckpt_dir / f"step_{step:07d}"
    manifest = json.loads((d / _MANIFEST).read_text())

    flat = _flatten_with_paths(template)
    keys = [k for k, _ in flat]
    if keys != manifest["keys"]:
        raise ValueError("checkpoint tree mismatch:\n saved=%s\n want=%s"
                         % (manifest["keys"][:5], keys[:5]))
    dev = None if device is None else resolve_device(device)
    out = []
    with np.load(d / _ARRAYS) as data:
        for i, (key, leaf) in enumerate(flat):
            arr = data[f"a{i}"]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"{key}: saved {arr.shape}, want "
                                 f"{tuple(leaf.shape)}")
            where = dev if dev is not None else leaf.device
            if where.type == "meta":
                where = resolve_device("cuda")
            out.append(_tensor(arr, manifest["dtypes"][i], where))
    return _unflatten(template, iter(out)), manifest["extra"]


def _gc(ckpt_dir: Path, keep: int):
    steps = sorted(ckpt_dir.glob("step_*"),
                   key=lambda p: int(p.name.split("_")[1]))
    for p in steps[:-keep]:
        shutil.rmtree(p, ignore_errors=True)
