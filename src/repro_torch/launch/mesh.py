"""Logical device meshes.

The counterpart of ``repro/launch/mesh.py``.  A :class:`Mesh` is the
mesh's axis names mapped to their sizes, plus the devices it stands for
(none for a production mesh, which the analytic terms and the sharding
rules read by names and sizes only).  Iterating a mesh gives its
data-axis devices, so a mesh is also the device sequence that
``SpgemmEngine(mesh=...)`` places shards on
(:func:`repro_torch.engine.partition.data_axis_devices`, re-exported
here).
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.csr import resolve_device
from repro_torch.engine.partition import data_axis_devices  # noqa: F401

DATA_AXES = ("pod", "data")


class Mesh:
    """Axis names and sizes (``shape``, in axis order) and optionally the
    devices, an array of that shape."""

    def __init__(self, shape: Dict[str, int],
                 devices: Optional[Sequence] = None):
        self.shape = dict(shape)
        self.devices = None
        if devices is not None:
            devs = np.empty(len(devices), dtype=object)
            devs[:] = list(devices)
            self.devices = devs.reshape(tuple(self.shape.values()))

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def __iter__(self) -> Iterator[torch.device]:
        """One device a data-parallel slot, in axis order: the model axes
        collapse to their first column (a row-sharded operand's shard s
        lands on the s-th data slot)."""
        if self.devices is None:
            return iter(())
        devs = self.devices
        for i, name in enumerate(self.axis_names):
            if name not in DATA_AXES:
                devs = np.take(devs, [0], axis=i)
        return iter(tuple(devs.flatten()))


# One H100: names and sizes only (the analytic terms' default mesh).
ONE_CARD = Mesh({"data": 1, "model": 1})


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's 16x16 (data, model) or 2x16x16 (pod, data, model)
    mesh, names and sizes only."""
    if multi_pod:
        return Mesh({"pod": 2, "data": 16, "model": 16})
    return Mesh({"data": 16, "model": 16})


def make_host_mesh(model_axis: int = 1, device="cuda") -> Mesh:
    """A mesh over the local devices of ``device``'s type: every visible
    card for ``"cuda"`` (one on the H100 machine), the one CPU for
    ``"cpu"``."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    else:
        devices = [dev]
    n = len(devices)
    if n % model_axis:
        raise ValueError(f"{n} devices do not split into a model axis of "
                         f"{model_axis}")
    return Mesh({"data": n // model_axis, "model": model_axis}, devices)


def data_axes(mesh: Mesh) -> tuple:
    """The data-parallel axes of a mesh ('pod' + 'data')."""
    return tuple(a for a in mesh.axis_names if a in DATA_AXES)


def dp_size(mesh: Mesh) -> int:
    out = 1
    for a in data_axes(mesh):
        out *= mesh.shape[a]
    return out
