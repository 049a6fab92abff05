"""The port's device mesh: an array of ``torch.device`` with axis names.

The mesh-slice executors (``core.executor.make_slices`` and
``MeshSliceExecutorPool``) partition one along an axis. Several entries
may name the same device: on one card every slice of a mesh is ``cuda:0``,
and the slices are logical, as the JAX package's slices are on its CPU
container. The JAX package's TPU-pod meshes (``make_production_mesh``)
wait for the multi-GPU LM work (ROADMAP Queue 1 items 5–6).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.device import default_device

__all__ = ["DeviceMesh", "make_mesh"]


class DeviceMesh:
    """``devices``: an object array of ``torch.device``, one axis per name
    in ``axis_names``. ``shape`` maps each axis name to its size."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d devices for axes {tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def device(self) -> torch.device:
        """The mesh's first device: where a one-device task on it runs."""
        return self.devices.flat[0]

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"DeviceMesh({self.shape}, {sorted({str(d) for d in self.devices.flat})})"


def make_mesh(shape: Sequence[int], axes: Sequence[str], devices=None) -> DeviceMesh:
    """A mesh of ``shape`` over ``devices`` (a list as long as the mesh, or
    one device for every entry; default :func:`default_device`)."""
    n = int(np.prod(shape))
    if devices is None or isinstance(devices, (str, torch.device)):
        devices = [default_device(devices)] * n
    devices = [torch.device(d) for d in devices]
    if len(devices) != n:
        raise ValueError(f"a mesh of shape {tuple(shape)} needs {n} devices, got {len(devices)}")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return DeviceMesh(arr.reshape(tuple(shape)), axes)
