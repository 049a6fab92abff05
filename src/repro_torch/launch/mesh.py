"""Device meshes: the mesh-slice executors' array of devices, and the
process meshes (``torch.distributed.device_mesh``) of the LM and of
``compat.sharded_call``.

:class:`DeviceMesh` is an array of ``torch.device`` with axis names. The
mesh-slice executors (``core.executor.make_slices`` and
``MeshSliceExecutorPool``) partition one along an axis. Several entries
may name the same device: on one card every slice of a mesh is ``cuda:0``,
and the slices are logical, as the JAX package's slices are on its CPU
container.

:func:`compat_make_mesh` and the meshes built on it are the JAX package's
``launch/mesh.py``: one rank of a process group per mesh entry, made with
``init_device_mesh``. :func:`init_process_group` joins the group of a
``torchrun`` launch or, in a single process, makes a group of one. The
backend follows the devices: NCCL for CUDA ranks, gloo for the CPU, chosen
explicitly and never switched. A CUDA mesh larger than the visible cards
raises. The production meshes keep the reference's device counts, 256 and
512, as functions so that importing this module touches no device.
"""
from __future__ import annotations

import os
import socket
from typing import Sequence

import numpy as np
import torch

from repro_torch.device import default_device

__all__ = ["DeviceMesh", "make_mesh", "init_process_group", "backend_for",
           "compat_make_mesh", "make_test_mesh", "make_production_mesh",
           "device_count_needed", "run_local_ranks"]


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


def backend_for(device) -> str:
    """The process-group backend of ``device``'s type: ``nccl`` for CUDA,
    ``gloo`` for the CPU."""
    kind = torch.device(device).type
    if kind == "cuda":
        return "nccl"
    if kind == "cpu":
        return "gloo"
    raise ValueError(f"no process-group backend for device type {kind!r}")


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_process_group(backend: str | None = None, *, device=None,
                       world_size: int | None = None, rank: int | None = None,
                       init_method: str | None = None) -> None:
    """Join the default process group, or create it when there is none.

    ``world_size``/``rank`` default to ``torchrun``'s ``WORLD_SIZE``/``RANK``
    (1 and 0 in a plain process) and ``init_method`` to ``env://`` under
    ``torchrun``, else ``tcp://localhost:<free port>``. ``backend``
    defaults to :func:`backend_for` the default device. An existing group
    with another backend raises rather than be used in its place. On CUDA
    each rank takes the card ``LOCAL_RANK`` (0 in a plain process)."""
    import torch.distributed as dist

    backend = backend or backend_for(default_device(device))
    if dist.is_initialized():
        have = dist.get_backend()
        if have != backend:
            raise RuntimeError(f"the process group runs {have!r}, {backend!r} was asked for")
        return
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    world_size = int(os.environ.get("WORLD_SIZE", 1)) if world_size is None else world_size
    rank = int(os.environ.get("RANK", 0)) if rank is None else rank
    if init_method is None:
        init_method = ("env://" if "MASTER_ADDR" in os.environ
                       else f"tcp://localhost:{_free_port()}")
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank)


def compat_make_mesh(shape: Sequence[int], axes: Sequence[str], *, device=None):
    """A ``torch.distributed`` device mesh of ``shape`` with axis names
    ``axes`` over the ranks of the default process group (joined or made
    by :func:`init_process_group` with :func:`backend_for` the device), on
    ``device``'s type (the card by default). The group must have exactly one
    rank per mesh entry, and a CUDA mesh one card per rank of its host:
    a mesh larger than the visible cards raises. A group on the ``fake``
    backend (the dry-run's, which traces and launches nothing) is taken as
    it is."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    n = int(np.prod(shape))
    fake = dist.is_initialized() and dist.get_backend() == "fake"
    if fake:
        kind = torch.device(device).type if device is not None else "cpu"
    else:
        dev = default_device(device)
        kind = dev.type
        if kind == "cuda":
            local = int(os.environ.get("LOCAL_WORLD_SIZE", n))
            if local > torch.cuda.device_count():
                raise RuntimeError(f"a mesh with {local} ranks on this host needs "
                                   f"{local} cards, {torch.cuda.device_count()} are visible")
        if not dist.is_initialized() and int(os.environ.get("WORLD_SIZE", 1)) != n:
            raise RuntimeError(f"a mesh of shape {shape} needs {n} ranks, this launch has "
                               f"{os.environ.get('WORLD_SIZE', 1)} (run it under torchrun "
                               f"--nproc-per-node {n})")
        init_process_group(device=dev)
    if dist.get_world_size() != n:
        raise RuntimeError(f"a mesh of shape {shape} needs {n} ranks, the process "
                           f"group has {dist.get_world_size()}")
    return init_device_mesh(kind, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """256 GPUs as (data, model) = (32, 8); multi-pod adds a leading pod=2
    axis (512 GPUs).

    The reference's TPU pod is 16 × 16 on a torus whose every link is alike.
    An H100 system's fast links are NVLink inside a node of 8 cards
    (900 GB/s a card); between nodes it is InfiniBand (400 Gb/s a card). A
    ``model`` axis of 16 would cross two nodes and put tensor parallelism,
    the most frequent and the most latency-bound collectives, on the slow
    link; a ``model`` axis of 8 is one node, and ``data`` (and ``pod``)
    span the nodes."""
    shape = (2, 32, 8) if multi_pod else (32, 8)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return compat_make_mesh(shape, axes, device=device)


def make_test_mesh(data: int = 2, model: int = 2, pod: int | None = None, *, device=None):
    """A small mesh for tests and launchers (one rank per entry)."""
    if pod:
        return compat_make_mesh((pod, data, model), ("pod", "data", "model"), device=device)
    return compat_make_mesh((data, model), ("data", "model"), device=device)


def device_count_needed(multi_pod: bool = False) -> int:
    return 512 if multi_pod else 256


def run_local_ranks(code: str, n: int, *, timeout: float = 120.0, env: dict | None = None,
                    cwd: str | None = None) -> list[str]:
    """Run the Python snippet ``code`` in ``n`` local processes, the ranks
    of one group, as ``torchrun --nproc-per-node n`` would (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``
    and a free ``MASTER_PORT`` in each one's environment, on top of this
    process's and ``env``). Returns each rank's standard output. Raises if
    a rank fails or the group outlives ``timeout`` seconds (a hung
    rendezvous), and kills every rank it started either way."""
    import subprocess
    import sys
    import tempfile

    base = {**os.environ, **(env or {}), "MASTER_ADDR": "localhost",
            "MASTER_PORT": str(_free_port()), "WORLD_SIZE": str(n), "LOCAL_WORLD_SIZE": str(n)}
    procs, outs = [], []
    try:
        for r in range(n):
            out = tempfile.TemporaryFile(mode="w+")
            procs.append(subprocess.Popen(
                [sys.executable, "-c", code], stdout=out, stderr=subprocess.STDOUT,
                env={**base, "RANK": str(r), "LOCAL_RANK": str(r)}, cwd=cwd, text=True))
            outs.append(out)
        import time

        deadline = time.monotonic() + timeout
        for p in procs:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
        texts = []
        for out in outs:
            out.seek(0)
            texts.append(out.read())
        bad = [r for r, p in enumerate(procs) if p.returncode != 0]
        if bad:
            raise RuntimeError(f"rank {bad[0]} of {n} exited {procs[bad[0]].returncode}:\n"
                               + texts[bad[0]][-4000:])
        return texts
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for out in outs:
            out.close()
