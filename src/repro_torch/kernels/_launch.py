"""What every kernel wrapper shares: launch counters, input checks, errors.

Each wrapper is registered under a name with :func:`counted` and adds one
to its count where it launches its kernel (:func:`count`), nowhere else, so
a run can show that its path went through the kernels. The counts are plain
integers on the wrapper functions, guarded by one lock because executor
threads launch concurrently.
"""
from __future__ import annotations

import threading

import torch

from repro_torch.kernels import _build

__all__ = ["counted", "count", "launch_counts", "reset_launch_counts",
           "check", "raise_on", "dtype_code"]

_lock = threading.Lock()
_wrappers: dict = {}

# element types the LM kernels take (csrc/common.cuh: repro::DType)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def counted(name: str):
    """Register a wrapper under ``name`` with a launch count of 0."""
    def wrap(fn):
        fn.launches = 0
        _wrappers[name] = fn
        return fn
    return wrap


def count(fn) -> None:
    with _lock:
        fn.launches += 1


def launch_counts(names=None) -> dict[str, int]:
    """Launches of each registered wrapper (or of ``names``) since the last
    :func:`reset_launch_counts`."""
    with _lock:
        return {n: _wrappers[n].launches for n in (names or _wrappers)}


def reset_launch_counts(names=None) -> None:
    with _lock:
        for n in names or _wrappers:
            _wrappers[n].launches = 0


def check(name: str, t: torch.Tensor, dtype, shape) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` and
    ``shape`` (``dtype=None``: any dtype the LM kernels take)."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got device {t.device}")
    if dtype is None:
        dtype_code(name, t)
    elif t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def dtype_code(name: str, t: torch.Tensor) -> int:
    try:
        return _DTYPE_CODES[t.dtype]
    except KeyError:
        raise ValueError(f"{name} must be float32 or bfloat16, got {t.dtype}") from None


def raise_on(err: int, what: str) -> None:
    if err != 0:
        text = _build.load().repro_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({text})")
