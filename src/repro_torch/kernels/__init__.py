"""Kernels for Hopper, with plain-PyTorch oracles.

Layout (the ``<name>.py + ops.py + ref.py`` contract of the JAX package):
  histogram.py        ctypes wrappers of csrc/histogram.cu (GBDT levels)
  flash_attention.py  ctypes wrapper of csrc/flash_attention.cu
  rglru.py            ctypes wrapper of csrc/rglru.cu
  rwkv6.py            ctypes wrapper of csrc/rwkv6.cu
  _build.py           builds csrc/ with nvcc on first use and loads it
  _launch.py          launch counters, input checks, CUDA errors
  ops.py              dispatch by the tensor's device: CUDA → kernel, CPU → plain
  ref.py              plain-PyTorch semantic oracles

:func:`launch_counts` gives every kernel's launches since the last
:func:`reset_launch_counts`.
"""
from repro_torch.kernels import flash_attention, histogram, ops, ref, rglru, rwkv6
from repro_torch.kernels._launch import launch_counts, reset_launch_counts

__all__ = ["ops", "ref", "histogram", "flash_attention", "rglru", "rwkv6",
           "launch_counts", "reset_launch_counts"]
