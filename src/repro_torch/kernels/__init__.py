"""GBDT kernels for Hopper, with plain-PyTorch oracles.

Layout (the ``<name>.py + ops.py + ref.py`` contract of the JAX package):
  histogram.py   ctypes wrappers of the CUDA kernels in csrc/histogram.cu
  _build.py      builds csrc/ with nvcc on first use and loads it
  ops.py         dispatch by the tensor's device: CUDA → kernel, CPU → plain
  ref.py         plain-PyTorch semantic oracles
"""
from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]
