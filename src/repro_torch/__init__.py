"""PyTorch and CUDA port of the model-search framework (paper §III).

Module paths and public names mirror the JAX package ``repro``:
``repro.kernels.ops`` becomes ``repro_torch.kernels.ops``,
``repro.tabular.gbdt`` becomes ``repro_torch.tabular.gbdt``, and so on.
Entry points run on the CUDA device unless the caller asks for the CPU
(:mod:`repro_torch.device`); on the card the GBDT hot path and the LM
serving path run the hand-written kernels of ``repro_torch/kernels/csrc``.
"""
from repro_torch.device import default_device, set_default_device

__all__ = ["default_device", "set_default_device"]
