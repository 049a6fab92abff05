"""The RG-LRU recurrence as a hand-written CUDA kernel for Hopper.

The port of the JAX package's ``kernels/rglru.py`` (``rglru_tpu``). The
kernels are in ``csrc/rglru.cu``, whose header says what bounds them: from
T = 65 on ``rglru_chain``, one launch, a block walking one (batch, 32
channels) chain through T in chunks of 64 steps, its gate warps forming the
chunks ahead once each while a scan warp runs the chunk before, with the
arithmetic of the chunked three-pass form it replaced; at T ≤ 64 (decode)
``rglru_fwd``. This module holds their ctypes wrapper.
Oracle: :func:`repro_torch.kernels.ref.rglru_ref`. Dispatch: ``ops.rglru``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, _launch

__all__ = ["rglru_cuda"]


@_launch.counted("rglru")
def rglru_cuda(x, input_gate, rec_gate, a_param, h0=None, *, c: float = 8.0):
    """RG-LRU on the card; see ``ref.rglru_ref``.

    x, input_gate, rec_gate: (B, T, D) contiguous CUDA tensors of one dtype
    (the gates are pre-sigmoid logits); a_param: (D,) float32; h0: (B, D)
    float32 or None. Any T ≥ 0, T=1 included. Returns ``(y, h_T)``: y (B,
    T, D) in x's dtype, h_T (B, D) float32."""
    if x.dim() != 3:
        raise ValueError(f"x must be (batch, seq, width), got shape {tuple(x.shape)}")
    b, t, d = x.shape
    _launch.check("x", x, None, (b, t, d))
    _launch.check("input_gate", input_gate, x.dtype, (b, t, d))
    _launch.check("rec_gate", rec_gate, x.dtype, (b, t, d))
    _launch.check("a_param", a_param, torch.float32, (d,))
    if h0 is not None:
        _launch.check("h0", h0, torch.float32, (b, d))
    for name, tensor in (("input_gate", input_gate), ("rec_gate", rec_gate),
                         ("a_param", a_param), ("h0", h0)):
        if tensor is not None and tensor.device != x.device:
            raise ValueError(f"{name} must be on {x.device}")
    lib = _build.load()
    y = torch.empty_like(x)
    h_last = torch.empty((b, d), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.repro_rglru(
            x.data_ptr(), input_gate.data_ptr(), rec_gate.data_ptr(),
            a_param.data_ptr(), None if h0 is None else h0.data_ptr(),
            y.data_ptr(), h_last.data_ptr(), _launch.dtype_code("x", x), b, t, d, float(c),
            torch.cuda.current_stream(x.device).cuda_stream)
    _launch.raise_on(err, "RG-LRU kernel launch")
    _launch.count(rglru_cuda)
    return y, h_last
