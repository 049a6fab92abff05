"""The RG-LRU recurrence as a hand-written CUDA kernel for Hopper.

The port of the JAX package's ``kernels/rglru.py`` (``rglru_tpu``). The
kernel is ``csrc/rglru.cu`` (its header says what bounds it and how the
chained scan over chunks of T spreads the recurrence over the card); this
module holds its ctypes wrapper, which also allocates the scan's scratch.
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
    # per-chunk decay products, local end states and entry states
    # (none at T ≤ 64, where one chunk runs)
    n_scratch = lib.repro_rglru_scratch(b, t, d)
    scratch = (torch.empty(n_scratch, dtype=torch.float32, device=x.device)
               if n_scratch > 0 else None)
    with torch.cuda.device(x.device):
        err = lib.repro_rglru(
            x.data_ptr(), input_gate.data_ptr(), rec_gate.data_ptr(),
            a_param.data_ptr(), None if h0 is None else h0.data_ptr(),
            y.data_ptr(), h_last.data_ptr(), None if scratch is None else scratch.data_ptr(),
            _launch.dtype_code("x", x), b, t, d, float(c),
            torch.cuda.current_stream(x.device).cuda_stream)
    _launch.raise_on(err, "RG-LRU kernel launch")
    _launch.count(rglru_cuda)
    return y, h_last
