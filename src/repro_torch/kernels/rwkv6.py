"""The RWKV-6 WKV recurrence as a hand-written CUDA kernel for Hopper.

The port of the JAX package's ``kernels/rwkv6.py`` (``rwkv6_tpu``). The
kernel is ``csrc/rwkv6.cu`` (its header says what bounds it, how the
state is spread over threads, and why it runs the recurrence in time order
without the TPU kernel's −50 clamp on the log decay); this module holds
its ctypes wrapper. Oracle:
:func:`repro_torch.kernels.ref.rwkv6_ref`. Dispatch: ``ops.rwkv6``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, _launch

__all__ = ["rwkv6_cuda"]


@_launch.counted("rwkv6")
def rwkv6_cuda(r, k, v, w, u, s0=None):
    """RWKV-6 on the card; see ``ref.rwkv6_ref``.

    r, k: (B, H, T, Dk) and v: (B, H, T, Dv), contiguous CUDA tensors of one
    dtype; w: (B, H, T, Dk) float32 pre-activation decay; u: (H, Dk)
    float32; s0: (B, H, Dk, Dv) float32 or None. Any T ≥ 0, T=1 included;
    Dk ≤ 256, any Dv.
    Returns ``(y, S_T)``: y (B, H, T, Dv) in v's dtype, S_T float32."""
    if r.dim() != 4 or v.dim() != 4:
        raise ValueError("r, k, v and w must be (batch, heads, seq, dim)")
    b, h, t, dk = r.shape
    dv = v.shape[-1]
    _launch.check("r", r, None, (b, h, t, dk))
    _launch.check("k", k, r.dtype, (b, h, t, dk))
    _launch.check("v", v, r.dtype, (b, h, t, dv))
    _launch.check("w", w, torch.float32, (b, h, t, dk))
    _launch.check("u", u, torch.float32, (h, dk))
    if s0 is not None:
        _launch.check("s0", s0, torch.float32, (b, h, dk, dv))
    for name, tensor in (("k", k), ("v", v), ("w", w), ("u", u), ("s0", s0)):
        if tensor is not None and tensor.device != r.device:
            raise ValueError(f"{name} must be on {r.device}")
    lib = _build.load()
    idx = r.device.index if r.device.index is not None else torch.cuda.current_device()
    smem = lib.repro_rwkv6_smem(dk, dv)
    if smem < 0 or smem > lib.repro_smem_optin(idx):
        raise ValueError(f"a {dk}x{dv} state is past the kernel's reach (Dk ≤ 256)")
    y = torch.empty((b, h, t, dv), dtype=v.dtype, device=r.device)
    s_last = torch.empty((b, h, dk, dv), dtype=torch.float32, device=r.device)
    with torch.cuda.device(r.device):
        err = lib.repro_rwkv6(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
            None if s0 is None else s0.data_ptr(), y.data_ptr(), s_last.data_ptr(),
            _launch.dtype_code("r", r), b, h, t, dk, dv,
            torch.cuda.current_stream(r.device).cuda_stream)
    _launch.raise_on(err, "RWKV-6 kernel launch")
    _launch.count(rwkv6_cuda)
    return y, s_last
