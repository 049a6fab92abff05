"""The RWKV-6 WKV recurrence as hand-written CUDA kernels for Hopper.

The port of the JAX package's ``kernels/rwkv6.py`` (``rwkv6_tpu``). The
kernels are in ``csrc/rwkv6.cu``, whose header says what bounds them:
``rwkv6_chunked`` runs sub-chunks of 16 steps on the tensor cores (the
readout of the carried state, the state update, the intra-sub-chunk scores
split by levels of a binary tree so that every decay factor is a product of
per-step decays, and scores · V), and ``rwkv6_fwd`` runs the recurrence step
by step. Neither clamps the log decay as the TPU kernel does. This module
holds their ctypes wrapper, which picks one (:func:`chunked_form`). Oracle:
:func:`repro_torch.kernels.ref.rwkv6_ref`. Dispatch: ``ops.rwkv6``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, _launch

__all__ = ["rwkv6_cuda", "chunked_form", "SUB_CHUNK", "CHUNKED_MAX_DK"]

#: steps of one sub-chunk of ``rwkv6_chunked``; a state carried across two
#: calls gives the bits of one call where the split lies on this grid
SUB_CHUNK = 16
#: the largest Dk the chunked kernel takes (its state tile in registers)
CHUNKED_MAX_DK = 64


def chunked_form(t: int, dk: int, dv: int, itemsize: int, *ptrs: int) -> bool:
    """Whether ``rwkv6_cuda`` runs the chunked kernel: T of at least one
    sub-chunk, Dk ≤ 64, and every row of r, k, v, w and y 16-byte aligned
    (the sub-chunks are staged with cp.async). Decode (T = 1), any shorter T
    and other shapes take the step kernel, whose bits do not depend on where
    a call starts."""
    return (t >= SUB_CHUNK and dk <= CHUNKED_MAX_DK and (dk * itemsize) % 16 == 0
            and (dv * itemsize) % 16 == 0 and all(p % 16 == 0 for p in ptrs))


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
    code = _launch.dtype_code("r", r)
    chunked = chunked_form(t, dk, dv, r.element_size(), r.data_ptr(), k.data_ptr(),
                           v.data_ptr(), w.data_ptr(), y.data_ptr())
    if chunked and not 0 < lib.repro_rwkv6_chunked_smem(dk, code) <= lib.repro_smem_optin(idx):
        chunked = False
    fn = lib.repro_rwkv6_chunked if chunked else lib.repro_rwkv6
    with torch.cuda.device(r.device):
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
                 None if s0 is None else s0.data_ptr(), y.data_ptr(), s_last.data_ptr(),
                 code, b, h, t, dk, dv, torch.cuda.current_stream(r.device).cuda_stream)
    _launch.raise_on(err, "RWKV-6 kernel launch")
    _launch.count(rwkv6_cuda)
    return y, s_last
