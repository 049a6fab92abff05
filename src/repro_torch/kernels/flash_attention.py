"""Flash attention as a hand-written CUDA kernel for Hopper.

The port of the JAX package's ``kernels/flash_attention.py``
(``flash_attention``). The kernels (two for bfloat16 on the tensor cores,
one for float32) are in ``csrc/flash_attention.cu``, whose header says
which runs when, what bounds them and how the work is laid out; this module
holds their ctypes wrapper. Oracle: :func:`repro_torch.kernels.ref.attention_ref`.
Dispatch: ``ops.attention``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, _launch

__all__ = ["flash_attention_cuda"]


@_launch.counted("flash_attention")
def flash_attention_cuda(q, k, v, *, causal: bool = True, window=None,
                         scale=None, logit_softcap=None):
    """Online-softmax attention on the card; see ``ref.attention_ref``.

    q: (B, Hq, Tq, D); k, v: (B, Hkv, Tk, D), contiguous CUDA tensors of one
    dtype, float32 or bfloat16, Hq a multiple of Hkv, D ≤ 256. Any Tq and
    Tk: the queries sit at the last Tq of the Tk positions. A row that sees
    no key gives 0 (the oracle gives NaN there). Statistics and accumulator
    are float32; the result has q's dtype. One of three kernels runs, and
    each counts as one launch here:

    * bfloat16 with D % 8 == 0 and every tensor 16-byte aligned:
      ``flash_fwd_hopper``, TMA loads and ``wgmma`` products, D padded to
      64, 128 or 256 by the tensor maps' zero fill;
    * other bfloat16 (D % 8 != 0, or an offset view TMA cannot address):
      ``flash_fwd_bf16``, ``mma.sync`` products on tiles the threads load;
    * float32: ``flash_fwd<float>``, float32 products on the CUDA cores.

    The bf16 kernels take the probabilities P into the P·V product as a
    pair of bf16 terms, P_hi + P_lo, which keeps about 16 bits of P. A row's
    result does not depend on B, the head count or the card's SM count, and
    two calls give the same bits. A tensor map the driver will not encode
    and a launch the card refuses raise; nothing falls back to another
    kernel or to the plain version.
    """
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("q, k and v must be (batch, heads, seq, head_dim)")
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    _launch.check("q", q, None, (b, hq, tq, d))
    _launch.check("k", k, q.dtype, (b, hkv, tk, d))
    _launch.check("v", v, q.dtype, (b, hkv, tk, d))
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must share one device")
    lib = _build.load()
    if hkv < 1 or hq % hkv:
        raise ValueError(f"n_heads {hq} is not a multiple of n_kv_heads {hkv}")
    if not 1 <= d <= lib.repro_flash_max_head_dim():
        raise ValueError(f"head_dim {d} outside 1..{lib.repro_flash_max_head_dim()}")
    sc = float(scale) if scale is not None else d ** -0.5
    cap = float(logit_softcap) if logit_softcap is not None else 0.0
    if logit_softcap is not None and cap <= 0.0:
        raise ValueError("logit_softcap must be positive")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _launch.dtype_code("q", q), b, hq, hkv, tq, tk, d, sc, cap,
            int(bool(causal)), -1 if window is None else int(window),
            torch.cuda.current_stream(q.device).cuda_stream)
    _launch.raise_on(err, "flash-attention kernel launch")
    _launch.count(flash_attention_cuda)
    return out
