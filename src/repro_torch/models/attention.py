"""Attention layer (MHA / GQA / MQA) with RoPE, windows, qk-norm, softcap.

The port of the JAX package's ``models/attention.py``. Three apply paths
share one parameter dict:
  * ``attn_train``   — full sequence, no cache
  * ``attn_prefill`` — full sequence, and fills the KV cache in place
  * ``attn_decode``  — one new token against the KV cache, written in place

The inner products go through ``ops.attention`` (the flash-attention kernel
on the card) and ``ops.decode_attention`` (plain PyTorch everywhere, as in
the JAX package). ``force`` is passed through to ``ops.attention``.
Cross-attention (``AttnCfg.cross``, whisper's decoder) takes K and V from
an encoder ``memory``, with no rotary and no causal mask; its cache holds
the encoder's K/V, written by the prefill and only read by decode steps.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers import Init, dense, rmsnorm, rope

__all__ = ["AttnCfg", "init_attention", "attn_train", "attn_prefill", "attn_decode",
           "init_kv_cache", "split_heads", "merge_heads"]


@dataclasses.dataclass(frozen=True)
class AttnCfg:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    bias: bool = False
    qk_norm: bool = False
    window: int | None = None          # sliding-window size (None = global)
    rope_theta: float | None = 10000.0  # None = no rotary (whisper: learned abs)
    logit_softcap: float | None = None
    scale: float | None = None         # None → head_dim ** −0.5
    cross: bool = False                # cross-attention (K/V from encoder memory)
    matmul_dtype: str = "float32"      # "input": bf16 operands, f32 accum


def init_attention(init: Init, cfg: AttnCfg) -> dict:
    d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": init.normal((d, h * dh)),
        "wk": init.normal((d, hkv * dh)),
        "wv": init.normal((d, hkv * dh)),
        "wo": init.normal((h * dh, d)),
    }
    if cfg.bias:
        p["bq"] = init.zeros((h * dh,))
        p["bk"] = init.zeros((hkv * dh,))
        p["bv"] = init.zeros((hkv * dh,))
    if cfg.qk_norm:
        p["q_norm"] = {"scale": init.zeros((dh,))}
        p["k_norm"] = {"scale": init.zeros((dh,))}
    return p


class _OnModelWhole(torch.autograd.Function):
    """A DTensor made whole over the mesh's ``model`` dimension, and its
    gradient made whole there too. A reshape that splits or merges a head
    dimension the ``model`` ranks do not divide needs both sides whole:
    DTensor's view rules refuse an uneven split (PyTorch 2.11) or
    redistribute implicitly (2.13), and the gradient reaching the reshape
    from a row-parallel product is sharded on ``model``."""

    @staticmethod
    def forward(ctx, t):
        return t.redistribute(t.device_mesh, _whole_on_model(t))

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(g.device_mesh, _whole_on_model(g))


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose gradient is made contiguous: the backward of a
    head split views its gradient, which arrives transposed, and DTensor
    runs that view on the local block (the reshape of the forward becomes a
    view there), which fails on a non-contiguous block."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _whole_on_model(t) -> list:
    from torch.distributed.tensor import Replicate

    return [Replicate() if name == "model" else p
            for name, p in zip(t.device_mesh.mesh_dim_names, t.placements)]


def _heads_split(t, n: int) -> bool:
    """Whether ``n`` heads of the DTensor ``t`` divide its ``model`` ranks."""
    from torch.distributed.tensor import DTensor

    if not isinstance(t, DTensor):
        return True
    sizes = dict(zip(t.device_mesh.mesh_dim_names, t.device_mesh.shape))
    return n % sizes.get("model", 1) == 0


def split_heads(y: torch.Tensor, n: int, head_dim: int) -> torch.Tensor:
    """(B, T, n·head_dim) → (B, T, n, head_dim). On a mesh whose ``model``
    dimension does not divide the ``n`` heads, the projection is gathered
    over ``model`` first (forward and backward): a rank then holds every
    head, as GSPMD would (``ops.head_gather_needed``)."""
    from torch.distributed.tensor import DTensor

    b, t, _ = y.shape
    if not _heads_split(y, n):
        y = _OnModelWhole.apply(y)
    y = y.reshape(b, t, n, head_dim)
    return _ContiguousGrad.apply(y) if isinstance(y, DTensor) else y


def merge_heads(o: torch.Tensor) -> torch.Tensor:
    """(B, T, n, head_dim) → (B, T, n·head_dim), whole over ``model`` where
    its ranks do not divide the n heads (see :func:`split_heads`)."""
    from torch.distributed.tensor import DTensor

    b, t, n, d = o.shape
    if isinstance(o, DTensor):
        # DTensor runs the reshape as a view of the local block, which a
        # transposed block cannot take
        o = o.contiguous()
    y = o.reshape(b, t, n * d)
    return y if _heads_split(o, n) else _OnModelWhole.apply(y)


def _heads(params, cfg: AttnCfg, x: torch.Tensor, which: str, n: int) -> torch.Tensor:
    return split_heads(dense(params[f"w{which}"], x, params.get(f"b{which}")), n, cfg.head_dim)


def _qkv(params, cfg: AttnCfg, x: torch.Tensor, kv_x: torch.Tensor, positions: torch.Tensor):
    q = _heads(params, cfg, x, "q", cfg.n_heads)
    k = _heads(params, cfg, kv_x, "k", cfg.n_kv_heads)
    v = _heads(params, cfg, kv_x, "v", cfg.n_kv_heads)
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q)
        k = rmsnorm(params["k_norm"], k)
    if cfg.rope_theta is not None and not cfg.cross:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    # (B, H, T, Dh)
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


def _attend(params, cfg: AttnCfg, q, k, v, causal: bool, force):
    o = ops.attention(q, k, v, causal=causal, window=cfg.window, scale=cfg.scale,
                      logit_softcap=cfg.logit_softcap, matmul_dtype=cfg.matmul_dtype,
                      force=force)
    return dense(params["wo"], merge_heads(o.transpose(1, 2)))


def attn_train(params, cfg: AttnCfg, x: torch.Tensor, positions: torch.Tensor,
               memory: torch.Tensor | None = None, causal: bool = True, *, force=None):
    """x: (B, T, d). ``memory`` (B, Tm, d) switches to cross-attention.
    Returns (B, T, d)."""
    q, k, v = _qkv(params, cfg, x, memory if cfg.cross else x, positions)
    return _attend(params, cfg, q, k, v, causal and not cfg.cross, force)


def init_kv_cache(cfg: AttnCfg, batch: int, max_len: int, dtype=torch.bfloat16,
                  device=None) -> dict:
    shape = (batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _cache_write(cache: torch.Tensor, new: torch.Tensor, start: int) -> None:
    """``cache[:, :, start:start + T] = new`` in place. A DTensor cache (a
    decode state on a mesh) is written on each rank's local block: the
    positions of its own sequence range, ``new`` redistributed to the
    cache's placements on every dimension but the sequence, so a cache
    sharded on its sequence is written where it lies and not in a gathered
    copy."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    new = new.to(cache.dtype)
    if not isinstance(cache, DTensor):
        cache[:, :, start:start + new.shape[2]] = new
        return
    from repro_torch.distributed.sharding import local_shape_and_offset

    pls = tuple(Replicate() if isinstance(p, Shard) and p.dim == 2 else p
                for p in cache.placements)
    if not isinstance(new, DTensor):
        new = DTensor.from_local(new, cache.device_mesh, [Replicate()] * len(pls))
    block = new.redistribute(cache.device_mesh, pls).to_local()
    length, offset = local_shape_and_offset(cache.shape, cache.device_mesh, cache.placements)
    lo, hi = max(start, offset[2]), min(start + new.shape[2], offset[2] + length[2])
    if lo < hi:
        cache.to_local()[:, :, lo - offset[2]:hi - offset[2]] = block[:, :, lo - start:hi - start]


def attn_prefill(params, cfg: AttnCfg, x: torch.Tensor, positions: torch.Tensor,
                 cache: dict, memory: torch.Tensor | None = None, *, force=None):
    """Full-sequence attention that also writes cache[:, :, 0:T] in place
    (T the memory's length for cross-attention). Returns (out, cache)."""
    q, k, v = _qkv(params, cfg, x, memory if cfg.cross else x, positions)
    _cache_write(cache["k"], k, 0)
    _cache_write(cache["v"], v, 0)
    return _attend(params, cfg, q, k, v, not cfg.cross, force), cache


def attn_decode(params, cfg: AttnCfg, x: torch.Tensor, pos: int, cache: dict):
    """One-token step. x: (B, 1, d); pos: index of the new token.

    Self-attention writes the new K/V at ``pos`` in place, then attends over
    cache[0:pos+1]. Cross-attention attends over the whole cache (the
    encoder's K/V from the prefill) and writes nothing."""
    positions = torch.full((1,), int(pos), dtype=torch.int32, device=x.device)
    if cfg.cross:
        q = _heads(params, cfg, x, "q", cfg.n_heads)
        if cfg.qk_norm:
            q = rmsnorm(params["q_norm"], q)
        q = q.transpose(1, 2)                                      # (B, H, 1, Dh)
        cache_len = cache["k"].shape[2]
    else:
        q, k_new, v_new = _qkv(params, cfg, x, x, positions)       # (B, H, 1, Dh)
        _cache_write(cache["k"], k_new, int(pos))
        _cache_write(cache["v"], v_new, int(pos))
        cache_len = int(pos) + 1
    o = ops.decode_attention(
        q, cache["k"], cache["v"], cache_len, window=cfg.window, scale=cfg.scale,
        logit_softcap=cfg.logit_softcap, matmul_dtype=cfg.matmul_dtype)
    return dense(params["wo"], merge_heads(o.transpose(1, 2))), cache
