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
           "init_kv_cache"]


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


def _heads(params, cfg: AttnCfg, x: torch.Tensor, which: str, n: int) -> torch.Tensor:
    b, t, _ = x.shape
    return dense(params[f"w{which}"], x, params.get(f"b{which}")).reshape(b, t, n, cfg.head_dim)


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
    b, h, t, dh = o.shape
    return dense(params["wo"], o.transpose(1, 2).reshape(b, t, h * dh))


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


def attn_prefill(params, cfg: AttnCfg, x: torch.Tensor, positions: torch.Tensor,
                 cache: dict, memory: torch.Tensor | None = None, *, force=None):
    """Full-sequence attention that also writes cache[:, :, 0:T] in place
    (T the memory's length for cross-attention). Returns (out, cache)."""
    q, k, v = _qkv(params, cfg, x, memory if cfg.cross else x, positions)
    t = k.shape[2]
    cache["k"][:, :, :t] = k.to(cache["k"].dtype)
    cache["v"][:, :, :t] = v.to(cache["v"].dtype)
    return _attend(params, cfg, q, k, v, not cfg.cross, force), cache


def attn_decode(params, cfg: AttnCfg, x: torch.Tensor, pos: int, cache: dict):
    """One-token step. x: (B, 1, d); pos: index of the new token.

    Self-attention writes the new K/V at ``pos`` in place, then attends over
    cache[0:pos+1]. Cross-attention attends over the whole cache (the
    encoder's K/V from the prefill) and writes nothing."""
    b = x.shape[0]
    positions = torch.full((1,), int(pos), dtype=torch.int32, device=x.device)
    if cfg.cross:
        q = _heads(params, cfg, x, "q", cfg.n_heads)
        if cfg.qk_norm:
            q = rmsnorm(params["q_norm"], q)
        q = q.transpose(1, 2)                                      # (B, H, 1, Dh)
        cache_len = cache["k"].shape[2]
    else:
        q, k_new, v_new = _qkv(params, cfg, x, x, positions)       # (B, H, 1, Dh)
        cache["k"][:, :, pos:pos + 1] = k_new.to(cache["k"].dtype)
        cache["v"][:, :, pos:pos + 1] = v_new.to(cache["v"].dtype)
        cache_len = int(pos) + 1
    o = ops.decode_attention(
        q, cache["k"], cache["v"], cache_len, window=cfg.window, scale=cfg.scale,
        logit_softcap=cfg.logit_softcap, matmul_dtype=cfg.matmul_dtype)
    return dense(params["wo"], o.transpose(1, 2).reshape(b, 1, cfg.n_heads * cfg.head_dim)), cache
