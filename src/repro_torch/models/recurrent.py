"""Recurrent blocks: Griffin RG-LRU (RecurrentGemma) and RWKV-6 time/channel mix.

The port of the JAX package's ``models/recurrent.py``. Both blocks have one
path for a whole sequence (prefill) and for one token (decode, T=1), the
recurrent state carried between calls; the recurrences go through
``ops.rglru`` / ``ops.rwkv6`` (the CUDA kernels on the card). ``force`` is
passed through to ``ops``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.attention import merge_heads, split_heads
from repro_torch.models.layers import Init, causal_conv1d, dense, gathered

__all__ = [
    "init_rglru_block", "rglru_block_apply", "init_rglru_state",
    "init_rwkv_block", "rwkv_time_mix", "rwkv_channel_mix", "init_rwkv_state",
]


# ---------------------------------------------------------------------------
# Griffin / RecurrentGemma recurrent block
# ---------------------------------------------------------------------------

def init_rglru_block(init: Init, d: int, lru_width: int, conv_width: int = 4) -> dict:
    return {
        "w_x": init.normal((d, lru_width)),
        "w_y": init.normal((d, lru_width)),
        "conv_w": init.normal((conv_width, lru_width), stddev=conv_width ** -0.5),
        "ig_w": init.normal((lru_width, lru_width)),
        "rg_w": init.normal((lru_width, lru_width)),
        "a_param": init.full((lru_width,), 0.7),
        "w_out": init.normal((lru_width, d)),
    }


def init_rglru_state(d_lru: int, batch: int, conv_width: int = 4,
                     dtype=torch.float32, device=None) -> dict:
    return {
        "conv": torch.zeros((batch, conv_width - 1, d_lru), dtype=dtype, device=device),
        "h": torch.zeros((batch, d_lru), dtype=torch.float32, device=device),
    }


def rglru_block_apply(params, x: torch.Tensor, state: dict | None = None, *, force=None):
    """x: (B, T, d), already normed. Returns (out, new_state)."""
    gate = F.gelu(dense(params["w_y"], x), approximate="tanh")
    u = dense(params["w_x"], x)
    conv_state = None if state is None else state["conv"]
    u, new_conv = causal_conv1d(params["conv_w"], u, conv_state)
    ig = dense(params["ig_w"], u)
    rg = dense(params["rg_w"], u)
    h0 = None if state is None else state["h"]
    h, h_last = ops.rglru(u, ig, rg, params["a_param"], h0, force=force)
    out = dense(params["w_out"], h * gate)
    return out, {"conv": new_conv, "h": h_last}


# ---------------------------------------------------------------------------
# RWKV-6 (Finch)
# ---------------------------------------------------------------------------

def init_rwkv_block(init: Init, d: int, d_ff: int, head_size: int = 64,
                    decay_lora: int = 64) -> dict:
    n_heads = d // head_size
    return {
        "tmix": {
            "mu_r": init.zeros((d,)), "mu_k": init.zeros((d,)),
            "mu_v": init.zeros((d,)), "mu_g": init.zeros((d,)),
            "mu_w": init.zeros((d,)),
            "w0": init.full((d,), -6.0),
            "w_lora_a": init.normal((d, decay_lora)),
            "w_lora_b": init.normal((decay_lora, d), stddev=0.01),
            "wr": init.normal((d, d)), "wk": init.normal((d, d)),
            "wv": init.normal((d, d)), "wg": init.normal((d, d)),
            "wo": init.normal((d, d)),
            "u": init.zeros((n_heads, head_size)),
            "ln_x": {"scale": init.ones((d,)), "bias": init.zeros((d,))},
        },
        "cmix": {
            "mu_k": init.zeros((d,)), "mu_r": init.zeros((d,)),
            "wk": init.normal((d, d_ff)),
            "wv": init.normal((d_ff, d)),
            "wr": init.normal((d, d)),
        },
    }


def init_rwkv_state(d: int, batch: int, head_size: int = 64, dtype=torch.float32,
                    device=None) -> dict:
    n_heads = d // head_size
    return {
        "tshift": torch.zeros((batch, 1, d), dtype=dtype, device=device),
        "cshift": torch.zeros((batch, 1, d), dtype=dtype, device=device),
        "wkv": torch.zeros((batch, n_heads, head_size, head_size), dtype=torch.float32,
                           device=device),
    }


def _token_shift(x: torch.Tensor, prev: torch.Tensor | None):
    """The x_{t-1} stream: (B, T, d) with ``prev`` the last token of the
    previous chunk. Returns (shifted, new prev)."""
    b, t, d = x.shape
    if prev is None:
        prev = torch.zeros((b, 1, d), dtype=x.dtype, device=x.device)
    return torch.cat([prev.to(x.dtype), x[:, :-1]], dim=1), x[:, -1:].clone()


def _time_mix(p, x: torch.Tensor, shift_prev, wkv_state, head_size: int, force):
    b, t, d = x.shape
    h = d // head_size
    x_prev, new_shift = _token_shift(x, shift_prev)
    delta = x_prev - x

    def mixed(name):
        return x + delta * p[f"mu_{name}"].to(x.dtype)

    def heads(y):
        return split_heads(y, h, head_size).transpose(1, 2)

    r = heads(dense(p["wr"], mixed("r")))
    k = heads(dense(p["wk"], mixed("k")))
    v = heads(dense(p["wv"], mixed("v")))
    g = F.silu(dense(p["wg"], mixed("g")))
    # Finch's data-dependent decay through a low-rank adapter, in float32
    xw = mixed("w").float()
    w = (p["w0"].float()
         + torch.tanh(xw @ gathered(p["w_lora_a"]).float()) @ gathered(p["w_lora_b"]).float())
    y, s_last = ops.rwkv6(r, k, v, heads(w), p["u"], wkv_state, force=force)
    # per-head group norm (RWKV's ln_x)
    yf = y.transpose(1, 2).float()                                # (B, T, H, hs)
    mu = yf.mean(-1, keepdim=True)
    var = ((yf - mu) ** 2).mean(-1, keepdim=True)
    yf = merge_heads((yf - mu) * torch.rsqrt(var + 1e-5))
    y = (yf * p["ln_x"]["scale"] + p["ln_x"]["bias"]).to(x.dtype)
    return dense(p["wo"], y * g), new_shift, s_last


def _channel_mix(p, x: torch.Tensor, shift_prev):
    x_prev, new_shift = _token_shift(x, shift_prev)
    delta = x_prev - x
    xk = x + delta * p["mu_k"].to(x.dtype)
    xr = x + delta * p["mu_r"].to(x.dtype)
    k = torch.square(F.relu(dense(p["wk"], xk)))
    return torch.sigmoid(dense(p["wr"], xr)) * dense(p["wv"], k), new_shift


def rwkv_time_mix(params, x_normed: torch.Tensor, state: dict | None,
                  head_size: int = 64, *, force=None):
    """Time-mix half. Returns (out, {"tshift", "wkv"} partial state)."""
    st = state or {}
    out, new_shift, wkv = _time_mix(params["tmix"], x_normed, st.get("tshift"),
                                    st.get("wkv"), head_size, force)
    return out, {"tshift": new_shift, "wkv": wkv}


def rwkv_channel_mix(params, x_normed: torch.Tensor, state: dict | None):
    """Channel-mix half. Returns (out, {"cshift"} partial state)."""
    st = state or {}
    out, new_shift = _channel_mix(params["cmix"], x_normed, st.get("cshift"))
    return out, {"cshift": new_shift}
