"""Shared neural building blocks for the LM stack.

Ports of the JAX package's ``models/layers.py``: plain functions on tensors
and parameter dictionaries (a dict, or a :class:`ParamTree` that reads like
one). Products run in the model's compute dtype (bf16 on the card) with
float32 accumulation; norms and recurrences accumulate in float32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
    "Init",
    "ParamTree",
    "gathered",
    "rmsnorm",
    "layernorm",
    "dense",
    "mesh_matmul",
    "multi_rank",
    "ffn_apply",
    "init_ffn",
    "rope",
    "causal_conv1d",
    "init_norm",
]


class Init:
    """Seeded initializer: every tensor is drawn from one CPU
    ``torch.Generator``, moved to ``device`` right away and stored in
    ``dtype``, so one seed gives the same weights on every device (PyTorch's
    CPU and CUDA generators are different algorithms) and the host holds one
    tensor at a time. The draws are PyTorch's, not ``jax.random``'s: weights
    carried from the JAX package go through
    ``transformer.params_from_reference`` instead. On the ``meta`` device
    nothing is drawn or allocated: the tensors carry shapes and dtypes
    only."""

    def __init__(self, generator: torch.Generator, dtype=torch.float32, device=None):
        self.generator = generator
        self.dtype = dtype
        self.device = torch.device(device) if device is not None else generator.device

    def normal(self, shape, stddev: float | None = None) -> torch.Tensor:
        if self.device.type == "meta":
            return torch.empty(shape, dtype=self.dtype, device="meta")
        std = stddev if stddev is not None else shape[0] ** -0.5
        # bound for the card, drawn into pinned memory: its copy runs while
        # the next tensor is drawn, and the scaling (float32, exact on
        # either device) runs there
        x = torch.randn(shape, generator=self.generator, dtype=torch.float32,
                        pin_memory=self.device.type == "cuda")
        return x.to(self.device, non_blocking=True).mul_(std).to(self.dtype)

    def zeros(self, shape) -> torch.Tensor:
        return torch.zeros(shape, dtype=self.dtype, device=self.device)

    def ones(self, shape) -> torch.Tensor:
        return torch.ones(shape, dtype=self.dtype, device=self.device)

    def full(self, shape, value: float) -> torch.Tensor:
        return torch.full(shape, value, dtype=self.dtype, device=self.device)


class ParamTree(nn.Module):
    """A nested dict of tensors as an ``nn.Module``: every leaf a frozen
    ``nn.Parameter``, every sub-dict a child ``ParamTree``, with the same
    keys. ``tree["wq"]`` and ``tree.get("bq")`` read it like the JAX
    package's parameter dict; ``.to(device)`` and ``state_dict`` work."""

    def __init__(self, tree: dict):
        super().__init__()
        for key, value in tree.items():
            if isinstance(value, dict):
                self.add_module(key, ParamTree(value))
            else:
                self.register_parameter(key, nn.Parameter(value, requires_grad=False))

    def __getitem__(self, key: str):
        try:
            return getattr(self, key)
        except AttributeError:
            raise KeyError(key) from None

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules

    def get(self, key: str, default=None):
        return self[key] if key in self else default


def init_norm(init: Init, d: int, kind: str = "rmsnorm") -> dict:
    if kind == "rmsnorm":
        return {"scale": init.zeros((d,))}       # gemma convention: (1 + scale)
    return {"scale": init.ones((d,)), "bias": init.zeros((d,))}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * (1.0 + params["scale"].float())).to(x.dtype)


def layernorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    normed = (xf - mu) * torch.rsqrt(var + eps)
    out = normed * params["scale"].float() + params["bias"].float()
    return out.to(x.dtype)


def gathered(w: torch.Tensor) -> torch.Tensor:
    """A weight as a product uses it: on a mesh, a DTensor sharded over a
    data dimension (FSDP) is gathered there first, keeping its ``model``
    sharding; its gradient is reduce-scattered back (the backward of the
    gather). Left to DTensor, the product may move the activations instead,
    which on a large batch or vocabulary costs far more. Anything else is
    returned as it is."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(w, DTensor):
        return w
    names = w.device_mesh.mesh_dim_names
    pls = [Replicate() if name != "model" and isinstance(p, Shard) else p
           for name, p in zip(names, w.placements)]
    return w if list(w.placements) == pls else w.redistribute(w.device_mesh, pls)


def _reduced(t: torch.Tensor) -> torch.Tensor:
    """A DTensor with its partial sums reduced (an all-reduce in t's dtype)."""
    from torch.distributed.tensor import Replicate

    pls = [Replicate() if p.is_partial() else p for p in t.placements]
    return t if list(t.placements) == pls else t.redistribute(t.device_mesh, pls)


class _MeshProduct(torch.autograd.Function):
    """x @ w for DTensors on a mesh of more than one rank, forward and
    backward, as the JAX package's ``preferred_element_type=float32``
    product is partitioned: float32 products of the operands' values, each
    rank's partial sums all-reduced in float32, one rounding to ``out_dtype``
    (the gradients: to their operand's dtype) after the reduction. Left to
    DTensor, a bf16 product rounds each rank's partial sum to bf16 before
    the all-reduce (the row-parallel output, the column-parallel input
    gradient, the data-parallel weight gradient), and a float32 product of
    upcast operands rounds its input gradient's partial sums when the
    upcast's backward casts them down. The operands are saved in their own
    dtype."""

    @staticmethod
    def forward(ctx, x, w, out_dtype):
        ctx.save_for_backward(x, w)
        return _reduced(torch.matmul(x.float(), w.float())).to(out_dtype)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.float()
        gx = _reduced(torch.matmul(g, w.float().T)).to(x.dtype)
        gw = torch.matmul(x.float().reshape(-1, x.shape[-1]).T, g.reshape(-1, g.shape[-1]))
        return gx, _reduced(gw).to(w.dtype), None


def multi_rank(t: torch.Tensor) -> bool:
    """Whether ``t`` is a DTensor on a mesh of more than one rank."""
    return getattr(t, "device_mesh", None) is not None and t.device_mesh.size() > 1


def mesh_matmul(x: torch.Tensor, w: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """x @ w for DTensors on a mesh of more than one rank, every sum in
    float32 and the result rounded once to ``out_dtype``
    (:class:`_MeshProduct`)."""
    return _MeshProduct.apply(x, w, out_dtype)


def dense(w: torch.Tensor, x: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """x @ w in x's dtype: the weight is cast to it on every call (float32
    parameters become bf16 operands, as the JAX package does), the products
    and their sums are float32 and the result is rounded to x's dtype once.
    On the card that is cuBLAS's bf16 product; on the CPU it is a float32
    product of the operands' values, since the CPU's bf16 product sums in
    another order than its float32 one and a mesh's products are float32
    (:func:`mesh_matmul`): so a CPU mesh run matches one CPU device. On a
    mesh an FSDP-sharded weight is gathered first (:func:`gathered`), and on
    a mesh of more than one rank the cross-rank sums are float32 too."""
    w = gathered(w).to(x.dtype)
    if multi_rank(w):
        y = mesh_matmul(x, w, x.dtype)
    elif x.device.type == "cpu":
        y = torch.matmul(x.float(), w.float()).to(x.dtype)
    else:
        y = torch.matmul(x, w)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def _gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


_ACTS = {"silu": F.silu, "gelu": _gelu_tanh, "relu": F.relu}


def init_ffn(init: Init, d: int, d_ff: int, act: str = "swiglu") -> dict:
    if act in ("swiglu", "geglu"):
        return {
            "w_gate": init.normal((d, d_ff)),
            "w_up": init.normal((d, d_ff)),
            "w_down": init.normal((d_ff, d)),
        }
    return {"w_up": init.normal((d, d_ff)), "w_down": init.normal((d_ff, d))}


def ffn_apply(params, x: torch.Tensor, act: str = "swiglu") -> torch.Tensor:
    if act in ("swiglu", "geglu"):
        fn = _ACTS["silu"] if act == "swiglu" else _ACTS["gelu"]
        h = fn(dense(params["w_gate"], x)) * dense(params["w_up"], x)
    else:
        h = _ACTS[act](dense(params["w_up"], x))
    return dense(params["w_down"], h)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding on split halves. x: (B, T, H, Dh) with Dh even;
    positions: (T,)."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    angles = positions.to(torch.float32)[:, None, None] * freqs      # (T, 1, Dh/2)
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = torch.split(x.float(), half, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def causal_conv1d(w: torch.Tensor, x: torch.Tensor, state: torch.Tensor | None = None):
    """Depthwise causal conv. w: (width, D); x: (B, T, D); state: (B,
    width-1, D), the last inputs of the previous chunk. Returns (y,
    new_state); the RecurrentGemma temporal-conv branch."""
    width = w.shape[0]
    b, t, d = x.shape
    if state is None:
        state = torch.zeros((b, width - 1, d), dtype=x.dtype, device=x.device)
    xx = torch.cat([state.to(x.dtype), x], dim=1)                 # (B, T+w-1, D)
    y = torch.zeros((b, t, d), dtype=torch.float32, device=x.device)
    wf = w.float()
    for i in range(width):
        y = y + xx[:, i:i + t].float() * wf[i]
    new_state = xx[:, -(width - 1):].clone() if width > 1 else state
    return y.to(x.dtype), new_state
