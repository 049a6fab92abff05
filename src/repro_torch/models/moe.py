"""Mixture-of-Experts FFN with capacity-based sorted dispatch.

The port of the JAX package's ``models/moe.py``, which runs outside any
Pallas kernel: a router, a stable sort of the token slots by expert, a
dense (E, capacity, d) buffer gathered from the tokens, the expert products
as batched matmuls, and a weighted combine back to token order. Slots whose
rank in their expert's group reaches the capacity are dropped (Switch-style
token dropping; ``capacity_factor`` sets the rate), as in the reference:
  * ``torch.argsort(..., stable=True)``, as ``jnp.argsort`` is stable, so the
    same slots are dropped;
  * the reference's ``.at[...].set(..., mode="drop")`` drops out-of-range
    slots silently where PyTorch raises, so the overflow slots are sent to
    one spare entry of the tables, which is sliced off;
  * the expert products run in the compute dtype with float32 accumulation,
    rounded once, as ``_expert_einsum``;
  * the combine is the reference's float32 scatter-add of each kept slot's
    weighted output into its token, computed as a gather: every token reads
    its ``top_k`` slots (a dropped slot reads a zero row) and sums them in
    float32, with no atomics, so a rerun on the card gives the same bits.

On a device mesh (DTensor inputs) the dispatch runs under
``torch.distributed.tensor.experimental.local_map`` with the experts
sharded on ``model``, the reference's MoE rule ``P("tp", f, None)``
(expert parallelism): DTensor has no sharding rule for the stable
``argsort`` and the gathers of the dispatch. Every rank routes ALL the
step's tokens (gathered over the data dimension, so the capacity and the
dropped slots are the reference's, which sorts the global batch), keeps
the slots of its own experts, and returns its experts' share of each
token's combine: the output is a partial sum over ``model``, which the
next product reduces. Where the experts do not divide ``model`` they are
gathered and every rank computes the whole layer. The dense residual
branch (Arctic) runs outside, as any FFN on the mesh.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import Init, dense, ffn_apply, init_ffn

__all__ = ["init_moe", "moe_apply", "aux_load_balance_loss"]


def init_moe(init: Init, d: int, n_experts: int, d_ff: int, *,
             act: str = "swiglu", dense_residual_ff: int = 0) -> dict:
    p = {
        "router": init.normal((d, n_experts)),
        "w_gate": init.normal((n_experts, d, d_ff)),
        "w_up": init.normal((n_experts, d, d_ff)),
        "w_down": init.normal((n_experts, d_ff, d), stddev=d_ff ** -0.5),
    }
    if dense_residual_ff:
        p["dense"] = init_ffn(init, d, dense_residual_ff, act)
    return p


def _expert_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(E, C, i) x (E, i, o) in a's dtype, float32 accumulation."""
    return torch.matmul(a, b.to(a.dtype))


def capacity(n_tokens: int, top_k: int, capacity_factor: float, n_experts: int) -> int:
    """Slots per expert, computed on the host as the reference does."""
    n_slots = n_tokens * top_k
    return max(8, int(-(-n_slots * capacity_factor // n_experts)))


def moe_apply(params, x: torch.Tensor, *, top_k: int, capacity_factor: float = 1.25,
              act: str = "swiglu") -> torch.Tensor:
    """x: (B, S, d) → (B, S, d). See the module docstring for the dispatch."""
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        y = _moe_on_mesh(params, x, top_k=top_k, capacity_factor=capacity_factor, act=act)
    else:
        y = _dispatch(params["router"], params["w_gate"], params["w_up"], params["w_down"],
                      x, top_k=top_k, capacity_factor=capacity_factor, act=act)
    if "dense" in params:   # Arctic-style parallel dense residual branch
        y = y + ffn_apply(params["dense"], x, act)
    return y


def _moe_on_mesh(params, x, *, top_k, capacity_factor, act):
    """The dispatch on each rank's experts (module docstring)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = x.device_mesh
    e = params["router"].shape[1]
    ep = [n for name, n in zip(mesh.mesh_dim_names, mesh.shape) if name == "model"]
    ep = ep[0] if ep and e % ep[0] == 0 else 1
    whole = [Replicate()] * mesh.ndim
    experts = [Shard(0) if name == "model" and ep > 1 else Replicate()
               for name in mesh.mesh_dim_names]
    # a rank's output, and its gradient of the router and of the tokens,
    # come from its own experts' slots: sums over ``model``
    out = [Partial() if name == "model" and ep > 1 else Replicate()
           for name in mesh.mesh_dim_names]

    def local(router, w_gate, w_up, w_down, xx):
        lo = (mesh.get_local_rank("model") if ep > 1 else 0) * (e // ep)
        return _dispatch(router, w_gate, w_up, w_down, xx, top_k=top_k,
                         capacity_factor=capacity_factor, act=act, expert_lo=lo,
                         out_dtype=torch.float32)

    y = local_map(local, out_placements=out,
                  in_placements=(whole, experts, experts, experts, whole),
                  in_grad_placements=(out, experts, experts, experts, out),
                  redistribute_inputs=True)(
        params["router"], params["w_gate"], params["w_up"], params["w_down"], x)
    # the ranks' float32 shares summed, then rounded once, as off the mesh
    return y.redistribute(mesh, whole).to(x.dtype)


def _dispatch(router, w_gate, w_up, w_down, x: torch.Tensor, *, top_k: int,
              capacity_factor: float, act: str, expert_lo: int = 0,
              out_dtype=None) -> torch.Tensor:
    """The routed experts' output for every token of ``x`` (B, S, d), from
    the experts ``expert_lo .. expert_lo + len(w_gate)`` alone (all of them
    off the mesh): the slots of other experts add nothing. The float32 sum
    is rounded to ``out_dtype`` (default: ``x``'s)."""
    b, s, d = x.shape
    e = router.shape[1]
    n_local = w_up.shape[0]
    t = b * s
    xt = x.reshape(t, d)
    dev = x.device

    logits = dense(router, xt).float()                                # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, top_k, dim=-1)                   # (T, k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    # -- sorted capacity dispatch ---------------------------------------
    n_slots = t * top_k
    cap = capacity(t, top_k, capacity_factor, e)
    slot_expert = top_e.reshape(-1)                                   # (T·k,)
    order = torch.argsort(slot_expert, stable=True)
    sorted_expert = slot_expert[order]
    counts = torch.zeros(e, dtype=torch.long, device=dev).scatter_add_(
        0, slot_expert, torch.ones_like(slot_expert))                 # a bincount
    starts = torch.cumsum(counts, 0) - counts
    pos_in_grp = torch.arange(n_slots, device=dev) - starts[sorted_expert]
    # each sorted slot's cell of the flat (E·cap) table; overflow → spare cell
    cell = torch.where(pos_in_grp < cap, sorted_expert * cap + pos_in_grp, e * cap)
    table = torch.full((e * cap + 1,), t, dtype=torch.long, device=dev).scatter(
        0, cell, order // top_k)[:-1].view(e, cap)

    # -- expert FFN over this rank's (E_local, cap, d) --------------------
    table = table[expert_lo:expert_lo + n_local]
    x_pad = torch.cat([xt, xt.new_zeros((1, d))])
    xe = x_pad[table]                                                 # (E_l, C, d)
    if act in ("swiglu", "geglu"):
        fn = F.silu if act == "swiglu" else (lambda v: F.gelu(v, approximate="tanh"))
        h = fn(_expert_matmul(xe, w_gate)) * _expert_matmul(xe, w_up)
    else:
        h = F.gelu(_expert_matmul(xe, w_up), approximate="tanh")
    out = _expert_matmul(h, w_down)                                   # (E_l, C, d)

    # -- weighted combine back to token order ----------------------------
    # slot_cell[i]: the table cell of slot i (token i // k, choice i % k),
    # counted from this rank's first expert; another rank's cell → spare
    slot_cell = torch.empty_like(cell).scatter_(0, order, cell) - expert_lo * cap
    mine = (slot_cell >= 0) & (slot_cell < n_local * cap)
    slot_cell = torch.where(mine, slot_cell, n_local * cap)
    out_pad = torch.cat([out.reshape(n_local * cap, d), out.new_zeros((1, d))])
    weight = torch.where(mine, top_p.reshape(-1), 0.0)
    y = (out_pad[slot_cell].float() * weight[:, None]).view(t, top_k, d).sum(1)
    return y.to(out_dtype or x.dtype).reshape(b, s, d)


def aux_load_balance_loss(router_probs: torch.Tensor, top_e: torch.Tensor,
                          n_experts: int) -> torch.Tensor:
    """Switch-style auxiliary loss: E · Σ_e f_e · P_e."""
    frac_tokens = torch.mean(F.one_hot(top_e[..., 0], n_experts).float(), dim=0)
    frac_probs = torch.mean(router_probs.float(), dim=0)
    return n_experts * torch.sum(frac_tokens * frac_probs)
