"""GPipe-style pipeline parallelism over the ``stage`` axis of a
``torch.distributed`` device mesh.

The port of the JAX package's ``distributed/pipeline.py``. An optional
policy (the default production layout is DP × TP(+EP)):

  * layer stacks are split into S contiguous STAGES; stage s's weights live
    on the ranks at index s of the ``stage`` axis, and each rank holds only
    its own stage's;
  * a batch is split into M microbatches; microbatch m enters stage 0, and
    activations hop stage → stage around the ring, one point-to-point send
    to the next rank and one receive from the previous one a tick (no
    all-to-all);
  * the classic GPipe schedule runs S + M − 1 ticks; bubble fraction
    (S − 1)/(S + M − 1), reported by :func:`bubble_fraction`.

Every rank runs the same tick loop on the whole input (replicated, as the
reference replicates the microbatches to every stage) and returns the last
stage's output, broadcast from the last stage's rank.

Differentiable, as the reference's ``ppermute`` ring is. Each hop is an
autograd Function whose backward is the reverse hop (the transpose of a
permutation is its inverse): the gradient goes to the previous rank and
the next rank's comes back. Every hop stays on every rank's graph (stage
0 drops the activation it received through ``torch.where``, as the
reference does with ``jnp.where``), so every rank runs every hop's
backward, from the last tick to the first, in one order. Gradients follow
DTensor's convention for a replicated tensor:

  * the output is replicated: every rank computes the same loss of it,
    and the backward hands the last stage its own copy's cotangent, once
    (the other ranks' copies give none), as ``jax.grad`` counts the
    reference's closing ``psum`` once;
  * ``x`` and the plain stage-stacked leaves are replicated inputs: each
    rank computes only its part of their gradient (stage 0's ``x``, row s
    of a leaf), and the parts are summed over the stage axis, so every rank
    holds the whole gradient ``jax.grad`` returns;
  * a DTensor leaf's gradient is a DTensor of its placements: each rank
    holds its own stage's block, with no collective.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

__all__ = ["pipeline_apply", "bubble_fraction", "stage_params_sharding"]


def bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    return (n_stages - 1) / (n_stages + n_microbatches - 1)


def stage_params_sharding(mesh, params_tree: Any, stage_axis: str = "stage") -> Any:
    """The DTensor placements of stage-stacked params (leading dim =
    n_stages) sharded one stage per index of ``stage_axis``: dim 0 sharded
    over that axis, replicated over every other axis of ``mesh``."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.train.optimizer import tree_map

    names = tuple(mesh.mesh_dim_names)
    if stage_axis not in names:
        raise ValueError(f"mesh axes {names} have no {stage_axis!r} axis")
    placements = tuple(Shard(0) if n == stage_axis else Replicate() for n in names)
    return tree_map(lambda _leaf: placements, params_tree)


def _stage_block(leaf: torch.Tensor, n_stages: int) -> tuple[torch.Tensor, bool]:
    """The tensor that holds this rank's stage of a stage-stacked leaf, and
    whether it is a plain (replicated) one: a DTensor sharded by
    :func:`stage_params_sharding` gives its one local block, of which the
    stage is row 0; a plain tensor is itself, of which stage s is row s."""
    from torch.distributed.tensor import DTensor

    if isinstance(leaf, DTensor):
        local = leaf.to_local()
        if leaf.shape[0] != n_stages or local.shape[0] != 1:
            raise ValueError(f"a stage-stacked DTensor of shape {tuple(leaf.shape)} holds "
                             f"{local.shape[0]} stages on this rank, one was expected")
        return local, False
    if leaf.shape[0] != n_stages:
        raise ValueError(f"a stage-stacked leaf leads with {leaf.shape[0]}, not the "
                         f"{n_stages} stages")
    return leaf, True


def _staged(x: torch.Tensor, group) -> torch.Tensor:
    """A fresh contiguous copy of ``x`` for a collective of ``group``: gloo
    takes host tensors only, so a CUDA tensor's copy is in pinned host
    memory there (``.to(x.device)`` brings the result back)."""
    import torch.distributed as dist

    pin = x.is_cuda and dist.get_backend(group) == "gloo"
    return torch.empty(x.shape, dtype=x.dtype, device="cpu" if pin else x.device,
                       pin_memory=pin).copy_(x)


def _summed(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``'s ranks, on ``x``'s device."""
    import torch.distributed as dist

    host = _staged(x, group)
    dist.all_reduce(host, group=group)
    return host.to(x.device)


def _ring_hop(buf: torch.Tensor, nxt: int, prv: int, group, host) -> torch.Tensor:
    """Send ``buf`` to rank ``nxt`` and receive the previous rank's
    (``prv``) in one ``batch_isend_irecv``. ``host``: the pinned (send,
    receive) buffers of ``buf``'s shape that a CUDA tensor is staged through
    on gloo, made once a call; None to send ``buf`` itself."""
    import torch.distributed as dist

    if host is None:
        src = buf.contiguous()
        got = torch.empty_like(src)
    else:
        src, got = host
        src.copy_(buf)
    for work in dist.batch_isend_irecv([dist.P2POp(dist.isend, src, nxt, group),
                                        dist.P2POp(dist.irecv, got, prv, group)]):
        work.wait()
    return got if host is None else got.to(buf.device)


class _RingHop(torch.autograd.Function):
    """One tick's hop, :func:`_ring_hop`; its backward is the reverse hop:
    the gradient of what came from ``prv`` goes back to ``prv``, and the
    gradient of what went to ``nxt`` comes back from ``nxt``."""

    @staticmethod
    def forward(ctx, buf, nxt, prv, group, host):
        ctx.reverse = (prv, nxt, group, host)
        return _ring_hop(buf, nxt, prv, group, host)

    @staticmethod
    def backward(ctx, grad):
        return _ring_hop(grad, *ctx.reverse), None, None, None, None


class _Entry(torch.autograd.Function):
    """The pipeline's inputs passed on: ``x``, a zero first activation of
    shape ``mb_shape`` and the stage leaves' blocks (:func:`_stage_block`).
    The zero activation makes every hop of a differentiated call a node of
    the graph on every rank, whatever its stage's parameters require. The
    backward sums the gradients of the replicated inputs over ``group``
    (the plain blocks in tree order, then ``x``: one order on every rank)
    and passes a DTensor's block's gradient on as it is."""

    @staticmethod
    def forward(ctx, group, plain, mb_shape, x, *blocks):
        ctx.group, ctx.plain = group, plain
        return (x.view_as(x), x.new_zeros(mb_shape)) + tuple(b.view_as(b) for b in blocks)

    @staticmethod
    def backward(ctx, gx, _gbuf, *gblocks):
        def total(g, replicated):
            return _summed(g, ctx.group) if replicated and ctx.group.size() > 1 else g

        need = ctx.needs_input_grad
        gblocks = [total(g, p) if n else None for g, p, n in zip(gblocks, ctx.plain, need[4:])]
        gx = total(gx, True) if need[3] else None
        return (None, None, None, gx, *gblocks)


class _Broadcast(torch.autograd.Function):
    """The last stage's ``outs`` broadcast from rank ``src`` to every rank
    of ``group``. ``buf``, this rank's last activation, is taken only so
    that the last hop stays on every rank's graph. Backward: the output is
    replicated, so the last stage (``last``) takes its own copy's
    cotangent and every other rank's ``outs`` a zero."""

    @staticmethod
    def forward(ctx, outs, buf, src, group, last):
        import torch.distributed as dist

        ctx.last = last
        host = _staged(outs, group)
        dist.broadcast(host, src=src, group=group)
        return host.to(outs.device)

    @staticmethod
    def backward(ctx, grad):
        return grad if ctx.last else torch.zeros_like(grad), None, None, None, None


def _tree_rebuilt(tree: Any, leaves) -> Any:
    """``tree`` with its leaves taken in turn from the iterator ``leaves``,
    in ``tree_leaves``' order (dict keys sorted)."""
    if isinstance(tree, dict):
        return {k: _tree_rebuilt(tree[k], leaves) for k in sorted(tree)}
    return next(leaves)


def pipeline_apply(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stage_params: Any,
    x: torch.Tensor,
    mesh,
    n_microbatches: int,
    stage_axis: str = "stage",
) -> torch.Tensor:
    """Run ``stage_fn`` S times over x through the pipeline.

    ``mesh``: a ``torch.distributed`` device mesh (``launch.mesh.
    compat_make_mesh``) with a ``stage_axis`` of S ranks; every rank of the
    mesh calls this with the same ``x`` and ``stage_params``, with the same
    ``requires_grad``. ``stage_params``: a dict tree whose leaves lead with
    the stage dim (S): DTensors placed by :func:`stage_params_sharding`, or
    plain tensors of which rank ``s`` takes ``leaf[s]``. ``x``: the
    (batch, ...) global batch; batch % n_microbatches == 0. Returns
    stage_{S-1}(…stage_0(x)) on every rank, with GPipe scheduling.

    Differentiable in ``x`` and ``stage_params`` (not in tensors that
    ``stage_fn`` closes over): every rank computes the same loss of the
    output and runs its backward; each then holds ``jax.grad``'s gradient
    of ``x`` and of the plain leaves, and its own stage's block of a
    DTensor leaf's (see the module docstring)."""
    import torch.distributed as dist

    from repro_torch.train.optimizer import tree_leaves

    names = tuple(mesh.mesh_dim_names)
    n_stages = mesh.size(names.index(stage_axis))
    b = x.shape[0]
    if b % n_microbatches:
        raise ValueError(f"batch {b} not divisible into {n_microbatches} microbatches")
    mb = b // n_microbatches
    group = mesh.get_group(stage_axis)
    sid = mesh.get_local_rank(stage_axis)
    ranks = dist.get_process_group_ranks(group)      # global ranks, in stage order
    own = [_stage_block(leaf, n_stages) for leaf in tree_leaves(stage_params)]
    plain = tuple(p for _, p in own)
    x, buf, *blocks = _Entry.apply(group, plain, (mb,) + tuple(x.shape[1:]), x,
                                   *(blk for blk, _ in own))
    params = _tree_rebuilt(stage_params, (blk[sid] if p else blk[0]
                                          for blk, p in zip(blocks, plain)))
    xs = x.reshape((n_microbatches, mb) + tuple(x.shape[1:]))
    tracked = buf.requires_grad

    n_ticks = n_stages + n_microbatches - 1
    host = (tuple(torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True) for _ in range(2))
            if n_stages > 1 and buf.is_cuda and dist.get_backend(group) == "gloo" else None)
    ingest = torch.ones((), dtype=torch.bool, device=buf.device)
    outs = torch.zeros_like(xs)
    untracked_grad = False
    for t in range(n_ticks):
        if sid == 0 and t < n_microbatches:          # stage 0 ingests microbatch t
            buf = torch.where(ingest, xs[t], buf)    # (the hop's buf stays on the graph)
        if 0 <= t - sid < n_microbatches:            # stage s works on microbatch t − s
            buf = stage_fn(params, buf)
            untracked_grad |= buf.requires_grad and not tracked
        if sid == n_stages - 1 and t >= n_stages - 1:  # the last stage emits
            outs[t - (n_stages - 1)] = buf
        if n_stages > 1 and t < n_ticks - 1:         # rotate one stage forward
            buf = _RingHop.apply(buf, ranks[(sid + 1) % n_stages],
                                 ranks[(sid - 1) % n_stages], group, host)
    # only the last stage's outs are real: broadcast them to every stage
    if n_stages > 1:
        outs = _Broadcast.apply(outs, buf, ranks[-1], group, sid == n_stages - 1)
    if untracked_grad:
        raise ValueError("stage_fn's output requires grad, but neither x nor a leaf of "
                         "stage_params does: only their gradients cross the stages")
    return outs.reshape((b,) + tuple(x.shape[1:]))
