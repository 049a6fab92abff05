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

Forward only: ``torch.distributed``'s point-to-point operations carry no
autograd, so no gradient flows from one stage to the one before it (the
reference's ``ppermute`` is differentiable; the pipeline's backward is not
ported).
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


def _own_stage(leaf: torch.Tensor, sid: int, n_stages: int) -> torch.Tensor:
    """This rank's stage of a stage-stacked leaf: the one block of a DTensor
    sharded by :func:`stage_params_sharding`, or row ``sid`` of a plain
    tensor."""
    from torch.distributed.tensor import DTensor

    if isinstance(leaf, DTensor):
        local = leaf.to_local()
        if leaf.shape[0] != n_stages or local.shape[0] != 1:
            raise ValueError(f"a stage-stacked DTensor of shape {tuple(leaf.shape)} holds "
                             f"{local.shape[0]} stages on this rank, one was expected")
        return local[0]
    if leaf.shape[0] != n_stages:
        raise ValueError(f"a stage-stacked leaf leads with {leaf.shape[0]}, not the "
                         f"{n_stages} stages")
    return leaf[sid]


def _staged(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as ``group``'s backend moves it: gloo takes host tensors only,
    so a CUDA tensor goes through pinned host memory there."""
    import torch.distributed as dist

    x = x.contiguous()
    if x.is_cuda and dist.get_backend(group) == "gloo":
        return torch.empty(x.shape, dtype=x.dtype, pin_memory=True).copy_(x)
    return x


def _ring_hop(buf: torch.Tensor, nxt: int, prv: int, group, host) -> torch.Tensor:
    """Send ``buf`` to rank ``nxt`` and receive the previous rank's
    (``prv``) in one ``batch_isend_irecv``. ``host``: the pinned (send,
    receive) buffers of ``buf``'s shape that a CUDA tensor is staged through
    on gloo, made once a call; None to send ``buf`` itself."""
    import torch.distributed as dist

    if host is None:
        src, got = buf.contiguous(), torch.empty_like(buf)
    else:
        src, got = host
        src.copy_(buf)
    for work in dist.batch_isend_irecv([dist.P2POp(dist.isend, src, nxt, group),
                                        dist.P2POp(dist.irecv, got, prv, group)]):
        work.wait()
    return got if host is None else got.to(buf.device)


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
    mesh calls this with the same ``x``. ``stage_params``: a dict tree
    whose leaves lead with the stage dim (S): DTensors placed by
    :func:`stage_params_sharding`, or plain tensors of which rank ``s``
    takes ``leaf[s]``. ``x``: the (batch, ...) global batch; batch %
    n_microbatches == 0. Returns stage_{S-1}(…stage_0(x)) on every rank,
    with GPipe scheduling. Forward only (see the module docstring)."""
    import torch.distributed as dist

    from repro_torch.train.optimizer import tree_map

    names = tuple(mesh.mesh_dim_names)
    n_stages = mesh.size(names.index(stage_axis))
    b = x.shape[0]
    if b % n_microbatches:
        raise ValueError(f"batch {b} not divisible into {n_microbatches} microbatches")
    mb = b // n_microbatches
    xs = x.reshape((n_microbatches, mb) + tuple(x.shape[1:]))
    group = mesh.get_group(stage_axis)
    sid = mesh.get_local_rank(stage_axis)
    ranks = dist.get_process_group_ranks(group)      # global ranks, in stage order
    params = tree_map(lambda leaf: _own_stage(leaf, sid, n_stages), stage_params)

    n_ticks = n_stages + n_microbatches - 1
    buf = torch.zeros_like(xs[0])                    # resident activation
    host = (tuple(torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True) for _ in range(2))
            if n_stages > 1 and buf.is_cuda and dist.get_backend(group) == "gloo" else None)
    outs = torch.zeros_like(xs)
    for t in range(n_ticks):
        if sid == 0 and t < n_microbatches:          # stage 0 ingests microbatch t
            buf = xs[t]
        if 0 <= t - sid < n_microbatches:            # stage s works on microbatch t − s
            buf = stage_fn(params, buf)
        if sid == n_stages - 1 and t >= n_stages - 1:  # the last stage emits
            outs[t - (n_stages - 1)] = buf
        if n_stages > 1 and t < n_ticks - 1:         # rotate one stage forward
            buf = _ring_hop(buf, ranks[(sid + 1) % n_stages], ranks[(sid - 1) % n_stages],
                            group, host)
    # only the last stage's outs are real: broadcast them to every stage
    if n_stages > 1:
        host = _staged(outs, group)
        dist.broadcast(host, src=ranks[-1], group=group)
        outs = host.to(outs.device)
    return outs.reshape((b,) + tuple(x.shape[1:]))
