"""Dispatching wrappers: CUDA kernel for CUDA tensors, plain PyTorch for CPU.

Estimators and models call ``ops.*`` only — never a kernel or an oracle
directly.
Dispatch follows the tensor's device, not a backend probe. ``force``
overrides it for tests:

    force="kernel"    the CUDA kernel; raises for CPU tensors (it has no
                      CPU mode)
    force="ref"       the plain-PyTorch oracle (kernels/ref.py)
    force="plain"     the plain path on any device: what a CPU tensor runs
                      (the GBDT histograms as a scatter, with subtraction),
                      cheap enough to set beside the kernel at full size
                      where the one-hot oracle is not
    force=None        CUDA tensor → kernel, CPU tensor → plain path (for
                      attention over more than 2,048 queries the blocked
                      plain version, ``ref.attention_xla_blocked``, as the
                      JAX package's CPU path takes)

On a CUDA tensor the kernel runs or the call raises: nothing falls back.
Unlike the TPU dispatch, which sends ragged shapes to the plain path, the
CUDA kernels take every shape (any sequence length, T=1 included), so on
the card nothing takes the plain path.

Gradients. The CUDA kernels are forward kernels: a launch through ctypes
records no autograd graph. When autograd needs a gradient (grad mode on and
an input that requires grad), ``attention``, ``rglru`` and ``rwkv6`` run
the kernel inside :class:`_KernelGradByPlain`, whose backward recomputes
the plain differentiable version on the saved inputs and back-propagates
through it: what the JAX package differentiates, which has no backward for
its Pallas kernels either. No kernel output comes back without a
``grad_fn`` while an input requires grad (:func:`_launch` raises if one
would). The plain path on the card (``force="ref"``) goes through the same
Function, its forward the plain version itself, so that it too keeps only
its inputs from the forward to the backward: kept, the (B, H, T, T) scores
of plain attention would hold 2 GiB a layer of TinyLlama-1.1B's train step
at batch 4 × 2,048. On the CPU the plain path's own autograd runs.

On a device mesh. ``attention``, ``decode_attention``, ``rglru`` and
``rwkv6`` take DTensors (the LM's mesh forms, ``distributed.sharding``):
each runs the same call on its local shard through
``torch.distributed.tensor.experimental.local_map`` (:func:`_on_mesh`),
the batch on the mesh's data dimension and the heads (or channels) on its
``model`` dimension, so the kernel launches on each rank's block and its
gradient still goes through :class:`_KernelGradByPlain`. No sharded
operand is gathered, except where the heads (or channels) do not divide the
``model`` dimension: there they are gathered before the call, as GSPMD
would (:func:`head_gather_needed`). A kernel that fails to build or launch
under ``local_map`` fails the step, as it does off the mesh.
"""
from __future__ import annotations

import torch

from repro_torch.compat import MeshAxis, ShardAxis
from repro_torch.kernels import ref as _ref

__all__ = ["attention", "decode_attention", "rglru", "rwkv6", "histogram",
           "split_scan", "level_split", "head_gather_needed", "kernel_io"]


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def _placements(mesh, batch: int, split: int | None, batch_dim, split_dim) -> tuple:
    """One operand's placements on ``mesh``: the ``model`` dimension shards
    ``split_dim`` (the heads or channels) when ``split`` of them divide it,
    every other mesh dimension shards ``batch_dim`` when ``batch`` divides
    it; a ``None`` dim or count, or a count that does not divide,
    replicates."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for name, size in zip(mesh.mesh_dim_names, mesh.shape):
        dim, count = (split_dim, split) if name == "model" else (batch_dim, batch)
        ok = size > 1 and dim is not None and count is not None and count % size == 0
        out.append(Shard(dim) if ok else Replicate())
    return tuple(out)


def head_gather_needed(n_heads: int, n_kv_heads: int, tp: int) -> bool:
    """Whether attention on a ``model`` dimension of ``tp`` ranks gathers
    its heads before the kernel: the query and the KV heads must both
    divide it for each rank to hold whole GQA groups."""
    return tp > 1 and (n_heads % tp != 0 or n_kv_heads % tp != 0)


def _on_mesh(fn, args, dims, out_dims, *, batch: int, split: int | None):
    """``fn(*args)`` on each rank's local shards of the DTensor ``args``
    through ``local_map`` (a None arg passes through as None). ``dims[i]``
    is ``(batch_dim, split_dim)`` of ``args[i]``, ``out_dims`` those of
    each output; :func:`_placements` turns them into placements, with the
    operands redistributed to them first."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = next(a for a in args if _is_dtensor(a)).device_mesh
    present = [i for i, a in enumerate(args) if a is not None]
    ins = tuple(_placements(mesh, batch, split, *dims[i]) for i in present)
    outs = tuple(list(_placements(mesh, batch, split, *d)) for d in out_dims)
    # an operand whole on a dimension over which the batch is split (a
    # weight such as RWKV's u) gets each rank's gradient of its own batch
    # block: a partial sum there
    split_batch = _placements(mesh, batch, None, 0, None)
    grads = tuple(tuple(Partial() if isinstance(p, Replicate) and b != Replicate() else p
                        for p, b in zip(pl, split_batch)) for pl in ins)

    def local(*tensors):
        full = [None] * len(args)
        for i, t in zip(present, tensors):
            full[i] = t
        return fn(*full)

    return local_map(local, out_placements=outs if len(outs) > 1 else outs[0],
                     in_placements=ins, in_grad_placements=grads, redistribute_inputs=True)(
        *(args[i] for i in present))


_io_counter = None


class kernel_io:
    """Within it, a kernel's plain version (``force="ref"``, or the CPU)
    reports its forward to ``counter.kernel(fn, inputs)``, which counts
    the bytes of the kernel's own inputs and outputs in place of the plain
    version's intermediates (``roofline.RankFlopCounter``: the dry-run's
    memory term is then the kernel's). Its backward, which the card too
    runs as the plain version, is counted as it runs."""

    def __init__(self, counter):
        self.counter = counter

    def __enter__(self):
        global _io_counter
        self._prev, _io_counter = _io_counter, self.counter
        return self

    def __exit__(self, *exc):
        global _io_counter
        _io_counter = self._prev


def _as_kernel(fn, *inputs):
    return fn(*inputs) if _io_counter is None else _io_counter.kernel(fn, inputs)


def _tp(t) -> int:
    mesh = t.device_mesh
    return dict(zip(mesh.mesh_dim_names, mesh.shape)).get("model", 1)


def _use_kernel(force, t: torch.Tensor) -> bool:
    if force == "kernel":
        if not t.is_cuda:
            raise RuntimeError("force='kernel' needs CUDA tensors: the kernel "
                               "is CUDA C++ and has no CPU mode")
        return True
    return force is None and t.is_cuda


def _needs_grad(*inputs) -> bool:
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in inputs)


class _KernelGradByPlain(torch.autograd.Function):
    """Forward: ``kernel(*inputs)``. Backward: ``plain(*inputs)`` recomputed
    under grad mode on the saved inputs and differentiated. Both return a
    tensor or a tuple of tensors of the same structure; ``None`` inputs
    (an absent initial state) get no gradient."""

    @staticmethod
    def forward(ctx, kernel, plain, *inputs):
        ctx.plain = plain
        ctx.save_for_backward(*inputs)
        return kernel(*inputs)

    @staticmethod
    def backward(ctx, *grad_outs):
        leaves = [None if t is None else t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad[2:])]
        with torch.enable_grad():
            outs = ctx.plain(*leaves)
        outs = outs if isinstance(outs, tuple) else (outs,)
        pairs = [(o, g) for o, g in zip(outs, grad_outs)
                 if g is not None and o.requires_grad]
        wrt = [t for t in leaves if t is not None and t.requires_grad]
        grads = iter(torch.autograd.grad([o for o, _ in pairs], wrt,
                                         [g for _, g in pairs], allow_unused=True))
        return (None, None) + tuple(
            next(grads) if t is not None and t.requires_grad else None for t in leaves)


def _launch(kernel, plain, *inputs):
    """``kernel(*inputs)``, through :class:`_KernelGradByPlain` when
    autograd needs a gradient of it (only the inputs are kept for the
    backward, which differentiates ``plain``)."""
    if not _needs_grad(*inputs):
        return kernel(*inputs)
    out = _KernelGradByPlain.apply(kernel, plain, *inputs)
    if any(o.grad_fn is None for o in (out if isinstance(out, tuple) else (out,))):
        raise RuntimeError("a kernel output has no grad_fn while its inputs require grad")
    return out


def attention(q, k, v, *, causal=True, window=None, scale=None,
              logit_softcap=None, force=None, matmul_dtype="float32"):
    """Multi-head attention (GQA via head-count ratio). See
    ``attention_ref``. On the card ``matmul_dtype`` is not read: for bf16
    inputs the kernel multiplies on the tensor cores, bf16 × bf16 into
    float32 (exact products), and takes P into the P·V product as two bf16
    terms, P_hi + P_lo, about 16 bits of P where ``matmul_dtype="input"``
    would round it to 8; for float32 inputs it multiplies in float32. For
    bf16 with a head_dim that is a multiple of 8 the Hopper kernel runs
    (TMA loads, ``wgmma``), else the unaligned one; see
    ``flash_attention_cuda``. The JAX package's ``block_q``/``block_k``
    tiling arguments have no counterpart here: the kernel's tiles are fixed
    and it takes any sequence length."""
    if _is_dtensor(q):
        h, hkv = q.shape[1], k.shape[1]
        split = None if head_gather_needed(h, hkv, _tp(q)) else hkv
        return _on_mesh(
            lambda q, k, v: attention(q, k, v, causal=causal, window=window, scale=scale,
                                      logit_softcap=logit_softcap, force=force,
                                      matmul_dtype=matmul_dtype),
            (q, k, v), [(0, 1)] * 3, [(0, 1)], batch=q.shape[0], split=split)

    def plain(q, k, v):
        return _ref.attention_ref(
            q, k, v, causal=causal, window=window, scale=scale,
            logit_softcap=logit_softcap, matmul_dtype=matmul_dtype)

    if _use_kernel(force, q):
        from repro_torch.kernels.flash_attention import flash_attention_cuda

        def kernel(q, k, v):
            return flash_attention_cuda(
                q.contiguous(), k.contiguous(), v.contiguous(), causal=causal,
                window=window, scale=scale, logit_softcap=logit_softcap)

        return _launch(kernel, plain, q, k, v)
    if q.is_cuda:
        return _as_kernel(lambda *a: _launch(plain, plain, *a), q, k, v)
    if force is None and q.shape[2] > 2048:
        return _as_kernel(lambda q, k, v: _ref.attention_xla_blocked(
            q, k, v, causal=causal, window=window, scale=scale,
            logit_softcap=logit_softcap, matmul_dtype=matmul_dtype), q, k, v)
    return _as_kernel(plain, q, k, v)


def decode_attention(q, k_cache, v_cache, cache_len, *, window=None, scale=None,
                     logit_softcap=None, matmul_dtype="float32"):
    """Single-token decode over a KV cache: plain PyTorch on every device,
    as the JAX package leaves it to XLA on both backends (one pass over the
    cache, no Pallas kernel). On a mesh the heads are split as
    :func:`attention` splits them; a cache sharded on its sequence is
    gathered for the call."""
    if _is_dtensor(q):
        h, hkv = q.shape[1], k_cache.shape[1]
        split = None if head_gather_needed(h, hkv, _tp(q)) else hkv
        return _on_mesh(
            lambda q, k, v: decode_attention(q, k, v, cache_len, window=window, scale=scale,
                                             logit_softcap=logit_softcap,
                                             matmul_dtype=matmul_dtype),
            (q, k_cache, v_cache), [(0, 1)] * 3, [(0, 1)], batch=q.shape[0], split=split)
    return _ref.decode_attention_ref(
        q, k_cache, v_cache, cache_len, window=window, scale=scale,
        logit_softcap=logit_softcap, matmul_dtype=matmul_dtype)


def rglru(x, input_gate, rec_gate, a_param, h0=None, *, c=8.0, force=None):
    """RG-LRU recurrence. See ``rglru_ref``; returns ``(y, h_T)``. On a
    mesh the channels are split over ``model``."""
    if _is_dtensor(x):
        return _on_mesh(
            lambda *a: rglru(*a, c=c, force=force), (x, input_gate, rec_gate, a_param, h0),
            [(0, 2), (0, 2), (0, 2), (None, 0), (0, 1)], [(0, 2), (0, 1)],
            batch=x.shape[0], split=x.shape[2])
    def plain(x, input_gate, rec_gate, a_param, h0):
        return _ref.rglru_ref(x, input_gate, rec_gate, a_param, h0, c=c)

    if _use_kernel(force, x):
        from repro_torch.kernels.rglru import rglru_cuda

        def kernel(x, input_gate, rec_gate, a_param, h0):
            return rglru_cuda(
                x.contiguous(), input_gate.contiguous(), rec_gate.contiguous(),
                a_param.float().contiguous(),
                None if h0 is None else h0.float().contiguous(), c=c)

        return _launch(kernel, plain, x, input_gate, rec_gate, a_param, h0)
    args = (x, input_gate, rec_gate, a_param, h0)
    return _as_kernel(lambda *a: _launch(plain, plain, *a) if x.is_cuda else plain(*a), *args)


def rwkv6(r, k, v, w, u, s0=None, *, force=None):
    """RWKV-6 WKV recurrence. See ``rwkv6_ref``; returns ``(y, S_T)``. The
    float32 casts of ``w``, ``u`` and ``s0`` are the ones the oracle makes.
    On the card the wrapper picks the kernel by T (``rwkv6.chunked_form``):
    from T = 16 on the chunked kernel runs sub-chunks of 16 steps on the
    tensor cores, so a state carried across calls gives the bits of one
    call only where a split lies on that grid; decode (T = 1), any shorter T
    and shapes it does not take (Dk > 64, unaligned rows) run the step
    kernel. The JAX package's ``chunk`` argument has no counterpart: the
    sub-chunk is fixed. On a mesh the heads are split over ``model``."""
    if _is_dtensor(r):
        return _on_mesh(
            lambda *a: rwkv6(*a, force=force), (r, k, v, w, u, s0),
            [(0, 1)] * 4 + [(None, 0), (0, 1)], [(0, 1), (0, 1)],
            batch=r.shape[0], split=r.shape[1])
    if _use_kernel(force, r):
        from repro_torch.kernels.rwkv6 import rwkv6_cuda

        def kernel(r, k, v, w, u, s0):
            return rwkv6_cuda(
                r.contiguous(), k.contiguous(), v.contiguous(), w.float().contiguous(),
                u.float().contiguous(), None if s0 is None else s0.float().contiguous())

        return _launch(kernel, _ref.rwkv6_ref, r, k, v, w, u, s0)
    args = (r, k, v, w, u, s0)
    return _as_kernel(lambda *a: _launch(_ref.rwkv6_ref, _ref.rwkv6_ref, *a) if r.is_cuda
                      else _ref.rwkv6_ref(*a), *args)


def _histogram_scatter(bins, grad, hess, node, n_nodes, n_bins):
    """Plain path: scatter-add formulation, ``index_add_`` in row order — on
    the CPU bit-identical to the JAX package's ``ops._histogram_scatter``.

    The buffer holds one spare node: a pad/dump row (node == n_nodes) lands
    there and is sliced off, as JAX silently drops out-of-bounds scatter
    indices where PyTorch would raise."""
    r, f = bins.shape
    dev = bins.device
    flat = ((node.long()[:, None] * f + torch.arange(f, device=dev)[None, :]) * n_bins
            + bins.long()).reshape(-1)                          # (R·F,)
    size = n_nodes * f * n_bins

    def acc(vals):
        src = vals.to(torch.float32)[:, None].expand(r, f).reshape(-1)
        out = torch.zeros(size + f * n_bins, dtype=torch.float32, device=dev)
        return out.index_add_(0, flat, src)[:size].reshape(n_nodes, f, n_bins)

    return torch.stack([acc(grad), acc(hess)], dim=-1)


def histogram(bins, grad, hess, node, *, n_nodes, n_bins, force=None,
              axis_name=None, row_valid=None):
    """GBDT grad/hess histograms. See ``histogram_ref``.

    Tree levels go through :func:`level_split`; this is the standalone
    histogram entry point, which ``build_tree`` uses for its leaf sums
    (one feature, one bin) so that they too are deterministic on the card.
    With ``axis_name`` (a :class:`~repro_torch.compat.ShardAxis`) the inputs
    are row blocks stacked by shard and the result is the shards' partial
    histograms summed in shard order (:func:`_shard_histogram`).
    """
    if axis_name is not None:
        return _shard_histogram(bins, grad, hess, node, n_nodes=n_nodes,
                                n_bins=n_bins, axis=axis_name,
                                row_valid=row_valid, force=force)
    if force == "ref":
        return _ref.histogram_ref(bins, grad, hess, node, n_nodes, n_bins)
    if _use_kernel(force, bins):
        from repro_torch.kernels.histogram import histogram_cuda

        return histogram_cuda(bins, grad, hess, node, n_nodes=n_nodes,
                              n_bins=n_bins)
    return _histogram_scatter(bins, grad, hess, node, n_nodes, n_bins)


def _plan_smaller_child(node, n_nodes, n_rows):
    """Histogram-subtraction plan for one tree level (DESIGN.md §3.8).

    ``node``: (R,) CHILD-level assignment in [0, n_nodes). For every sibling
    pair (2p, 2p+1) pick the child with fewer rows (ties → left), then build
    a COMPACTED index set covering only smaller-child rows: per-pair minima
    sum to ≤ floor(R/2), so ``idx`` has exactly floor(R/2) slots. Returns
    ``(small_is_left, idx, valid)``: (N/2,) bool, (R//2,) int32 row indices
    (stable order), (R//2,) bool marking really-filled slots.

    Rows that are not compacted write to slot ``cap`` of a ``cap + 1``
    buffer that is then sliced off (JAX drops that out-of-bounds write).
    The counts are integer sums, exact in any order. The plain path's plan:
    on the card the level kernel picks the same children itself."""
    dev = node.device
    nl = node.long()
    cnt = torch.zeros(n_nodes, dtype=torch.int32, device=dev).index_add_(
        0, nl, torch.ones(n_rows, dtype=torch.int32, device=dev))
    small_is_left = cnt[0::2] <= cnt[1::2]
    is_small = torch.stack([small_is_left, ~small_is_left], dim=1).reshape(-1)
    row_small = is_small[nl]
    cap = n_rows // 2
    pos = torch.cumsum(row_small, dim=0) - 1             # stable slot of each small row
    slot = torch.where(row_small, pos, torch.full_like(pos, cap))
    idx = torch.zeros(cap + 1, dtype=torch.int32, device=dev)
    idx[slot] = torch.arange(n_rows, dtype=torch.int32, device=dev)
    valid = torch.arange(cap, device=dev) < row_small.sum()
    return small_is_left, idx[:cap], valid


def split_scan(hist, *, lam, min_child_weight, bin_limit=None, feat_mask=None,
               force=None):
    """Each node's best split of a level's histograms ``hist`` (n_nodes, F,
    B, 2): ``(best_gain, best_feat, best_split)``. See ``split_scan_ref``;
    on the card the level kernel's scan pass (``split_scan_cuda``)."""
    if _use_kernel(force, hist):
        from repro_torch.kernels.histogram import split_scan_cuda

        return split_scan_cuda(hist.contiguous(), lam=lam,
                               min_child_weight=min_child_weight,
                               bin_limit=bin_limit, feat_mask=feat_mask)
    return _ref.split_scan_ref(hist, lam=lam, min_child_weight=min_child_weight,
                               n_bins=hist.shape[2], bin_limit=bin_limit,
                               feat_mask=feat_mask)


def _shard_histogram(bins, g, h, node, *, n_nodes, n_bins, axis, row_valid=None,
                     force=None):
    """The row-sharded histogram (DESIGN.md §3.9): ``bins`` (S, Rs, F) and
    ``g``/``h``/``node`` (S, Rs) hold each shard's row block, ``row_valid``
    (S, Rs) masks the pad rows. Each shard's partial (n_nodes, F, B, 2)
    histogram comes from one histogram call over all the blocks side by
    side, shard s's nodes offset by ``s * n_nodes`` and every pad row on the
    padding node ``S * n_nodes``; the partials are then summed by the
    axis's ``psum``, in shard order. A shard's cells hold its own rows only,
    in its own row order, so its partial is what it alone would give.

    On the card that call is ``histogram_cuda`` (``force="ref"`` or
    ``"plain"``: the scatter); on the CPU the scatter, as the JAX package's
    sharded level scatters."""
    if not isinstance(axis, (ShardAxis, MeshAxis)) or not axis.stacked:
        raise TypeError("a sharded histogram needs a compat.ShardAxis (or a stacked "
                        f"compat.MeshAxis), got {axis!r}")
    s, rs = node.shape
    nd = node.to(torch.int32) + (torch.arange(s, dtype=torch.int32, device=node.device)
                                 * n_nodes)[:, None]
    if row_valid is not None:
        nd = torch.where(row_valid, nd, torch.full_like(nd, s * n_nodes))
    flat = (bins.reshape(s * rs, bins.shape[-1]), g.reshape(-1), h.reshape(-1),
            nd.reshape(-1))
    if _use_kernel(force, bins):
        from repro_torch.kernels.histogram import histogram_cuda

        part = histogram_cuda(*(t.contiguous() for t in flat), n_nodes=s * n_nodes,
                              n_bins=n_bins)
    else:
        part = _histogram_scatter(*flat, s * n_nodes, n_bins)
    return axis.psum(part.reshape(s, n_nodes, *part.shape[1:]))


def _sharded_level_split(
    bins, g, h, node, *, n_nodes, n_bins, lam, min_child_weight, axis,
    row_valid, bin_limit=None, feat_mask=None, parent_hist=None,
    return_hist=True, force=None,
):
    """Cross-shard level build (DESIGN.md §3.9): per-shard partial
    histograms combined by ONE shard-order ``psum`` before the split scan
    (``split_scan``: ``split_scan_cuda`` on the card).

    The inputs are the stacked row blocks of ``compat.sharded_call``;
    ``row_valid`` masks the zero-padded tail. Subtraction composes across
    shards, but the smaller-child PLAN must be global: per-shard row counts
    can disagree on which sibling is smaller, so the counts are summed
    first and every shard sends its small-child rows to their parent's
    slot and every other row to the dump slot — no compaction: a globally
    small child's rows may all sit on one shard, so a per-shard ``R/2`` cap
    would drop rows. After the psum the histogram, and so every split
    decision, is the same whatever the shard count."""
    subtract = parent_hist is not None and n_nodes > 1
    if subtract:
        valid = (torch.ones(node.shape, dtype=torch.bool, device=node.device)
                 if row_valid is None else row_valid)
        per_shard = torch.zeros((node.shape[0], n_nodes), dtype=torch.int32,
                                device=node.device)
        cnt = axis.psum(per_shard.scatter_add_(1, node.long(), valid.to(torch.int32)))
        small_is_left = cnt[0::2] <= cnt[1::2]
        n_half = n_nodes // 2
        is_small = torch.stack([small_is_left, ~small_is_left], dim=1).reshape(-1)
        is_small = is_small[node.long()] & valid
        small = _shard_histogram(bins, g, h, node // 2, n_nodes=n_half,
                                 n_bins=n_bins, axis=axis, row_valid=is_small,
                                 force=force)
        big = parent_hist - small
        silb = small_is_left[:, None, None, None]
        hist = torch.stack(
            [torch.where(silb, small, big), torch.where(silb, big, small)], dim=1,
        ).reshape(n_nodes, bins.shape[-1], n_bins, 2)
    else:
        hist = _shard_histogram(bins, g, h, node, n_nodes=n_nodes, n_bins=n_bins,
                                axis=axis, row_valid=row_valid, force=force)
    bg, bf, bs = split_scan(hist, lam=lam, min_child_weight=min_child_weight,
                            bin_limit=bin_limit, feat_mask=feat_mask, force=force)
    return (hist if return_hist else None), bg, bf, bs


def level_split(
    bins, g, h, node, *, n_nodes, n_bins, lam, min_child_weight,
    bin_limit=None, feat_mask=None, parent_hist=None, return_hist=True,
    force=None, axis_name=None, row_valid=None,
):
    """One GBDT tree level: histogram build + best-split scan.
    See ``level_split_ref``; returns ``(hist, best_gain, best_feat,
    best_split)`` with ``hist=None`` when ``return_hist`` is False.

    ``parent_hist`` (the previous level's (n_nodes/2, F, B, 2) histograms)
    enables histogram subtraction: only the smaller child of each sibling
    pair is accumulated from rows, the sibling is ``parent − small``. The CPU
    path's DIRECT mode is ``_histogram_scatter`` + ``ref.split_scan_ref``.
    ``force`` is threaded by ``build_tree`` so tests can pin a path end to
    end.

    With ``axis_name`` (a :class:`~repro_torch.compat.ShardAxis`) the call
    runs on the row-sharded data plane (DESIGN.md §3.9): the inputs are row
    blocks stacked by shard, ``row_valid`` masks pad rows, per-shard partial
    histograms are combined with one ``psum`` and the scan runs on the
    global histogram (:func:`_sharded_level_split`); the returned decisions
    (and ``hist``) do not depend on the shard count.
    """
    if axis_name is not None:
        return _sharded_level_split(
            bins, g, h, node, n_nodes=n_nodes, n_bins=n_bins, lam=lam,
            min_child_weight=min_child_weight, axis=axis_name,
            row_valid=row_valid, bin_limit=bin_limit, feat_mask=feat_mask,
            parent_hist=parent_hist, return_hist=return_hist, force=force)
    if force == "ref":
        hist, bg, bf, bs = _ref.level_split_ref(
            bins, g, h, node, n_nodes, n_bins, lam=lam,
            min_child_weight=min_child_weight, bin_limit=bin_limit,
            feat_mask=feat_mask)
        return (hist if return_hist else None), bg, bf, bs
    subtract = parent_hist is not None and n_nodes > 1
    if _use_kernel(force, bins):
        # the kernel picks the smaller children and gathers their rows itself
        from repro_torch.kernels.histogram import fused_level_split_cuda

        return fused_level_split_cuda(
            bins, g, h, node, n_nodes=n_nodes, n_bins=n_bins,
            lam=lam, min_child_weight=min_child_weight, bin_limit=bin_limit,
            feat_mask=feat_mask, parent_hist=parent_hist if subtract else None,
            return_hist=return_hist)
    if subtract:
        sil, idx, valid = _plan_smaller_child(node, n_nodes, bins.shape[0])
        n_half = n_nodes // 2
        il = idx.long()
        sbins, sg, sh = bins[il], g[il], h[il]
        snode = torch.where(valid, node[il] // 2,
                            torch.full_like(idx, n_half))   # n_half = dump slot
        small = _histogram_scatter(sbins, sg, sh, snode, n_half, n_bins)
        big = parent_hist - small
        silb = sil[:, None, None, None]
        hist = torch.stack(
            [torch.where(silb, small, big), torch.where(silb, big, small)], dim=1,
        ).reshape(n_nodes, bins.shape[1], n_bins, 2)
    else:
        hist = _histogram_scatter(bins, g, h, node, n_nodes, n_bins)
    bg, bf, bs = _ref.split_scan_ref(
        hist, lam=lam, min_child_weight=min_child_weight, n_bins=n_bins,
        bin_limit=bin_limit, feat_mask=feat_mask)
    return (hist if return_hist else None), bg, bf, bs
