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
    force=None        CUDA tensor → kernel, CPU tensor → plain path

On a CUDA tensor the kernel runs or the call raises: nothing falls back.
Unlike the TPU dispatch, which sends ragged shapes to the plain path, the
CUDA kernels take every shape (any sequence length, T=1 included), so on
the card nothing takes the plain path.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref as _ref

__all__ = ["attention", "decode_attention", "rglru", "rwkv6", "histogram",
           "level_split"]


def _use_kernel(force, t: torch.Tensor) -> bool:
    if force == "kernel":
        if not t.is_cuda:
            raise RuntimeError("force='kernel' needs CUDA tensors: the kernel "
                               "is CUDA C++ and has no CPU mode")
        return True
    return force is None and t.is_cuda


def attention(q, k, v, *, causal=True, window=None, scale=None,
              logit_softcap=None, force=None, matmul_dtype="float32"):
    """Multi-head attention (GQA via head-count ratio). See
    ``attention_ref``. On the card ``matmul_dtype`` is not read: for bf16
    inputs the kernel multiplies on the tensor cores, bf16 × bf16 into
    float32 (exact products), and takes P into the P·V product as two bf16
    terms, P_hi + P_lo, about 16 bits of P where ``matmul_dtype="input"``
    would round it to 8; for float32 inputs it multiplies in float32. The
    JAX package's ``block_q``/``block_k`` tiling arguments have no
    counterpart here: the kernel's tiles are fixed and it takes any
    sequence length."""
    if _use_kernel(force, q):
        from repro_torch.kernels.flash_attention import flash_attention_cuda

        return flash_attention_cuda(
            q.contiguous(), k.contiguous(), v.contiguous(), causal=causal,
            window=window, scale=scale, logit_softcap=logit_softcap)
    return _ref.attention_ref(
        q, k, v, causal=causal, window=window, scale=scale,
        logit_softcap=logit_softcap, matmul_dtype=matmul_dtype)


def decode_attention(q, k_cache, v_cache, cache_len, *, window=None, scale=None,
                     logit_softcap=None, matmul_dtype="float32"):
    """Single-token decode over a KV cache: plain PyTorch on every device,
    as the JAX package leaves it to XLA on both backends (one pass over the
    cache, no Pallas kernel)."""
    return _ref.decode_attention_ref(
        q, k_cache, v_cache, cache_len, window=window, scale=scale,
        logit_softcap=logit_softcap, matmul_dtype=matmul_dtype)


def rglru(x, input_gate, rec_gate, a_param, h0=None, *, c=8.0, force=None):
    """RG-LRU recurrence. See ``rglru_ref``; returns ``(y, h_T)``."""
    if _use_kernel(force, x):
        from repro_torch.kernels.rglru import rglru_cuda

        return rglru_cuda(
            x.contiguous(), input_gate.contiguous(), rec_gate.contiguous(),
            a_param.float().contiguous(),
            None if h0 is None else h0.float().contiguous(), c=c)
    return _ref.rglru_ref(x, input_gate, rec_gate, a_param, h0, c=c)


def rwkv6(r, k, v, w, u, s0=None, *, force=None):
    """RWKV-6 WKV recurrence. See ``rwkv6_ref``; returns ``(y, S_T)``. The
    float32 casts of ``w``, ``u`` and ``s0`` are the ones the oracle makes
    (the JAX package's ``chunk`` argument has no counterpart: the kernel
    runs the recurrence in time order)."""
    if _use_kernel(force, r):
        from repro_torch.kernels.rwkv6 import rwkv6_cuda

        return rwkv6_cuda(
            r.contiguous(), k.contiguous(), v.contiguous(), w.float().contiguous(),
            u.float().contiguous(), None if s0 is None else s0.float().contiguous())
    return _ref.rwkv6_ref(r, k, v, w, u, s0)


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


def histogram(bins, grad, hess, node, *, n_nodes, n_bins, force=None):
    """GBDT grad/hess histograms. See ``histogram_ref``.

    Tree levels go through :func:`level_split`; this is the standalone
    histogram entry point, which ``build_tree`` uses for its leaf sums
    (one feature, one bin) so that they too are deterministic on the card.
    """
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
    The counts are integer sums, exact in any order."""
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
    end. ``axis_name``/``row_valid`` (the row-sharded data plane) are not
    ported yet.
    """
    if axis_name is not None:
        raise NotImplementedError(
            "the row-sharded data plane (axis_name) is not ported yet")
    if force == "ref":
        hist, bg, bf, bs = _ref.level_split_ref(
            bins, g, h, node, n_nodes, n_bins, lam=lam,
            min_child_weight=min_child_weight, bin_limit=bin_limit,
            feat_mask=feat_mask)
        return (hist if return_hist else None), bg, bf, bs
    use_kernel = _use_kernel(force, bins)
    subtract = parent_hist is not None and n_nodes > 1
    if subtract:
        sil, idx, valid = _plan_smaller_child(node, n_nodes, bins.shape[0])
        n_half = n_nodes // 2
        il = idx.long()
        sbins, sg, sh = bins[il], g[il], h[il]
        snode = torch.where(valid, node[il] // 2,
                            torch.full_like(idx, n_half))   # n_half = dump slot
        if use_kernel:
            from repro_torch.kernels.histogram import fused_level_split_cuda

            return fused_level_split_cuda(
                sbins, sg, sh, snode, n_nodes=n_nodes, n_bins=n_bins,
                lam=lam, min_child_weight=min_child_weight,
                bin_limit=bin_limit, feat_mask=feat_mask,
                parent_hist=parent_hist, small_is_left=sil,
                return_hist=return_hist)
        small = _histogram_scatter(sbins, sg, sh, snode, n_half, n_bins)
        big = parent_hist - small
        silb = sil[:, None, None, None]
        hist = torch.stack(
            [torch.where(silb, small, big), torch.where(silb, big, small)], dim=1,
        ).reshape(n_nodes, bins.shape[1], n_bins, 2)
    elif use_kernel:
        from repro_torch.kernels.histogram import fused_level_split_cuda

        return fused_level_split_cuda(
            bins, g, h, node, n_nodes=n_nodes, n_bins=n_bins,
            lam=lam, min_child_weight=min_child_weight, bin_limit=bin_limit,
            feat_mask=feat_mask, return_hist=return_hist)
    else:
        hist = _histogram_scatter(bins, g, h, node, n_nodes, n_bins)
    bg, bf, bs = _ref.split_scan_ref(
        hist, lam=lam, min_child_weight=min_child_weight, n_bins=n_bins,
        bin_limit=bin_limit, feat_mask=feat_mask)
    return (hist if return_hist else None), bg, bf, bs
