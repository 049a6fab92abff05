"""Plain-PyTorch semantic oracles for every kernel.

Ports of the JAX package's ``kernels/ref.py``: straight-line torch, no
tiling, float32 accumulation. They run on any device and define what the
CUDA kernels in ``csrc/`` must compute.

* GBDT: ``histogram_ref``, ``split_scan_ref``, ``level_split_ref`` (one-hot
  contraction, cumsum, gain, masked first argmax).
* LM: ``attention_ref``, ``attention_xla_blocked`` (the same function in
  query blocks, for long sequences on the CPU), ``decode_attention_ref``,
  ``rglru_ref``, ``rwkv6_ref``. Attention tensors are ``(batch, heads, seq, head_dim)``;
  with GQA, ``k``/``v`` have ``n_kv_heads`` dividing ``n_heads`` and are
  logically repeated. The recurrences loop over the time axis step by step.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["histogram_ref", "split_gains_ref", "split_scan_ref", "level_split_ref",
           "attention_ref", "attention_xla_blocked", "decode_attention_ref", "rglru_ref",
           "rwkv6_ref"]

#: largest (rows, F, B, 2) float32 one-hot block histogram_ref builds at once
_ONE_HOT_BYTES = 256 << 20


def histogram_ref(bins, grad, hess, node, n_nodes: int, n_bins: int):
    """Gradient/hessian histograms for GBDT split finding.

    bins: (rows, features) int32 in [0, n_bins); grad/hess: (rows,);
    node: (rows,) int32 in [0, n_nodes) — current tree-node of each row.
    Returns (n_nodes, features, n_bins, 2) f32 with [..., 0] = Σgrad and
    [..., 1] = Σhess over rows in that (node, feature-bin) cell. Out-of-range
    node or bin ids match no one-hot column and add nothing. Rows are
    contracted in blocks so the one-hot tensor stays bounded at any size.
    """
    r, f = bins.shape
    dev = bins.device
    out = torch.zeros((n_nodes, f, n_bins, 2), dtype=torch.float32, device=dev)
    step = max(1, _ONE_HOT_BYTES // max(1, f * n_bins * 8))
    node_ids = torch.arange(n_nodes, device=dev)
    bin_ids = torch.arange(n_bins, device=dev)
    for lo in range(0, r, step):
        sl = slice(lo, lo + step)
        node_oh = (node[sl, None] == node_ids).to(torch.float32)          # (R, N)
        bin_oh = (bins[sl, :, None] == bin_ids).to(torch.float32)         # (R, F, B)
        gh = torch.stack([grad[sl], hess[sl]], dim=-1).to(torch.float32)  # (R, 2)
        weighted = bin_oh[..., None] * gh[:, None, None, :]               # (R, F, B, 2)
        out += torch.einsum("rn,rfbt->nfbt", node_oh, weighted)
    return out


def split_gains_ref(hist, *, lam, min_child_weight, n_bins: int,
                    bin_limit=None, feat_mask=None):
    """Masked gain of every candidate split: (n_nodes, F, B), -inf where the
    split is not allowed. Node totals come from FEATURE 0's cumsum tail
    (every feature's bins sum to the same node total), even when feature 0
    is masked."""
    gl = torch.cumsum(hist[..., 0], dim=-1)             # (N, F, B) left sums
    hl = torch.cumsum(hist[..., 1], dim=-1)
    gt = gl[:, :1, -1:]                                  # (N, 1, 1) node totals
    ht = hl[:, :1, -1:]
    gr = gt - gl
    hr = ht - hl
    gain = gl**2 / (hl + lam) + gr**2 / (hr + lam) - gt**2 / (ht + lam)
    ok = (hl >= min_child_weight) & (hr >= min_child_weight)
    if feat_mask is not None:
        ok &= torch.as_tensor(feat_mask, device=hist.device).to(torch.bool)[None, :, None]
    # splitting at the last bin sends every row left — not a real split
    last = n_bins - 1 if bin_limit is None else bin_limit - 1
    ok &= torch.arange(n_bins, device=hist.device)[None, None, :] < last
    return torch.where(ok, gain, torch.full_like(gain, -torch.inf))


def split_scan_ref(hist, *, lam, min_child_weight, n_bins: int,
                   bin_limit=None, feat_mask=None):
    """Best-split scan over one level's histograms: cumsum → gain → masked
    argmax. ``hist``: (n_nodes, F, B, 2); returns per-node
    ``(best_gain, best_feat, best_split)``.

    This is also the scan half of the CPU path of ``ops.level_split``. A
    node whose every candidate is masked gets ``(-inf, 0, 0)``, the first
    argmax over -inf.
    """
    n_nodes, f = hist.shape[0], hist.shape[1]
    gain = split_gains_ref(hist, lam=lam, min_child_weight=min_child_weight,
                           n_bins=n_bins, bin_limit=bin_limit,
                           feat_mask=feat_mask)
    flat = gain.reshape(n_nodes, f * n_bins)
    best = torch.argmax(flat, dim=-1)                    # first max wins ties
    best_gain = torch.gather(flat, 1, best[:, None])[:, 0]
    feat = torch.div(best, n_bins, rounding_mode="floor").to(torch.int32)
    split = (best % n_bins).to(torch.int32)
    return best_gain, feat, split


def level_split_ref(bins, grad, hess, node, n_nodes: int, n_bins: int, *,
                    lam, min_child_weight, bin_limit=None, feat_mask=None):
    """One GBDT tree level end to end: histogram build + best-split scan.

    The oracle for the fused level kernel — always the DIRECT formulation
    (no histogram subtraction): subtraction is an implementation strategy
    whose result must match this definition. Returns
    ``(hist, best_gain, best_feat, best_split)``.
    """
    hist = histogram_ref(bins, grad, hess, node, n_nodes, n_bins)
    best_gain, feat, split = split_scan_ref(
        hist, lam=lam, min_child_weight=min_child_weight, n_bins=n_bins,
        bin_limit=bin_limit, feat_mask=feat_mask)
    return hist, best_gain, feat, split


def _repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, Hkv, T, D) -> (B, Hkv*n_rep, T, D) by head repetition."""
    if n_rep == 1:
        return x
    b, h, t, d = x.shape
    return x[:, :, None].expand(b, h, n_rep, t, d).reshape(b, h * n_rep, t, d)


def _softcap(logits, logit_softcap):
    if logit_softcap is None:
        return logits
    return logit_softcap * torch.tanh(logits / logit_softcap)


def attention_ref(q, k, v, *, causal: bool = True, window: int | None = None,
                  scale: float | None = None, logit_softcap: float | None = None,
                  matmul_dtype: str = "float32"):
    """Plain softmax attention with causal and/or sliding-window masking.

    q: (B, Hq, Tq, D); k, v: (B, Hkv, Tk, D). When Tq < Tk the queries
    occupy the LAST Tq key positions. ``window``: key j is visible from
    query i iff ``i - j < window`` (absolute positions); None = unlimited.
    Products are float32 on float32 copies of the operands (exact for bf16
    inputs, as the JAX oracle's ``preferred_element_type``);
    ``matmul_dtype="input"`` also rounds the probabilities to v's dtype
    before the second product. A row that sees no key gives NaN, as in the
    JAX oracle (the kernel gives 0 there)."""
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    kf = _repeat_kv(k, hq // hkv).float()
    vf = _repeat_kv(v, hq // hkv)
    s = scale if scale is not None else d ** -0.5
    logits = torch.matmul(q.float(), kf.transpose(-1, -2)) * s
    logits = _softcap(logits, logit_softcap)
    q_pos = torch.arange(tq, device=q.device) + (tk - tq)
    k_pos = torch.arange(tk, device=q.device)
    mask = torch.ones((tq, tk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        mask &= (q_pos[:, None] - k_pos[None, :]) < window
    logits = logits.masked_fill(~mask, -torch.inf)
    probs = torch.softmax(logits, dim=-1)
    if matmul_dtype == "input":
        probs = probs.to(v.dtype).float()
    return torch.matmul(probs, vf.float()).to(q.dtype)


def attention_xla_blocked(q, k, v, *, causal: bool = True, window: int | None = None,
                          scale: float | None = None, logit_softcap: float | None = None,
                          block_q: int = 2048, matmul_dtype: str = "float32"):
    """:func:`attention_ref` with the queries in blocks of ``block_q``, each
    block attending only to the key range it can reach (the causal end,
    the window's start), so no (Tq, Tk) logits tensor exists: the largest
    is (block_q, reachable keys). The JAX package's XLA path for long
    sequences; the same masking conventions and the same result."""
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    if tq <= block_q:
        return attention_ref(q, k, v, causal=causal, window=window, scale=scale,
                             logit_softcap=logit_softcap, matmul_dtype=matmul_dtype)
    kf = _repeat_kv(k, hq // hkv).float()
    vf = _repeat_kv(v, hq // hkv)
    sc = scale if scale is not None else d ** -0.5
    offset = tk - tq                     # absolute position of query 0
    outs = []
    for start in range(0, tq, block_q):
        stop = min(start + block_q, tq)
        q_lo, q_hi = start + offset, stop - 1 + offset
        k_lo = 0 if window is None else max(0, q_lo - window + 1)
        k_hi = min(q_hi if causal else tk - 1, tk - 1)
        logits = torch.matmul(q[:, :, start:stop].float(),
                              kf[:, :, k_lo:k_hi + 1].transpose(-1, -2)) * sc
        logits = _softcap(logits, logit_softcap)
        q_pos = torch.arange(start, stop, device=q.device) + offset
        k_pos = torch.arange(k_lo, k_hi + 1, device=q.device)
        mask = torch.ones((stop - start, k_hi + 1 - k_lo), dtype=torch.bool, device=q.device)
        if causal:
            mask &= k_pos[None, :] <= q_pos[:, None]
        if window is not None:
            mask &= (q_pos[:, None] - k_pos[None, :]) < window
        probs = torch.softmax(logits.masked_fill(~mask, -torch.inf), dim=-1)
        if matmul_dtype == "input":
            probs = probs.to(v.dtype).float()
        outs.append(torch.matmul(probs, vf[:, :, k_lo:k_hi + 1].float()).to(q.dtype))
    return torch.cat(outs, dim=2)


def decode_attention_ref(q, k_cache, v_cache, cache_len, *, window: int | None = None,
                         scale: float | None = None,
                         logit_softcap: float | None = None,
                         matmul_dtype: str = "float32"):
    """Single-position decode attention over a (possibly oversized) KV cache.

    q: (B, Hq, 1, D); caches: (B, Hkv, S, D); ``cache_len`` = number of
    valid entries (the new token's K/V already written at cache_len-1).
    Positions >= cache_len are masked out; the sliding ``window`` is
    honoured. Query heads are folded into a per-kv-head group, so each cache
    element is read once (no repeated K/V)."""
    b, hq, _, d = q.shape
    hkv, s_max = k_cache.shape[1], k_cache.shape[2]
    g = hq // hkv
    qg = q.reshape(b, hkv, g, d).float()
    sc = scale if scale is not None else d ** -0.5
    logits = torch.einsum("bkgd,bksd->bkgs", qg, k_cache.float()) * sc
    logits = _softcap(logits, logit_softcap)
    pos = torch.arange(s_max, device=q.device)
    valid = pos < cache_len
    if window is not None:
        valid &= pos >= (cache_len - window)
    logits = logits.masked_fill(~valid[None, None, None, :], -torch.inf)
    probs = torch.softmax(logits, dim=-1)
    if matmul_dtype == "input":
        probs = probs.to(v_cache.dtype).float()
    out = torch.einsum("bkgs,bksd->bkgd", probs, v_cache.float())
    return out.reshape(b, hq, 1, d).to(q.dtype)


def rglru_ref(x, input_gate, rec_gate, a_param, h0=None, *, c: float = 8.0):
    """Real-Gated Linear Recurrent Unit (Griffin / RecurrentGemma).

    x, input_gate, rec_gate: (B, T, D), the gates PRE-sigmoid logits;
    a_param: (D,), the learnable Λ; h0: (B, D) or None. Returns (y, h_T):
    y (B, T, D) in x's dtype, h_T (B, D) float32.
        a_t = exp(-c · softplus(Λ) · σ(r_t))
        h_t = a_t ⊙ h_{t-1} + √(1 − a_t²) ⊙ (σ(i_t) ⊙ x_t)
    """
    b, t, d = x.shape
    log_a = -c * F.softplus(a_param.float())[None, None, :] * torch.sigmoid(rec_gate.float())
    a = torch.exp(log_a)
    gated_x = torch.sigmoid(input_gate.float()) * x.float()
    # sqrt(1 - a^2) in log space: sqrt(-expm1(2 log a))
    u = torch.sqrt(-torch.expm1(2.0 * log_a)) * gated_x
    h = (torch.zeros((b, d), dtype=torch.float32, device=x.device) if h0 is None
         else h0.float())
    ys = []
    for i in range(t):
        h = a[:, i] * h + u[:, i]
        ys.append(h)
    y = torch.stack(ys, dim=1) if ys else torch.zeros_like(x, dtype=torch.float32)
    return y.to(x.dtype), h


def rwkv6_ref(r, k, v, w, u, s0=None):
    """RWKV-6 (Finch) WKV recurrence with data-dependent decay.

    r, k, w: (B, H, T, Dk); v: (B, H, T, Dv); u: (H, Dk) bonus; ``w`` is
    the PRE-activation decay, the effective decay exp(-exp(w)) ∈ (0, 1).
        y_t = (S_{t-1} + (u ⊙ k_t) v_tᵀ)ᵀ r_t
        S_t = diag(d_t) S_{t-1} + k_t v_tᵀ,   d_t = exp(-exp(w_t))
    Returns (y, S_T): y (B, H, T, Dv) in v's dtype; S_T (B, H, Dk, Dv) f32.
    """
    b, h, t, dk = r.shape
    dv = v.shape[-1]
    rf, kf, vf = r.float(), k.float(), v.float()
    decay = torch.exp(-torch.exp(w.float()))
    uf = u.float()[None, :, :, None]
    s = (torch.zeros((b, h, dk, dv), dtype=torch.float32, device=r.device)
         if s0 is None else s0.float())
    ys = []
    for i in range(t):
        kv = kf[:, :, i, :, None] * vf[:, :, i, None, :]          # (B,H,Dk,Dv)
        ys.append(torch.einsum("bhk,bhkv->bhv", rf[:, :, i], s + uf * kv))
        s = decay[:, :, i, :, None] * s + kv
    y = (torch.stack(ys, dim=2) if ys
         else torch.zeros((b, h, 0, dv), dtype=torch.float32, device=r.device))
    return y.to(v.dtype), s
