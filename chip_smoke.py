#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py                 # every phase, on cuda:0
    python3 chip_smoke.py --phases 1,2    # a subset, for debugging
    python3 chip_smoke.py --phases 6,7,8  # the LM serving path only
    python3 chip_smoke.py --phases 1,9,10 # the paper's grid only
    python3 chip_smoke.py --phases 1,11,12 # the sharded search and the service only
    python3 chip_smoke.py --phases 1,6,13,14 # the dense LMs served and TinyLlama trained
    python3 chip_smoke.py --phases 1,15   # whisper, InternVL and the MoEs served
    python3 chip_smoke.py --phases 1,16   # the device-mesh layer
    python3 chip_smoke.py --phases 1,14,17 # the LM search on mesh slices and the pipeline

It imports only the port (``src/repro_torch``), never JAX or the JAX
package, and exits non-zero without printing a result when CUDA is absent
or any phase fails. Phases:

1. device: the card's name and power limit, and the kernels' build time
   (``nvcc`` builds ``src/repro_torch/kernels/csrc`` on first use);
2. each CUDA kernel against its plain PyTorch version at the search path's
   shapes (R = 800,000 rows, F = 28; uniform bins and, at B = 64 and 256,
   90 % of each feature's rows in bin 0): histograms within tolerance, split
   decisions tie-aware, integer-valued sums bit-equal, two launches
   bit-identical; kernel, plain and library times beside the bound; and
   each kernel's registers and spill bytes (phase 1); the forest's
   deepest level (R = 600,000, B = 256, N = 512 in subtraction mode, 5 of 28
   features unmasked, Poisson integer g/h), bit-equal to the plain path;
   NaN and infinite g/h giving the plain path's NaN and infinities; the
   same rows shuffled giving the same bits; and the kernel launches of one
   level, counted by the profiler;
3. the search path: ``Session(SearchSpec(...)).results(train, valid)`` over
   a GBDT grid on 1,000,000 HIGGS-like rows, with launch counts showing that
   every tree level went through the level kernel;
4. the path against the plain path, determinism and resume;
5. one GBDT fit at UCI HIGGS's full size (11,000,000 rows x 28 features,
   256 bins): seconds per round, the kernels' share, peak device memory;
6. the LM kernels (flash attention, RG-LRU, RWKV-6) against their plain
   versions at the serving path's shapes, with stated tolerances, two
   launches bit-identical, kernel / plain / library times beside the bound;
   for the recurrences also their device time from a CUDA graph replay,
   which at T=1 separates the card from the host's launch cost;
7. RecurrentGemma-9B served at full width and half depth (19 of its 38
   layers; see SERVE_DEPTH) on seeded random weights (drawn on the card,
   ``_card_init``): one wave of 4 requests (prompts of 4096, 3000, 2048 and
   1000 tokens, 32 new tokens each) through ``ServeEngine``, with the
   launches of each kernel per prefill and per decode step, the kernel
   path against the plain path (the float32 prefill layer by layer against
   a float64 plain path: the kernel path no further from it than the plain
   float32 path, or within 1e-3 of each layer's update; the bf16 prefill
   logits within the plain path's own bf16 noise),
   and two serves giving the same tokens;
8. RWKV6-7B (16 of its 32 layers) the same way;
9. the paper's §V-A grid (89 tasks: GBDT 54, MLP 24, forest 6, logreg 5)
   through the search CLI's ``run_tabular`` on 250,000 HIGGS-like rows,
   2 executors, LPT with the sampling profiler: every task scored, every
   GBDT and forest tree level through the level kernel, one forest config
   bit-identical between the search, the plain path and a resume, logreg
   on the card within tolerance of its CPU run, and the same search with
   ``--fuse`` giving the same scores and trees;
10. the same grid on SECOM-like data (1,567 rows x 590 features), with the
   GBDT and forest kernel paths against their plain paths;
11. the row-sharded search (DESIGN.md §3.9): a cut grid of every family on
   1,000,000 HIGGS-like rows through ``run_tabular`` at ``--shards`` 1, 2
   and 4, the sharded levels through the histogram kernel and the split
   scan: tree AUC and logreg/MLP margins against ``--shards 1``, per-shard
   residency, a ``MeshSliceExecutorPool`` in shard groups against the
   thread pool, one sharded config's device-busy share;
12. the multi-tenant ``SearchService``: a replicated and a 2-shard tenant at
   once on one shared cache, then the sharded tenant again under injected
   train failures with retries; exact per-tenant ledgers and the same best
   configuration;
13. the four dense LMs served at full width and half depth (11, 14, 9 and 24
   of 22, 28, 18 and 48 layers; SERVE_DEPTH) on seeded weights, as in
   phase 7: TinyLlama-1.1B (prompts of 2048, 1500, 1024 and 500 tokens:
   its context), Qwen2-1.5B, Gemma-2B and Gemma3-12B (phase 7's wave), the
   flash kernel at head dims 64, 128 and 256 and Gemma3's window of 1024;
   Gemma3-12B also gets the float32 layer check;
14. TinyLlama-1.1B trained at full width and depth through ``Trainer``
   (AdamW, batch 4 x 2,048 tokens, the kernels' gradients through their
   plain versions): the first step's loss and gradient norm against the
   plain path, one layer's attention gradient through the kernel against
   the plain version's own autograd, 6 steps with a checkpoint every 3,
   and a fresh ``Trainer`` resumed from step 3 giving the uninterrupted
   run's losses;
15. the rest of the zoo served as in phase 7: whisper-medium at full width
   and depth (24 encoder and 24 decoder layers; prompts of 384, 300, 200
   and 100 tokens, within its 448 learned positions; the checks feed
   seeded (4, 1500, 1024) frames: 72 flash launches a prefill, the
   encoder's output against the plain path, the float32 decoder layers
   against float64), InternVL2-1B (prompts of 2048, 1500, 1024 and 500
   tokens; seeded (4, 256, 896) patches), Qwen3-MoE-235B at full width and
   2 of its 94 layers (phase 7's wave; each MoE layer's output against a
   per-token reference, the share of slots dropped), Arctic-480B's smoke
   config served, and one full-width Arctic layer (13.61B bfloat16
   parameters drawn on the card) on 4 x 1024 tokens, its MoE output
   against the per-token reference; first, flash timed at the zoo's
   prefill shapes and at TinyLlama-1.1B's (j), beside SDPA (with
   ``is_causal=True`` where the mask is exactly causal over Tq == Tk);
16. the device-mesh layer: the JAX package's small dry-run cells traced
   at the 32 x 8 production mesh (256 ranks of a ``fake`` process group,
   under ``FakeTensorMode``) and TinyLlama's train cell at 2 x 32 x 8 (512),
   each ``CellReport.summary()`` printed; phase 14's step traced on a 1 x 1
   mesh against the real step (FLOPs and argument bytes within 1 %); on a
   1 x 1 NCCL mesh on cuda:0, TinyLlama-1.1B trained 3 steps through
   ``Trainer(mesh=..., fsdp=True, zero1=True)`` (losses within 1e-5 of the
   one-device Trainer's, the same flash launches) and 3 with
   ``dp_mode="shard_map_int8"``, and served phase 13's wave (the same
   greedy tokens as the one-device engine); and ``compat.sharded_call``
   over two gloo ranks sharing cuda:0, a depth-6 GBDT tree on 800,000 x 28
   rows: its split decisions bit-equal to the stacked lowering's, its leaf
   sums within HIST_TOL (each rank's histogram rounds its own rows to its
   own grid, the stacked lowering's all rows to one: sums of other
   roundings), the
   histogram kernel and the split scan launched in each rank;
17. the LM search on mesh slices and the GPipe pipeline: ``run_lm`` through
   the search launcher at its defaults (6 smoke-config tasks, 2 logical
   slices on cuda:0, 5 steps each: every task ok with a finite loss, one
   task's loss bit-equal to a one-device ``Trainer``'s, flash launches a
   task); the LM search at full width through a ``MeshSliceExecutorPool``
   with a task runner, as ``examples/distributed_search.py`` runs it:
   TinyLlama-1.1B at full width and depth on 2 logical slices, AdamW at lr
   1e-5 and 3e-5, 3 steps each on batch 4 x 2,048 (the lr 1e-5 task's
   losses bit-equal to phase 14's first three, or to a one-device
   ``Trainer``'s when phase 14 did not run; each task's state freed before
   the next; peak memory within 1.1x phase 14's); and
   ``distributed.pipeline.pipeline_apply`` over two gloo ranks sharing
   cuda:0, S = 2 stages of 11 of TinyLlama-1.1B's 22 layers each (every
   rank holding its own stage as DTensors), x of (8, 512, 2048) embeddings
   in M = 4 microbatches: the output bit-equal to both stages applied in
   order to each microbatch on one rank, within the plain path's bf16
   noise of one pass over the whole batch, 44 flash launches a rank; then
   its backward, the same call under grad mode with the loss
   ``sum(y.float() * c)`` on every rank: every rank's gradients finite,
   x's the same bits on both ranks, a second call the same bits, 44 flash
   launches a rank, and rank 0's gradients (stage 0's leaves and x) each
   within 2x the plain path's bf16 noise of autograd through the stages
   in order on each microbatch.

Phase 2 also holds the sharded level (the shards' partial histograms in
one histogram launch, summed in shard order, scanned by ``split_scan``)
against the unsharded level kernel, and phase 6 RWKV-6 in float32 at
RWKV6-7B's serving shape, its error printed per window of steps.

The line before the last is one JSON object with every kernel's numbers;
the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

# H100 SXM data sheet: HBM3 at 3.35 TB/s; float32 outside the tensor cores
# at 67 TFLOP/s; dense bf16 on the tensor cores at 989 TFLOP/s (all at the
# full 700 W power limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
PEAK_BF16_FLOP_PER_S = 989e12

R_KERNEL, F_KERNEL = 800_000, 28
HIST_TOL = dict(rtol=1e-4, atol=1e-3)   # float sums in another order
GAIN_RTOL = 1e-4                        # gain tolerance, see _decisions_tie_aware
AUC_TOL = 5e-3
SKEW_SHARE = 0.9                        # phase 2's skewed cells: rows in bin 0
# phase 2's forest cell: the paper grid's deepest forest level (depth 10) on
# the training rows of a 1,000,000-row search, sqrt(28) = 5 features a tree
FOREST_R, FOREST_NODES, FOREST_FEATURES = 600_000, 512, 5
# phase 2's sharded-level cells: shard counts and a level of 64 nodes (a
# depth-7 tree's deepest level, and above the paper grid's depth-6 GBDT)
SHARD_COUNTS, SHARD_NODES = (2, 4, 8), 64


def _bound_ms(n_bytes: float, n_flops: float,
              peak_flops: float = PEAK_F32_FLOP_PER_S) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _time_ms(torch, fn, reps: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _self_device_us(evt) -> float:
    t = getattr(evt, "self_device_time_total", None)
    return t if t is not None else getattr(evt, "self_cuda_time_total", 0.0)


def _device_ms(torch, fn, reps: int = 10, replays: int = 5) -> float:
    """Device time of one call of ``fn``: ``reps`` calls captured in a CUDA
    graph, the graph replayed ``replays`` times between CUDA events. The
    host's cost per call (Python, ctypes, the launch) is left out, which
    CUDA events around back-to-back calls also see; what is timed is the
    kernels and the graph's own gaps between them."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (reps * replays)
    del graph
    return ms


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _level_inputs(torch, gen, r, f, nb, nn, integer=False, skew=False):
    """Seeded level inputs on the card. ``skew``: SKEW_SHARE of each
    feature's rows in bin 0 (a zero-inflated quantized column), the rest
    uniform."""
    dev = torch.device("cuda")
    bins = torch.randint(0, nb, (r, f), generator=gen, device=dev, dtype=torch.int32)
    if skew:
        zero = torch.rand((r, f), generator=gen, device=dev) < SKEW_SHARE
        bins = bins.masked_fill(zero, 0)
    if integer:
        g = torch.randint(-8, 9, (r,), generator=gen, device=dev).float()
        h = torch.randint(1, 5, (r,), generator=gen, device=dev).float()
    else:
        g = torch.randn(r, generator=gen, device=dev)
        h = torch.rand(r, generator=gen, device=dev) + 0.1
    node = torch.randint(0, nn, (r,), generator=gen, device=dev, dtype=torch.int32)
    return bins, g, h, node


def _exact_hist(torch, bins, g, h, node, nn, nb):
    """The plain path's scatter with float64 sums, rounded to float32 once.

    The skewed cells put ~720,000 rows in one cell, where the plain path's
    float32 atomics drift from the exact sum by more than HIST_TOL (their
    order changes from run to run, and each add rounds at the running sum's
    magnitude), so those cells hold the kernel to this sum instead, at the
    same tolerance; the plain path's own error is printed beside it."""
    r, f = bins.shape
    flat = ((node.long()[:, None] * f + torch.arange(f, device=bins.device)[None, :]) * nb
            + bins.long()).reshape(-1)
    gh = torch.stack([g, h], dim=1).double()[:, None, :].expand(r, f, 2).reshape(-1, 2)
    out = torch.zeros(((nn + 1) * f * nb, 2), dtype=torch.float64, device=bins.device)
    out.index_add_(0, flat, gh)          # the spare node takes the pad rows
    return out[: nn * f * nb].reshape(nn, f, nb, 2).float()


def _decisions_tie_aware(torch, ref, hist_plain, hist_kernel, got, kw, exact=False):
    """Split decisions, held two ways (``kw``: the split_gains_ref arguments).

    1. The scan itself: on the kernel's own histogram, the kernel's
       (feat, split) and best gain are the plain scan's, up to GAIN_RTOL
       (only the cumsum order differs); an all-masked node is (-inf, 0, 0).
    2. Against the plain path: the kernel's candidate has a plain-path gain
       within the gain tables' own disagreement of the plain best. The two
       histograms add in another order, so the two gain tables differ. Per
       node the tolerance is that disagreement at the two candidates
       compared (the plain best and the kernel's pick) plus GAIN_RTOL, so
       only a tie under that node's noise may flip. A candidate legal in
       one table and masked in the other (a child hessian within rounding
       of ``min_child_weight``) is counted as a legality flip, not held.
    ``exact``: both gain tables in float64 (the skewed cells). There a split
    with little mass on its right takes hr = ht - hl of two sums ~100x
    larger, so a float32 gain table moves with the order of its cumsum by
    more than GAIN_RTOL (torch.cumsum's order against a sequential one does
    too); in float64 it does not, and the kernel is held to the exact table.
    Returns (largest plain-path gain gap, largest tolerance, legality flips)."""
    n = hist_plain.shape[0]
    if exact:
        hist_plain, hist_kernel = hist_plain.double(), hist_kernel.double()
    g_plain = ref.split_gains_ref(hist_plain, **kw).reshape(n, -1)
    g_kern = ref.split_gains_ref(hist_kernel, **kw).reshape(n, -1)
    _, bg, bf, bs = got
    pick = (bf.long() * kw["n_bins"] + bs.long())[:, None]
    rows = torch.arange(n, device=g_plain.device)
    best_k = g_kern.max(dim=1).values
    fin_k = torch.isfinite(best_k)
    _check(bool(torch.equal(torch.isfinite(bg), fin_k)), "which nodes can split")
    tol_k = GAIN_RTOL * best_k[fin_k].abs().clamp_min(1.0)
    _check(bool(((best_k - g_kern.gather(1, pick)[:, 0])[fin_k].abs() <= tol_k).all()),
           "the scan's decision is not its histogram's best split")
    off = (bg - best_k)[fin_k].abs()
    if not bool((off <= tol_k).all()):
        i = int((off - tol_k).argmax())
        node = int(torch.nonzero(fin_k)[i])
        raise AssertionError(f"best gain disagrees at node {node}: kernel {float(bg[node])!r} "
                             f"(feat {int(bf[node])}, split {int(bs[node])}), its histogram's "
                             f"best {float(best_k[node])!r}, tolerance {float(tol_k[i]):.3g}")
    _check(bool(((bf[~fin_k] == 0) & (bs[~fin_k] == 0)).all()),
           "an all-masked node must give (-inf, 0, 0)")
    best_p, arg_p = g_plain.max(dim=1)
    diff = (g_plain - g_kern).abs()
    noise = diff[rows, arg_p] + diff[rows, pick[:, 0]]
    held = torch.isfinite(best_p) & fin_k & torch.isfinite(noise)
    flips = int((torch.isfinite(best_p) & fin_k & ~torch.isfinite(noise)).sum().item())
    gap = (best_p - g_plain[rows, pick[:, 0]])[held]
    tol_p = noise[held] + GAIN_RTOL * best_p[held].abs().clamp_min(1.0)
    worst = float(gap.max().item()) if gap.numel() else 0.0
    widest = float(tol_p.max().item()) if tol_p.numel() else 0.0
    _check(bool((gap <= tol_p).all()), f"split decision off the plain path's by {worst}")
    return worst, widest, flips


def _level_cell(torch, gen, r, f, nb, nn, skew):
    """One phase-2 cell: the level kernel (direct, without the histogram,
    masked, and in subtraction mode) and the histogram kernel against the
    plain path at R = r, F = f, B = nb, N = nn, with their times."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.histogram import fused_level_split_cuda, histogram_cuda

    lam, mcw = 1.0, 1.0
    bins, g, h, node = _level_inputs(torch, gen, r, f, nb, nn, skew=skew)
    kw = dict(lam=lam, min_child_weight=mcw, n_bins=nb)
    scatter = ((lambda *a: _exact_hist(torch, *a)) if skew
               else ops._histogram_scatter)
    plain = scatter(bins, g, h, node, nn, nb)
    plain_err = ""
    if skew:
        drift = (ops._histogram_scatter(bins, g, h, node, nn, nb) - plain).abs().max().item()
        plain_err = f" (against float64 sums; the float32 plain path is off them by {drift:.3g})"
    got = fused_level_split_cuda(bins, g, h, node, n_nodes=nn, n_bins=nb,
                                 lam=lam, min_child_weight=mcw)
    torch.cuda.synchronize()
    err = (got[0] - plain).abs().max().item()
    _check(torch.allclose(got[0], plain, **HIST_TOL),
           f"hist B={nb} N={nn}{' skewed' if skew else ''}: {err}")
    ties = [_decisions_tie_aware(torch, ref, plain, got[0], got, kw, exact=skew)]
    again = fused_level_split_cuda(bins, g, h, node, n_nodes=nn, n_bins=nb,
                                   lam=lam, min_child_weight=mcw)
    _check(all(torch.equal(a, b) for a, b in zip(got, again)),
           "two launches differ")
    slim = fused_level_split_cuda(bins, g, h, node, n_nodes=nn, n_bins=nb,
                                  lam=lam, min_child_weight=mcw,
                                  return_hist=False)
    _check(slim[0] is None and all(torch.equal(a, b) for a, b in zip(got[1:], slim[1:])),
           "return_hist=False changed the decisions")
    # a feature mask and bin_limit < B
    mask = torch.arange(f, device="cuda") % 3 == 0
    mkw = dict(kw, bin_limit=nb // 2, feat_mask=mask)
    masked = fused_level_split_cuda(bins, g, h, node, n_nodes=nn, n_bins=nb,
                                    lam=lam, min_child_weight=mcw,
                                    bin_limit=nb // 2, feat_mask=mask)
    ties.append(_decisions_tie_aware(torch, ref, plain, got[0], masked, mkw, exact=skew))
    real = torch.isfinite(masked[1])
    _check(bool(mask[masked[2][real].long()].all()
                and (masked[3][real] < nb // 2 - 1).all()), "mask or bin_limit ignored")
    sub_ms = None
    if nn > 1:
        parent = scatter(bins, g, h, node // 2, nn // 2, nb)
        sub = ops.level_split(bins, g, h, node, n_nodes=nn, n_bins=nb, lam=lam,
                              min_child_weight=mcw, parent_hist=parent)
        _check(torch.allclose(sub[0], plain, **HIST_TOL), "subtraction hist")
        ties.append(_decisions_tie_aware(torch, ref, plain, sub[0], sub, kw, exact=skew))
        sub_ms = _time_ms(torch, lambda: ops.level_split(
            bins, g, h, node, n_nodes=nn, n_bins=nb, lam=lam,
            min_child_weight=mcw, parent_hist=parent))
    ms = _time_ms(torch, lambda: fused_level_split_cuda(
        bins, g, h, node, n_nodes=nn, n_bins=nb, lam=lam, min_child_weight=mcw))
    plain_ms = _time_ms(torch, lambda: ref.split_scan_ref(
        ops._histogram_scatter(bins, g, h, node, nn, nb), **kw))
    hist_ms = _time_ms(torch, lambda: histogram_cuda(
        bins, g, h, node, n_nodes=nn, n_bins=nb))
    gap, gap_tol = (max(t[i] for t in ties) for i in (0, 1))
    flips = sum(t[2] for t in ties)
    row = dict(B=nb, N=nn, skew=skew, level_ms=ms, subtract_ms=sub_ms, hist_ms=hist_ms,
               plain_ms=plain_ms, max_abs_err=err, gain_gap=gap, gain_tol=gap_tol,
               legality_flips=flips)
    print(f"  B={nb:3d} N={nn:2d}{' skewed' if skew else ''}: level {ms:.3f} ms, subtraction "
          f"{'-' if sub_ms is None else f'{sub_ms:.3f}'} ms, histogram "
          f"{hist_ms:.3f} ms, plain {plain_ms:.3f} ms, max|err| {err:.3g}{plain_err}, "
          f"gain gap {gap:.3g} (tol {gap_tol:.3g}, legality flips {flips})",
          flush=True)
    return row


def _forest_cell(torch, gen, out: dict) -> None:
    """Phase 2's forest cell: the level kernel at the forest's deepest level
    (a depth-10 tree: N = 512 nodes, the 256 smaller children accumulated
    and their siblings taken from the parent's histogram) with 5 of 28
    features unmasked and the forest's integer statistics (g = -y*w,
    h = w, w ~ Poisson(1)). Every sum is exact, so the histograms are held
    bit-equal to the plain path and the decisions equal."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.histogram import fused_level_split_cuda

    r, f, nb, nn = FOREST_R, F_KERNEL, 256, FOREST_NODES
    dev = torch.device("cuda")
    bins = torch.randint(0, nb, (r, f), generator=gen, device=dev, dtype=torch.int32)
    w = torch.poisson(torch.ones(r, device=dev), generator=gen)
    y = (torch.rand(r, generator=gen, device=dev) < 0.5).float()
    g, h = -y * w, w
    node = torch.randint(0, nn, (r,), generator=gen, device=dev, dtype=torch.int32)
    mask = torch.zeros(f, dtype=torch.bool, device=dev)
    mask[torch.randperm(f, generator=gen, device=dev)[:FOREST_FEATURES]] = True
    kw = dict(n_nodes=nn, n_bins=nb, lam=1e-6, min_child_weight=1.0, feat_mask=mask)
    plain_hist = ops._histogram_scatter(bins, g, h, node, nn, nb)
    plain = ref.split_scan_ref(plain_hist, lam=1e-6, min_child_weight=1.0, n_bins=nb,
                               feat_mask=mask)
    parent = ops._histogram_scatter(bins, g, h, node // 2, nn // 2, nb)
    sub = ops.level_split(bins, g, h, node, parent_hist=parent, **kw)
    direct = fused_level_split_cuda(bins, g, h, node, **kw)
    torch.cuda.synchronize()
    for what, got in (("subtraction", sub), ("direct", direct)):
        _check(torch.equal(got[0], plain_hist), f"forest cell {what}: histogram not bit-equal")
        _check(torch.equal(got[2], plain[1]) and torch.equal(got[3], plain[2]),
               f"forest cell {what}: decisions differ from the plain path's")
        _check(bool(mask[got[2][torch.isfinite(got[1])].long()].all()),
               f"forest cell {what}: a masked feature won")
    _check(all(torch.equal(a, b) for a, b in zip(
        sub, ops.level_split(bins, g, h, node, parent_hist=parent, **kw))),
        "forest cell: two launches differ")
    sub_ms = _time_ms(torch, lambda: ops.level_split(bins, g, h, node, parent_hist=parent,
                                                     **kw))
    direct_ms = _time_ms(torch, lambda: fused_level_split_cuda(bins, g, h, node, **kw))
    plain_ms = _time_ms(torch, lambda: ref.split_scan_ref(
        ops._histogram_scatter(bins, g, h, node, nn, nb), lam=1e-6, min_child_weight=1.0,
        n_bins=nb, feat_mask=mask), reps=3)
    flat = ((node.long()[:, None] * f + torch.arange(f, device=dev)[None, :]) * nb
            + bins.long()).reshape(-1)
    gh = torch.stack([g, h], dim=1)[:, None, :].expand(r, f, 2).reshape(-1, 2)
    lib_ms = _time_ms(torch, lambda: torch.zeros((nn * f * nb, 2), device=dev)
                      .index_add_(0, flat, gh), reps=3)
    del flat, gh
    # the subtraction level's work: the plan reads every row's node, the
    # smaller children's rows are accumulated, the parent histogram is read
    # and the level's histogram and decisions written
    n_small = int(ops._plan_smaller_child(node, nn, r)[2].sum())
    n_bytes = r * 4 + n_small * (f * 4 + 12) + (nn // 2 + nn) * f * nb * 8 + f + nn * 12
    bound, by = _bound_ms(n_bytes, 2 * n_small * f + 10 * nn * f * nb)
    print(f"  forest's deepest level R={r:,} F={f} B={nb} N={nn}, {FOREST_FEATURES} of {f} "
          f"features, Poisson integer g/h: subtraction level {sub_ms:.3f} ms ({n_small:,} "
          f"smaller-child rows), direct kernel {direct_ms:.3f} ms, plain {plain_ms:.3f} ms, "
          f"index_add_ {lib_ms:.3f} ms, bound {bound:.4f} ms ({by}); histograms bit-equal, "
          f"decisions equal", flush=True)
    out["forest_level"] = dict(ms=sub_ms, direct_ms=direct_ms, plain_ms=plain_ms,
                               library_ms=lib_ms, bound_ms=bound, bound_by=by)


def _nonfinite_cell(torch, gen) -> None:
    """Phase 2's non-finite cell: integer g/h at R = 800,000, F = 28, B =
    64, N = 8, with NaN, +inf and -inf planted in g and h (one cell meets
    both infinities). The kernel gives the plain path's histogram, NaN for
    NaN and the same infinities, the finite cells bit-equal, direct and by
    subtraction; the decisions are the plain scan's on it."""
    from repro_torch.kernels import ops, ref

    nn, nb = 8, 64
    bins, g, h, node = _level_inputs(torch, gen, R_KERNEL, F_KERNEL, nb, nn, integer=True)
    bins[:8], node[:8] = 3, 0
    g[0], g[1], g[2], h[3] = float("inf"), float("-inf"), float("nan"), float("inf")
    g[4], bins[4] = float("inf"), 5
    h[5], h[6], bins[5:7] = float("-inf"), float("inf"), 6
    kw = dict(n_nodes=nn, n_bins=nb, lam=1.0, min_child_weight=1.0)
    plain = ops._histogram_scatter(bins, g, h, node, nn, nb)
    parent = ops._histogram_scatter(bins, g, h, node // 2, nn // 2, nb)
    _check(bool(torch.isnan(plain).any() and torch.isinf(plain).any()), "non-finite cell")
    for mode, ph in (("direct", None), ("subtraction", parent)):
        got = ops.level_split(bins, g, h, node, parent_hist=ph, **kw)
        want = plain if ph is None else ops.level_split(
            bins, g, h, node, parent_hist=ph, force="plain", **kw)[0]
        _check(torch.equal(torch.isnan(got[0]), torch.isnan(want))
               and torch.equal(torch.nan_to_num(got[0]), torch.nan_to_num(want)),
               f"non-finite g/h {mode}: histogram is not the plain path's")
        scan = ref.split_scan_ref(got[0], lam=1.0, min_child_weight=1.0, n_bins=nb)
        _check(torch.equal(got[2], scan[1]) and torch.equal(got[3], scan[2]),
               f"non-finite g/h {mode}: decisions are not the plain scan's")
    print(f"  non-finite g/h R={R_KERNEL:,} N={nn} B={nb}: NaN and infinities as the plain "
          f"path's ({int(torch.isnan(plain).sum())} NaN, {int(torch.isinf(plain).sum())} "
          f"infinite cells), finite cells bit-equal, direct and by subtraction", flush=True)


def _permutation_cell(torch, gen) -> None:
    """Phase 2's row-permutation cell: real g/h at R = 800,000, F = 28, B =
    256, N = 8; the same rows shuffled give bit-equal histograms and equal
    decisions, direct and by subtraction, and so does the histogram alone."""
    from repro_torch.kernels import ops

    nn, nb = 8, 256
    t = _level_inputs(torch, gen, R_KERNEL, F_KERNEL, nb, nn)
    perm = torch.randperm(R_KERNEL, generator=gen, device="cuda")
    s = [x[perm].contiguous() for x in t]
    kw = dict(n_nodes=nn, n_bins=nb, lam=1.0, min_child_weight=1.0)
    parent = ops._histogram_scatter(t[0], t[1], t[2], t[3] // 2, nn // 2, nb)
    for mode, ph in (("direct", None), ("subtraction", parent)):
        a = ops.level_split(*t, parent_hist=ph, **kw)
        b = ops.level_split(*s, parent_hist=ph, **kw)
        _check(all(torch.equal(x, y) for x, y in zip(a, b)),
               f"row permutation {mode}: the level differs")
    _check(torch.equal(ops.histogram(*t, n_nodes=nn, n_bins=nb),
                       ops.histogram(*s, n_nodes=nn, n_bins=nb)),
           "row permutation: the histogram differs")
    print(f"  rows permuted R={R_KERNEL:,} N={nn} B={nb}: histograms bit-equal and decisions "
          f"equal, direct and by subtraction", flush=True)


def _level_launch_counts(torch, gen, out: dict) -> None:
    """The kernel launches of one level, counted on the device by the
    profiler: two where one tile holds the level (the root, the leaf sums),
    three where rows are grouped by node."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.histogram import level_launches

    counts = {}
    for label, r, f, nb, nn, sub in (("root", R_KERNEL, F_KERNEL, 64, 1, False),
                                     ("N=8", R_KERNEL, F_KERNEL, 64, 8, False),
                                     ("forest by subtraction", FOREST_R, F_KERNEL, 256,
                                      FOREST_NODES, True),
                                     ("leaf sums", R_KERNEL, 1, 1, 64, False)):
        bins, g, h, node = _level_inputs(torch, gen, r, f, nb, nn)
        ph = ops._histogram_scatter(bins, g, h, node // 2, nn // 2, nb) if sub else None
        if label == "leaf sums":
            def call():
                return ops.histogram(bins, g, h, node, n_nodes=nn, n_bins=nb)
        else:
            def call():
                return ops.level_split(bins, g, h, node, n_nodes=nn, n_bins=nb, lam=1.0,
                                       min_child_weight=1.0, parent_hist=ph)
        call()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type.name == "CUDA"
                 and ("level_" in e.name or "split_scan" in e.name)]
        planned = level_launches(r, f, nb, nn, subtract=sub)
        _check(not names or len(names) == planned,
               f"{label}: {len(names)} kernel launches, planned {planned}")
        counts[label] = len(names) if names else None
    out["level_launches"] = counts
    print("  kernel launches a level (profiler): " + "; ".join(
        f"{k} {'not measured' if v is None else v}" for k, v in counts.items()), flush=True)


def _sharded_stats(torch, gen, r, integer):
    """Phase 2's sharded cells' statistics: a logistic round's g/h at a
    seeded random margin (or integer-valued ones), and a random node of
    SHARD_NODES per row."""
    y = (torch.rand(r, generator=gen, device="cuda") < 0.5).float()
    if integer:
        g = torch.randint(-8, 9, (r,), generator=gen, device="cuda").float()
        h = torch.randint(1, 5, (r,), generator=gen, device="cuda").float()
    else:
        p = torch.sigmoid(torch.randn(r, generator=gen, device="cuda"))
        g, h = p - y, p * (1 - p)
    node = torch.randint(0, SHARD_NODES, (r,), generator=gen, device="cuda",
                         dtype=torch.int32)
    return g, h, node


def _sharded_cells(torch, gen, out: dict) -> None:
    """Phase 2's sharded-level cells (DESIGN.md §3.9): the level on the
    shards' stacked row blocks (one ``histogram_cuda`` launch for every
    shard's partial histogram, a shard-order sum, ``split_scan_cuda``)
    against the unsharded level kernel, at R = 800,000 HIGGS-like rows, F =
    28, B in {64, 256}, S in {2, 4, 8}, N = SHARD_NODES, direct and by
    subtraction: histograms within HIST_TOL and decisions tie-aware on real
    g/h, bit-equal histograms and equal decisions on integer g/h, two runs
    bit-identical, each run's launches counted. Also the split scan alone
    against its plain version, for the kernels line."""
    from repro_torch.compat import sharded_call
    from repro_torch.core import convert
    from repro_torch.core.data_format import shard_payload
    from repro_torch.data.synthetic import make_higgs_like
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.histogram import launch_counts, split_scan_cuda

    higgs = make_higgs_like(R_KERNEL, seed=2)
    nn, lam, mcw = SHARD_NODES, 1.0, 1.0
    kw = dict(n_nodes=nn, lam=lam, min_child_weight=mcw)
    rows = []
    for nb in (64, 256):
        bins = convert(higgs, "quantized_bins", max_bins=nb, device="cuda")["bins"]
        for integer in (False, True):
            g, h, node = _sharded_stats(torch, gen, R_KERNEL, integer)
            plain = ops._histogram_scatter(bins, g, h, node, nn, nb)
            parent = ops._histogram_scatter(bins, g, h, node // 2, nn // 2, nb)
            for s in SHARD_COUNTS:
                sh = shard_payload({"bins": bins, "g": g, "h": h, "node": node}, s)
                blocks = [sh[k] for k in ("bins", "g", "h", "node", "_shard_valid")]
                for mode, ph in (("direct", None), ("subtraction", parent)):
                    run = sharded_call(
                        lambda axis, b, gg, hh, nd, v: ops.level_split(
                            b, gg, hh, nd, n_bins=nb, axis_name=axis, row_valid=v,
                            parent_hist=ph, **kw), n_shards=s)
                    before = launch_counts()
                    got = run(*blocks)
                    torch.cuda.synchronize()
                    after = launch_counts()
                    launches = {k: after[k] - before[k] for k in after}
                    _check(launches == {"histogram": 1, "level_split": 0, "split_scan": 1},
                           f"sharded level launched {launches}")
                    _check(all(torch.equal(a, b) for a, b in zip(got, run(*blocks))),
                           f"sharded level B={nb} S={s} {mode}: two runs differ")
                    label = f"B={nb} S={s} {mode}{' integer' if integer else ''}"
                    err = float((got[0] - plain).abs().max())
                    if integer:
                        base = ops.level_split(bins, g, h, node, n_bins=nb, parent_hist=ph, **kw)
                        _check(torch.equal(got[0], plain) and all(
                            torch.equal(a, b) for a, b in zip(got[1:], base[1:])),
                            f"sharded level {label}: not bit-equal to the unsharded level")
                        continue
                    _check(torch.allclose(got[0], plain, **HIST_TOL),
                           f"sharded level {label}: hist off by {err}")
                    gap, gtol, flips = _decisions_tie_aware(
                        torch, ref, plain, got[0], got, dict(lam=lam, min_child_weight=mcw,
                                                             n_bins=nb))
                    ms = _time_ms(torch, lambda: run(*blocks))
                    base_ms = _time_ms(torch, lambda: ops.level_split(
                        bins, g, h, node, n_bins=nb, parent_hist=ph, **kw))
                    # every row's bins, g, h, node id and valid flag read; the
                    # S partial histograms (of N/2 smaller children by
                    # subtraction) written and read, the parent's read; the
                    # level's histogram and decisions written
                    part = (nn // 2 if ph is not None else nn) * F_KERNEL * nb
                    n_bytes = (R_KERNEL * (F_KERNEL * 4 + 13) + 2 * s * part * 8
                               + (part * 8 if ph is not None else 0) + nn * F_KERNEL * nb * 8
                               + nn * 12)
                    bound, by = _bound_ms(n_bytes, 2 * R_KERNEL * F_KERNEL + 2 * s * part
                                          + 10 * nn * F_KERNEL * nb)
                    rows.append(dict(B=nb, S=s, mode=mode, ms=ms, unsharded_ms=base_ms,
                                     max_abs_err=err, gain_gap=gap, bound_ms=bound,
                                     bound_by=by))
                    print(f"  sharded level {label} N={nn}: {ms:.3f} ms (unsharded level "
                          f"kernel {base_ms:.3f} ms, bound {bound:.4f} ms ({by})), "
                          f"launches {launches} a level, "
                          f"max|err| {err:.3g}, gain gap {gap:.3g} (tol {gtol:.3g}, "
                          f"legality flips {flips}); integer g/h bit-equal", flush=True)
    # the split scan alone, at the last level of a depth-6 GBDT (N = 32)
    # on 64 bins: the numbers of the kernels line
    bins, g, h, node = _level_inputs(torch, gen, R_KERNEL, F_KERNEL, 64, 32)
    hist = ops._histogram_scatter(bins, g, h, node, 32, 64)
    got = split_scan_cuda(hist, lam=lam, min_child_weight=mcw)
    want = ref.split_scan_ref(hist, lam=lam, min_child_weight=mcw, n_bins=64)
    torch.cuda.synchronize()
    _decisions_tie_aware(torch, ref, hist, hist, (None, *got),
                         dict(lam=lam, min_child_weight=mcw, n_bins=64))
    fin = torch.isfinite(want[0])
    err = float((got[0] - want[0])[fin].abs().max())
    _check(all(torch.equal(a, b) for a, b in zip(got, split_scan_cuda(
        hist, lam=lam, min_child_weight=mcw))), "split scan: two launches differ")
    n_cells = 32 * F_KERNEL * 64
    bound, by = _bound_ms(n_cells * 8 + F_KERNEL * 4 + 32 * 12, 10 * n_cells)
    out["split_scan"] = dict(
        ms=_time_ms(torch, lambda: split_scan_cuda(hist, lam=lam, min_child_weight=mcw)),
        plain_ms=_time_ms(torch, lambda: ref.split_scan_ref(
            hist, lam=lam, min_child_weight=mcw, n_bins=64)),
        max_abs_err=err, bound_ms=bound, bound_by=by, library_ms=None)
    sc = out["split_scan"]
    print(f"  split scan alone N=32 F={F_KERNEL} B=64: {sc['ms']:.4f} ms, plain "
          f"{sc['plain_ms']:.4f} ms, bound {bound:.5f} ms ({by}), best-gain max|err| "
          f"{err:.3g}, decisions tie-aware", flush=True)
    out["sharded_rows"] = rows


def phase_kernels(torch, out: dict) -> None:
    from repro_torch.kernels import ops
    from repro_torch.kernels.histogram import histogram_cuda

    gen = torch.Generator(device="cuda").manual_seed(0)
    r, f = R_KERNEL, F_KERNEL
    lam, mcw = 1.0, 1.0
    rows = []
    cells = [(nb, nn, False) for nb in (32, 64, 128, 256) for nn in (1, 8, 32)]
    cells += [(nb, nn, True) for nb in (64, 256) for nn in (1, 8)]
    for nb, nn, skew in cells:
        rows.append(_level_cell(torch, gen, r, f, nb, nn, skew))
    _forest_cell(torch, gen, out)
    # the cells added with the fixed-point kernel draw from their own
    # generator, so the cells after them keep their inputs
    gen_fp = torch.Generator(device="cuda").manual_seed(1)
    _nonfinite_cell(torch, gen_fp)
    _permutation_cell(torch, gen_fp)
    _level_launch_counts(torch, gen_fp, out)
    _sharded_cells(torch, gen, out)
    # integer-valued grad/hess: every sum is exact, so bit-equal in any order
    for nb, nn, skew in ((64, 1, False), (256, 32, False), (256, 8, True)):
        bins, g, h, node = _level_inputs(torch, gen, r, f, nb, nn, integer=True, skew=skew)
        plain = ops._histogram_scatter(bins, g, h, node, nn, nb)
        _check(torch.equal(histogram_cuda(bins, g, h, node, n_nodes=nn, n_bins=nb), plain),
               "integer histogram not bit-equal")
        if nn > 1:
            parent = ops._histogram_scatter(bins, g, h, node // 2, nn // 2, nb)
            sub = ops.level_split(bins, g, h, node, n_nodes=nn, n_bins=nb, lam=lam,
                                  min_child_weight=mcw, parent_hist=parent)
            _check(torch.equal(sub[0], plain), "integer subtraction not bit-equal")
    # R = 0 (subtraction with one row leaves no smaller-child rows)
    bins, g, h, node = _level_inputs(torch, gen, 1, f, 32, 2)
    parent = ops._histogram_scatter(bins, g, h, node // 2, 1, 32)
    sub = ops.level_split(bins, g, h, node, n_nodes=2, n_bins=32, lam=lam,
                          min_child_weight=0.0, parent_hist=parent)
    _check(torch.equal(sub[0], ops._histogram_scatter(bins, g, h, node, 2, 32)), "R=0")

    # the numbers of the kernels line: the root level of the default config
    # (B = 64) for level_split, the leaf sums of a depth-6 tree for histogram
    b64 = next(x for x in rows if x["B"] == 64 and x["N"] == 1 and not x["skew"])
    n_bytes = r * f * 4 + r * 12 + f * 4 + 1 * f * 64 * 8 + 12
    bound, by = _bound_ms(n_bytes, 2 * r * f + 10 * f * 64)
    out["level_split"] = dict(ms=b64["level_ms"], plain_ms=b64["plain_ms"],
                              max_abs_err=b64["max_abs_err"], bound_ms=bound,
                              bound_by=by, library_ms=None)
    n_leaves = 64
    bins, g, h, node = _level_inputs(torch, gen, r, 1, 1, n_leaves)
    bins.zero_()
    hk = histogram_cuda(bins, g, h, node, n_nodes=n_leaves, n_bins=1)
    hp = ops._histogram_scatter(bins, g, h, node, n_leaves, 1)
    _check(torch.allclose(hk, hp, **HIST_TOL), "leaf sums")
    gh = torch.stack([g, h], dim=1)
    nl = node.long()
    lib_ms = _time_ms(torch, lambda: torch.zeros(n_leaves, 2, device="cuda").index_add_(0, nl, gh))
    bound, by = _bound_ms(r * 4 + r * 12 + n_leaves * 8, 2 * r)
    out["histogram"] = dict(
        ms=_time_ms(torch, lambda: histogram_cuda(bins, g, h, node, n_nodes=n_leaves, n_bins=1)),
        plain_ms=_time_ms(torch, lambda: ops._histogram_scatter(bins, g, h, node, n_leaves, 1)),
        max_abs_err=(hk - hp).abs().max().item(), bound_ms=bound, bound_by=by,
        library_ms=lib_ms)
    leaf = out["histogram"]
    print(f"  leaf sums F=1 B=1 N={n_leaves}: histogram {leaf['ms']:.3f} ms, plain "
          f"{leaf['plain_ms']:.3f} ms, index_add_ {lib_ms:.3f} ms, bound {bound:.4f} ms ({by}), "
          f"max|err| {leaf['max_abs_err']:.3g}", flush=True)
    out["phase2_rows"] = rows


def _higgs(n_rows: int):
    from repro_torch.data.synthetic import make_higgs_like

    data = make_higgs_like(n_rows, seed=0)
    train, valid = data.split((0.8, 0.2), seed=1)
    train, mu, sd = train.standardize()
    valid, _, _ = valid.standardize(mu, sd)
    return train, valid


def phase_search(torch, out: dict, train, valid) -> None:
    from repro_torch.core import (GridBuilder, SamplingProfiler, SearchSpec, Session,
                                  prepared_data_cache)
    from repro_torch.kernels.histogram import launch_counts, reset_launch_counts

    space = (GridBuilder("gbdt").add_grid("eta", [0.1, 0.3])
             .add_grid("max_bin", [32, 64, 128]).build())
    spec = SearchSpec(spaces=[space], n_executors=2, policy="lpt",
                      profiler=SamplingProfiler(0.01))
    session = Session(spec)
    reset_launch_counts()
    t0 = time.perf_counter()
    results = list(session.results(train, valid))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    _check(len(results) == 6, f"expected 6 results, got {len(results)}")
    for res in results:
        _check(res.ok and res.score is not None, f"{res.task.key()}: {res.error}")
    rounds, depth = 30, 6
    _check(counts["level_split"] >= len(results) * rounds * depth,
           f"level_split launched {counts['level_split']} times")
    _check(counts["histogram"] >= len(results) * rounds, "leaf sums did not launch")
    best = max(results, key=lambda x: x.score)
    pc = prepared_data_cache()
    print(f"  tasks {len(results)}, wall {wall:.2f} s, best auc {best.score:.6f} "
          f"({best.task.key()}), launches {counts}, prepared cache "
          f"hits {session.stats.prepared_cache_hits} misses "
          f"{session.stats.prepared_cache_misses} bytes {pc.bytes_cached}", flush=True)
    _add_launches(out, counts)
    out["search"] = dict(tasks=len(results), wall_s=wall, best_auc=best.score)


def phase_path(torch, out: dict, train, valid) -> None:
    from repro_torch.core import get_estimator, prepare_cached, auc

    est = get_estimator("gbdt")
    params = {"eta": 0.3, "max_bin": 64, "round": 30, "max_depth": 6}
    data, _, _ = prepare_cached(train, "quantized_bins", {"max_bins": 64})
    x_dev = torch.as_tensor(valid.x, device="cuda")
    kern = est.train(data, params)
    plain = est.train(data, params, force="ref")
    auc_k = auc(valid.y, kern.predict_proba_device(x_dev))
    auc_p = auc(valid.y, plain.predict_proba_device(x_dev))
    print(f"  auc kernel {auc_k:.6f} plain {auc_p:.6f} gap {abs(auc_k - auc_p):.2e}",
          flush=True)
    _check(abs(auc_k - auc_p) <= AUC_TOL, "kernel and plain paths disagree on AUC")
    _check(bool((kern.predict_margin_device(x_dev) == kern.predict_margin(valid.x)).all()),
           "device margins differ from numpy margins")
    again = est.train(data, params)
    same = lambda a, b: all(np.array_equal(getattr(a, k), getattr(b, k))  # noqa: E731
                            for k in ("feat", "thresh", "leaves"))
    _check(same(kern, again), "two identical trainings differ")
    _, s10 = est.train_resumable(data, params, budget=10)
    resumed, _ = est.train_resumable(data, params, budget=30, state=s10)
    _check(same(kern, resumed), "resume 10 + 20 differs from 30 straight rounds")
    print("  deterministic: two runs bit-identical; resume 10+20 == 30 rounds", flush=True)
    out["path"] = dict(auc_kernel=auc_k, auc_plain=auc_p)


def phase_full_size(torch, out: dict) -> None:
    from repro_torch.core import convert, get_estimator
    from repro_torch.data.synthetic import make_higgs_like

    n_rows, rounds = 11_000_000, 10
    t0 = time.perf_counter()
    data = make_higgs_like(n_rows, seed=0)
    t_gen = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    prepared = convert(data, "quantized_bins", max_bins=256)
    torch.cuda.synchronize()
    t_conv = time.perf_counter() - t0
    del data
    est = get_estimator("gbdt")
    params = {"max_bin": 256, "max_depth": 6, "round": rounds}
    est.train(prepared, {**params, "round": 1})     # warm-up: allocator, first launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = est.train(prepared, params)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    _check(np.isfinite(model.leaves).all() and model.feat.shape == (rounds, 63),
           "full-size model malformed")
    peak = torch.cuda.max_memory_allocated()
    # kernels' share of the wall time, from a profiled two-round fit
    from torch.profiler import ProfilerActivity, profile

    names = ("level_stats", "level_group", "level_accumulate", "split_scan")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        est.train(prepared, {**params, "round": 2})
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    kern_us = dev_us = 0.0
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue                     # host ops: their kernels count below
        t = _self_device_us(evt)
        dev_us += t
        if any(n in evt.key for n in names):
            kern_us += t
    share = f"{kern_us / 1e6 / prof_wall:.3f}" if dev_us > 0 else "not measured"
    dev_share = f"{dev_us / 1e6 / prof_wall:.3f}" if dev_us > 0 else "not measured"
    print(f"  rows {n_rows:,} (bins {prepared['bins'].nbytes / 1e9:.2f} GB int32 on "
          f"the card), data {t_gen:.1f} s, quantize {t_conv:.1f} s, train {train_s:.2f} s "
          f"= {train_s / rounds:.3f} s/round, kernels' share {share}, device busy "
          f"{dev_share} (profiled 2-round fit), peak memory {peak / 2**30:.2f} GiB",
          flush=True)
    out["full_size"] = dict(rows=n_rows, s_per_round=train_s / rounds,
                            kernel_share=share, peak_bytes=peak)


# ---------------------------------------------------------------------------
# The paper's grid over the four families (phases 9-10)
# ---------------------------------------------------------------------------

# phase 9's HIGGS-like rows, split 0.6 / 0.2 / 0.2: cut from 1,000,000 to keep
# phases 9 and 10 near 300 s (the two searches at 1,000,000 rows took 124 and
# 141 s on an NVIDIA H100 80GB HBM3 at 700 W, PERF.md; most of a search is host
# time, which the cut leaves as it is)
GRID_ROWS = 250_000
# the paper grid at full size; LPT with SamplingProfiler(0.03) are the CLI's defaults
GRID_ARGV = ["--scale", "1.0", "--executors", "2"]
GRID_TASKS = 89
GRID_FOREST = {"n_estimators": 100, "max_depth": 10}   # the grid's largest forest
FUSED_SCORE_TOL = 1e-4
# logreg on the card against the port's CPU run of one config: the two sum
# rows in other orders, and Adam divides each gradient component by its own
# running scale, so a small component's rounding moves a step by far more
# than an ulp (tests/test_torch_linear.py measures the same against JAX)
LOGREG_PARAM_TOL, LOGREG_PROBA_TOL = 5e-3, 2e-3
TREE_FIELDS = ("feat", "thresh", "leaves")


def _add_launches(out: dict, counts: dict) -> None:
    acc = out.setdefault("launches", {})
    for name, n in counts.items():
        acc[name] = acc.get(name, 0) + n


def _same_trees(a, b) -> bool:
    return all(np.array_equal(getattr(a, k), getattr(b, k)) for k in TREE_FIELDS)


def _grid_search(torch, argv: list[str], label: str):
    """One search through the CLI's ``run_tabular`` over the paper grid,
    the GBDT kernels' launch counts set to 0 just before it and read just
    after. Checks that every task trained and scored and that every tree
    level of the search's GBDT and forest fits went through the level
    kernel; returns ``(args, results, counts, wall)``."""
    from repro_torch.kernels.histogram import launch_counts, reset_launch_counts
    from repro_torch.launch import search

    args = search.parse_args(argv)
    reset_launch_counts()
    t0 = time.perf_counter()
    session = search.run_tabular(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    multi = session.multi_model()
    _check(not multi.failures, f"{label}: failed tasks {[r.error for r in multi.failures][:3]}")
    results = multi.results
    _check(len(results) == GRID_TASKS and all(r.score is not None for r in results),
           f"{label}: {len(results)} results, {sum(r.score is None for r in results)} unscored")
    want_levels = want_trees = 0
    fam: dict[str, list] = {}
    for r in results:
        p = r.task.params
        trees = {"gbdt": p.get("round"), "forest": p.get("n_estimators")}.get(r.task.estimator)
        if trees is not None:
            want_levels += trees * p["max_depth"]
            want_trees += trees
        f = fam.setdefault(r.task.estimator, [0, 0.0, 0.0])
        f[0] += 1
        f[1] += r.train_seconds
        f[2] = max(f[2], r.score)
    _check(counts["level_split"] >= want_levels and counts["histogram"] >= want_trees,
           f"{label}: launches {counts}, the search's own fits need {want_levels} levels and "
           f"{want_trees} trees")
    print(f"  {label}: {len(results)} tasks in {wall:.2f} s, profiling ratio "
          f"{session.stats.profiling_ratio:.3f}, launches {counts} (the search's own fits: "
          f"{want_levels} levels, {want_trees} trees; the rest are the sampling profiler's)",
          flush=True)
    print("  by family: " + "; ".join(
        f"{name} {n} tasks, train {secs:.2f} s (summed over tasks), best auc {best:.6f}"
        for name, (n, secs, best) in sorted(fam.items())), flush=True)
    return args, results, counts, wall


def _best_line(args, results, label: str) -> dict:
    from repro_torch.core import auc
    from repro_torch.launch import search

    _, _, test = search.tabular_data(args)
    best = max(results, key=lambda r: r.score)
    test_auc = auc(test.y, best.model.predict_proba(test.x))
    print(f"  {label} best: {best.task.key()} valid auc {best.score:.6f}, test auc "
          f"{test_auc:.6f}", flush=True)
    return dict(best=best.task.key(), valid_auc=best.score, test_auc=test_auc)


# one config a family, timed alone: host against device
FAMILY_PROBES = (("gbdt", {"eta": 0.3, "round": 30, "max_bin": 64, "max_depth": 6}),
                 ("forest", {"n_estimators": 50, "max_depth": 8}),
                 ("mlp", {"network": "128_128", "learning_rate": 0.003, "steps": 200}),
                 ("logreg", {"c": 0.3}))


def _family_device_share(torch, train) -> dict:
    """Each family's train seconds for one config, alone on the card, and
    the share of that wall its kernels kept the device busy (the kernels'
    time from a profiled second run, over the wall of an unprofiled one)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import get_estimator, prepare_cached

    shares = {}
    for family, params in FAMILY_PROBES:
        est = get_estimator(family)
        data, _, _ = prepare_cached(train, est.data_format, est.format_params(params))
        est.train(data, params)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        est.train(data, params)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            est.train(data, params)
            torch.cuda.synchronize()
        dev_us = sum(_self_device_us(e) for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA)
        shares[family] = dict(params=params, train_s=wall,
                              device_busy=dev_us / 1e6 / wall if dev_us > 0 else None)
    for family, v in shares.items():
        busy = v["device_busy"]
        print(f"  {family} {v['params']} alone: {v['train_s']:.3f} s, device busy "
              f"{'not measured' if busy is None else f'{busy:.3f}'}", flush=True)
    return shares


def phase_paper_grid(torch, out: dict) -> None:
    from repro_torch import default_device
    from repro_torch.core import convert, get_estimator, prepare_cached
    from repro_torch.launch import search

    _check(not torch.backends.cuda.matmul.allow_tf32,
           "TF32 matmuls are on: logreg and the MLP train in float32")
    argv = ["--dataset", "higgs", "--rows", str(GRID_ROWS)] + GRID_ARGV
    args, results, counts, wall = _grid_search(torch, argv, "HIGGS-like grid")
    _add_launches(out, counts)
    out["grid_higgs"] = dict(wall_s=wall, launches=counts,
                             **_best_line(args, results, "HIGGS-like grid"))
    train, valid, _ = search.tabular_data(args)
    out["grid_higgs"]["families"] = _family_device_share(torch, train)

    # one forest config: the search's model, a second kernel run, the plain
    # path and a resume 50 + 50, all bit-identical (integer statistics)
    params = dict(GRID_FOREST)
    est = get_estimator("forest")
    data, _, _ = prepare_cached(train, "quantized_bins", {})
    in_search = next(r.model for r in results
                     if r.task.estimator == "forest" and dict(r.task.params) == params)
    t0 = time.perf_counter()
    kern = est.train(data, params)
    torch.cuda.synchronize()
    kern_s = time.perf_counter() - t0
    _check(_same_trees(kern, in_search), "forest: two kernel runs grew different trees")
    t0 = time.perf_counter()
    plain = est.train(data, params, force="plain")
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    _check(_same_trees(kern, plain), "forest: the kernel and plain paths grew different trees")
    n = params["n_estimators"]
    _, half = est.train_resumable(data, params, budget=n // 2)
    resumed, _ = est.train_resumable(data, params, budget=n, state=half)
    _check(_same_trees(kern, resumed),
           f"forest: resume {n // 2} + {n - n // 2} differs from {n} straight trees")
    print(f"  forest {params}: kernel path {kern_s:.2f} s, plain path {plain_s:.2f} s; trees "
          f"bit-identical between the search, a second kernel run, the plain path and a "
          f"resume {n // 2} + {n - n // 2}", flush=True)

    # one logreg config on the card against the port's own CPU run
    lr_params = {"c": 0.9}
    lr_est = get_estimator("logreg")
    on_card = lr_est.train(prepare_cached(train, "dense_rows")[0], lr_params)
    on_cpu = lr_est.train(convert(train, "dense_rows", device="cpu"), lr_params)
    dw = max(float(np.abs(on_card.w - on_cpu.w).max()), abs(on_card.b - on_cpu.b))
    dp = float(np.abs(on_card.predict_proba(valid.x) - on_cpu.predict_proba(valid.x)).max())
    print(f"  logreg {lr_params} card vs CPU: params {dw:.3g} (tol {LOGREG_PARAM_TOL:g}), "
          f"probabilities {dp:.3g} (tol {LOGREG_PROBA_TOL:g})", flush=True)
    _check(dw <= LOGREG_PARAM_TOL and dp <= LOGREG_PROBA_TOL,
           "logreg on the card is off its CPU run")

    # the same search with fused batches: the same scores, the same trees
    _, fused, fcounts, fwall = _grid_search(torch, argv + ["--fuse"], "HIGGS-like grid, --fuse")
    x_dev = torch.as_tensor(valid.x, device=default_device())
    by_key = {r.task.key(): r for r in results}
    gap = 0.0
    n_trees = 0
    for fr in fused:
        r = by_key[fr.task.key()]
        gap = max(gap, abs(fr.score - r.score))
        if fr.task.estimator in ("gbdt", "forest"):
            n_trees += 1
            _check(np.array_equal(fr.model.predict_margin_device(x_dev),
                                  r.model.predict_margin_device(x_dev)),
                   f"{fr.task.key()}: the fused model's margins differ")
    worst = max(fused, key=lambda fr: abs(fr.score - by_key[fr.task.key()].score))
    _check(gap <= FUSED_SCORE_TOL, f"fused scores off the unfused ones by {gap:.3g} "
                                   f"({worst.task.key()})")
    print(f"  fused against unfused: largest score gap {gap:.3g} (tol {FUSED_SCORE_TOL:g}); "
          f"the {n_trees} GBDT and forest models' validation margins bit-equal", flush=True)
    # the program caches. Each of the fused grid's batches has its own
    # signature (family, padded steps or rounds, depth, bins, padded batch),
    # so the grid builds one program a batch and reuses none; the grid's
    # logreg configs trained again as one fused batch, twice, on the
    # search's prepared data: the second call must reuse the first's program
    # (a hit) and give the first call's models bit for bit
    from repro_torch.core import compile_cache, predict_compile_cache

    lr_runs = [r for r in fused if r.task.estimator == "logreg"]
    prepared = prepare_cached(train, "dense_rows")[0]
    cc, pc = compile_cache(), predict_compile_cache()
    hits0 = cc.counters()[0]
    again = [lr_est.train_batched(prepared, [dict(r.task.params) for r in lr_runs])
             for _ in range(2)]
    _check(cc.counters()[0] >= hits0 + 1, "a second fused logreg batch did not reuse its program")
    _check(all(np.array_equal(a.w, b.w) and a.b == b.b for a, b in zip(*again)),
           "a fused logreg batch run twice gave different models")
    vs_grid = max(float(np.abs(m.w - r.model.w).max()) for r, m in zip(lr_runs, again[0]))
    caches = {}
    for name, cache in (("compile_cache", cc), ("predict_cache", pc)):
        hits, misses = cache.counters()
        _check(hits > 0, f"{name}: no hits ({hits}h/{misses}m)")
        caches[name] = dict(hits=hits, misses=misses,
                            build_ms=cache.build_seconds / max(misses, 1) * 1e3)
    print(f"  program caches after the fused grid and its {len(lr_runs)} logreg configs "
          f"retrained twice as one batch (the two runs bit-equal; max |w - the grid's w| "
          f"{vs_grid:.3g}): " + "; ".join(
              f"{name}={c['hits']}h/{c['misses']}m, a build (what a hit saves) "
              f"{c['build_ms']:.4f} ms" for name, c in caches.items()), flush=True)
    out["grid_higgs"].update(fused_wall_s=fwall, fused_gap=gap, forest_kernel_s=kern_s,
                             program_caches=caches,
                             forest_plain_s=plain_s, logreg_card_vs_cpu=dw)


def phase_secom_grid(torch, out: dict) -> None:
    """The grid on SECOM-like data, then the kernels at its width (F = 590,
    59 constant features) against their plain versions: one level, tie-aware
    as in phase 2, and one GBDT and one forest config end to end. The
    config's AUC gap is taken over all 1,567 rows: the validation split
    has 19 positives, where one near-tie split that the kernel's sums and
    the plain path's order differently moves the AUC by up to 0.03 (a CPU
    run of the grid's 54 GBDT configs, subtraction against direct: 21 over
    5e-3 on the validation split, 8 over all rows)."""
    from repro_torch.core import auc, get_estimator, prepare_cached
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.histogram import fused_level_split_cuda
    from repro_torch.launch import search

    args, results, counts, wall = _grid_search(torch, ["--dataset", "secom"] + GRID_ARGV,
                                               "SECOM-like grid")
    _add_launches(out, counts)
    out["grid_secom"] = dict(wall_s=wall, launches=counts,
                             **_best_line(args, results, "SECOM-like grid"))
    train, valid, test = search.tabular_data(args)
    all_x = np.concatenate([train.x, valid.x, test.x])
    all_y = np.concatenate([train.y, valid.y, test.y])
    gbdt = {"eta": 0.3, "round": 30, "max_bin": 64, "max_depth": 6}
    data, _, _ = prepare_cached(train, "quantized_bins", {"max_bins": 64})
    bins, y = data["bins"], data["y"]
    p = torch.sigmoid(torch.zeros_like(y))
    g, h = p - y, p * (1 - p)                          # a first boosting round's statistics
    gen = torch.Generator(device=bins.device).manual_seed(1)
    kw = dict(lam=1.0, min_child_weight=1.0, n_bins=64)
    for nn in (1, 32):
        node = torch.randint(0, nn, (bins.shape[0],), generator=gen, device=bins.device,
                             dtype=torch.int32)
        plain = ops._histogram_scatter(bins, g, h, node, nn, 64)
        got = fused_level_split_cuda(bins, g, h, node, n_nodes=nn, **kw)
        _check(torch.allclose(got[0], plain, **HIST_TOL), f"SECOM level N={nn}: histogram")
        gap, tol, flips = _decisions_tie_aware(torch, ref, plain, got[0], got, kw)
        print(f"  level at F={bins.shape[1]} B=64 N={nn}: gain gap {gap:.3g} (tol {tol:.3g}, "
              f"legality flips {flips})", flush=True)
    for family, params, fmt in (("gbdt", gbdt, {"max_bins": 64}),
                                ("forest", {"n_estimators": 50, "max_depth": 8}, {})):
        est = get_estimator(family)
        data, _, _ = prepare_cached(train, "quantized_bins", fmt)
        kern = est.train(data, params)
        plain = est.train(data, params, force="ref")
        gap = abs(auc(all_y, kern.predict_proba(all_x)) - auc(all_y, plain.predict_proba(all_x)))
        gap_v = abs(auc(valid.y, kern.predict_proba(valid.x))
                    - auc(valid.y, plain.predict_proba(valid.x)))
        print(f"  {family} {params}: kernel vs plain auc gap {gap:.3g} over all rows (tol "
              f"{AUC_TOL:g}), {gap_v:.3g} on the validation split; trees "
              f"{'bit-identical' if _same_trees(kern, plain) else 'differ'}", flush=True)
        _check(gap <= AUC_TOL, f"SECOM {family}: kernel and plain paths disagree on AUC")
        if family == "forest":
            _check(_same_trees(kern, plain), "SECOM forest: kernel and plain trees differ")


# ---------------------------------------------------------------------------
# The row-sharded search (phase 11) and the multi-tenant service (phase 12)
# ---------------------------------------------------------------------------

# phase 11: the paper's HIGGS sample size with UCI HIGGS's 28 features, split
# 0.6 / 0.2 / 0.2, and a cut grid that keeps every family (9 configs)
SHARD_ROWS = 1_000_000
SHARD_SEARCH_SHARDS = (1, 2, 4)
SHARD_AUC_TOL = 5e-3        # tree families: AUC against --shards 1
# logreg / MLP validation margins against --shards 1, in units of the
# largest |margin| (at least 1): the shards sum each gradient in another
# order, Adam carries the rounding on, and the MLPs' margins reach ~100,
# where one float32 ulp is 7.6e-6 (a CPU rehearsal at 4,000 rows: 5.3e-5
# absolute at max |margin| 108)
SHARD_MARGIN_TOL = 1e-5
# phase 12: the service's rows, its tenants and the chaos run's faults
SERVICE_ROWS = 250_000
SERVICE_TENANTS = {"alice": 2.0, "bob": 1.0}
CHAOS_FAILURE_RATE, CHAOS_RETRIES = 0.2, 3


def _shard_grid():
    from repro_torch.core import GridBuilder

    return [GridBuilder("gbdt").add_grid("eta", [0.1, 0.3]).add_grid("max_bin", [64, 256])
            .add_grid("max_depth", [6]).add_grid("round", [30]).build(),
            GridBuilder("forest").add_grid("n_estimators", [50]).add_grid("max_depth", [8])
            .build(),
            GridBuilder("logreg").add_grid("c", [0.1, 0.9]).build(),
            GridBuilder("mlp").add_grid("network", ["128_128"])
            .add_grid("learning_rate", [0.003, 0.03]).add_grid("steps", [200]).build()]


def _sharded_search(torch, n_shards: int, backend=None, label=None):
    """One search of the cut grid through the CLI's ``run_tabular`` at
    ``--shards n_shards``, the GBDT kernels' counts set to 0 just before
    and read just after; every task trained and scored, and every tree
    level of the search's own fits through the level kernel (unsharded) or
    the histogram kernel and the split scan (sharded)."""
    from repro_torch.core import prepared_data_cache
    from repro_torch.kernels.histogram import launch_counts, reset_launch_counts
    from repro_torch.launch import search

    args = search.parse_args(["--dataset", "higgs", "--rows", str(SHARD_ROWS), "--scale",
                              "1.0", "--executors", "2", "--shards", str(n_shards)])
    prepared_data_cache().clear()
    reset_launch_counts()
    t0 = time.perf_counter()
    session = search.run_tabular(args, spaces=_shard_grid(), backend=backend)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    label = label or f"--shards {n_shards}"
    multi = session.multi_model()
    n_tasks = sum(len(s.configs) for s in _shard_grid())
    _check(not multi.failures, f"{label}: failed tasks {[r.error for r in multi.failures][:3]}")
    results = {r.task.key(): r for r in multi.results}
    _check(len(results) == n_tasks and all(r.score is not None for r in results.values()),
           f"{label}: {len(results)} results of {n_tasks}, some unscored")
    levels = trees = 0
    for r in results.values():
        n = {"gbdt": r.task.params.get("round"),
             "forest": r.task.params.get("n_estimators")}.get(r.task.estimator)
        if n is not None:
            levels += n * r.task.params["max_depth"]
            trees += n
    level_path = "split_scan" if n_shards > 1 else "level_split"
    _check(counts[level_path] >= levels and counts["histogram"] >= trees,
           f"{label}: launches {counts}, the search's own fits need {levels} levels")
    if n_shards > 1:
        # every sharded level is one histogram launch (all shards) + one scan
        _check(counts["histogram"] >= levels + trees, f"{label}: launches {counts}")
    print(f"  {label}: {len(results)} tasks in {wall:.2f} s, launches {counts} (the "
          f"search's own fits: {levels} levels, {trees} trees; the rest the profiler's), "
          f"shard residency {session.stats.shard_residency_bytes} bytes", flush=True)
    return args, session, results, counts, wall


def phase_sharded_search(torch, out: dict) -> None:
    """The row-sharded search (DESIGN.md §3.9): the cut grid at --shards 1,
    2 and 4 through ``run_tabular``; tree families' validation AUC within
    SHARD_AUC_TOL of --shards 1 and logreg/MLP validation margins within
    SHARD_MARGIN_TOL; per-shard residency within a full copy / S plus pad
    slack; a MeshSliceExecutorPool of 4 slices on cuda:0 in 2 shard groups
    giving the thread pool's results; one sharded config's device-busy
    share alone."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import default_device
    from repro_torch.core import (MeshSliceExecutorPool, get_estimator, prepare_cached,
                                  prepared_data_cache)
    from repro_torch.core.data_format import ShardedPlacement
    from repro_torch.launch import search
    from repro_torch.launch.mesh import make_mesh

    runs = {}
    for s in SHARD_SEARCH_SHARDS:
        args, session, results, counts, wall = _sharded_search(torch, s)
        runs[s] = results
        if s == 1:
            full_bytes = prepared_data_cache().bytes_cached
            n_entries = prepared_data_cache().n_entries
            _, valid, _ = search.tabular_data(args)
            x_val = torch.as_tensor(valid.x, device=default_device())
        out.setdefault("sharded_search", {})[s] = dict(wall_s=wall, launches=counts)
        _add_launches(out, counts)
        if s == 1:
            continue
        resident = session.stats.shard_residency_bytes
        rows_per_shard = -(-int(SHARD_ROWS * 0.6) // s)
        # pad slack per entry: its zero-padded rows (fewer than S, at up to
        # 29 four-byte columns a row), its validity mask, and its replicated
        # leaves (bin edges: 28 x 255 float32 at most)
        slack = n_entries * (s * 29 * 4 + rows_per_shard + 28 * 255 * 4)
        _check(0 < resident <= full_bytes / s + slack,
               f"--shards {s}: residency {resident} beyond {full_bytes}/{s} + {slack}")
        auc_gap, margin_gap, margin_abs = 0.0, 0.0, 0.0
        for key, r in results.items():
            b = runs[1][key]
            if r.task.estimator in ("gbdt", "forest"):
                auc_gap = max(auc_gap, abs(r.score - b.score))
            else:
                m_s, m_1 = (m.model.predict_margin_device(x_val) for m in (r, b))
                gap = float(np.abs(m_s - m_1).max())
                margin_abs = max(margin_abs, gap)
                margin_gap = max(margin_gap, gap / max(1.0, float(np.abs(m_1).max())))
        print(f"  --shards {s} against --shards 1: GBDT/forest validation AUC gap "
              f"{auc_gap:.3g} (tol {SHARD_AUC_TOL:g}), logreg/MLP validation margin gap "
              f"{margin_abs:.3g}, {margin_gap:.3g} of max |margin| (tol {SHARD_MARGIN_TOL:g}); "
              f"residency {resident} bytes "
              f"against a full copy's {full_bytes} / {s} = {full_bytes / s:.0f} + slack "
              f"{slack}", flush=True)
        _check(auc_gap <= SHARD_AUC_TOL, f"--shards {s}: tree AUC off by {auc_gap:.3g}")
        _check(margin_gap <= SHARD_MARGIN_TOL, f"--shards {s}: margins off by {margin_gap:.3g}")
        out["sharded_search"][s].update(auc_gap=auc_gap, margin_gap=margin_gap,
                                        margin_abs=margin_abs,
                                        residency_bytes=resident, full_bytes=full_bytes)

    # the mesh pool: 4 slices of cuda:0 in 2 shard groups of 2
    pool = MeshSliceExecutorPool(make_mesh((4,), ("data",), "cuda:0"), 4, n_shards=2)
    _check(pool.n_executors == 2 and all(
        isinstance(tok, ShardedPlacement) for tok in pool.prepare_placements()),
        "the mesh pool's shard groups")
    _, _, mesh_results, mcounts, mwall = _sharded_search(
        torch, 2, backend=pool, label="MeshSliceExecutorPool(n_shards=2) over 4 slices")
    _add_launches(out, mcounts)
    _check(mesh_results.keys() == runs[2].keys() and all(
        r.score == runs[2][k].score for k, r in mesh_results.items()),
        "the mesh pool's scores differ from the thread pool's")
    print(f"  the mesh pool's {len(mesh_results)} scores equal the thread pool's at "
          f"--shards 2", flush=True)

    # one sharded config alone: its wall and the device's busy share
    est = get_estimator("gbdt")
    params = {"eta": 0.3, "max_bin": 64, "max_depth": 6, "round": 30}
    train, _, _ = search.tabular_data(args)
    data, _, _ = prepare_cached(train, "quantized_bins", est.format_params(params),
                                placement=ShardedPlacement(2))
    est.train(data, params)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    est.train(data, params)
    torch.cuda.synchronize()
    alone_s = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        est.train(data, params)
        torch.cuda.synchronize()
    dev_us = sum(_self_device_us(e) for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    busy = dev_us / 1e6 / alone_s if dev_us > 0 else None
    print(f"  gbdt {params} at --shards 2 alone: {alone_s:.3f} s, device busy "
          f"{'not measured' if busy is None else f'{busy:.3f}'}", flush=True)
    out["sharded_search"]["mesh_wall_s"] = mwall
    out["sharded_search"]["gbdt_alone"] = dict(train_s=alone_s, device_busy=busy)


def _service_grid():
    from repro_torch.core import GridBuilder

    return [GridBuilder("gbdt").add_grid("eta", [0.1, 0.3]).add_grid("max_bin", [32, 64])
            .add_grid("max_depth", [4, 6]).add_grid("round", [20]).build(),
            GridBuilder("forest").add_grid("n_estimators", [20]).add_grid("max_depth", [6])
            .build(),
            GridBuilder("logreg").add_grid("c", [0.1, 0.9]).build(),
            GridBuilder("mlp").add_grid("network", ["64_64"])
            .add_grid("learning_rate", [0.003]).add_grid("steps", [100]).build()]


def phase_service(torch, out: dict) -> None:
    """The multi-tenant search service (DESIGN.md §3.5) and chaos (§3.7):
    one SearchService, tenants alice (weight 2, a replicated search) and
    bob (weight 1, a 2-shard search) at once on one shared prepared cache,
    then bob again under injected train failures with retries. Every task
    scored exactly once, the per-tenant ledgers equal to what was
    submitted and summing to the cache's counters, sharded and replicated
    entries side by side, and the chaos run's best configuration the run
    without chaos's."""
    from repro_torch.core import PreparedDataCache, SearchSpec
    from repro_torch.core.chaos import FaultPlan
    from repro_torch.data.synthetic import make_higgs_like
    from repro_torch.kernels.histogram import launch_counts, reset_launch_counts
    from repro_torch.serve import SearchService

    data = make_higgs_like(SERVICE_ROWS, seed=0)
    train, valid = data.split((0.8, 0.2), seed=0)
    train, mu, sd = train.standardize()
    valid, _, _ = valid.standardize(mu, sd)
    n_tasks = sum(len(s.configs) for s in _service_grid())
    cache = PreparedDataCache()
    svc = SearchService(n_executors=2, prepared_cache=cache)

    def scored_once(handle, label):
        results = list(handle.results())
        ids = [r.task.task_id for r in results]
        _check(len(ids) == n_tasks and len(set(ids)) == n_tasks,
               f"{label}: {len(ids)} results for {n_tasks} tasks")
        _check(all(r.ok and r.score is not None for r in results),
               f"{label}: {[r.error for r in results if not r.ok][:3]}")
        return handle.multi_model().best(valid)

    reset_launch_counts()
    t0 = time.perf_counter()
    try:
        handles = {name: svc.submit_search(
            SearchSpec(spaces=_service_grid(), n_executors=2,
                       n_shards=2 if name == "bob" else 1),
            train, valid, tenant=name, weight=w) for name, w in SERVICE_TENANTS.items()}
        best = {name: scored_once(h, name) for name, h in handles.items()}
        wall = time.perf_counter() - t0
        # bob's per-shard entries beside alice's full copies in the one cache
        sharded_bytes, cached_bytes = cache.sharded_resident_bytes(), cache.bytes_cached
        _check(0 < sharded_bytes < cached_bytes,
               f"cache: {sharded_bytes} sharded bytes of {cached_bytes}")
        chaos = FaultPlan(seed=0, task_failure_rate=CHAOS_FAILURE_RATE).build()
        svc.failure_hook = chaos.hook
        t1 = time.perf_counter()
        again = svc.submit_search(
            SearchSpec(spaces=_service_grid(), n_executors=2, n_shards=2,
                       max_task_retries=CHAOS_RETRIES),
            train, valid, tenant="bob", weight=SERVICE_TENANTS["bob"])
        chaos_best = scored_once(again, "bob under chaos")
        chaos_wall = time.perf_counter() - t1
        svc.failure_hook = None
        stats = svc.stats()
    finally:
        svc.close()
    counts = launch_counts()
    _add_launches(out, counts)
    _check(chaos.n_train_faults > 0, "chaos injected no fault")
    _check(chaos_best.task.key() == best["bob"].task.key(),
           f"chaos run's best {chaos_best.task.key()} != {best['bob'].task.key()}")
    want = {"alice": (1, n_tasks), "bob": (2, 2 * n_tasks)}
    for name, (sessions, results) in want.items():
        ts = stats.per_tenant[name]
        _check((ts.n_sessions, ts.n_results, ts.n_failures) == (sessions, results, 0),
               f"{name}'s ledger: {ts.n_sessions} sessions, {ts.n_results} results, "
               f"{ts.n_failures} failures; expected {sessions}, {results}, 0")
    hits, misses = cache.counters()
    per_tenant = cache.tenant_counters()
    _check(sum(v.get("hits", 0) for v in per_tenant.values()) == hits
           and sum(v.get("misses", 0) for v in per_tenant.values()) == misses,
           "per-tenant cache ledgers do not sum to the cache's counters")
    _check(counts["split_scan"] > 0 and counts["level_split"] > 0,
           f"the service's searches launched {counts}")
    print(f"  alice (replicated) and bob (2 shards) at once: {2 * n_tasks} tasks in "
          f"{wall:.2f} s, each scored once; best alice {best['alice'].task.key()} auc "
          f"{best['alice'].score:.6f}, bob {best['bob'].task.key()} auc "
          f"{best['bob'].score:.6f}; cache {cache.n_entries} entries, {sharded_bytes} of "
          f"{cached_bytes} bytes per-shard blocks; tenant ledgers sum to its {hits} hits / "
          f"{misses} misses", flush=True)
    print(f"  bob again under chaos (train-failure rate {CHAOS_FAILURE_RATE}, "
          f"{CHAOS_RETRIES} retries): {chaos.n_train_faults} injected faults, every task "
          f"scored once in {chaos_wall:.2f} s, the same best config; launches {counts}",
          flush=True)
    print("  " + stats.summary().replace("\n", "\n  "), flush=True)
    out["service"] = dict(wall_s=wall, chaos_wall_s=chaos_wall,
                          chaos_faults=chaos.n_train_faults, launches=counts)


# ---------------------------------------------------------------------------
# The LM serving path (phases 6-8)
# ---------------------------------------------------------------------------

# bf16 outputs: the kernel and the plain version each round a float32 result
# to bf16 once, so they may differ by one bf16 ulp of the value. Held as
# |err| <= BF16_TOL * (max |plain| over the row + |plain|), a row being the
# last axis (one query's head_dim, one step's channels): that covers one ulp
# (2**-7 of the value's binade) at every magnitude, and each row is held to
# its own scale, not the largest value of the tensor.
BF16_TOL = 2.0 ** -8
ATTN_F32_TOL = dict(atol=1e-5, rtol=1e-4)   # float32 attention: sums in another order
STATE_TOL = 1e-4    # float32 recurrent states: atol and rtol, in units of max |plain|
# the float32 prefill, layer by layer: each layer on the kernel path and on
# the plain path in float32, both given the plain path's output of the layer
# before, against the plain path run in float64 on float64 copies of the
# layer's weights and that input, in units of the layer's largest update
# |out - in|. A layer passes if the kernel path is no further from float64
# than the plain float32 path is, or within LAYER_F32_TOL of its update.
# Holding the kernel to the plain float32 path instead measured float32
# rounding at badly conditioned positions: RWKV6-7B's per-head group norm
# divides by a head's spread, which is tiny at the first real tokens after
# long left padding, and with one set of random weights layer 1's kernel
# path was 6.5e-3 of its update off the plain path while closer to float64
# than the plain path was. The kernel path run freely through the stack is
# reported beside it: a random stack carries the float32 differences of one
# layer on to the next (RWKV6-7B's grow about 15x a layer at first), so the
# end-to-end logits are not a yardstick.
LAYER_F32_TOL = 1e-3
# prefill logits, kernel path against plain path on the same card. Both run
# in bf16 and round different values in every kernel layer, and a random
# 32- or 38-layer stack carries those differences to the logits, so a fixed
# fraction of the logits is no yardstick (a first run at 5 % of max |logit|
# passed RecurrentGemma at 1.0 % and failed RWKV6-7B at 7.4 %). The noise
# is measured instead: the plain path's own distance from the plain path in
# float32 (max |logit difference| over the batch). The kernel path must lie
# within LOGIT_NOISE_FACTOR of that noise from the plain path and from the
# float32 run alike: the two bf16 paths each sit about one noise from the
# float32 result.
LOGIT_NOISE_FACTOR = 2.0
LM_PROMPTS = (4096, 3000, 2048, 1000)
LM_NEW_TOKENS = 32
# phases 7-8 at full width and half depth: RecurrentGemma-9B's pattern
# (rec, rec, attn) x 6 and one rec of its tail (19 of 38 layers), RWKV6-7B
# 16 of 32 layers. Cut to keep the whole script within its 1,200 s once
# phases 13-14 joined (at full depth phases 7-8 took about 406 s together
# on an NVIDIA H100 80GB HBM3 at 700 W, PERF.md). Every kernel of the path
# still runs at its serving shape, and the float32 layer check holds every
# layer that runs
SERVE_DEPTH = {"recurrentgemma-9b": 19, "rwkv6-7b": 16,
               # phase 13's dense configs at half depth, cut when phase 15
               # joined: the whole script took 1,404 s on an NVIDIA H100 80GB
               # HBM3 at 700 W whose host ran the grids 40 % slower than
               # before (PERF.md). Gemma3-12B's 24 keep 4 of its 5:1
               # local:global groups, both kinds under the float32 check
               "tinyllama-1.1b": 11, "qwen2-1.5b": 14, "gemma-2b": 9, "gemma3-12b": 24}
# float32 operations per element of the fused RG-LRU gate math and update:
# two sigmoids (3 each), softplus folded into a per-channel constant, the
# product with it, exp, expm1 with its doubling, sqrt and negation, two
# products for beta * (sigmoid * x), and the a * h + u update
RGLRU_OPS_PER_ELEMENT = 16
# phase 6's float32 RWKV-6 case and phase 8's layers: the error over T, in
# windows of this many steps
RWKV6_WINDOW = 256


def _held(torch, what, got, want, atol, rtol) -> float:
    """``atol``: a float, or a tensor that broadcasts against ``want``."""
    diff = (got.float() - want.float()).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    bad = diff > atol + rtol * want.float().abs()
    if bool(bad.any()):
        i = int(bad.flatten().nonzero()[0])
        raise AssertionError(f"{what}: |err| {float(diff.flatten()[i]):.3g} at flat index "
                             f"{i} (plain {float(want.flatten()[i]):.3g}) beyond its "
                             f"tolerance; max |err| {err:.3g}")
    return err


def _bf16_held(torch, what, got, want) -> tuple[float, str]:
    row_max = want.float().abs().amax(dim=-1, keepdim=True)
    tol = (f"atol {BF16_TOL:.3g} x row max |plain| in [{float(row_max.min()):.3g}, "
           f"{float(row_max.max()):.3g}], rtol {BF16_TOL:.3g}")
    return _held(torch, what, got, want, BF16_TOL * row_max, BF16_TOL), tol


def _state_held(torch, what, got, want) -> float:
    scale = float(want.abs().max())
    return _held(torch, what, got, want, STATE_TOL * scale, STATE_TOL)


def _attention_case(torch, gen, label, b, hq, hkv, tq, tk, d, dtype, *, window=None,
                    cap=None, causal=True):
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
               for shape in ((b, hq, tq, d), (b, hkv, tk, d), (b, hkv, tk, d)))
    kw = dict(causal=causal, window=window, logit_softcap=cap)
    got = flash_attention_cuda(q, k, v, **kw)
    want = ref.attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    _check(not bool(torch.isnan(want).any()), f"{label}: a row sees no key")
    if dtype == torch.float32:
        err, tol = _held(torch, f"attention {label}", got, want, **ATTN_F32_TOL), "rtol 1e-4"
    else:
        err, tol = _bf16_held(torch, f"attention {label}", got, want)
        # reported, not held: the plain version with P rounded to bf16 as a
        # single tensor-core operand would round it
        want_in = ref.attention_ref(q, k, v, matmul_dtype="input", **kw)
        tol += (f"; against matmul_dtype='input' {float((got.float() - want_in.float()).abs().max()):.3g}"
                f", which is off the float32-P plain version by "
                f"{float((want_in.float() - want.float()).abs().max()):.3g}")
    _check(torch.equal(got, flash_attention_cuda(q, k, v, **kw)), f"{label}: two launches differ")
    ms = _time_ms(torch, lambda: flash_attention_cuda(q, k, v, **kw))
    plain_ms = _time_ms(torch, lambda: ref.attention_ref(q, k, v, **kw), reps=3)
    q_pos = torch.arange(tq, device="cuda")[:, None] + (tk - tq)
    k_pos = torch.arange(tk, device="cuda")[None, :]
    mask = k_pos <= q_pos if causal else torch.ones((tq, tk), dtype=torch.bool, device="cuda")
    if window is not None:
        mask &= q_pos - k_pos < window
    library_ms, library = None, "none"
    if cap is None:       # no PyTorch call applies a tanh softcap
        full = not causal and window is None
        library_ms = _time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=None if full else mask, enable_gqa=hq != hkv))
        library = f"{library_ms:.3f} ms"
        if causal and window is None and tq == tk:
            # the call a user makes for this mask; an explicit boolean mask
            # can take SDPA off its fastest path
            mask_ms = library_ms
            library_ms = _time_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=hq != hkv))
            library = f"{library_ms:.3f} ms (is_causal; {mask_ms:.3f} ms with the explicit mask)"
    n_bytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    n_flops = 4.0 * b * hq * int(mask.sum()) * d        # QK^T and PV on visible pairs
    peak = PEAK_BF16_FLOP_PER_S if dtype == torch.bfloat16 else PEAK_F32_FLOP_PER_S
    bound, by = _bound_ms(n_bytes, n_flops, peak)
    print(f"  attention {label}: max|err| {err:.3g} ({tol}), bit-identical reruns, "
          f"{ms:.3f} ms, plain {plain_ms:.3f} ms, library {library}, bound "
          f"{bound:.4f} ms ({by})", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, max_abs_err=err, bound_ms=bound, bound_by=by,
                library_ms=library_ms)


def _rglru_case(torch, gen, b, t, d, with_h0):
    from repro_torch.kernels import ref
    from repro_torch.kernels.rglru import rglru_cuda

    x, ig, rg = (torch.randn((b, t, d), generator=gen, device="cuda").bfloat16()
                 for _ in range(3))
    a = torch.randn(d, generator=gen, device="cuda")
    h0 = torch.randn((b, d), generator=gen, device="cuda") if with_h0 else None
    y, h = rglru_cuda(x, ig, rg, a, h0)
    y_r, h_r = ref.rglru_ref(x, ig, rg, a, h0)
    torch.cuda.synchronize()
    label = f"B={b} T={t} D={d}{' h0' if with_h0 else ''}"
    err, tol = _bf16_held(torch, f"rglru {label} y", y, y_r)
    h_err = _state_held(torch, f"rglru {label} h_T", h, h_r)
    y2, h2 = rglru_cuda(x, ig, rg, a, h0)
    _check(torch.equal(y, y2) and torch.equal(h, h2), f"rglru {label}: two launches differ")
    ms = _time_ms(torch, lambda: rglru_cuda(x, ig, rg, a, h0))
    dev_ms = _device_ms(torch, lambda: rglru_cuda(x, ig, rg, a, h0))
    plain_ms = _time_ms(torch, lambda: ref.rglru_ref(x, ig, rg, a, h0), reps=3)
    n = b * t * d
    n_bytes = 4 * n * 2 + 4 * d + 4 * b * d * (2 if with_h0 else 1)
    bound, by = _bound_ms(n_bytes, RGLRU_OPS_PER_ELEMENT * n)
    print(f"  rglru {label}: y max|err| {err:.3g} ({tol}), "
          f"h_T max|err| {h_err:.3g} (rtol {STATE_TOL:g} of scale), bit-identical reruns, "
          f"{ms:.4f} ms (CUDA events), device {dev_ms:.4f} ms (CUDA graph replay), "
          f"plain {plain_ms:.3f} ms, bound {bound:.4f} ms ({by})", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, max_abs_err=err, bound_ms=bound, bound_by=by,
                library_ms=None)


def _rwkv6_chunked_work_ms(b, h, t, dk, dv, sub=16):
    """The least time for the operations of ``rwkv6_chunked``'s form, as
    (ms, a text with its two terms): its tensor-core products at the bf16
    peak, counted as the kernel takes them in bf16 (the readout r~ S and the
    update k~^T V in 3 terms of bf16 pieces each, scores . V in 2, the
    levels 8, 4, 2 in 3 and level 1 in 1, each level 8 x 8 pairs), and its
    elementwise work at the float32 peak (a step and channel: the decay
    exp(-exp(w)) 3, the prefix and suffix products and r~, k~ 4, the three
    levels' row and column products 9, the bonus 3; and the state's decay
    once a sub-chunk), the two added."""
    steps = b * h * t
    tensor = steps * (2 * 2 * dk * dv * 3 + 2 * sub * dv * 2
                      + (3 * 3 + 1) * 2 * 8 * 8 * dk / sub)
    elementwise = steps * (19 * dk + dk * dv / sub)
    t_tensor = tensor / PEAK_BF16_FLOP_PER_S * 1e3
    t_elem = elementwise / PEAK_F32_FLOP_PER_S * 1e3
    return t_tensor + t_elem, (f"{t_tensor + t_elem:.4f} ms: tensor-core products "
                               f"{tensor / 1e9:.1f} GFLOP {t_tensor:.4f} ms + elementwise "
                               f"{elementwise / 1e9:.2f} GFLOP {t_elem:.4f} ms")


def _rwkv6_case(torch, gen, b, h, t, dk, dv, with_s0):
    from repro_torch.kernels import ref
    from repro_torch.kernels.rwkv6 import chunked_form, rwkv6_cuda

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    r, k = randn(b, h, t, dk).bfloat16(), randn(b, h, t, dk).bfloat16()
    v = randn(b, h, t, dv).bfloat16()
    w = randn(b, h, t, dk) * 1.5 - 1.0     # decays from ~0 to ~0.99 per step
    u = randn(h, dk) * 0.5
    s0 = randn(b, h, dk, dv) if with_s0 else None
    y, s = rwkv6_cuda(r, k, v, w, u, s0)
    y_r, s_r = ref.rwkv6_ref(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    label = f"B={b} H={h} T={t} Dk={dk} Dv={dv}{' s0' if with_s0 else ''}"
    err, tol = _bf16_held(torch, f"rwkv6 {label} y", y, y_r)
    s_err = _state_held(torch, f"rwkv6 {label} S_T", s, s_r)
    y2, s2 = rwkv6_cuda(r, k, v, w, u, s0)
    _check(torch.equal(y, y2) and torch.equal(s, s2), f"rwkv6 {label}: two launches differ")
    ms = _time_ms(torch, lambda: rwkv6_cuda(r, k, v, w, u, s0))
    dev_ms = _device_ms(torch, lambda: rwkv6_cuda(r, k, v, w, u, s0))
    plain_ms = _time_ms(torch, lambda: ref.rwkv6_ref(r, k, v, w, u, s0), reps=3)
    steps = b * h * t
    n_bytes = (steps * ((2 * dk + dv) * 2 + dk * 4 + dv * 2) + h * dk * 4
               + b * h * dk * dv * 4 * (2 if with_s0 else 1))
    if chunked_form(t, dk, dv, r.element_size(), 0):
        work_ms, work = _rwkv6_chunked_work_ms(b, h, t, dk, dv)
        t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
        bound, by = max((t_bytes, "bytes"), (work_ms, "operations"))
        terms = f"bytes {t_bytes:.4f} ms, the chunked form's work {work}"
    else:
        # step by step, per step and head: the readout r.S (2 Dk Dv: a
        # product and a sum per state element), the update d*S + k v^T (3 Dk
        # Dv), the bonus as the scalar r.(u*k) (3 Dk) times v added to y (2
        # Dv), the decay exp(-exp(w)) (2 Dk), on the CUDA cores
        n_flops = steps * (5 * dk * dv + 5 * dk + 2 * dv)
        bound, by = _bound_ms(n_bytes, n_flops)
        terms = "the step kernel's form"
    print(f"  rwkv6 {label}: y max|err| {err:.3g} ({tol}), "
          f"S_T max|err| {s_err:.3g} (rtol {STATE_TOL:g} of scale), bit-identical reruns, "
          f"{ms:.4f} ms (CUDA events), device {dev_ms:.4f} ms (CUDA graph replay), "
          f"plain {plain_ms:.3f} ms, bound {bound:.4f} ms ({by}; {terms})", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, max_abs_err=err, bound_ms=bound, bound_by=by,
                library_ms=None)


def _rwkv6_f32_case(torch, gen, b, h, t, dk, dv):
    """RWKV-6 in float32 at RWKV6-7B's serving shape: the kernel against its
    plain version, held to STATE_TOL of the scale, with the largest
    relative error of y in each window of RWKV6_WINDOW steps (max |err| over
    max |plain| of the window) and of the final state, to show where over T
    the float32 difference grows."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.rwkv6 import rwkv6_cuda

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    r, k, v = randn(b, h, t, dk), randn(b, h, t, dk), randn(b, h, t, dv)
    w = randn(b, h, t, dk) * 1.5 - 1.0
    u = randn(h, dk) * 0.5
    y, s = rwkv6_cuda(r, k, v, w, u)
    y_r, s_r = ref.rwkv6_ref(r, k, v, w, u)
    torch.cuda.synchronize()
    label = f"B={b} H={h} T={t} Dk={dk} Dv={dv} float32"
    y_err = _state_held(torch, f"rwkv6 {label} y", y, y_r)
    s_err = _state_held(torch, f"rwkv6 {label} S_T", s, s_r)
    diff, scale = (y - y_r).abs(), y_r.abs()
    windows = [float(diff[:, :, i:i + RWKV6_WINDOW].max() / scale[:, :, i:i + RWKV6_WINDOW].max())
               for i in range(0, t, RWKV6_WINDOW)]
    s_rel = s_err / float(s_r.abs().max())
    worst = int(np.argmax(windows))
    print(f"  rwkv6 {label}: y max|err| {y_err:.3g}, S_T max|err| {s_err:.3g} (rtol "
          f"{STATE_TOL:g} of scale); relative y error per {RWKV6_WINDOW}-step window: "
          + ", ".join(f"{e:.2e}" for e in windows)
          + f" (largest in steps {worst * RWKV6_WINDOW}-{(worst + 1) * RWKV6_WINDOW - 1}); "
          f"S_T relative {s_rel:.2e}", flush=True)
    return dict(windows=windows, state_rel=s_rel)


def phase_lm_kernels(torch, out: dict) -> None:
    gen = torch.Generator(device="cuda").manual_seed(1)
    bf16 = torch.bfloat16
    # (a) RecurrentGemma-9B's prefill attention: the numbers of the kernels line
    out["flash_attention"] = _attention_case(
        torch, gen, "(a) B=4 Hq=16 Hkv=1 T=4096 D=256 window=2048 bf16",
        4, 16, 1, 4096, 4096, 256, bf16, window=2048)
    _attention_case(torch, gen, "(a') the same in float32", 4, 16, 1, 4096, 4096, 256,
                    torch.float32, window=2048)
    _attention_case(torch, gen, "(b) B=2 Hq=32 Hkv=4 T=1000 D=64 bf16", 2, 32, 4,
                    1000, 1000, 64, bf16)
    _attention_case(torch, gen, "(b') the same in float32", 2, 32, 4, 1000, 1000, 64,
                    torch.float32)
    _attention_case(torch, gen, "(c) (b) with softcap 50", 2, 32, 4, 1000, 1000, 64,
                    bf16, cap=50.0)
    _attention_case(torch, gen, "(d) Tq=1 Tk=64 B=4 Hq=16 Hkv=1 D=256 bf16", 4, 16, 1,
                    1, 64, 256, bf16)
    out["rglru"] = _rglru_case(torch, gen, 4, 4096, 4096, False)
    _rglru_case(torch, gen, 4, 4096, 4096, True)
    _rglru_case(torch, gen, 4, 1, 4096, True)
    out["rwkv6"] = _rwkv6_case(torch, gen, 4, 64, 4096, 64, 64, False)
    _rwkv6_case(torch, gen, 4, 64, 4096, 64, 64, True)
    _rwkv6_case(torch, gen, 4, 64, 1, 64, 64, True)
    out["rwkv6_f32"] = _rwkv6_f32_case(torch, gen, 4, 64, 4096, 64, 64)


@contextlib.contextmanager
def _float64_plain(torch):
    """Within it, ``Tensor.float()`` called from this thread leaves a
    float64 tensor float64 (other threads keep the usual ``.float()``): the
    plain path widens its operands with ``.float()``, so on float64 weights
    and inputs it then runs in float64, all but the rotary angles, which
    ``layers.rope`` builds in float32 in every pass (the float64 reference
    shares their rounding with both float32 paths)."""
    widen = torch.Tensor.float
    owner = threading.get_ident()

    def keep64(t, *args, **kw):
        if t.dtype == torch.float64 and threading.get_ident() == owner:
            return t
        return widen(t, *args, **kw)

    torch.Tensor.float = keep64
    try:
        yield
    finally:
        torch.Tensor.float = widen


def _layerwise_f32(torch, cfg32, params, batch, max_len):
    """The float32 prefill one layer at a time, each layer held against a
    float64 recurrence (see LAYER_F32_TOL). Returns per layer ``(e_k, e_p,
    e_kp)``: the kernel path's and the plain float32 path's distances from
    the plain path run in float64 on float64 copies of the layer's weights
    and input, and the kernel path's from the plain float32 path, all in
    units of the layer's largest float64 update; how far the freely running
    kernel path has drifted from the plain path (units of each layer's
    update); and for the layer with the largest ``e_k`` that error per
    window of RWKV6_WINDOW positions and the position of the largest one."""
    from repro_torch.models import layer_specs
    from repro_torch.models import transformer as tm
    from repro_torch.train.optimizer import tree_map

    x_ref = tm._embed_inputs(cfg32, params, batch)
    x_free = x_ref
    positions = torch.arange(x_ref.shape[1], device="cuda")
    cfg64 = dataclasses.replace(cfg32, compute_dtype="float64")
    # cross-attention's memory: the plain float32 encoder's output, an input
    # of every layer like x_ref (widened for the float64 pass); the freely
    # running kernel path takes the kernel path's own
    memory = tm._memory(cfg32, params, batch, "ref")
    memory_free = tm._memory(cfg32, params, batch, None)
    memory64 = None if memory is None else memory.double()
    errs, drift, profile = [], [], None
    with torch.no_grad():
        for i, (spec, p) in enumerate(zip(layer_specs(cfg32), params.layers)):
            # one layer's decode state at a time (the layers only write it)
            st = tm._init_layer_state(cfg32, spec, 4, max_len, torch.bfloat16, "cuda")
            want = tm._prefill_layer(cfg32, spec, p, st, x_ref, positions, memory, "ref")
            got = tm._prefill_layer(cfg32, spec, p, st, x_ref, positions, memory, None)
            x_free = tm._prefill_layer(cfg32, spec, p, st, x_free, positions, memory_free,
                                       None)
            with _float64_plain(torch):
                p64 = tree_map(lambda t: t.double(), tm._as_dict(p))
                want64 = tm._prefill_layer(cfg64, spec, p64, st, x_ref.double(), positions,
                                           memory64, "ref")
            scale = float((want64 - x_ref.double()).abs().max())
            e_k = float((got.double() - want64).abs().max()) / scale
            e_p = float((want.double() - want64).abs().max()) / scale
            e_kp = float((got - want).abs().max()) / scale
            _check(e_k <= max(e_p, LAYER_F32_TOL),
                   f"float32 layer {i} ({spec.kind}): kernel path {e_k:.3g} of its update "
                   f"from float64, the plain float32 path {e_p:.3g} (tol {LAYER_F32_TOL:g})")
            if not errs or e_k > max(e[0] for e in errs):
                diff = (got.double() - want64).abs().amax(dim=(0, 2)) / scale  # per position
                profile = ([float(diff[j:j + RWKV6_WINDOW].max())
                            for j in range(0, diff.shape[0], RWKV6_WINDOW)],
                           int(diff.argmax()))
            errs.append((e_k, e_p, e_kp))
            drift.append(float((x_free - want).abs().max()) / scale)
            x_ref = want
            del want64, p64, st
    return errs, drift, profile


def _profiled_serve(torch, engine, wave):
    """One more serve under torch.profiler: the device's busy share of the
    wall time, its time by kind of kernel (shares of device time), and the
    five kernels with the most device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.serve(wave())
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # in this order: "copy" is dtype casts and copies, chiefly dense()'s
    # float32 → bf16 weight cast on every call (PyTorch runs them as
    # elementwise kernels named after direct_copy); "elementwise" the other
    # pointwise ops (norms, rope, activations, the causal conv)
    kinds = (("flash_attention", ("flash_fwd",)), ("rglru", ("rglru_",)),
             ("rwkv6", ("rwkv6_",)),
             ("matmul", ("gemm", "xmma", "cutlass", "cublas", "nvjet")),
             ("copy", ("copy",)), ("elementwise", ("elementwise", "reduce")))
    by_kind: dict = {}
    per_kernel = []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = _self_device_us(evt)
        kind = next((k for k, keys in kinds if any(x in evt.key.lower() for x in keys)),
                    "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + t
        per_kernel.append((t, evt.key[:100]))
    dev_us = sum(by_kind.values())
    if dev_us <= 0:
        return "not measured", {}, []
    shares = {k: round(v / dev_us, 3) for k, v in sorted(by_kind.items(), key=lambda kv: -kv[1])}
    top = [(name, round(t / dev_us, 3)) for t, name in sorted(per_kernel, reverse=True)[:5]]
    return f"{dev_us / wall_us:.3f}", shares, top


def _card_init(torch, dtype, seed: int):
    """An ``Init`` that draws on the card from a CUDA generator seeded with
    ``seed``: the reference's shapes and scales (a float32 normal draw,
    scaled, cast to ``dtype``), with other bits than ``init_params``'s CPU
    draws. The host's one generator drew 150M-190M parameters a second,
    over 200 s of the script's LM phases."""
    from repro_torch.models.layers import Init

    class CardInit(Init):
        def normal(self, shape, stddev=None):
            std = stddev if stddev is not None else shape[0] ** -0.5
            x = torch.randn(shape, generator=self.generator, device="cuda",
                            dtype=torch.float32)
            return x.mul_(std).to(self.dtype)

    return CardInit(torch.Generator(device="cuda").manual_seed(seed), dtype, "cuda")


def _cut_depth(cfg, n_layers):
    """``cfg`` with its first ``n_layers`` layers (None: all of them):
    whole repeats of the pattern, then the first layers of the tail."""
    if n_layers is None:
        return cfg
    repeats = min(cfg.repeats, n_layers // len(cfg.pattern))
    tail = cfg.tail[:n_layers - repeats * len(cfg.pattern)]
    cut = dataclasses.replace(cfg, repeats=repeats, tail=tail)
    _check(cut.n_layers == n_layers, f"{cfg.name} cannot be cut to {n_layers} layers")
    return cut


def phase_serve(torch, out: dict, arch: str, prompts_len=LM_PROMPTS, *,
                layerwise: bool = True, profiled: bool = True, n_layers: int | None = None,
                smoke: bool = False) -> None:
    """One LM served at full width (depth: see ``n_layers``) on seeded
    weights drawn on the card (``_card_init``), one wave of
    ``prompts_len`` prompts, checked against the plain path (see the module
    docstring, phase 7); ``layerwise``: also the float32 prefill layer by
    layer against float64, ``profiled``: also a third serve under
    torch.profiler; ``n_layers``: the first layers only (default
    SERVE_DEPTH's, else all); ``smoke``: the arch's smoke config. The
    kernel-against-plain checks feed the stub frontends seeded normal
    inputs (zero frames, the engine's, make every row's memory the same
    and would hide a cross-attention fault); every MoE layer's output in
    the kernel path's prefill is held against a per-token loop, and an
    encoder's output against the plain path's."""
    import gc

    from repro_torch import configs
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import count_params, init_decode_state, layer_specs, prefill
    from repro_torch.models import transformer as tm
    from repro_torch.serve import Request, ServeEngine

    cfg = (configs.get_smoke_config(arch) if smoke
           else _cut_depth(configs.get_config(arch), n_layers or SERVE_DEPTH.get(arch)))
    t0 = time.perf_counter()
    params = tm._draw_params(_card_init(torch, cfg.pdtype, 0), cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    max_len = max(prompts_len) + LM_NEW_TOKENS
    engine = ServeEngine(cfg, params, batch_size=4, max_len=max_len)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32) for n in prompts_len]

    def wave():
        return [Request(i, p, max_new_tokens=LM_NEW_TOKENS) for i, p in enumerate(prompts)]

    kinds = [s.kind for s in layer_specs(cfg)]
    # flash: every self-attention layer, every cross-attention and every
    # encoder layer once a prefill
    n_flash = (kinds.count("attn") + sum(s.cross_attn for s in layer_specs(cfg))
               + cfg.encoder_layers)
    per_pass = {"flash_attention": n_flash, "rglru": kinds.count("rglru"),
                "rwkv6": kinds.count("rwkv"), "histogram": 0, "level_split": 0,
                "split_scan": 0}
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    first = engine.serve(wave())
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    st = engine.last_stats
    _check(st.decode_steps == LM_NEW_TOKENS - 1, f"{st.decode_steps} decode steps")
    _check(all(len(r.output) == LM_NEW_TOKENS for r in first), "a request is short of tokens")
    # prefill launches every kernel of its layers once, each decode step the
    # recurrent ones again (decode attention is plain PyTorch, as in the JAX package)
    want = {n: c * (1 if n == "flash_attention" else 1 + st.decode_steps)
            for n, c in per_pass.items()}
    _check(counts == want, f"launches {counts}, expected {want}")
    _check(all(counts[n] > 0 for n, c in per_pass.items() if c), "a kernel of the path never ran")

    batch, _ = engine._make_batch(wave())
    stubs = _stub_inputs(torch, cfg)
    if stubs:     # the served wave's own prefill, for its first tokens
        state = init_decode_state(cfg, 4, max_len, device="cuda")
        logits_0, _ = prefill(cfg, params, state, batch)
        del state
        batch.update(stubs)
    reset_launch_counts()
    state = init_decode_state(cfg, 4, max_len, device="cuda")
    moe_calls: list = []
    with _recording_moe(moe_calls):
        logits_k, _ = prefill(cfg, params, state, batch)
    if not stubs:
        logits_0 = logits_k
    _check(launch_counts() == per_pass, f"one prefill launched {launch_counts()}")
    _check(len(moe_calls) == sum(s.ffn == "moe" for s in layer_specs(cfg)),
           f"{len(moe_calls)} MoE layers ran")
    moe_lines = _moe_held(torch, cfg, moe_calls)
    del state, moe_calls
    t0 = time.perf_counter()
    state = init_decode_state(cfg, 4, max_len, device="cuda")
    logits_r, _ = prefill(cfg, params, state, batch, force="ref")
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    del state
    state = init_decode_state(cfg, 4, max_len, device="cuda")
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    logits_32, _ = prefill(cfg32, params, state, batch, force="ref")
    del state
    _check(launch_counts() == per_pass, "the plain path launched a kernel")
    state = init_decode_state(cfg, 4, max_len, device="cuda")
    moe_calls = []
    with _recording_moe(moe_calls):
        logits_k32, _ = prefill(cfg32, params, state, batch)
    moe_lines += _moe_held(torch, cfg32, moe_calls)
    del state, moe_calls
    _check(launch_counts() == {n: 2 * c for n, c in per_pass.items()},
           f"the float32 prefill launched {launch_counts()}")
    err_f32 = float((logits_k32 - logits_32).abs().max())
    enc_line = _encoder_held(torch, cfg, params, batch) if cfg.encoder_layers else None
    if layerwise:
        layer_errs, drift, profile = _layerwise_f32(torch, cfg32, params, batch, max_len)
        worst = max(range(len(layer_errs)), key=lambda i: layer_errs[i][0])
        e_k, e_p, e_kp = layer_errs[worst]
    _check(bool(torch.isfinite(logits_k).all()) and logits_k.shape == (4, cfg.vocab),
           "prefill logits malformed")
    noise = float((logits_r - logits_32).abs().max())
    tol = LOGIT_NOISE_FACTOR * noise
    err = float((logits_k - logits_r).abs().max())
    err32 = float((logits_k - logits_32).abs().max())
    _check(err <= tol, f"prefill logits: kernel path off the plain path by {err:.4g} > {tol:.4g}")
    _check(err32 <= tol, f"prefill logits: kernel path off the float32 run by {err32:.4g} "
                         f"> {tol:.4g}")
    top2 = logits_r.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > tol
    agree = logits_k.argmax(-1) == logits_r.argmax(-1)
    _check(bool(agree[clear].all()), "first greedy token differs where the margin is clear")
    _check([r.output[0] for r in first] == logits_0.argmax(-1).tolist(),
           "the served first tokens are not the prefill's argmax")
    second = engine.serve(wave())
    _check([r.output for r in second] == [r.output for r in first], "two serves differ")
    busy, shares, top = (_profiled_serve(torch, engine, wave) if profiled
                         else ("not measured", {}, []))
    print(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{count_params(params) / 1e9:.2f}B {cfg.param_dtype} parameters (init {init_s:.1f} s: "
          f"drawn on the card); "
          f"prompts {list(prompts_len)}, {LM_NEW_TOKENS} new tokens each"
          + (f"; stub inputs for the checks {sorted(stubs)}, seeded normal, "
             f"{[tuple(t.shape) for t in stubs.values()]}" if stubs else ""), flush=True)
    print(f"  prefill {st.prefill_s:.3f} s, decode {st.decode_steps} steps in "
          f"{st.decode_s:.3f} s = {st.decode_tokens_per_s:.1f} tok/s "
          f"({st.decode_s / st.decode_steps * 1e3:.1f} ms/step); second serve prefill "
          f"{engine.last_stats.prefill_s:.3f} s, {engine.last_stats.decode_tokens_per_s:.1f} "
          f"tok/s; peak memory {peak / 2**30:.2f} GiB", flush=True)
    if layerwise:
        marks = sorted({i for i in (0, 1, 3, 7, 15) if i < len(drift)} | {len(drift) - 1})
        print(f"  float32 prefill layer by layer against float64: worst layer {worst + 1}, "
              f"kernel path {e_k:.3g} and plain float32 path {e_p:.3g} of its update from "
              f"the float64 plain path, kernel vs plain float32 {e_kp:.3g} (pass: kernel <= "
              f"max(plain, {LAYER_F32_TOL:g})); free-running drift after layer "
              + ", ".join(f"{i + 1}: {drift[i]:.3g}" for i in marks)
              + f"; float32 logits kernel vs plain {err_f32:.4g} of max|logit| "
              f"{float(logits_32.abs().max()):.4g}", flush=True)
        print("  float32 error of each layer from float64, kernel/plain (units of its "
              "update): "
              + ", ".join(f"{i + 1}:{e[0]:.2e}/{e[1]:.2e}" for i, e in enumerate(layer_errs))
              + f"; in layer {worst + 1}, kernel path per {RWKV6_WINDOW}-position window: "
              + ", ".join(f"{e:.2e}" for e in profile[0])
              + f" (largest at position {profile[1]} of the prompts' "
              f"{max(prompts_len)})", flush=True)
    print(f"  launches {counts} (per prefill {per_pass}); "
          f"bf16 prefill logits kernel vs plain: "
          f"max|err| {err:.4g}, vs plain float32 {err32:.4g} (tol {tol:.4g} = "
          f"{LOGIT_NOISE_FACTOR:g} x the plain path's bf16 noise {noise:.4g}; max|logit| "
          f"{float(logits_r.abs().max()):.4g}), "
          f"first token agrees on {int(agree.sum())}/4, margin clear on "
          f"{int(clear.sum())}/4; plain prefill {ref_s:.1f} s; two serves give the same "
          f"tokens", flush=True)
    if profiled:
        print(f"  profiled third serve: device busy {busy}, device time by kind {shares}; "
              f"top kernels {top}", flush=True)
    if enc_line:
        print(f"  encoder ({cfg.encoder_layers} layers, T={cfg.encoder_seq}): {enc_line}",
              flush=True)
    for line in moe_lines:
        print(f"  {line}", flush=True)
    _add_lm_launches(out, {n: c for n, c in counts.items() if per_pass[n]})
    out[arch] = dict(prefill_s=st.prefill_s, decode_tok_s=st.decode_tokens_per_s,
                     peak_bytes=peak, init_s=init_s, logit_err_f32=err_f32,
                     logit_err=err, logit_tol=tol,
                     flash_launches=counts["flash_attention"])
    if layerwise:
        out[arch].update(layer_err_f32=e_k, layer_errs_f32=layer_errs)
    del engine, params, first, second, logits_0, logits_k, logits_r, logits_32, logits_k32
    del batch, stubs
    gc.collect()
    torch.cuda.empty_cache()


def _add_lm_launches(out: dict, counts: dict) -> None:
    """Sum a main-path run's LM kernel launches into the kernels line."""
    total = out.setdefault("lm_launches", {})
    for name, n in counts.items():
        total[name] = total.get(name, 0) + n


# ---------------------------------------------------------------------------
# The dense LMs served (phase 13) and TinyLlama-1.1B trained (phase 14)
# ---------------------------------------------------------------------------

# phase 13: (arch, the wave's prompt lengths, the float32 layer check);
# TinyLlama's context is 2048 tokens
DENSE_SERVE = (("tinyllama-1.1b", (2048, 1500, 1024, 500), False),
               ("qwen2-1.5b", LM_PROMPTS, False),
               ("gemma-2b", LM_PROMPTS, False),
               ("gemma3-12b", LM_PROMPTS, True))
# phase 14: TinyLlama-1.1B at full width and depth, AdamW, batch 4 x 2,048
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_CKPT_EVERY = \
    "tinyllama-1.1b", 4, 2048, 6, 3
# a step size a warm-up would give in its first steps: at 3e-4 without one
# the loss of the random-weight model rose from 10.90 to 14.10 in 4 steps
TRAIN_LR = 1e-5
# the first step against the same step on the plain path (force="ref"):
# both run bf16 products that round differently, the loss a mean over 8,192
# tokens and the gradient norm a sum over 1.1B squared entries
TRAIN_LOSS_RTOL, TRAIN_GNORM_RTOL = 1e-3, 1e-2
# the resumed run against the uninterrupted one: bit-equal is expected
# (deterministic algorithms on, the same restored bits and batches); a
# difference within this would be float32 sums run in another order by an
# op PyTorch has no deterministic version of (they warn), far below what a
# lost or repeated update moves the loss (more than 1e-3)
TRAIN_RESUME_RTOL = 1e-6


def phase_dense_serve(torch, out: dict) -> None:
    for arch, prompts_len, layerwise in DENSE_SERVE:
        t0 = time.perf_counter()
        print(f"  -- {arch}", flush=True)
        phase_serve(torch, out, arch, prompts_len, layerwise=layerwise, profiled=False)
        print(f"  {arch} took {time.perf_counter() - t0:.1f} s", flush=True)


def _train_step_parts(torch, cfg, state, batch):
    """One step's forward and backward, timed apart (seconds each)."""
    from repro_torch.models import train_loss
    from repro_torch.train.optimizer import tree_leaves, tree_map

    params = tree_map(lambda p: p.detach().requires_grad_(), state["params"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = train_loss(cfg, params, batch)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    torch.autograd.grad(loss, tree_leaves(params))
    torch.cuda.synchronize()
    return t1 - t0, time.perf_counter() - t1


def _train_attention_grad(torch, cfg) -> None:
    """One layer's attention at the train step's shape in bf16: the
    gradient through ``ops.attention`` (the kernel forward in
    _KernelGradByPlain, whose backward differentiates the plain version
    recomputed) against ``ref.attention_ref``'s own autograd on the same
    leaves, within BF16_TOL of each row's largest plain gradient."""
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device="cuda").manual_seed(14)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    shape = (TRAIN_BATCH, cfg.n_heads, TRAIN_SEQ, cfg.head_dim)
    q, k, v = (randn(*shape[:1], h, *shape[2:]).to(torch.bfloat16).requires_grad_()
               for h in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads))
    w = randn(*shape)                   # the upstream gradient of the output
    got = ops.attention(q, k, v, causal=True)
    _check(got.grad_fn is not None, "the kernel's output has no grad_fn")
    g = torch.autograd.grad((got.float() * w).sum(), (q, k, v))
    del got
    want = ref.attention_ref(q, k, v, causal=True)
    g_r = torch.autograd.grad((want.float() * w).sum(), (q, k, v))
    del want
    errs = [_bf16_held(torch, f"attention d{n} at the train shape", a, b)[0]
            for n, a, b in zip("qkv", g, g_r)]
    print(f"  one layer's attention gradient at {tuple(shape)} bf16, through the kernel's "
          f"Function vs the plain version's autograd: max|err| dq {errs[0]:.3g}, dk "
          f"{errs[1]:.3g}, dv {errs[2]:.3g} (atol {BF16_TOL:.3g} x row max |plain|, rtol "
          f"{BF16_TOL:.3g})", flush=True)


def phase_train(torch, out: dict) -> None:
    import gc
    import os
    import shutil

    from repro_torch import configs
    from repro_torch.data.pipeline import make_lm_stream
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import count_params
    from repro_torch.train import Trainer, build_train_step, init_train_state, make_optimizer

    cfg = configs.get_config(TRAIN_ARCH)
    opt = make_optimizer("adamw", lr=TRAIN_LR)
    root = Path(__file__).resolve().parent / "build" / "train_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    straight_dir, resume_dir = root / "straight", root / "resume"
    tokens = TRAIN_BATCH * TRAIN_SEQ

    # the first step, kernel path against plain path, on one state and batch.
    # On the card both steps differentiate through ops' _KernelGradByPlain
    # (the plain path too), so this holds the kernels' forward and cannot
    # see a fault in that Function's backward: _train_attention_grad below
    # holds it against the plain version's own autograd
    t0 = time.perf_counter()
    state = init_train_state(cfg, opt, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    stream = make_lm_stream(TRAIN_BATCH, TRAIN_SEQ, cfg.vocab, seed=0, device="cuda")
    batch = stream.get(0)
    reset_launch_counts()
    _, m_k = build_train_step(cfg, opt)(state, batch)
    step_launches = launch_counts()["flash_attention"]
    _, m_r = build_train_step(cfg, opt, force="ref")(state, batch)
    _check(launch_counts()["flash_attention"] == step_launches == cfg.n_layers,
           f"a train step launched flash attention {step_launches} times, the plain "
           f"step {launch_counts()['flash_attention'] - step_launches}")
    rel = {k: abs(float(m_k[k]) - float(m_r[k])) / abs(float(m_r[k]))
           for k in ("loss", "grad_norm")}
    print(f"  {cfg.name}: {count_params(state['params']) / 1e9:.3f}B parameters (init "
          f"{init_s:.1f} s), AdamW lr {TRAIN_LR:g}, batch {TRAIN_BATCH} x {TRAIN_SEQ}; "
          f"step 1 kernel path vs plain path: loss {float(m_k['loss']):.6f} / "
          f"{float(m_r['loss']):.6f} (rel {rel['loss']:.3g}, tol {TRAIN_LOSS_RTOL:g}), "
          f"grad norm {float(m_k['grad_norm']):.6f} / {float(m_r['grad_norm']):.6f} "
          f"(rel {rel['grad_norm']:.3g}, tol {TRAIN_GNORM_RTOL:g})", flush=True)
    _check(rel["loss"] <= TRAIN_LOSS_RTOL and rel["grad_norm"] <= TRAIN_GNORM_RTOL,
           "the first train step is off the plain path")
    del _
    fwd_s, bwd_s = _train_step_parts(torch, cfg, state, batch)
    del state, batch
    gc.collect()
    torch.cuda.empty_cache()
    _train_attention_grad(torch, cfg)

    # the main path: Trainer, 6 steps, a checkpoint every 3, then a fresh
    # Trainer resumed from step 3's checkpoint
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        trainer = Trainer(cfg, opt, stream, ckpt_dir=str(straight_dir),
                          ckpt_every=TRAIN_CKPT_EVERY, device="cuda")
        trainer.init_or_restore(seed=0)
        t0 = time.perf_counter()
        straight = trainer.run(TRAIN_STEPS)
        run_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
        os.makedirs(resume_dir)
        for ext in ("npz", "json"):
            os.link(straight_dir / f"ckpt-{TRAIN_CKPT_EVERY}.{ext}",
                    resume_dir / f"ckpt-{TRAIN_CKPT_EVERY}.{ext}")
        resumed_tr = Trainer(cfg, opt, stream, ckpt_dir=str(resume_dir),
                             ckpt_every=10 * TRAIN_STEPS, device="cuda")
        t0 = time.perf_counter()
        start = resumed_tr.init_or_restore()
        restore_s = time.perf_counter() - t0
        resumed = resumed_tr.run(TRAIN_STEPS)
    finally:
        torch.use_deterministic_algorithms(False)
        stream.close()
    total_launches = launch_counts()["flash_attention"]
    n_run = TRAIN_STEPS + (TRAIN_STEPS - TRAIN_CKPT_EVERY)
    _check(start == TRAIN_CKPT_EVERY, f"resumed at step {start}")
    _check(straight.nan_skips == 0 and resumed.nan_skips == 0, "a non-finite step was skipped")
    _check(total_launches == n_run * cfg.n_layers,
           f"{total_launches} flash launches in {n_run} steps, {cfg.n_layers} a step expected")
    want = {h["step"]: h["loss"] for h in straight.history}
    got = {h["step"]: h["loss"] for h in resumed.history}
    _check(sorted(got) == list(range(TRAIN_CKPT_EVERY, TRAIN_STEPS)),
           f"resumed steps {sorted(got)}")
    bit_equal = all(got[s] == want[s] for s in got)
    worst = max(abs(got[s] - want[s]) / abs(want[s]) for s in got)
    _check(bit_equal or worst <= TRAIN_RESUME_RTOL,
           f"resumed losses off the uninterrupted run's by {worst:.3g}")
    losses = [h["loss"] for h in straight.history]
    _check(all(np.isfinite(losses)), f"losses {losses}")
    step_s = [h["seconds"] for h in straight.history]
    warm = float(np.mean(step_s[1:]))
    print(f"  {TRAIN_STEPS} steps: losses " + ", ".join(f"{x:.6f}" for x in losses)
          + f"; resumed from step {start} (restore {restore_s:.1f} s): steps "
          + ", ".join(f"{s + 1}: {got[s]:.6f}" for s in sorted(got))
          + f" ({'bit-equal' if bit_equal else f'within {worst:.3g}'} to the uninterrupted "
          f"run); no non-finite skips", flush=True)
    print(f"  s/step {warm:.3f} (steps 2-{TRAIN_STEPS}, checkpoint copies included; first "
          f"{step_s[0]:.3f}; run {run_s:.1f} s) = {tokens / warm:.0f} tokens/s; one step "
          f"apart: forward {fwd_s:.3f} s, backward {bwd_s:.3f} s; peak memory {peak / 2**30:.2f} GiB; flash launches "
          f"{total_launches} in {n_run} steps = {total_launches // n_run} a step "
          f"({cfg.n_layers} layers)", flush=True)
    _add_lm_launches(out, {"flash_attention": total_launches})
    out["train"] = dict(losses=losses, step_s=warm, forward_s=fwd_s, backward_s=bwd_s,
                        tokens_per_s=tokens / warm, peak_bytes=peak, bit_equal=bit_equal,
                        loss_rel=rel["loss"], grad_norm_rel=rel["grad_norm"])
    shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# The rest of the zoo served (phase 15)
# ---------------------------------------------------------------------------

# (arch, the wave's prompt lengths, layers (None: all), the float32 layer
# check): whisper-medium's decoder has 448 learned positions, so its wave
# stays within them; Qwen3-MoE-235B at 2 of its 94 layers, whose float32
# weights (940 GB) do not fit one 80 GB card (2 layers and the embeddings:
# 6.22B parameters, 24.9 GB)
ZOO_SERVE = (("whisper-medium", (384, 300, 200, 100), None, True),
             ("internvl2-1b", (2048, 1500, 1024, 500), None, False),
             ("qwen3-moe-235b-a22b", LM_PROMPTS, 2, False))
# flash attention timed at the zoo's prefill shapes: (label, b, hq, hkv, tq,
# tk, d, causal)
ZOO_ATTENTION = (("(e) whisper encoder B=4 H=16 T=1500 D=64 bidirectional", 4, 16, 16, 1500,
                  1500, 64, False),
                 ("(f) whisper cross B=4 H=16 Tq=384 Tk=1500 D=64", 4, 16, 16, 384, 1500, 64,
                  False),
                 ("(g) InternVL2-1B B=4 Hq=14 Hkv=2 T=2048 D=64", 4, 14, 2, 2048, 2048, 64,
                  True),
                 ("(h) Qwen3-MoE B=4 Hq=64 Hkv=4 T=4096 D=128", 4, 64, 4, 4096, 4096, 128,
                  True),
                 ("(i) Arctic B=4 Hq=56 Hkv=8 T=1024 D=128", 4, 56, 8, 1024, 1024, 128, True),
                 # TinyLlama-1.1B's attention: the port's most-launched flash shape
                 # (phases 13, 14, 16 and 17)
                 ("(j) TinyLlama-1.1B B=4 Hq=32 Hkv=4 T=2048 D=64", 4, 32, 4, 2048, 2048, 64,
                  True))
# Arctic-480B: its smoke config served (the dense residual end to end) and
# one full-width layer (13.61B bfloat16 parameters, drawn on the card) on
# ARCTIC_BATCH x ARCTIC_TOKENS tokens
ARCTIC_SMOKE_PROMPTS = (1024, 800, 512, 256)
ARCTIC_BATCH, ARCTIC_TOKENS = 4, 1024
# an MoE layer's output against the per-token reference, each token's row
# held to |err| <= tol x (sum over its kept slots of weight x max |expert
# output| + max |out|) + tol x |out|: one rounding of each weighted expert
# output and of the sum. The two run the expert products on other shapes
# (the layer a batched product over (E, capacity, d), the reference one
# product an expert over its kept tokens), whose sums in another order
# round some elements of a bf16 expert output one ulp apart, and a token's
# weighted outputs partly cancel: held to one ulp of the output row alone
# (BF16_TOL x max |out|, ``_bf16_held``), Qwen3-MoE's layer 1 failed on an
# NVIDIA H100 80GB HBM3 at 700 W (an output of -5.06 off by 0.0625, two
# ulps; max |err| 0.25). In float32 the same rule at 1e-4 (ATTN_F32_TOL's
# rtol), which holds the dispatch: a wrong or lost slot moves a token by a
# whole term
MOE_TOL = {"torch.bfloat16": BF16_TOL, "torch.float32": 1e-4}


def _stub_inputs(torch, cfg, batch: int = 4) -> dict:
    """The stub frontends' inputs as seeded normal draws on the card: the
    audio stub's (batch, encoder_seq, d) frames, the vision stub's (batch,
    num_patches, d) patches."""
    gen = torch.Generator().manual_seed(5)
    shapes = {}
    if cfg.frontend == "audio_stub":
        shapes["enc_embeds"] = (batch, cfg.encoder_seq, cfg.d_model)
    if cfg.frontend == "vision_stub":
        shapes["patch_embeds"] = (batch, cfg.num_patches, cfg.d_model)
    return {k: torch.randn(shape, generator=gen).to("cuda") for k, shape in shapes.items()}


@contextlib.contextmanager
def _recording_moe(calls: list):
    """Within it, every ``moe_apply`` the transformer calls appends
    (its parameters, its input, its output) to ``calls``."""
    from repro_torch.models import transformer as tm

    inner = tm.moe_apply

    def record(p, x, **kw):
        y = inner(p, x, **kw)
        calls.append((p, x, y))
        return y

    tm.moe_apply = record
    try:
        yield
    finally:
        tm.moe_apply = inner


def _moe_per_token(torch, p, x, top_k: int, capacity_factor: float, act: str):
    """The MoE FFN written per token, with no sort, gather table or
    scatter: route each token to its top_k experts (weights renormalised);
    a slot (token t, choice j) is kept if fewer than ``cap`` slots of its
    expert come before it in the order t·k + j; each expert runs its FFN on
    the tokens whose slot it keeps, in x's dtype with float32
    accumulation, and the weighted outputs are summed per token in
    float32. Returns (y, the sum over each token's kept slots of weight x
    max |expert output| (B, S, 1), slots dropped, slots)."""
    import math

    import torch.nn.functional as F

    from repro_torch.models.layers import ffn_apply

    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    t, e = xt.shape[0], p["router"].shape[1]
    probs = torch.softmax(torch.matmul(xt, p["router"].to(xt.dtype)).float(), dim=-1)
    top_p, top_e = torch.topk(probs, top_k, dim=-1)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    cap = max(8, math.ceil(t * top_k * capacity_factor / e))
    gelu = lambda v: F.gelu(v, approximate="tanh")  # noqa: E731
    fn = F.silu if act == "swiglu" else gelu
    flat_e, flat_p = top_e.reshape(-1), top_p.reshape(-1)
    y = torch.zeros((t, d), dtype=torch.float32, device=x.device)
    terms = torch.zeros((t, 1), dtype=torch.float32, device=x.device)
    kept = 0
    for ex in range(e):
        slots = (flat_e == ex).nonzero()[:, 0][:cap]       # ascending t·k + j
        if not len(slots):
            continue
        kept += len(slots)
        tok = slots // top_k                                 # distinct tokens
        xe = xt[tok]
        if act in ("swiglu", "geglu"):
            h = (fn(torch.matmul(xe, p["w_gate"][ex].to(xe.dtype)))
                 * torch.matmul(xe, p["w_up"][ex].to(xe.dtype)))
        else:
            h = gelu(torch.matmul(xe, p["w_up"][ex].to(xe.dtype)))
        o = torch.matmul(h, p["w_down"][ex].to(h.dtype))
        y[tok] = y[tok] + o.float() * flat_p[slots][:, None]
        terms[tok] = terms[tok] + flat_p[slots][:, None] * o.float().abs().amax(-1, keepdim=True)
    y = y.to(x.dtype).reshape(b, s, d)
    if "dense" in p:
        y = y + ffn_apply(p["dense"], x, act)
    return y, terms.reshape(b, s, 1), t * top_k - kept, t * top_k


def _moe_held(torch, cfg, calls: list) -> list[str]:
    """Each recorded MoE layer's output against :func:`_moe_per_token` on
    its input (see MOE_TOL); one line each with the share of slots dropped
    at the config's capacity factor."""
    lines = []
    for i, (p, x, y) in enumerate(calls):
        want, terms, dropped, n_slots = _moe_per_token(torch, p, x, cfg.top_k,
                                                       cfg.capacity_factor, cfg.ffn_act)
        tol = MOE_TOL[str(y.dtype)]
        row = terms + want.float().abs().amax(-1, keepdim=True)
        err = _held(torch, f"{cfg.name} layer {i + 1} {y.dtype} MoE against the per-token "
                           "reference", y, want, tol * row, tol)
        lines.append(f"MoE layer {i + 1} ({str(y.dtype).removeprefix('torch.')}): "
                     f"{n_slots:,} slots of {x.shape[0] * x.shape[1]:,} tokens, {dropped:,} "
                     f"dropped ({dropped / n_slots:.4f}) at capacity factor "
                     f"{cfg.capacity_factor}; against the per-token reference max|err| "
                     f"{err:.3g} (atol {tol:.3g} x (sum of weight x max|expert output| + max "
                     f"|out|) in [{float(row.min()):.3g}, {float(row.max()):.3g}] a token, "
                     f"rtol {tol:.3g})")
        del want, terms, row
    return lines


def _encoder_held(torch, cfg, params, batch) -> str:
    """The encoder's output as a whole: in bf16, the kernel path within
    LOGIT_NOISE_FACTOR x the plain path's own bf16 noise (its distance from
    the plain path in float32) of the plain path and of the float32 run; in
    float32, the kernel path no further from the plain path run in float64
    than the plain float32 path is, or within LAYER_F32_TOL of the output's
    largest |value|."""
    import types

    from repro_torch.models import transformer as tm
    from repro_torch.train.optimizer import tree_map

    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    with torch.no_grad():
        mem_k = tm._memory(cfg, params, batch, None)
        mem_r = tm._memory(cfg, params, batch, "ref")
        mem_32 = tm._memory(cfg32, params, batch, "ref")
        mem_k32 = tm._memory(cfg32, params, batch, None)

        def wide(tree):
            return tree_map(lambda t: t.double(), tm._as_dict(tree))

        enc64 = types.SimpleNamespace(embed=params.embed, enc_norm=wide(params.enc_norm),
                                      encoder=[wide(p) for p in params.encoder])
        with _float64_plain(torch):
            mem_64 = tm._memory(dataclasses.replace(cfg, compute_dtype="float64"), enc64,
                                {"enc_embeds": batch["enc_embeds"].double()}, "ref")
    _check(bool(torch.isfinite(mem_k).all()), "encoder output not finite")
    noise = float((mem_r.float() - mem_32).abs().max())
    err = float((mem_k.float() - mem_r.float()).abs().max())
    err32 = float((mem_k.float() - mem_32).abs().max())
    _check(err <= LOGIT_NOISE_FACTOR * noise and err32 <= LOGIT_NOISE_FACTOR * noise,
           f"encoder output: kernel path {err:.4g} from the plain path, {err32:.4g} from "
           f"float32, beyond {LOGIT_NOISE_FACTOR:g} x the plain path's bf16 noise {noise:.4g}")
    scale = float(mem_64.abs().max())
    e_k = float((mem_k32.double() - mem_64).abs().max()) / scale
    e_p = float((mem_32.double() - mem_64).abs().max()) / scale
    _check(e_k <= max(e_p, LAYER_F32_TOL),
           f"float32 encoder output: kernel path {e_k:.3g} of max|out| from float64, the "
           f"plain float32 path {e_p:.3g}")
    return (f"bf16 output kernel vs plain max|err| {err:.4g}, vs plain float32 {err32:.4g} "
            f"(tol {LOGIT_NOISE_FACTOR * noise:.4g} = {LOGIT_NOISE_FACTOR:g} x the plain "
            f"path's bf16 noise {noise:.4g}); float32 output from the float64 plain path: "
            f"kernel {e_k:.3g}, plain float32 {e_p:.3g} of max|out| {scale:.4g}")


def _arctic_layer(torch, out: dict) -> None:
    """One full-width Arctic-480B layer (attention, 128 experts of 4864
    top-2 and the dense residual FFN, bfloat16 parameters) on ARCTIC_BATCH
    x ARCTIC_TOKENS tokens through the prefill's layer path: its MoE output
    against the per-token reference. The weights are drawn on the card by a
    CUDA generator at the reference's scales (``_card_init``)."""
    import gc

    from repro_torch import configs
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import layer_specs
    from repro_torch.models import transformer as tm

    cfg = _cut_depth(configs.get_config("arctic-480b"), 1)
    spec = layer_specs(cfg)[0]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    init = _card_init(torch, cfg.pdtype, 0)
    p = tm._init_layer(init, cfg, spec)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tm._leaves(p))
    x = torch.randn((ARCTIC_BATCH, ARCTIC_TOKENS, cfg.d_model), generator=init.generator,
                    device="cuda", dtype=cfg.cdtype)
    positions = torch.arange(ARCTIC_TOKENS, device="cuda")
    st = tm._init_layer_state(cfg, spec, ARCTIC_BATCH, ARCTIC_TOKENS, torch.bfloat16, "cuda")
    calls: list = []
    reset_launch_counts()
    with torch.no_grad(), _recording_moe(calls):
        tm._prefill_layer(cfg, spec, p, st, x, positions, None, None)     # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = tm._prefill_layer(cfg, spec, p, st, x, positions, None, None)
        torch.cuda.synchronize()
        layer_s = time.perf_counter() - t0
    _check(launch_counts()["flash_attention"] == 2, f"the layer launched {launch_counts()}")
    _check(bool(torch.isfinite(y).all()) and y.shape == x.shape, "Arctic layer output malformed")
    lines = _moe_held(torch, cfg, calls[1:])
    peak = torch.cuda.max_memory_allocated()
    print(f"  arctic-480b, one full-width layer: d_model {cfg.d_model}, {cfg.n_experts} "
          f"experts of {cfg.d_ff_expert} top-{cfg.top_k} and a dense residual FFN of "
          f"{cfg.d_ff}, {n_params / 1e9:.2f}B {cfg.param_dtype} parameters drawn on the card "
          f"in {init_s:.1f} s; {ARCTIC_BATCH} x {ARCTIC_TOKENS} tokens through the layer in "
          f"{layer_s:.3f} s (flash launched once a pass); peak memory {peak / 2**30:.2f} GiB",
          flush=True)
    for line in lines:
        print(f"  {line}", flush=True)
    out["arctic-480b-layer"] = dict(init_s=init_s, layer_s=layer_s, peak_bytes=peak)
    del p, x, y, st, calls
    gc.collect()
    torch.cuda.empty_cache()


def phase_zoo_serve(torch, out: dict) -> None:
    gen = torch.Generator(device="cuda").manual_seed(2)
    bf16 = torch.bfloat16
    print("  flash attention at the zoo's prefill shapes (bf16):", flush=True)
    for label, *shape, causal in ZOO_ATTENTION:
        _attention_case(torch, gen, label, *shape, bf16, causal=causal)
    torch.cuda.empty_cache()
    for arch, prompts_len, n_layers, layerwise in ZOO_SERVE:
        t0 = time.perf_counter()
        print(f"  -- {arch}", flush=True)
        phase_serve(torch, out, arch, prompts_len, layerwise=layerwise, profiled=False,
                    n_layers=n_layers)
        print(f"  {arch} took {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    print("  -- arctic-480b (smoke config)", flush=True)
    phase_serve(torch, out, "arctic-480b", ARCTIC_SMOKE_PROMPTS, layerwise=False,
                profiled=False, smoke=True)
    _arctic_layer(torch, out)
    print(f"  arctic-480b took {time.perf_counter() - t0:.1f} s", flush=True)


# ---------------------------------------------------------------------------
# The device-mesh layer (phase 16)
# ---------------------------------------------------------------------------

# phase 16: the steps TinyLlama trains on the 1 x 1 mesh in each DP mode,
# and how far the mesh's losses may lie from the one-device Trainer's (the
# same ops on the same bits: a 1 x 1 mesh moves nothing, so only an op that
# DTensor runs in another form could move a loss)
MESH_STEPS, MESH_LOSS_RTOL = 3, 1e-5
# the reference's small dry-run cells (tests/test_dryrun_small.py), traced
# at the production mesh in the scan form, and the multi-pod cell
MESH_DRYRUN_CELLS = (("qwen2_1_5b", "train_4k"), ("rwkv6_7b", "decode_32k"),
                     ("qwen3_moe_235b", "train_4k"), ("whisper_medium", "prefill_32k"))
MESH_MULTIPOD_CELL = ("tinyllama_1_1b", "train_4k")
# the yardstick: the dry-run of phase 14's step on a 1 x 1 mesh against the
# real step on the card, FLOPs and argument bytes
YARDSTICK_RTOL = 0.01
# sharded_call over two gloo ranks that share cuda:0: phase 2's sharded
# level at R rows x F features, B bins, a tree of depth D (N = 2^D leaves)
MESH_SHARDS, MESH_ROWS, MESH_FEATURES, MESH_BINS, MESH_DEPTH = 2, 800_000, 28, 64, 6

_SHARDED_RANK = r"""
import json, sys, torch, numpy as np, torch.distributed as dist
from repro_torch import compat
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.launch.mesh import compat_make_mesh
from repro_torch.tabular.gbdt import build_tree
S, R, F, B, D = {S}, {R}, {F}, {B}, {D}
mesh = compat_make_mesh((S,), ("shards",), device="cpu")      # gloo
gen = torch.Generator(device="cuda").manual_seed(16)
bins = torch.randint(0, B, (S, R // S, F), generator=gen, device="cuda", dtype=torch.int32)
g = torch.randn((S, R // S), generator=gen, device="cuda")
h = torch.rand((S, R // S), generator=gen, device="cuda") + 0.1
valid = torch.ones((S, R // S), dtype=torch.bool, device="cuda")
kw = dict(n_bins=B, max_depth=D, lam=1.0, gamma=0.0, min_child_weight=1.0)
def per_shard(axis, bins, g, h, valid):
    return build_tree(bins, g, h, axis_name=axis, row_valid=valid, **kw)
reset_launch_counts()
t0 = __import__("time").perf_counter()
spmd = compat.sharded_call(per_shard, n_shards=S, mesh=mesh)(bins, g, h, valid)
torch.cuda.synchronize()
secs = __import__("time").perf_counter() - t0
counts = launch_counts()
stacked = compat.sharded_call(per_shard, n_shards=S)(bins, g, h, valid)
# the decisions (feature, split bin) bit-equal; the leaf sums each rank's
# fixed-point sums on its own grid, against one grid of every row stacked
same = all(torch.equal(a, b) for a, b in zip(spmd[:2], stacked[:2]))
leaf = max(float(((a - b).abs() / (b.abs() + 1e-3)).max()) for a, b in zip(spmd[2:], stacked[2:]))
print("RANK " + json.dumps(dict(rank=dist.get_rank(), same=same, leaf_rel=leaf, secs=secs,
      histogram=counts["histogram"], split_scan=counts["split_scan"],
      level_split=counts["level_split"])), flush=True)
dist.barrier()
dist.destroy_process_group()
"""


def _mesh_dryrun(torch) -> dict:
    """Phase 16's dry-runs, on fake process groups: the reference's small
    cells at 32 x 8 and TinyLlama's train cell at 2 x 32 x 8 (scan form),
    and the yardstick cell, phase 14's step traced whole on a 1 x 1 mesh."""
    from repro_torch import configs
    from repro_torch.launch.dryrun import fake_process_group, run_cell
    from repro_torch.launch.mesh import compat_make_mesh, make_production_mesh

    reports = []
    for multi_pod, cells in ((False, MESH_DRYRUN_CELLS), (True, (MESH_MULTIPOD_CELL,))):
        fake_process_group(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod, device="cuda")
        for arch, shape in cells:
            rep, secs = run_cell(arch, shape, mesh=mesh, scan=True, verbose=False)
            print(f"  {rep.summary()} [trace {secs:.1f} s; args/rank "
                  f"{rep.memory_stats['argument_size_in_bytes'] / 1e9:.2f} GB, collective "
                  f"bytes/rank {rep.collective_bytes['total'] / 1e9:.3f} GB]", flush=True)
            _check(rep.flops_per_device > 0 and rep.collective_bytes["total"] > 0,
                   f"{arch} x {shape}: no FLOPs or no collectives")
            reports.append(rep)
    fake_process_group(1)
    mesh = compat_make_mesh((1, 1), ("data", "model"), device="cuda")
    cell = configs.ShapeCell("train_phase14", TRAIN_SEQ, TRAIN_BATCH, "train")
    yard, secs = run_cell(TRAIN_ARCH, cell, mesh=mesh, verbose=False, overrides=dict(
        fsdp=True))
    print(f"  yardstick {yard.summary()} [trace {secs:.1f} s]", flush=True)
    import torch.distributed as dist

    dist.destroy_process_group()
    return {"reports": reports, "yardstick": yard}


def _unique_bytes(torch, tree) -> int:
    """Bytes of the distinct storages under a tree of (D)tensors."""
    from torch.distributed.tensor import DTensor

    seen, total = set(), 0

    def walk(t):
        nonlocal total
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, torch.Tensor):
            t = t.to_local() if isinstance(t, DTensor) else t
            st = t.untyped_storage()
            if st.data_ptr() not in seen:
                seen.add(st.data_ptr())
                total += st.nbytes()
    walk(tree)
    return total


def phase_mesh(torch, out: dict) -> None:
    import gc
    import os

    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.data.pipeline import make_lm_stream
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.mesh import compat_make_mesh, run_local_ranks
    from repro_torch.models import transformer as tm
    from repro_torch.roofline.analysis import RankFlopCounter
    from repro_torch.serve import Request, ServeEngine
    from repro_torch.train import Trainer, build_train_step, init_train_state, make_optimizer
    from repro_torch.train.train_step import distribute_tree

    t0 = time.perf_counter()
    dry = _mesh_dryrun(torch)
    dry_s = time.perf_counter() - t0

    # -- 1. a 1 x 1 NCCL mesh on cuda:0, training ---------------------------
    t0 = time.perf_counter()
    mesh = compat_make_mesh((1, 1), ("data", "model"), device="cuda")
    _check(dist.get_backend() == "nccl", f"the 1 x 1 mesh runs {dist.get_backend()}")
    cfg = configs.get_config(TRAIN_ARCH)
    opt = make_optimizer("adamw", lr=TRAIN_LR)
    state0 = init_train_state(cfg, opt, seed=0, device="cuda")

    def run(mesh_, yardstick=None, **kw):
        """MESH_STEPS steps from state0; the run's losses, its flash
        launches and its warm seconds a step; ``yardstick(trainer)`` runs
        before the trainer is dropped."""
        stream = make_lm_stream(TRAIN_BATCH, TRAIN_SEQ, cfg.vocab, seed=0, device="cuda",
                                mesh=mesh_)
        tr = Trainer(cfg, opt, stream, device="cuda", mesh=mesh_, **kw)
        tr.state = state0 if mesh_ is None else {
            "step": 0,
            "params": distribute_tree(state0["params"], mesh_, tr.state_specs["params"]),
            "opt_state": distribute_tree(state0["opt_state"], mesh_,
                                         tr.state_specs["opt_state"])}
        reset_launch_counts()
        m = tr.run(MESH_STEPS)
        n_flash = launch_counts()["flash_attention"]
        stream.close()
        extra = yardstick(tr) if yardstick is not None else None
        del tr
        gc.collect()
        torch.cuda.empty_cache()
        return ([h["loss"] for h in m.history], n_flash,
                float(np.mean([h["seconds"] for h in m.history[1:]])), extra)

    def yardstick(tr):
        """The real step's FLOPs (the plain path, as the trace runs it) and
        the bytes its arguments hold."""
        stream = make_lm_stream(TRAIN_BATCH, TRAIN_SEQ, cfg.vocab, seed=0, mesh=mesh)
        batch = stream.get(0)
        stream.close()
        step = build_train_step(cfg, opt, mesh=mesh, force="ref", state_specs=tr.state_specs)
        with RankFlopCounter() as fc:
            step(tr.state, batch)
        return float(fc.get_total_flops()), _unique_bytes(
            torch, {"params": tr.state["params"], "opt_state": tr.state["opt_state"],
                    "batch": batch})

    want, flash_local, local_s, _ = run(None)
    got, flash_mesh, step_s, (real_flops, real_args) = run(mesh, yardstick, fsdp=True,
                                                             zero1=True)
    got8, flash_int8, _, _ = run(mesh, dp_mode="shard_map_int8")
    del state0
    worst = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    print(f"  {cfg.name} on a 1 x 1 NCCL mesh, batch {TRAIN_BATCH} x {TRAIN_SEQ}: losses "
          f"one device " + ", ".join(f"{x:.6f}" for x in want) + "; mesh gspmd (FSDP, "
          "ZeRO-1) " + ", ".join(f"{x:.6f}" for x in got) + f" (worst rel {worst:.3g}, tol "
          f"{MESH_LOSS_RTOL:g}); shard_map_int8 " + ", ".join(f"{x:.6f}" for x in got8)
          + f"; flash launches {flash_local} / {flash_mesh} / {flash_int8}", flush=True)
    _check(len(got) == MESH_STEPS and worst <= MESH_LOSS_RTOL,
           "the mesh Trainer's losses are off the one-device Trainer's")
    _check(all(np.isfinite(got8)) and abs(got8[0] - got[0]) <= MESH_LOSS_RTOL * abs(got[0]),
           f"shard_map_int8 losses {got8}")
    _check(flash_mesh == flash_local == MESH_STEPS * cfg.n_layers and flash_int8 == flash_mesh,
           f"flash launches {flash_local} / {flash_mesh} / {flash_int8}")
    _add_lm_launches(out, {"flash_attention": flash_mesh + flash_int8})

    # the yardstick: the real step's FLOPs and argument bytes against the
    # dry-run's, the roofline step time beside the measured one
    yard = dry["yardstick"]
    yard_args = yard.memory_stats["argument_size_in_bytes"]
    rel_f = abs(yard.flops_per_device - real_flops) / real_flops
    rel_a = abs(yard_args - real_args) / real_args
    print(f"  yardstick: FLOPs/rank dry-run {yard.flops_per_device:.6g} vs real step "
          f"{real_flops:.6g} (rel {rel_f:.3g}, tol {YARDSTICK_RTOL:g}); argument bytes "
          f"{yard_args:.6g} vs allocated {real_args:.6g} (rel {rel_a:.3g}); roofline step "
          f"{yard.step_time_s:.4f} s ({yard.dominant}; compute {yard.compute_s:.4f}, memory "
          f"{yard.memory_s:.4f}, collective {yard.collective_s:.4f}) vs measured "
          f"{step_s:.4f} s on the mesh ({local_s:.4f} s one device): roofline share "
          f"{yard.step_time_s / step_s:.3f}", flush=True)
    _check(rel_f <= YARDSTICK_RTOL, "the dry-run's FLOPs are off the real step's")
    _check(rel_a <= YARDSTICK_RTOL, "the dry-run's argument bytes are off the real state's")
    train_s = time.perf_counter() - t0

    # -- 2. the 1 x 1 mesh serving TinyLlama's phase-13 wave ----------------
    t0 = time.perf_counter()
    prompts_len = dict((a, p) for a, p, _ in DENSE_SERVE)[TRAIN_ARCH]
    scfg = _cut_depth(cfg, SERVE_DEPTH.get(TRAIN_ARCH))
    params = tm._draw_params(_card_init(torch, scfg.pdtype, 0), scfg)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, scfg.vocab, size=n).astype(np.int32) for n in prompts_len]
    max_len = max(prompts_len) + LM_NEW_TOKENS
    tokens, flash = [], []
    for mesh_ in (None, mesh):
        engine = ServeEngine(scfg, params, batch_size=4, max_len=max_len, mesh=mesh_)
        reset_launch_counts()
        done = engine.serve([Request(i, p, max_new_tokens=LM_NEW_TOKENS)
                             for i, p in enumerate(prompts)])
        flash.append(launch_counts()["flash_attention"])
        tokens.append([r.output for r in done])
        del engine
    print(f"  served {scfg.name} ({scfg.n_layers} layers) on the 1 x 1 mesh: greedy tokens "
          f"{'equal' if tokens[0] == tokens[1] else 'DIFFER'} to the one-device engine's "
          f"({sum(map(len, tokens[1]))} tokens); flash launches {flash[0]} / {flash[1]}",
          flush=True)
    _check(tokens[0] == tokens[1], "the mesh engine's tokens differ from the one-device's")
    _check(flash[1] == flash[0] == scfg.n_layers, f"serve flash launches {flash}")
    _add_lm_launches(out, {"flash_attention": flash[1]})
    del params
    dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    serve_s = time.perf_counter() - t0

    # -- 3. sharded_call over two gloo ranks sharing cuda:0 -----------------
    t0 = time.perf_counter()
    code = _SHARDED_RANK.replace("{S}", str(MESH_SHARDS)).replace("{R}", str(MESH_ROWS)) \
        .replace("{F}", str(MESH_FEATURES)).replace("{B}", str(MESH_BINS)) \
        .replace("{D}", str(MESH_DEPTH))
    src = str(Path(__file__).resolve().parent / "src")
    texts = run_local_ranks(code, MESH_SHARDS, timeout=120,
                            env={"PYTHONPATH": src + os.pathsep + os.environ.get("PYTHONPATH", "")})
    ranks = [json.loads(line[5:]) for t in texts for line in t.splitlines()
             if line.startswith("RANK ")]
    _check(len(ranks) == MESH_SHARDS, f"{len(ranks)} ranks reported")
    for r in ranks:
        _check(r["same"], f"rank {r['rank']}: the mesh lowering's split decisions differ "
                          "from the stacked lowering's")
        _check(r["leaf_rel"] <= HIST_TOL["rtol"], f"rank {r['rank']}: leaf sums off the "
                                                  f"stacked lowering's by {r['leaf_rel']:.3g}")
        _check(r["histogram"] > 0 and r["split_scan"] > 0,
               f"rank {r['rank']} launched histogram {r['histogram']}, split_scan "
               f"{r['split_scan']}")
    print(f"  sharded_call over {MESH_SHARDS} gloo ranks sharing cuda:0 ({MESH_ROWS:,} x "
          f"{MESH_FEATURES}, B={MESH_BINS}, depth {MESH_DEPTH}): the split decisions "
          "bit-equal to the stacked lowering's in every rank, leaf sums within "
          + ", ".join(f"{r['leaf_rel']:.3g}" for r in ranks) + " (tol "
          f"{HIST_TOL['rtol']:g}); launches per rank " + "; ".join(
              f"rank {r['rank']}: histogram {r['histogram']}, split_scan {r['split_scan']}, "
              f"level_split {r['level_split']} ({r['secs']:.2f} s)" for r in ranks), flush=True)
    _add_launches(out, {"histogram": sum(r["histogram"] for r in ranks),
                        "split_scan": sum(r["split_scan"] for r in ranks)})
    sharded_s = time.perf_counter() - t0
    print(f"  phase 16 parts: dry-run {dry_s:.1f} s, training {train_s:.1f} s, serving "
          f"{serve_s:.1f} s, sharded_call {sharded_s:.1f} s", flush=True)
    out["mesh"] = dict(losses_local=want, losses_mesh=got, losses_int8=got8,
                       step_s=step_s, local_step_s=local_s,
                       yardstick=dict(flops=yard.flops_per_device, real_flops=real_flops,
                                      args=yard_args, real_args=real_args,
                                      roofline_s=yard.step_time_s, dominant=yard.dominant),
                       dryrun=[r.summary() for r in dry["reports"]])


# ---------------------------------------------------------------------------
# The LM search on mesh slices and the pipeline (phase 17)
# ---------------------------------------------------------------------------

# (b): TinyLlama-1.1B at full width and depth on two logical slices, one
# task an lr; the first is phase 14's, so its losses are phase 14's first
# three; its peak memory may exceed phase 14's by at most this factor
LM_SEARCH_LRS, LM_SEARCH_STEPS, LM_SEARCH_PEAK_FACTOR = (1e-5, 3e-5), 3, 1.1
# phase 14's peak when it did not run in this call (PERF.md: NVIDIA H100
# 80GB HBM3 at 700 W)
TRAIN_PEAK_BYTES = 38.40 * 2**30
# (c): S stages of TinyLlama-1.1B's layers, x of (PIPE_BATCH, PIPE_SEQ,
# d_model) embeddings in PIPE_MICROBATCHES microbatches
PIPE_STAGES, PIPE_MICROBATCHES, PIPE_BATCH, PIPE_SEQ = 2, 4, 8, 512

_PIPELINE_RANK = r"""
import hashlib, json, time, dataclasses
import torch, torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor
from repro_torch import configs
from repro_torch.distributed.pipeline import bubble_fraction, pipeline_apply, \
    stage_params_sharding
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.launch.mesh import init_process_group
from repro_torch.models import transformer as tm
from repro_torch.models.layers import Init
from repro_torch.train.optimizer import tree_leaves, tree_map
S, M, B, T, ARCH = {S}, {M}, {B}, {T}, {ARCH!r}
t_start = time.perf_counter()
init_process_group("gloo")
# two ranks share cuda:0: take it before the mesh, which would otherwise
# pick the card LOCAL_RANK names; the mesh is a CUDA mesh on a gloo group,
# so a DTensor's local block stays on the card
torch.cuda.set_device(0)
torch.zeros(1, device="cuda")
mesh = init_device_mesh("cuda", (S,), mesh_dim_names=("stage",))
rank = dist.get_rank()
cfg = configs.get_config(ARCH)
specs = tm.layer_specs(cfg)
per = len(specs) // S

class CardInit(Init):
    def normal(self, shape, stddev=None):
        std = stddev if stddev is not None else shape[0] ** -0.5
        x = torch.randn(shape, generator=self.generator, device="cuda", dtype=torch.float32)
        return x.mul_(std).to(self.dtype)

# every rank draws the same weights (one CUDA generator a seed) and keeps
# its own stage for the pipeline; rank 0 keeps both for the references
init = CardInit(torch.Generator(device="cuda").manual_seed(17), cfg.pdtype, "cuda")
layers = [tm._init_layer(init, cfg, spec) for spec in specs]
stages = [{{f"l{{i}}": layers[s * per + i] for i in range(per)}} for s in range(S)]
embed = init.normal((cfg.vocab, cfg.d_model))
tokens = torch.randint(0, cfg.vocab, (B, T), device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(18))
x = F.embedding(tokens, embed).to(cfg.cdtype)
del embed
positions = torch.arange(T, device="cuda")

def stage_fn(p, h, cfg=cfg, force=None):
    for i in range(per):
        h = tm._apply_layer(cfg, specs[i], p[f"l{{i}}"], h, positions, None, force)
    return h

pl = stage_params_sharding(mesh, stages[rank])
def own(leaf, placements):
    if isinstance(leaf, dict):
        return {{k: own(v, placements[k]) for k, v in leaf.items()}}
    return DTensor.from_local(leaf[None], mesh, placements, run_check=False)
stage_params = own(stages[rank], pl)
def numel(t, local=False):
    if isinstance(t, dict):
        return sum(numel(v, local) for v in t.values())
    return t.to_local().numel() if local else t.numel()
holds, all_layers = numel(stage_params, local=True), sum(numel(l) for l in layers)
if rank != 0:
    del layers, stages
torch.cuda.synchronize()
reset_launch_counts()
t0 = time.perf_counter()
with torch.no_grad():
    y = pipeline_apply(stage_fn, stage_params, x, mesh, n_microbatches=M)
torch.cuda.synchronize()
secs = time.perf_counter() - t0
flash = launch_counts()["flash_attention"]
# again, warm (the first call in a process pays for cuBLAS's set-up and the
# pinned staging buffers' first allocations); the same bits expected
t0 = time.perf_counter()
with torch.no_grad():
    again = pipeline_apply(stage_fn, stage_params, x, mesh, n_microbatches=M)
torch.cuda.synchronize()
warm = time.perf_counter() - t0
rep = dict(rank=rank, flash=flash, secs=secs, warm=warm, rerun_equal=bool(torch.equal(y, again)),
           shape=list(y.shape),
           finite=bool(torch.isfinite(y).all()),
           digest=hashlib.sha1(y.view(torch.int16).cpu().numpy().tobytes()).hexdigest(),
           holds=holds, all_layers=all_layers)

# the backward: the same call under grad mode and a fixed projection of y
# as the loss, which every rank computes; twice (the second warm, and the
# same bits expected). The gradients: this rank's stage block of every
# DTensor leaf, then x's
dt = tree_leaves(stage_params)
for leaf in dt:
    leaf.requires_grad_()
c = torch.randn(y.shape, device="cuda", generator=torch.Generator(device="cuda").manual_seed(19))
def pipeline_grads():
    for leaf in dt:
        leaf.grad = None
    xg = x.detach().requires_grad_()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = (pipeline_apply(stage_fn, stage_params, xg, mesh, n_microbatches=M).float() * c).sum()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    loss.backward()
    torch.cuda.synchronize()
    return [leaf.grad.to_local()[0] for leaf in dt] + [xg.grad], (t1 - t0, time.perf_counter() - t1)
reset_launch_counts()
grads, first_s = pipeline_grads()
flash_grad = launch_counts()["flash_attention"]
again, warm_s = pipeline_grads()
rep.update(grad_first_s=first_s, grad_warm_s=warm_s, flash_grad=flash_grad,
           grad_finite=all(bool(torch.isfinite(g).all()) for g in grads),
           grad_rerun_equal=all(bool(torch.equal(g, h)) for g, h in zip(grads, again)),
           x_grad_digest=hashlib.sha1(grads[-1].view(torch.int16).cpu().numpy().tobytes())
           .hexdigest())
del again
if rank == 0:
    with torch.no_grad():
        seq = torch.cat([stage_fn(stages[1], stage_fn(stages[0], xm))
                         for xm in x.reshape((M, B // M) + tuple(x.shape[1:]))])
        whole = stage_fn(stages[1], stage_fn(stages[0], x))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stage_fn(stages[1], stage_fn(stages[0], x))
        torch.cuda.synchronize()
        whole_s = time.perf_counter() - t0
        plain = stage_fn(stages[1], stage_fn(stages[0], x, force="ref"), force="ref")
        cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
        plain32 = stage_fn(stages[1], stage_fn(stages[0], x.float(), cfg32, "ref"), cfg32, "ref")
    rep.update(bit_equal=bool(torch.equal(y, seq)),
               whole_err=float((y.float() - whole.float()).abs().max()),
               noise=float((plain.float() - plain32).abs().max()),
               scale=float(plain32.abs().max()), bubble=bubble_fraction(S, M), whole_s=whole_s)
    del seq, whole, plain, plain32

    def in_order_grads(cfg, x, force):
        # autograd through the stages in order, one backward a microbatch:
        # stage 0's leaves' gradients, then x's
        p = [tree_map(lambda t: t.detach().requires_grad_(), st) for st in stages]
        xr = x.detach().requires_grad_()
        for xm, cm in zip(xr.reshape((M, B // M) + tuple(x.shape[1:])),
                          c.reshape((M, B // M) + tuple(c.shape[1:]))):
            (stage_fn(p[1], stage_fn(p[0], xm, cfg, force), cfg, force).float() * cm).sum().backward()
        return [t.grad for t in tree_leaves(p[0])] + [xr.grad]

    def max_errs(a, b):
        return [float((g.float() - h.float()).abs().max()) for g, h in zip(a, b)]

    want = in_order_grads(cfg, x, None)
    rep["grad_errs"] = max_errs(grads, want)
    del want
    plain = in_order_grads(cfg, x, "ref")
    rep["grad_noises"] = max_errs(plain, in_order_grads(cfg32, x.float(), "ref"))
    rep["grad_scale"] = max(float(g.float().abs().max()) for g in plain)
rep["wall"] = time.perf_counter() - t_start
print("RANK " + json.dumps(rep), flush=True)
dist.barrier()
dist.destroy_process_group()
"""


def phase_lm_search(torch, out: dict) -> None:
    import gc
    import os

    from repro_torch import configs
    from repro_torch.core import MeshSliceExecutorPool, TrainTask, schedule
    from repro_torch.data.pipeline import make_lm_stream
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import search
    from repro_torch.launch.mesh import make_mesh, run_local_ranks
    from repro_torch.models import count_params, init_params, layer_specs
    from repro_torch.train import Trainer, make_optimizer

    def attn_layers(cfg) -> int:
        return sum(spec.kind == "attn" for spec in layer_specs(cfg))

    # -- (a) run_lm at the launcher's defaults --------------------------------
    t0 = time.perf_counter()
    args = search.parse_args(["--workload", "lm"])
    reset_launch_counts()
    results = search.run_lm(args)
    flash = launch_counts()["flash_attention"]
    a_s = time.perf_counter() - t0
    want_flash = sum(attn_layers(configs.get_smoke_config(r.task.estimator)) * args.steps
                     for r in results)
    _check(len(results) == 6 and all(r.ok and np.isfinite(r.model) for r in results),
           "run_lm: " + "; ".join(f"{r.task.key()} {r.model if r.ok else r.error}"
                                  for r in results))
    _check({r.executor_id for r in results} == {0, 1}, "run_lm used one slice")
    _check(flash == want_flash, f"run_lm launched flash {flash} times, {want_flash} expected")
    first = results[0]
    cfg = configs.get_smoke_config(first.task.estimator)
    stream = make_lm_stream(4, 32, cfg.vocab, device="cuda")
    try:
        ref = Trainer(cfg, make_optimizer("adamw", lr=first.task.params["lr"]), stream,
                      device="cuda").run(args.steps).history[-1]["loss"]
    finally:
        stream.close()
    _check(first.model == ref, f"run_lm's {first.task.key()} loss {first.model!r}, a "
                               f"one-device Trainer's {ref!r}")
    print(f"  (a) run_lm: {len(results)} tasks on {args.slices} logical slices of cuda:0, "
          f"{args.steps} steps each, all ok; {first.task.key()}'s loss {first.model:.6f} "
          f"bit-equal to a one-device Trainer's; flash launches {flash} = "
          f"{flash / len(results):g} a task; {a_s:.1f} s", flush=True)
    _add_lm_launches(out, {"flash_attention": flash})

    # -- (b) TinyLlama-1.1B at full width through the pool --------------------
    t0 = time.perf_counter()
    cfg = configs.get_config(TRAIN_ARCH)
    cost = count_params(init_params(cfg, device="meta")) * LM_SEARCH_STEPS
    tasks = [TrainTask(task_id=i, estimator=TRAIN_ARCH, params={"lr": lr}, cost=float(cost))
             for i, lr in enumerate(LM_SEARCH_LRS)]
    assignment = schedule(tasks, 2, policy="lpt")

    def train(lr):
        """LM_SEARCH_STEPS AdamW steps from seed 0 on phase 14's stream: the
        losses; the trainer and its state are freed before returning."""
        stream = make_lm_stream(TRAIN_BATCH, TRAIN_SEQ, cfg.vocab, seed=0, device="cuda")
        tr = Trainer(cfg, make_optimizer("adamw", lr=lr), stream, device="cuda")
        tr.init_or_restore(seed=0)
        try:
            hist = tr.run(LM_SEARCH_STEPS).history
        finally:
            stream.close()
            del tr
            gc.collect()
        return [h["loss"] for h in hist]

    def runner(task, sl, _data):
        _check(sl.device == torch.device("cuda"), f"slice on {sl.device}")
        t = time.perf_counter()
        return train(task.params["lr"]), time.perf_counter() - t

    # as phase 14's run: deterministic algorithms, so its losses compare bit for bit
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        pool = MeshSliceExecutorPool(make_mesh((2, 1), ("data", "model"), "cuda"), 2, runner)
        results = list(pool.submit(assignment, None))
        flash = launch_counts()["flash_attention"]
        peak = torch.cuda.max_memory_allocated()
        if "train" in out:
            want, src = out["train"]["losses"][:LM_SEARCH_STEPS], "phase 14's first three"
        else:
            want, src = train(LM_SEARCH_LRS[0]), "a one-device Trainer's"
    finally:
        torch.use_deterministic_algorithms(False)
    b_s = time.perf_counter() - t0
    _check(len(results) == 2 and all(r.ok for r in results),
           "; ".join(f"{r.task.key()} {r.error}" for r in results))
    _check({r.executor_id for r in results} == {0, 1}, "the two tasks shared a slice")
    losses = {r.task.params["lr"]: r.model for r in results}
    _check(all(np.isfinite(v).all() for v in losses.values()), f"losses {losses}")
    got = losses[LM_SEARCH_LRS[0]]
    _check(got == want, f"the lr {LM_SEARCH_LRS[0]:g} task's losses {got}, {src} {want}")
    _check(flash == len(tasks) * LM_SEARCH_STEPS * attn_layers(cfg),
           f"{flash} flash launches in the pool's run")
    peak_ref = out["train"]["peak_bytes"] if "train" in out else TRAIN_PEAK_BYTES
    _check(peak <= LM_SEARCH_PEAK_FACTOR * peak_ref,
           f"peak {peak / 2**30:.2f} GiB against phase 14's {peak_ref / 2**30:.2f} GiB")
    print(f"  (b) {cfg.name} at full width and depth ({cfg.n_layers} layers) on 2 logical "
          f"slices of cuda:0, batch {TRAIN_BATCH} x {TRAIN_SEQ}, {LM_SEARCH_STEPS} AdamW "
          "steps a task: " + "; ".join(
              f"slice {r.executor_id} lr {r.task.params['lr']:g} losses "
              + ", ".join(f"{x:.6f}" for x in r.model) + f" ({r.train_seconds:.1f} s)"
              for r in results)
          + f"; lr {LM_SEARCH_LRS[0]:g} bit-equal to {src}; flash launches {flash}; peak "
          f"memory {peak / 2**30:.2f} GiB (phase 14's {peak_ref / 2**30:.2f}); {b_s:.1f} s",
          flush=True)
    _add_lm_launches(out, {"flash_attention": flash})

    # -- (c) GPipe over two gloo ranks sharing cuda:0 -------------------------
    gc.collect()
    torch.cuda.empty_cache()      # the two ranks draw their weights beside this process
    t0 = time.perf_counter()
    code = _PIPELINE_RANK.format(S=PIPE_STAGES, M=PIPE_MICROBATCHES, B=PIPE_BATCH,
                                 T=PIPE_SEQ, ARCH=TRAIN_ARCH)
    src = str(Path(__file__).resolve().parent / "src")
    texts = run_local_ranks(code, PIPE_STAGES, timeout=150,
                            env={"PYTHONPATH": src + os.pathsep + os.environ.get("PYTHONPATH", "")})
    ranks = sorted((json.loads(line[5:]) for t in texts for line in t.splitlines()
                    if line.startswith("RANK ")), key=lambda r: r["rank"])
    c_s = time.perf_counter() - t0
    _check(len(ranks) == PIPE_STAGES, f"{len(ranks)} ranks reported")
    per_stage = attn_layers(cfg) // PIPE_STAGES
    for r in ranks:
        _check(r["finite"] and r["shape"] == [PIPE_BATCH, PIPE_SEQ, cfg.d_model],
               f"rank {r['rank']}: output {r['shape']}, finite {r['finite']}")
        _check(r["flash"] == per_stage * PIPE_MICROBATCHES,
               f"rank {r['rank']} launched flash {r['flash']} times")
        _check(r["digest"] == ranks[0]["digest"], "the ranks returned different outputs")
        _check(r["rerun_equal"], f"rank {r['rank']}: a second pipeline call gave other bits")
        _check(r["holds"] * PIPE_STAGES == r["all_layers"],
               f"rank {r['rank']} holds {r['holds']} of {r['all_layers']} layer parameters")
        _check(r["grad_finite"], f"rank {r['rank']}: a gradient is not finite")
        _check(r["grad_rerun_equal"], f"rank {r['rank']}: a second backward gave other bits")
        _check(r["flash_grad"] == per_stage * PIPE_MICROBATCHES,
               f"rank {r['rank']} launched flash {r['flash_grad']} times under grad mode")
        _check(r["x_grad_digest"] == ranks[0]["x_grad_digest"], "the ranks' x gradients differ")
    r0 = ranks[0]
    _check(r0["bit_equal"], "the pipeline's output differs from the stages applied in order "
                            "to each microbatch")
    _check(r0["whole_err"] <= LOGIT_NOISE_FACTOR * r0["noise"],
           f"the pipeline is {r0['whole_err']:.3g} off one pass over the whole batch, the "
           f"plain path's bf16 noise is {r0['noise']:.3g}")
    # rank 0's gradients (stage 0's leaves, then x's), each against autograd
    # through the stages in order, within the factor of the plain path's
    # bf16 noise of the same gradient
    errs, noises = r0["grad_errs"], r0["grad_noises"]
    bad = [i for i, (e, n) in enumerate(zip(errs, noises)) if not e <= LOGIT_NOISE_FACTOR * n]
    _check(len(errs) == len(noises) > 1 and not bad,
           f"{len(bad)} of rank 0's {len(errs)} gradients off the stages in order by more than "
           f"{LOGIT_NOISE_FACTOR:g}x the plain path's bf16 noise, the first "
           + (f"#{bad[0]}: {errs[bad[0]]:.3g} against {noises[bad[0]]:.3g}" if bad else "none"))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"  (c) pipeline_apply over {PIPE_STAGES} gloo ranks sharing cuda:0, {per_stage} of "
          f"{cfg.name}'s {cfg.n_layers} layers a stage (DTensors: each rank holds "
          f"{r0['holds'] / 1e6:.1f}M of the {r0['all_layers'] / 1e6:.1f}M layer parameters), x "
          f"({PIPE_BATCH}, {PIPE_SEQ}, {cfg.d_model}) in {PIPE_MICROBATCHES} microbatches: "
          f"bit-equal to the stages in order on each microbatch, the same bits on every "
          f"rank; {r0['whole_err']:.4g} off one pass over the whole batch (the plain path's "
          f"bf16 noise {r0['noise']:.4g}, tol {LOGIT_NOISE_FACTOR:g}x; |y| up to "
          f"{r0['scale']:.3g}); flash launches " + ", ".join(
              f"rank {r['rank']} {r['flash']}" for r in ranks)
          + f"; bubble_fraction({PIPE_STAGES}, {PIPE_MICROBATCHES}) = {r0['bubble']:g}; "
          "pipeline first call " + ", ".join(f"{r['secs']:.3f}" for r in ranks)
          + " s, warm " + ", ".join(f"{r['warm']:.4f}" for r in ranks) + " s (the same "
          f"bits), against {r0['whole_s']:.4f} s for one pass over the whole batch on one rank "
          "(the other rank idle at a barrier); ranks' wall "
          + ", ".join(f"{r['wall']:.1f}" for r in ranks) + f" s; {c_s:.1f} s", flush=True)
    ratio = max(e / n for e, n in zip(errs, noises) if n > 0)
    print(f"  (c) backward (loss sum(y.float() * c), every rank): rank 0's {len(errs)} gradients "
          f"(stage 0's {len(errs) - 1} leaves and x) at most {max(errs):.4g} off autograd through "
          f"the stages in order on each microbatch (x's {errs[-1]:.4g}), {ratio:.3g}x of their "
          f"plain path's bf16 noise "
          f"at most (tol {LOGIT_NOISE_FACTOR:g}x; the noise up to {max(noises):.4g}, |grad| up to "
          f"{r0['grad_scale']:.3g}); finite on every rank; x's gradient the same bits on every "
          f"rank; a second call the same bits; flash launches under grad mode " + ", ".join(
              f"rank {r['rank']} {r['flash_grad']}" for r in ranks)
          + "; forward + backward first call " + ", ".join(
              f"{r['grad_first_s'][0]:.3f} + {r['grad_first_s'][1]:.3f}" for r in ranks)
          + " s, warm " + ", ".join(
              f"{r['grad_warm_s'][0]:.4f} + {r['grad_warm_s'][1]:.4f}" for r in ranks)
          + f" s ({smi})", flush=True)
    _add_lm_launches(out, {"flash_attention": sum(r["flash"] + r["flash_grad"] for r in ranks)})
    print(f"  phase 17 parts: run_lm {a_s:.1f} s, full-width search {b_s:.1f} s, pipeline "
          f"{c_s:.1f} s", flush=True)
    out["lm_search"] = dict(run_lm_s=a_s, search_s=b_s, pipeline_s=c_s, peak_bytes=peak,
                            losses={str(k): v for k, v in losses.items()},
                            pipeline_err=r0["whole_err"], pipeline_noise=r0["noise"],
                            pipeline_warm_s=[r["warm"] for r in ranks],
                            whole_pass_s=r0["whole_s"],
                            pipeline_grad_err=max(errs), pipeline_grad_noise=max(noises),
                            pipeline_grad_warm_s=[r["grad_warm_s"] for r in ranks])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="1,2,3,4,5,6,7,8,9,10,11,12,13,14,15,16,17")
    phases = {int(p) for p in ap.parse_args().phases.split(",")}
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import repro_torch.tabular  # noqa: F401  (registers the estimators)
    from repro_torch.kernels import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"[1] device: {smi}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    t0 = time.perf_counter()
    _build.load()
    print(f"  kernels built in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.build_seconds if _build.build_seconds is not None else 'cached'})",
          flush=True)
    print("  registers per thread / local (spill) bytes per thread: " + "; ".join(
        f"{name} {regs}/{local}" for name, regs, local in _build.kernel_info()), flush=True)
    out: dict = {}
    t_start = time.perf_counter()
    higgs = _higgs(1_000_000) if phases & {3, 4} else None
    for n, title, phase in (
            (2, "kernels against their plain versions", phase_kernels),
            (3, "search", lambda torch, out: phase_search(torch, out, *higgs)),
            (4, "path against plain path", lambda torch, out: phase_path(torch, out, *higgs)),
            (5, "full size", phase_full_size),
            (6, "LM kernels against their plain versions", phase_lm_kernels),
            (7, f"RecurrentGemma-9B served ({SERVE_DEPTH['recurrentgemma-9b']} layers)",
             lambda torch, out: phase_serve(torch, out, "recurrentgemma-9b")),
            (8, f"RWKV6-7B served ({SERVE_DEPTH['rwkv6-7b']} layers)",
             lambda torch, out: phase_serve(torch, out, "rwkv6-7b")),
            (9, "the paper's grid on HIGGS-like data", phase_paper_grid),
            (10, "the paper's grid on SECOM-like data", phase_secom_grid),
            (11, "the row-sharded search", phase_sharded_search),
            (12, "the multi-tenant search service and chaos", phase_service),
            (13, "the four dense LMs served", phase_dense_serve),
            (14, "TinyLlama-1.1B trained and resumed", phase_train),
            (15, "the rest of the zoo served: whisper, InternVL, Qwen3-MoE, Arctic",
             phase_zoo_serve),
            (16, "the device-mesh layer: training and serving on a mesh, sharded_call over "
             "ranks, the pod dry-run", phase_mesh),
            (17, "the LM search on mesh slices and the GPipe pipeline", phase_lm_search)):
        if n not in phases:
            continue
        print(f"[{n}] {title}", flush=True)
        t0 = time.perf_counter()
        phase(torch, out)
        print(f"  phase {n} took {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"phases {sorted(phases)} took {time.perf_counter() - t_start:.1f} s", flush=True)
    kernels = []
    if "level_split" in out and "launches" in out:
        # split_scan is the level kernel's scan pass launched alone (the
        # sharded level's scan): the scan half of the same TPU kernel
        for name, replaces in (("level_split", "src/repro/kernels/histogram.py:328"),
                               ("histogram", "src/repro/kernels/histogram.py:134"),
                               ("split_scan", "src/repro/kernels/histogram.py:328")):
            kernels.append(dict(name=name, route="cuda",
                                source="src/repro_torch/kernels/csrc/histogram.cu",
                                replaces=replaces, launches=out["launches"].get(name, 0),
                                **out[name]))
    for name, replaces in (("flash_attention", "src/repro/kernels/flash_attention.py:115"),
                           ("rglru", "src/repro/kernels/rglru.py:75"),
                           ("rwkv6", "src/repro/kernels/rwkv6.py:97")):
        if name in out and name in out.get("lm_launches", {}):
            kernels.append(dict(name=name, route="cuda",
                                source=f"src/repro_torch/kernels/csrc/{name}.cu",
                                replaces=replaces, launches=out["lm_launches"][name],
                                **out[name]))
    print("kernels " + "; ".join(
        f"{k['name']}: launches {k['launches']}, ms {k['ms']:.4f}, plain_ms "
        f"{k['plain_ms']:.4f}, library_ms {k['library_ms']}, bound_ms {k['bound_ms']:.4f}"
        for k in kernels))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
