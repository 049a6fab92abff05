#!/usr/bin/env python3
"""Drive the PyTorch port's GBDT model search on one NVIDIA GPU and check it.

    python3 chip_smoke.py               # every phase, on cuda:0
    python3 chip_smoke.py --phases 1,2  # a subset, for debugging

It imports only the port (``src/repro_torch``), never JAX or the JAX
package, and exits non-zero without printing a result when CUDA is absent
or any phase fails. Phases:

1. device: the card's name and power limit, and the kernels' build time
   (``nvcc`` builds ``src/repro_torch/kernels/csrc`` on first use);
2. each CUDA kernel against its plain PyTorch version at the search path's
   shapes (R = 800,000 rows, F = 28): histograms within tolerance, split
   decisions tie-aware, integer-valued sums bit-equal, two launches
   bit-identical; kernel, plain and library times beside the bound;
3. the search path: ``Session(SearchSpec(...)).results(train, valid)`` over
   a GBDT grid on 1,000,000 HIGGS-like rows, with launch counts showing that
   every tree level went through the level kernel;
4. the path against the plain path, determinism and resume;
5. one GBDT fit at UCI HIGGS's full size (11,000,000 rows x 28 features,
   256 bins): seconds per round, the kernels' share, peak device memory.

The line before the last is one JSON object with every kernel's numbers;
the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

# H100 SXM data sheet: HBM3 at 3.35 TB/s; float32 outside the tensor cores
# at 67 TFLOP/s (both at the full 700 W power limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12

R_KERNEL, F_KERNEL = 800_000, 28
HIST_TOL = dict(rtol=1e-4, atol=1e-3)   # float sums in another order
GAIN_RTOL = 1e-4                        # gain tolerance, see _decisions_tie_aware
AUC_TOL = 5e-3


def _bound_ms(n_bytes: float, n_flops: float) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_flops / PEAK_F32_FLOP_PER_S * 1e3
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


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _level_inputs(torch, gen, r, f, nb, nn, integer=False):
    dev = torch.device("cuda")
    bins = torch.randint(0, nb, (r, f), generator=gen, device=dev, dtype=torch.int32)
    if integer:
        g = torch.randint(-8, 9, (r,), generator=gen, device=dev).float()
        h = torch.randint(1, 5, (r,), generator=gen, device=dev).float()
    else:
        g = torch.randn(r, generator=gen, device=dev)
        h = torch.rand(r, generator=gen, device=dev) + 0.1
    node = torch.randint(0, nn, (r,), generator=gen, device=dev, dtype=torch.int32)
    return bins, g, h, node


def _decisions_tie_aware(torch, ref, hist_plain, hist_kernel, got, kw):
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
    Returns (largest plain-path gain gap, largest tolerance, legality flips)."""
    n = hist_plain.shape[0]
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
    _check(bool(((bg - best_k)[fin_k].abs() <= tol_k).all()), "best gain disagrees")
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


def phase_kernels(torch, out: dict) -> None:
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.histogram import fused_level_split_cuda, histogram_cuda

    gen = torch.Generator(device="cuda").manual_seed(0)
    r, f = R_KERNEL, F_KERNEL
    lam, mcw = 1.0, 1.0
    rows = []
    for nb in (32, 64, 128, 256):
        for nn in (1, 8, 32):
            bins, g, h, node = _level_inputs(torch, gen, r, f, nb, nn)
            kw = dict(lam=lam, min_child_weight=mcw, n_bins=nb)
            plain = ops._histogram_scatter(bins, g, h, node, nn, nb)
            got = fused_level_split_cuda(bins, g, h, node, n_nodes=nn, n_bins=nb,
                                         lam=lam, min_child_weight=mcw)
            torch.cuda.synchronize()
            err = (got[0] - plain).abs().max().item()
            _check(torch.allclose(got[0], plain, **HIST_TOL), f"hist B={nb} N={nn}: {err}")
            ties = [_decisions_tie_aware(torch, ref, plain, got[0], got, kw)]
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
            ties.append(_decisions_tie_aware(torch, ref, plain, got[0], masked, mkw))
            real = torch.isfinite(masked[1])
            _check(bool(mask[masked[2][real].long()].all()
                        and (masked[3][real] < nb // 2 - 1).all()), "mask or bin_limit ignored")
            sub_ms = None
            if nn > 1:
                parent = ops._histogram_scatter(bins, g, h, node // 2, nn // 2, nb)
                sub = ops.level_split(bins, g, h, node, n_nodes=nn, n_bins=nb, lam=lam,
                                      min_child_weight=mcw, parent_hist=parent)
                _check(torch.allclose(sub[0], plain, **HIST_TOL), "subtraction hist")
                ties.append(_decisions_tie_aware(torch, ref, plain, sub[0], sub, kw))
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
            rows.append(dict(B=nb, N=nn, level_ms=ms, subtract_ms=sub_ms,
                             hist_ms=hist_ms, plain_ms=plain_ms, max_abs_err=err,
                             gain_gap=gap, gain_tol=gap_tol, legality_flips=flips))
            print(f"  B={nb:3d} N={nn:2d}: level {ms:.3f} ms, subtraction "
                  f"{'-' if sub_ms is None else f'{sub_ms:.3f}'} ms, histogram "
                  f"{hist_ms:.3f} ms, plain {plain_ms:.3f} ms, max|err| {err:.3g}, "
                  f"gain gap {gap:.3g} (tol {gap_tol:.3g}, legality flips {flips})",
                  flush=True)
    # integer-valued grad/hess: every sum is exact, so bit-equal in any order
    for nb, nn in ((64, 1), (256, 32)):
        bins, g, h, node = _level_inputs(torch, gen, r, f, nb, nn, integer=True)
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
    b64 = next(x for x in rows if x["B"] == 64 and x["N"] == 1)
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
    out["launches"] = counts
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

    names = ("hist_accumulate", "hist_reduce", "split_scan")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        est.train(prepared, {**params, "round": 2})
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    kern_us = dev_us = 0.0
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue                     # host ops: their kernels count below
        t = getattr(evt, "self_device_time_total", None)
        if t is None:
            t = getattr(evt, "self_cuda_time_total", 0.0)
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="1,2,3,4,5")
    phases = {int(p) for p in ap.parse_args().phases.split(",")}
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import repro_torch.tabular  # noqa: F401  (registers gbdt)
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
    out: dict = {}
    if 2 in phases:
        print("[2] kernels against their plain versions", flush=True)
        phase_kernels(torch, out)
    if phases & {3, 4}:
        train, valid = _higgs(1_000_000)
        if 3 in phases:
            print("[3] search", flush=True)
            phase_search(torch, out, train, valid)
        if 4 in phases:
            print("[4] path against plain path", flush=True)
            phase_path(torch, out, train, valid)
    if 5 in phases:
        print("[5] full size", flush=True)
        phase_full_size(torch, out)
    kernels = []
    if "level_split" in out and "launches" in out:
        for name, replaces in (("level_split", "src/repro/kernels/histogram.py:328"),
                               ("histogram", "src/repro/kernels/histogram.py:134")):
            kernels.append(dict(name=name, route="cuda",
                                source="src/repro_torch/kernels/csrc/histogram.cu",
                                replaces=replaces, launches=out["launches"][name],
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
