"""Device time of each kernel launch of the GBDT level and histogram wrappers.

Profiles ``fused_level_split_cuda`` and ``histogram_cuda`` of the checkout it
sits in (torch.profiler, 20 calls a shape: each launch's device time and its
count a call) at the shapes ``chip_smoke.py``'s phase 2 times, then times the
root levels and the leaf sums a call both ways: CUDA events around
back-to-back calls (the wrapper's host time included, as ``_time_ms``) and a
CUDA graph's replay (the device alone):

    python3 scripts/gbdt_probes/level_launches.py      # from the repo root, on the card
"""
from __future__ import annotations

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.histogram import fused_level_split_cuda, histogram_cuda  # noqa: E402

DEV = torch.device("cuda")
GEN = torch.Generator(device=DEV).manual_seed(0)


def inputs(r, f, nb, nn):
    bins = torch.randint(0, nb, (r, f), generator=GEN, device=DEV, dtype=torch.int32)
    g = torch.randn(r, generator=GEN, device=DEV)
    h = torch.rand(r, generator=GEN, device=DEV) + 0.1
    node = torch.randint(0, nn, (r,), generator=GEN, device=DEV, dtype=torch.int32)
    return bins, g, h, node


def profile(label, fn, reps=20):
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = []
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None) or getattr(evt, "self_cuda_time_total", 0)
        if us > 0:
            name = evt.key.replace("void ", "").replace("(anonymous namespace)::", "")
            rows.append((name.split("(")[0][:40], us / reps, evt.count / reps))
    rows.sort(key=lambda x: -x[1])
    print(f"{label}: " + "; ".join(f"{k} {us:.1f} us x{c:g}" for k, us, c in rows), flush=True)


def events_ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps=10, replays=5):
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def main() -> None:
    print(torch.cuda.get_device_name(0))
    kw = dict(lam=1.0, min_child_weight=1.0)
    for r, f, nb, nn in ((800_000, 28, 32, 1), (800_000, 28, 64, 1), (800_000, 28, 256, 1),
                         (800_000, 28, 64, 8), (800_000, 28, 256, 32), (600_000, 28, 256, 512)):
        t = inputs(r, f, nb, nn)
        profile(f"level R={r} F={f} B={nb} N={nn} direct",
                lambda: fused_level_split_cuda(*t, n_nodes=nn, n_bins=nb, **kw))
        if nn > 1:
            parent = ops._histogram_scatter(t[0], t[1], t[2], t[3] // 2, nn // 2, nb)
            label = f"level R={r} F={f} B={nb} N={nn} by subtraction"
            try:
                profile(label, lambda: fused_level_split_cuda(*t, n_nodes=nn, n_bins=nb,
                                                              parent_hist=parent, **kw))
            except ValueError as exc:  # a checkout whose wrapper wants compacted rows
                print(f"{label}: not measured ({exc})", flush=True)
    leaf = inputs(800_000, 1, 1, 64)
    profile("leaf sums R=800000 F=1 B=1 N=64",
            lambda: histogram_cuda(*leaf, n_nodes=64, n_bins=1))
    for nb in (32, 64, 256):
        t = inputs(800_000, 28, nb, 1)
        fn = lambda: fused_level_split_cuda(*t, n_nodes=1, n_bins=nb, **kw)  # noqa: E731
        print(f"root B={nb}: events {events_ms(fn):.4f} ms, graph {graph_ms(fn):.4f} ms",
              flush=True)
    fn = lambda: histogram_cuda(*leaf, n_nodes=64, n_bins=1)  # noqa: E731
    print(f"leaf sums: events {events_ms(fn):.4f} ms, graph {graph_ms(fn):.4f} ms", flush=True)


if __name__ == "__main__":
    main()
