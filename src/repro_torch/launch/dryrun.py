"""Pod-scale dry-run: trace every (arch × shape) cell on the production
mesh and emit memory/cost/roofline artifacts.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all --both-meshes
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-12b \\
        --shape train_4k --multi-pod --out experiments/dryrun

The port of the JAX package's ``launch/dryrun.py``, which lowers and
compiles each cell for 512 host devices. Here each cell's step runs once in
this one process as rank 0 of a process group on the ``fake`` backend of
256 (or 512) ranks, under ``FakeTensorMode``: every tensor holds a shape
and a dtype only, every collective returns at once, nothing is allocated
and no device is touched. The kernels run as their plain versions
(``force="ref"``). The step's FLOPs, bytes and collective bytes per rank
are counted as it runs (``roofline.trace_step``) and turned into an H100
roofline (``roofline.analyze_traced``).

A cell fails if its trace raises, or if its argument bytes per rank (the
local shards of params, optimizer state, decode state and batch) exceed
the card's 80 GB: the counterpart of the reference's compile-time OOM. The
exit code is 1 if any requested cell failed.

``--scan`` traces one repeat of the layer pattern (and one encoder layer):
much faster, its FLOPs and bytes those of the cut stack (inexact, as the
reference says of its scan form); the argument bytes are the full
stack's either way.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch

from repro_torch import configs
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import build_cell
from repro_torch.models import count_params, init_params
from repro_torch.roofline import analyze_traced, trace_step

__all__ = ["run_cell", "check_fits", "fake_process_group", "main"]


def fake_process_group(world_size: int) -> None:
    """Make the default process group a ``fake``-backend group of
    ``world_size`` ranks with this process as rank 0 (replacing one of
    another size)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


def _device() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


def run_cell(arch: str, shape_name, *, multi_pod: bool = False,
             out_dir: str | None = None, verbose: bool = True,
             overrides: dict | None = None, mesh=None, scan: bool = False):
    """Trace one cell; returns (CellReport, trace_seconds). ``shape_name``
    is a ``SHAPES`` name or a ``ShapeCell``; ``mesh`` (a device mesh on a
    ``fake`` group) defaults to the production mesh; ``overrides`` are
    ``build_cell``'s keywords."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    if mesh is None:
        fake_process_group(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod, device=_device())
    mesh_desc = "x".join(str(s) for s in mesh.shape)
    overrides = dict(overrides or {})
    shape = configs.SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    dev = mesh.device_type
    shd.compute_mesh(mesh)          # flatten a pod mesh before the fake mode
    t0 = time.perf_counter()
    with FakeTensorMode(allow_non_fake_inputs=True):
        full = build_cell(arch, shape_name, mesh, device=dev, **overrides)
        cell = full
        if scan:
            cfg = full.cfg
            cut = {"repeats": 1, "encoder_layers": min(cfg.encoder_layers, 1)}
            cell = build_cell(arch, shape_name, mesh, device=dev,
                              extra_cfg={**overrides.pop("extra_cfg", {}), **cut},
                              **overrides)
        counts = trace_step(cell.step_fn, cell.args, mesh)
        if scan:
            counts["argument_bytes"] = trace_step(lambda *a: None, full.args, mesh,
                                                  track_memory=False)["argument_bytes"]
        n_params = count_params(init_params(full.cfg, device="meta"))
    secs = time.perf_counter() - t0
    report = analyze_traced(counts, arch=configs.resolve(arch), shape=shape,
                            mesh_desc=mesh_desc, n_devices=mesh.size(), cfg=full.cfg,
                            n_params=n_params)
    if verbose:
        print({k: counts[k] for k in ("flops", "bytes", "argument_bytes", "peak_bytes")},
              dict(counts["collective_by_axis"]))
        print(report.summary(), f"[trace {secs:.1f}s]", flush=True)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"{configs.resolve(arch)}__{shape.name}__{mesh_desc}.json")
        with open(path, "w") as f:
            json.dump({**report.to_dict(), "trace_seconds": secs, "scan": scan}, f, indent=1)
    return report, secs


def check_fits(report) -> None:
    """Raise if the cell's argument bytes per rank exceed the card's memory:
    the counterpart of the reference's compile-time OOM."""
    args, limit = report.memory_stats["argument_size_in_bytes"], report.hw["hbm_bytes"]
    if args > limit:
        raise RuntimeError(f"{report.arch} × {report.shape} × {report.mesh}: argument bytes "
                           f"per rank {args:.4g} exceed the card's {limit:.4g}")


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--arch", default="all")
    p.add_argument("--shape", default="all")
    p.add_argument("--multi-pod", action="store_true")
    p.add_argument("--both-meshes", action="store_true",
                   help="run each cell on the single-pod AND multi-pod mesh")
    p.add_argument("--out", default="experiments/dryrun")
    p.add_argument("--remat", default=None)
    p.add_argument("--fsdp", default=None, choices=(None, "on", "off"))
    p.add_argument("--scan", action="store_true",
                   help="one repeat of the layer pattern (fast, inexact FLOPs)")
    args = p.parse_args(argv)

    archs = list(configs.ARCH_IDS) if args.arch == "all" else [
        configs.resolve(a) for a in args.arch.split(",")]
    cells = []
    for arch in archs:
        shapes = ([s for a, s in configs.live_cells() if a == arch]
                  if args.shape == "all" else args.shape.split(","))
        cells += [(arch, s) for s in shapes]

    overrides = {}
    if args.remat:
        overrides["remat"] = args.remat
    if args.fsdp:
        overrides["fsdp"] = args.fsdp == "on"

    meshes = [args.multi_pod] if not args.both_meshes else [False, True]
    failures = []
    for multi_pod in meshes:
        fake_process_group(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod, device=_device())
        for arch, shape_name in cells:
            tag = f"{arch} × {shape_name} × {'2x32x8' if multi_pod else '32x8'}"
            try:
                report, _ = run_cell(arch, shape_name, multi_pod=multi_pod, out_dir=args.out,
                                     overrides=overrides, mesh=mesh, scan=args.scan)
                check_fits(report)
            except Exception as e:                          # noqa: BLE001
                failures.append((tag, repr(e)))
                traceback.print_exc()
                print(f"FAILED: {tag}", flush=True)
    print(f"\n{len(cells) * len(meshes) - len(failures)}/{len(cells) * len(meshes)} "
          "cells traced")
    for tag, err in failures:
        print(f"  FAIL {tag}: {err[:200]}")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
