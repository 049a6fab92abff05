"""The recurrence kernels of two checkouts side by side on one card.

Compiles ``csrc/rglru.cu`` and ``csrc/rwkv6.cu`` of another checkout (the
parent of a change, unpacked with ``git archive``) into a library of its own
under ``build/ab/`` and runs it beside this checkout's kernels in one
process, on the same seeded inputs, at ``chip_smoke.py``'s phase-6 shapes:
RG-LRU at B=4 T=4096 D=4096 bf16 with and without h0 and at T=1; RWKV-6 at
B=4 H=64 T=4096 Dk=Dv=64 bf16 with and without s0 and at T=1. For each it
prints whether the two checkouts' outputs are bit-equal (else the largest
difference), each one's largest error against the plain version, and each
one's time by CUDA events over 20 calls (the wrapper's host time included)
and by a CUDA graph's replay (the device alone), timed in turns: other,
this, this, other. The other checkout's RWKV-6 is its ``repro_rwkv6``; this
checkout's is ``rwkv6_cuda``, which picks its kernel by T, and its step
kernel ``repro_rwkv6`` is timed beside it at T=4096 as a control:

    python3 scripts/recurrence_ab.py --other build/parent    # from the repo root, on the card
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels.rglru import rglru_cuda  # noqa: E402
from repro_torch.kernels.rwkv6 import rwkv6_cuda  # noqa: E402

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
DEV = torch.device("cuda")


def build_other(checkout: Path) -> ctypes.CDLL:
    csrc = checkout / "src" / "repro_torch" / "kernels" / "csrc"
    out = ROOT / "build" / "ab" / "other.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                    "-O3", "-Xcompiler", "-fPIC", "-shared", "-o", str(out),
                    str(csrc / "rglru.cu"), str(csrc / "rwkv6.cu")], check=True)
    lib = ctypes.CDLL(str(out))
    # before the one-pass RG-LRU, repro_rglru took a scratch buffer
    scratch = hasattr(lib, "repro_rglru_scratch")
    for name, args, res in (("repro_rglru_scratch", [_I] * 3, ctypes.c_longlong),
                            ("repro_rglru", [_P] * (8 if scratch else 7) + [_I] * 4 + [_F, _P],
                             _I),
                            ("repro_rwkv6", [_P] * 8 + [_I] * 6 + [_P], _I)):
        if name != "repro_rglru_scratch" or scratch:
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, res
    return lib


def _ptr(t):
    return None if t is None else t.data_ptr()


def rglru_lib(lib):
    def call(x, ig, rg, a, h0):
        b, t, d = x.shape
        y = torch.empty_like(x)
        h = torch.empty((b, d), dtype=torch.float32, device=DEV)
        ptrs = [x.data_ptr(), ig.data_ptr(), rg.data_ptr(), a.data_ptr(), _ptr(h0),
                y.data_ptr(), h.data_ptr()]
        if hasattr(lib, "repro_rglru_scratch"):
            n = lib.repro_rglru_scratch(b, t, d)
            scratch = torch.empty(n, dtype=torch.float32, device=DEV) if n > 0 else None
            ptrs.append(_ptr(scratch))
        err = lib.repro_rglru(*ptrs, 1, b, t, d, 8.0, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"repro_rglru: CUDA error {err}")
        return y, h
    return call


def rwkv6_lib(lib):
    def call(r, k, v, w, u, s0):
        b, h, t, dk = r.shape
        dv = v.shape[-1]
        y = torch.empty((b, h, t, dv), dtype=v.dtype, device=DEV)
        s = torch.empty((b, h, dk, dv), dtype=torch.float32, device=DEV)
        err = lib.repro_rwkv6(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                              u.data_ptr(), _ptr(s0), y.data_ptr(), s.data_ptr(), 1, b, h, t,
                              dk, dv, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"repro_rwkv6: CUDA error {err}")
        return y, s
    return call


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


def max_diff(a, b):
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def compare(label, other, this, plain, args, control=None):
    got_o, got_t = other(*args), this(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    same = all(torch.equal(p, q) for p, q in zip(got_o, got_t))
    diffs = ", ".join(f"{max_diff(p, q):.3g}" for p, q in zip(got_o, got_t))
    errs = [", ".join(f"{max_diff(p, q):.3g}" for p, q in zip(got, want))
            for got in (got_o, got_t)]
    fns = [("other", other), ("this", this), ("this", this), ("other", other)]
    if control is not None:
        fns[1:1] = [("this step", control)]
    times = [(name, events_ms(lambda: fn(*args)), graph_ms(lambda: fn(*args)))
             for name, fn in fns]
    print(f"{label}: bit-equal {same} (max |other - this| per output: {diffs}); max |err| "
          f"against the plain version: other {errs[0]}, this {errs[1]}; ms by events / graph "
          "replay: " + "; ".join(f"{n} {e:.4f} / {g:.4f}" for n, e, g in times), flush=True)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--other", type=Path, required=True, help="a checkout of the other tree")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    other = build_other(args.other)
    this = _build.load()
    gen = torch.Generator(device=DEV).manual_seed(1)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=DEV)

    for b, t, d, with_h0 in ((4, 4096, 4096, False), (4, 4096, 4096, True), (4, 1, 4096, True)):
        x, ig, rg = (randn(b, t, d).bfloat16() for _ in range(3))
        a, h0 = randn(d), (randn(b, d) if with_h0 else None)
        compare(f"rglru B={b} T={t} D={d}{' h0' if with_h0 else ''}", rglru_lib(other),
                rglru_cuda, ref.rglru_ref, (x, ig, rg, a, h0))
    for b, h, t, with_s0 in ((4, 64, 4096, False), (4, 64, 4096, True), (4, 64, 1, True)):
        r, k, v = (randn(b, h, t, 64).bfloat16() for _ in range(3))
        w = randn(b, h, t, 64) * 1.5 - 1.0
        u = randn(h, 64) * 0.5
        s0 = randn(b, h, 64, 64) if with_s0 else None
        compare(f"rwkv6 B={b} H={h} T={t} Dk=Dv=64{' s0' if with_s0 else ''}",
                rwkv6_lib(other), rwkv6_cuda, ref.rwkv6_ref, (r, k, v, w, u, s0),
                control=rwkv6_lib(this) if t > 1 else None)
    print("registers per thread / local (spill) bytes per thread: " + "; ".join(
        f"{name} {regs}/{local}" for name, regs, local in _build.kernel_info()
        if name.startswith(("rglru", "rwkv6_chunked"))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
