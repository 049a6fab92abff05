"""Knock-out variants of the chunked RWKV-6 kernel, timed side by side.

Each variant is a copy of ``csrc/rwkv6.cu`` with one text edit (a phase of
the prep warps or the chain warps skipped; the outputs are then wrong),
compiled with ``nvcc`` into its own library under ``build/var/`` and timed
through its ``repro_rwkv6_chunked`` at RWKV6-7B's prefill shape (B=4,
H=64, T=4096, Dk=Dv=64, bf16; CUDA events over 20 calls, two rounds). A
variant's saving against ``full`` is what that phase costs the kernel:

    python3 scripts/recurrence_probes/rwkv6_variants.py    # from the repo root, on the card
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402

CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
VARIANTS = {
    "full": [],
    # the chain warps skip the readout, scores . V and the update
    "prep_only": [("const bool active = jw < nc;", "const bool active = false;"),
                  ("    if (L::wg || active) {", "    if (active) {")],
    # the prep warps skip the running products (phase (c))
    "no_c": [("    if (i0 < DK) {\n      float2 dd[kSub], xs[kSub];",
              "    if (false) {\n      float2 dd[kSub], xs[kSub];")],
    # the prep warps skip the levels' products (phase (d))
    "no_level_mma": [("      if (pw < 3)\n        level_scores", "      if (false)\n        level_scores"),
                     ("      else\n        level_scores<PC::l1",
                      "      else if (false)\n        level_scores<PC::l1")],
    # the prep warps skip the decays (phase (b))
    "no_b": [("      for (int j = 0; j < kD; ++j)\n        // the inner exp",
              "      for (int j = 0; j < 0; ++j)\n        // the inner exp")],
}
_P, _I = ctypes.c_void_p, ctypes.c_int


def build(name, edits):
    src = (CSRC / "rwkv6.cu").read_text()
    for old, new in edits:
        if src.count(old) != 1:
            raise SystemExit(f"{name}: the edit's anchor is not in csrc/rwkv6.cu once")
        src = src.replace(old, new)
    out_dir = ROOT / "build" / "var"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"{name}.cu").write_text(src)
    out = out_dir / f"{name}.so"
    proc = subprocess.Popen([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                             "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared", "-I",
                             str(CSRC), "-o", str(out), str(out_dir / f"{name}.cu")],
                            stderr=subprocess.DEVNULL)
    return proc, out


def main() -> int:
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    procs = {name: build(name, edits) for name, edits in VARIANTS.items()}
    fns = {}
    for name, (proc, out) in procs.items():
        if proc.wait() != 0:
            raise SystemExit(f"{name}: nvcc failed")
        fn = ctypes.CDLL(str(out)).repro_rwkv6_chunked
        fn.argtypes, fn.restype = [_P] * 8 + [_I] * 6 + [_P], _I
        fns[name] = fn
    gen = torch.Generator(device="cuda").manual_seed(1)
    b, h, t, dk = 4, 64, 4096, 64
    r, k, v = (torch.randn((b, h, t, dk), generator=gen, device="cuda").bfloat16()
               for _ in range(3))
    w = torch.randn((b, h, t, dk), generator=gen, device="cuda") * 1.5 - 1.0
    u = torch.randn((h, dk), generator=gen, device="cuda") * 0.5
    y = torch.empty_like(v)
    s = torch.empty((b, h, dk, dk), device="cuda")

    def call(fn):
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(), None,
                 y.data_ptr(), s.data_ptr(), 1, b, h, t, dk, dk,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"CUDA error {err}")

    def ms(fn, reps=20):
        call(fn)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            call(fn)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    for _ in range(2):
        print("ms: " + ", ".join(f"{name} {ms(fn):.4f}" for name, fn in fns.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
