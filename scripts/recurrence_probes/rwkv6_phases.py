"""Cycles a sub-chunk in each phase of the chunked RWKV-6 kernel.

A copy of ``csrc/rwkv6.cu`` with ``clock64`` stamps at the phase borders
(the prep warps' wait for their data, the staging and the wait for a free
slot, phases (b) to (e); the chain warps' wait for a full slot, their
products and their y stores), summed over the launch by lane 0 of each
warp of block 0 and divided by the sub-chunks. Compiled with ``nvcc`` into
``build/var/`` and run once at RWKV6-7B's prefill shape (B=4, H=64,
T=4096, Dk=Dv=64, bf16); the stamps slow the kernel a little:

    python3 scripts/recurrence_probes/rwkv6_phases.py    # from the repo root, on the card
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
TICK = ("unsigned long long _acc[8] = {0, 0, 0, 0, 0, 0, 0, 0}; long long _c = 0, _n;\n"
        "#define TICK(k) _n = clock64(); _acc[k] += _n - _c; _c = _n;\n")
EDITS = [
    ("namespace {\n", "namespace {\n__device__ unsigned long long g_prof[64];\n"),
    ("  const int i0 = 2 * lane;               // this lane's channel pair in (c)\n",
     "  const int i0 = 2 * lane;               // this lane's channel pair in (c)\n" + TICK),
    ("    const int slot = c % kSlots, t0 = c * kSub, n = min(kSub, Tn - t0);\n"
     "    cp_async_wait<1>();\n",
     "    const int slot = c % kSlots, t0 = c * kSub, n = min(kSub, Tn - t0);\n"
     "    _c = clock64();\n    cp_async_wait<1>();\n"),
    ("    bar_sync(kBarPrep, kPrepThreads);    // sub-chunk c staged; c - 1's reads done\n",
     "    bar_sync(kBarPrep, kPrepThreads);    // sub-chunk c staged; c - 1's reads done\n"
     "    TICK(0)\n"),
    ("    if (c >= kSlots) bar_sync(kBarEmpty + slot, kChunkThreads);   // the chain is done with it\n",
     "    if (c >= kSlots) bar_sync(kBarEmpty + slot, kChunkThreads);   // the chain is done with it\n"
     "    TICK(1)\n"),
    ("    // (c) the running products, a lane a channel pair (zero past Dk in the\n",
     "    TICK(2)\n    // (c) the running products, a lane a channel pair (zero past Dk in the\n"),
    ("    // (d) level pw's scores (h = 8 >> pw) and, from warp 0, the diagonal\n",
     "    TICK(3)\n    // (d) level pw's scores (h = 8 >> pw) and, from warp 0, the diagonal\n"),
    ("    // (e) the scores' pieces into the slot, and hand it over\n",
     "    TICK(4)\n    // (e) the scores' pieces into the slot, and hand it over\n"),
    ("    bar_arrive(kBarFull + slot, kChunkThreads);\n  }\n  cp_async_wait<0>();\n",
     "    bar_arrive(kBarFull + slot, kChunkThreads);\n    TICK(5)\n  }\n  cp_async_wait<0>();\n"
     "  if (blockIdx.x == 0 && lane == 0)\n"
     "    for (int k = 0; k < 6; ++k) atomicAdd(&g_prof[pw * 8 + k], _acc[k]);\n#undef TICK\n"),
    ("  T* ys = reinterpret_cast<T*>(smem + L::ys) + warp * kSub * 16;\n",
     "  T* ys = reinterpret_cast<T*>(smem + L::ys) + warp * kSub * 16;\n" + TICK),
    ("    bar_sync(kBarFull + slot, kChunkThreads);\n    // y^T tile nt",
     "    _c = clock64();\n    bar_sync(kBarFull + slot, kChunkThreads);\n    TICK(0)\n    // y^T tile nt"),
    ("    if (c + kSlots < nsub) bar_arrive(kBarEmpty + slot, kChunkThreads);\n",
     "    if (c + kSlots < nsub) bar_arrive(kBarEmpty + slot, kChunkThreads);\n    TICK(1)\n"),
    ("              *reinterpret_cast<const uint4*>(ys + t * 16 + col);\n      }\n    }\n  }\n",
     "              *reinterpret_cast<const uint4*>(ys + t * 16 + col);\n      }\n    }\n    TICK(2)\n  }\n"
     "  if (blockIdx.x == 0 && lane == 0)\n"
     "    for (int k = 0; k < 3; ++k) atomicAdd(&g_prof[32 + warp * 8 + k], _acc[k]);\n#undef TICK\n"),
]
READERS = """
extern "C" int probe_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));
}
extern "C" int probe_zero() {
  unsigned long long z[64] = {};
  return (int)cudaMemcpyToSymbol(g_prof, z, sizeof(z));
}
"""
_P, _I = ctypes.c_void_p, ctypes.c_int


def main() -> int:
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    src = (CSRC / "rwkv6.cu").read_text()
    for old, new in EDITS:
        if src.count(old) != 1:
            raise SystemExit(f"an anchor is not in csrc/rwkv6.cu once: {old[:60]!r}")
        src = src.replace(old, new)
    out_dir = ROOT / "build" / "var"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "phases.cu").write_text(src + READERS)
    subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                    "-O3", "-Xcompiler", "-fPIC", "-shared", "-I", str(CSRC), "-o",
                    str(out_dir / "phases.so"), str(out_dir / "phases.cu")], check=True,
                   stderr=subprocess.DEVNULL)
    lib = ctypes.CDLL(str(out_dir / "phases.so"))
    fn = lib.repro_rwkv6_chunked
    fn.argtypes, fn.restype = [_P] * 8 + [_I] * 6 + [_P], _I
    gen = torch.Generator(device="cuda").manual_seed(1)
    b, h, t, dk = 4, 64, 4096, 64
    r, k, v = (torch.randn((b, h, t, dk), generator=gen, device="cuda").bfloat16()
               for _ in range(3))
    w = torch.randn((b, h, t, dk), generator=gen, device="cuda") * 1.5 - 1.0
    u = torch.randn((h, dk), generator=gen, device="cuda") * 0.5
    y = torch.empty_like(v)
    s = torch.empty((b, h, dk, dk), device="cuda")

    def call():
        if fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(), None,
              y.data_ptr(), s.data_ptr(), 1, b, h, t, dk, dk,
              torch.cuda.current_stream().cuda_stream):
            raise RuntimeError("launch failed")

    call()
    torch.cuda.synchronize()
    lib.probe_zero()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    call()
    end.record()
    torch.cuda.synchronize()
    out = (ctypes.c_ulonglong * 64)()
    lib.probe_read(out)
    nsub = t // 16
    print(f"one call {start.elapsed_time(end):.4f} ms; cycles a sub-chunk, block 0:")
    for pw in range(4):
        c = [out[pw * 8 + i] / nsub for i in range(6)]
        print(f"  prep warp {pw}: wait for data {c[0]:.0f}, staging and a free slot {c[1]:.0f}, "
              f"(b) {c[2]:.0f}, (c) {c[3]:.0f}, (d) {c[4]:.0f}, (e) {c[5]:.0f}")
    for wi in range(4):
        c = [out[32 + wi * 8 + i] / nsub for i in range(3)]
        print(f"  chain warp {wi}: wait for a full slot {c[0]:.0f}, products {c[1]:.0f}, "
              f"y {c[2]:.0f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
