"""Time the level kernel's histogram with parts of it switched off.

Copies ``src/repro_torch/kernels/csrc/histogram.cu`` into ``build/gbdt_probes/``
with compile-time hooks, builds each variant with ``nvcc`` (all at once) and
times ``repro_histogram`` through ctypes (CUDA events over 20 calls, both
launches) at R = 800,000 rows and F = 28 (and the leaf sums' F = 1):

    python3 scripts/gbdt_probes/level_variants.py      # from the repo root, on the card

Variants: ``base`` (the source as it is), ``no_atomics`` (each shared atomic
replaced by a compare that never stores), ``loads_only`` (the rows loaded,
nothing added), ``passes1`` and ``passes4`` (passes of 16-byte row loads a
thread keeps in flight; the source keeps 2).
"""
from __future__ import annotations

import ctypes
import shutil
import subprocess
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "gbdt_probes"
SHAPES = ((800_000, 28, 64, 1), (800_000, 28, 256, 1), (800_000, 28, 64, 8),
          (800_000, 28, 256, 32), (600_000, 28, 256, 512), (800_000, 1, 1, 64))

ADD_VALUE = """__device__ __forceinline__ void add_value(const TileSums& T, int k, int c, long long q) {
  atomicAdd(T.lo[k] + c, (unsigned)(q & ((1LL << kLoBits) - 1)));
  atomicAdd(T.hi[k] + c, (int)(q >> kLoBits));
}"""
ADD_LOOP = """#pragma unroll
    for (int m = 0; m < kUnroll; ++m) {
      bool ok = r0 + m * rows_per_pass < w_end && nf > 0;"""


def _variant_source() -> str:
    s = (CSRC / "histogram.cu").read_text()

    def sub(anchor: str, text: str) -> None:
        nonlocal s
        if anchor not in s:
            raise RuntimeError(f"histogram.cu changed: no {anchor[:60]!r}")
        s = s.replace(anchor, text, 1)

    sub("constexpr int kPassesVec = 2;",
        "#ifndef PASSES\n#define PASSES 2\n#endif\nconstexpr int kPassesVec = PASSES;")
    sub(ADD_VALUE, ADD_VALUE.replace(
        "  atomicAdd(T.lo[k] + c",
        "#ifdef NO_ATOMICS\n  if (q == 123456789) T.lo[k][c] = (unsigned)q;\n#else\n"
        "  atomicAdd(T.lo[k] + c").replace("(q >> kLoBits));\n}", "(q >> kLoBits));\n#endif\n}"))
    sub(ADD_LOOP, """#ifdef LOADS_ONLY
    int sink = 0;
#pragma unroll
    for (int m = 0; m < kUnroll; ++m)
      sink ^= bv[m].x ^ bv[m].y ^ bv[m].z ^ bv[m].w ^ __float_as_int(gv[m]) ^
              __float_as_int(hv[m]) ^ key[m];
    if (sink == 0x7654321) T.lo[0][0] = sink;
    continue;
#endif
""" + ADD_LOOP)
    return s


def build() -> dict[str, Path]:
    OUT.mkdir(parents=True, exist_ok=True)
    src = OUT / "histogram_variants.cu"
    src.write_text(_variant_source())
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    flags = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-Xcompiler", "-fPIC", "-shared", f"-I{CSRC}"]
    variants = {"base": [], "no_atomics": ["-DNO_ATOMICS"], "loads_only": ["-DLOADS_ONLY"],
                "passes1": ["-DPASSES=1"], "passes4": ["-DPASSES=4"]}
    libs = {name: OUT / f"{name}.so" for name in variants}
    procs = [subprocess.Popen([nvcc, *flags, *defs, "-o", str(libs[name]), str(src)])
             for name, defs in variants.items()]
    if any(p.wait() for p in procs):
        raise RuntimeError("nvcc failed")
    return libs


def main() -> None:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    p_, i_ = ctypes.c_void_p, ctypes.c_int
    libs = {}
    for name, path in build().items():
        lib = ctypes.CDLL(str(path))
        lib.repro_level_scratch.argtypes, lib.repro_level_scratch.restype = [i_] * 5, \
            ctypes.c_longlong
        lib.repro_histogram.argtypes, lib.repro_histogram.restype = [p_] * 6 + [i_] * 4 + [p_], i_
        libs[name] = lib
    print(torch.cuda.get_device_name(0))
    for r, f, nb, nn in SHAPES:
        bins = torch.randint(0, nb, (r, f), generator=gen, device=dev, dtype=torch.int32)
        g = torch.randn(r, generator=gen, device=dev)
        h = torch.rand(r, generator=gen, device=dev) + 0.1
        node = torch.randint(0, nn, (r,), generator=gen, device=dev, dtype=torch.int32)
        hist = torch.empty((nn, f, nb, 2), device=dev)
        times = []
        for name, lib in libs.items():
            scratch = torch.empty(lib.repro_level_scratch(r, f, nb, nn, 0), dtype=torch.uint8,
                                  device=dev)

            def call():
                err = lib.repro_histogram(
                    bins.data_ptr(), g.data_ptr(), h.data_ptr(), node.data_ptr(),
                    scratch.data_ptr(), hist.data_ptr(), r, f, nb, nn,
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")

            call()
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(20):
                call()
            end.record()
            torch.cuda.synchronize()
            times.append(f"{name} {start.elapsed_time(end) / 20 * 1000:.1f}")
        print(f"R={r} F={f} B={nb} N={nn} (us): " + ", ".join(times), flush=True)


if __name__ == "__main__":
    main()
