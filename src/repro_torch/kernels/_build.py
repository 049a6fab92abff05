"""Build and load the CUDA kernels of ``csrc/`` as one shared library.

The sources have a plain C interface, so ``nvcc`` compiles them in seconds
into ``build/`` at the root of the checkout (listed in ``.gitignore``) and
:func:`load` binds them with ``ctypes``. Every ``csrc/*.cu`` is compiled to
an object by its own ``nvcc``, all started together, and the objects are
linked into one library. Its file name carries a hash of every source and
header and of the flags, so an edited source is never served from a stale
build. Executor threads can reach the first launch together: the
build runs once under a lock, and the library is written under a temporary
name and renamed into place, so no process ever loads a half-written file.
"""
from __future__ import annotations

import ctypes
import hashlib
import itertools
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["load", "kernel_info", "BUILD_DIR", "CSRC"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "repro_error_string": ([_I], ctypes.c_char_p),
    "repro_smem_optin": ([_I], _I),
    "repro_level_scratch": ([_I] * 5, ctypes.c_longlong),
    "repro_level_launches": ([_I] * 5, _I),
    "repro_histogram": ([_P] * 6 + [_I] * 4 + [_P], _I),
    "repro_level_split": ([_P] * 7 + [_F, _F, _I] + [_P] * 5 + [_I] * 5 + [_P], _I),
    "repro_split_scan": ([_P] * 2 + [_F, _F, _I] + [_P] * 3 + [_I] * 3 + [_P], _I),
    "repro_flash_max_head_dim": ([], _I),
    "repro_flash_attention": ([_P] * 4 + [_I] * 7 + [_F, _F, _I, _I, _P], _I),
    "repro_rglru": ([_P] * 7 + [_I] * 4 + [_F, _P], _I),
    "repro_rwkv6_smem": ([_I, _I], ctypes.c_longlong),
    "repro_rwkv6": ([_P] * 8 + [_I] * 6 + [_P], _I),
    "repro_rwkv6_chunked_smem": ([_I, _I], ctypes.c_longlong),
    "repro_rwkv6_chunked": ([_P] * 8 + [_I] * 6 + [_P], _I),
}
#: one function per source: (i, &name, &registers, &local bytes) -> 0 | -1 | error
_KERNEL_INFO = ("repro_histogram_kernel_info", "repro_flash_kernel_info",
                "repro_rglru_kernel_info", "repro_rwkv6_kernel_info")
_SIGNATURES.update({name: ([_I, ctypes.POINTER(ctypes.c_char_p)] + [ctypes.POINTER(_I)] * 2, _I)
                    for name in _KERNEL_INFO})

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
#: seconds the last build in this process took (None: served from build/)
build_seconds: float | None = None
#: what nvcc printed for that build (ptxas register and shared-memory use)
build_log: str = ""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = Path("/usr/local/cuda/bin/nvcc")
    if fallback.exists():
        return str(fallback)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on first use "
                       "and need the CUDA toolkit")


def _sources() -> list[Path]:
    """Every kernel source of the checkout, in a fixed order."""
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):       # sources and headers
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return h.hexdigest()[:16]


def _build(out: Path) -> None:
    global build_seconds, build_log
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.{threading.get_ident()}"
    objs = [out.with_name(f"{src.stem}.{tag}.o") for src in _sources()]
    tmp = out.with_name(f"{out.name}.{tag}.tmp")
    nvcc = _nvcc()
    t0 = time.perf_counter()
    try:
        procs = [subprocess.Popen([nvcc, *_FLAGS, "-c", "-o", str(obj), str(src)],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                  text=True)
                 for src, obj in zip(_sources(), objs)]
        logs = []
        for src, proc in zip(_sources(), procs):
            _, err = proc.communicate()
            logs.append(err)
            if proc.returncode != 0:
                for other in procs:
                    other.wait()
                raise RuntimeError(f"nvcc failed on {src.name}:\n{err}")
        link = subprocess.run([nvcc, *_FLAGS[:2], "-shared", "-o", str(tmp),
                               *map(str, objs)], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"linking the kernels failed:\n{link.stderr}")
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
        for obj in objs:
            obj.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0
    build_log = "".join(logs)


def load() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            out = BUILD_DIR / f"libreprokernels-{_digest()}.so"
            if not out.exists():
                _build(out)
            lib = ctypes.CDLL(str(out))
            for name, (args, res) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = args, res
            _lib = lib
    return _lib


def kernel_info() -> list[tuple[str, int, int]]:
    """``(name, registers per thread, local bytes per thread)`` of every
    kernel in the library, from ``cudaFuncGetAttributes`` on the current
    device. Local bytes above 0 mean the kernel spills registers."""
    lib = load()
    out = []
    for fn_name in _KERNEL_INFO:
        fn = getattr(lib, fn_name)
        for i in itertools.count():
            name, regs, local = ctypes.c_char_p(), _I(), _I()
            err = fn(i, ctypes.byref(name), ctypes.byref(regs), ctypes.byref(local))
            if err == -1:
                break
            if err:
                raise RuntimeError(f"{fn_name}({i}): CUDA error {err} "
                                   f"({lib.repro_error_string(err).decode()})")
            out.append((name.value.decode(), regs.value, local.value))
    return out
