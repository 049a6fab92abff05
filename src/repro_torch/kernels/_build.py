"""Build and load the CUDA kernels of ``csrc/`` as a shared library.

The sources have a plain C interface, so ``nvcc`` compiles them in seconds
into ``build/`` at the root of the checkout (listed in ``.gitignore``) and
:func:`load` binds them with ``ctypes``. The library's file name carries a
hash of the source and the flags, so an edited source is never served from
a stale build. Executor threads can reach the first launch together: the
build runs once under a lock, and the library is written under a temporary
name and renamed into place, so no process ever loads a half-written file.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["load", "BUILD_DIR", "SOURCE"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "histogram.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "repro_error_string": ([_I], ctypes.c_char_p),
    "repro_smem_optin": ([_I], _I),
    "repro_accumulate_smem": ([_I, _I], ctypes.c_longlong),
    "repro_histogram": ([_P] * 6 + [_I] * 7 + [_P], _I),
    "repro_level_split": ([_P] * 7 + [_F, _F, _I] + [_P] * 5 + [_I] * 8 + [_P], _I),
}

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


def _build(out: Path) -> None:
    global build_seconds, build_log
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {SOURCE.name}:\n{proc.stderr}")
    os.replace(tmp, out)
    build_seconds = time.perf_counter() - t0
    build_log = proc.stderr


def load() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            digest = hashlib.sha256(SOURCE.read_bytes()
                                    + " ".join(_FLAGS).encode()).hexdigest()[:16]
            out = BUILD_DIR / f"libhistogram-{digest}.so"
            if not out.exists():
                _build(out)
            lib = ctypes.CDLL(str(out))
            for name, (args, res) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = args, res
            _lib = lib
    return _lib
