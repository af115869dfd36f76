"""Build and load the port's CUDA kernels.

``nvcc`` compiles ``nanosandbox_tpu_torch/csrc/paged_attention.cu`` into
a shared library with a plain C interface, which ``ctypes`` loads: no
PyTorch headers are compiled, so the build takes seconds. It happens at
first use, into ``build/`` at the repository root (listed in
.gitignore), under a name keyed by the source's and flags' hash, so an
edited source is never served by a stale library.

Nothing here runs at import time: importing the package on a machine
without ``nvcc`` or a GPU (the CPU test tier) must work.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_ROOT = os.path.dirname(_PKG)
BUILD_DIR = os.path.join(REPO_ROOT, "build")
SOURCES = (os.path.join(_PKG, "csrc", "paged_attention.cu"),)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
# What the last build did, for the caller that wants to report it.
build_info: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA "
            "kernels are built from source at first use and need the "
            "CUDA toolkit")
    return path


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # (q, k, v, table, lengths|start, out, B, H, [T,] D, N, page, nb,
    #  sm_scale, q dtype, kv dtype, stream)
    lib.nsb_paged_decode.argtypes = [p] * 6 + [i] * 6 + [f, i, i, p]
    lib.nsb_paged_decode.restype = i
    lib.nsb_paged_prefill.argtypes = [p] * 6 + [i] * 7 + [f, i, i, p]
    lib.nsb_paged_prefill.restype = i
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on the first call of the process
    (and reused from ``build/`` when an identical build exists)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for src in SOURCES:
            with open(src, "rb") as fh:
                h.update(fh.read())
        out = os.path.join(BUILD_DIR, f"nsb_kernels_{h.hexdigest()[:16]}.so")
        t0 = time.monotonic()
        built = False
        if not os.path.exists(out):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{out}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *SOURCES]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            with open(out[:-3] + ".log", "w") as fh:
                fh.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
            os.replace(tmp, out)
            built = True
        _lib = _declare(ctypes.CDLL(out))
        build_info.update(path=out, built=built,
                          seconds=time.monotonic() - t0,
                          log=out[:-3] + ".log")
        return _lib
