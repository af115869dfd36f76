"""ctypes binding of the native batch gather (csrc/batchgen.cpp).

g++ builds the source at first use into ``build/`` at the repository
root (listed in .gitignore), under a name keyed by the source's and the
flags' hash, as ops/_build.py does for the CUDA sources, and ctypes
loads it. A missing g++ or a failed build raises: the loader has no
other sampler. ``philox_offsets`` is the plain version the tests hold
the sampler's contract beside (the JAX package's fallback stream).

Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_ROOT = os.path.dirname(_PKG)
BUILD_DIR = os.path.join(REPO_ROOT, "build")
SOURCE = os.path.join(_PKG, "csrc", "batchgen.cpp")
# No -march=native: build/ may be copied to another host. No -fopenmp:
# see the source's header.
GXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
# What the loader's metrics header records.
OFFSET_SAMPLER = "native-xorshift128+"

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _target() -> str:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(SOURCE, "rb") as fh:
        h.update(fh.read())
    return os.path.join(BUILD_DIR, f"nsb_batchgen_{h.hexdigest()[:16]}.so")


def _build(out: str) -> None:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(
            "g++ not found on PATH: the data loader's batch gather "
            "(nanosandbox_tpu_torch/csrc/batchgen.cpp) is built from "
            "source at first use")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run([gxx, *GXX_FLAGS, SOURCE, "-o", tmp],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}) on "
                           f"{SOURCE}:\n{proc.stderr[-4000:]}")
    os.replace(tmp, out)


def get_lib() -> ctypes.CDLL:
    """The loaded library, built on the first call of the process."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        out = _target()
        if not os.path.exists(out):
            # lockcheck: disable=blocking-under-lock -- build once: the
            # lock makes one thread run g++ while the others wait for
            # the library instead of racing it over the same output.
            _build(out)
        lib = ctypes.CDLL(out)
        p, i64, u64 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint64
        lib.gather_windows_u16.argtypes = [p, i64, p, i64, i64, p]
        lib.gather_windows_u16.restype = None
        lib.sample_offsets.argtypes = [u64, u64, i64, i64, i64, p]
        lib.sample_offsets.restype = None
        _lib = lib
        return _lib


def gather_windows(data: np.ndarray, offsets: np.ndarray,
                   width: int) -> np.ndarray:
    """``len(offsets)`` windows of ``width`` uint16 tokens of ``data``,
    (B, width) uint16."""
    if data.dtype != np.uint16 or data.ndim != 1 \
            or not data.flags.c_contiguous:
        raise TypeError("gather_windows takes contiguous 1-D uint16 data, "
                        f"not {data.dtype} of shape {data.shape}")
    if width > data.shape[0]:
        raise ValueError(f"window {width} longer than the data "
                         f"({data.shape[0]} tokens)")
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    out = np.empty((len(offsets), width), dtype=np.uint16)
    get_lib().gather_windows_u16(
        data.ctypes.data_as(ctypes.c_void_p), data.shape[0],
        offsets.ctypes.data_as(ctypes.c_void_p), len(offsets), width,
        out.ctypes.data_as(ctypes.c_void_p))
    return out


def sample_offsets(seed: int, stream: int, n_tokens: int, width: int,
                   batch: int) -> np.ndarray:
    """Window offsets in [0, n_tokens - width] from the xorshift128+
    sampler, deterministic in (seed, stream)."""
    if width > n_tokens:
        raise ValueError(f"window {width} longer than the data "
                         f"({n_tokens} tokens)")
    out = np.empty(batch, dtype=np.int64)
    get_lib().sample_offsets(int(seed) & (2**64 - 1),
                             int(stream) & (2**64 - 1), n_tokens, width,
                             batch, out.ctypes.data_as(ctypes.c_void_p))
    return out


def philox_offsets(seed: int, stream: int, n_tokens: int, width: int,
                   batch: int) -> np.ndarray:
    """The plain sampler: numpy's Philox keyed by (seed, stream), the
    stream in the 128-bit key, so adjacent streams are unrelated. Other
    offsets than sample_offsets' from the same (seed, stream); used only
    to hold the loader's contract (deterministic, in range) in tests."""
    key = (int(seed) << 64) | (int(stream) & ((1 << 64) - 1))
    rng = np.random.Generator(np.random.Philox(key=key))
    return rng.integers(0, n_tokens - width + 1, size=batch, dtype=np.int64)
