"""Build and load the port's CUDA kernels.

``nvcc`` compiles each source under ``nanosandbox_tpu_torch/csrc/`` into
a shared library of its own with a plain C interface, which ``ctypes``
loads: no PyTorch headers are compiled, so a build takes seconds, and
the sources build in parallel (one ``nvcc`` each, all started
together). It happens at first use, into ``build/`` at the repository
root (listed in .gitignore), under a name keyed by the source's and
flags' hash (the shared headers included), so an edited source is
never served by a stale library.

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
import types

from nanosandbox_tpu_torch.utils import tracecheck

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_ROOT = os.path.dirname(_PKG)
BUILD_DIR = os.path.join(REPO_ROOT, "build")
SOURCES = tuple(os.path.join(_PKG, "csrc", name) for name in
                ("paged_attention.cu", "flash_decode.cu",
                 "flash_attention.cu", "flash_attention_sm90.cu"))
# Headers the sources include: part of every library's hash.
HEADERS = tuple(os.path.join(_PKG, "csrc", name) for name in
                ("attend_f32.cuh", "decode_common.cuh", "dropout.cuh",
                 "flash_ring_f32.cuh", "mma_common.cuh"))
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# After the source: flash_attention_sm90.cu looks the driver's
# cuTensorMapEncodeTiled up with dlopen.
LINK_FLAGS = ("-ldl",)

_lock = threading.Lock()
_lib: types.SimpleNamespace | None = None
# The libraries' one load a process, counted in tracecheck's global
# registry under this name (Engine.program_counts' 'kernel_builds', which
# the post_freeze_retrace watchdog watches) once the load has succeeded;
# a second load, or one while the registry is frozen, raises before nvcc
# runs.
BUDGET_NAME = "kernel_library"
tracecheck.global_registry().register(BUDGET_NAME, 1)
# What the last build did, for the caller that wants to report it:
# seconds, and per source its library path, whether it was built now,
# and nvcc's log (with ptxas's register and spill report).
build_info: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA "
            "kernels are built from source at first use and need the "
            "CUDA toolkit")
    return path


def _signatures() -> dict:
    """argtypes of every C entry point, by name."""
    p, i, f, u = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                  ctypes.c_uint)
    return {
        # (q, k, v, k_scale, v_scale, table, lengths, out, part, tickets,
        #  B, H, D, N, page, nb, S, Ls, sm_scale, q dtype, kv dtype, stream)
        "nsb_paged_decode": [p] * 10 + [i] * 8 + [f, i, i, p],
        # (q, k, v, k_scale, v_scale, table, start, out, B, H, T, D, N,
        #  page, nb, sm_scale, q dtype, kv dtype, stream)
        "nsb_paged_prefill": [p] * 8 + [i] * 7 + [f, i, i, p],
        # (q, k, v, k_scale, v_scale, lengths, out, part, tickets, B, H, D,
        #  L, S, sm_scale, q dtype, kv dtype, stream)
        "nsb_flash_decode": [p] * 9 + [i] * 5 + [f, i, i, p],
        # (q dtype, kv dtype, D, out int[6]): threads, dynamic and static
        #  shared memory bytes, registers a thread, blocks an SM, the
        #  positions a block walks before a row splits
        "nsb_flash_decode_shape": [i] * 3 + [p],
        # (q, k, v, o, lse, seed, BH, H, T, D, sm_scale, dtype, dropout on,
        #  threshold, keep scale, hash_seq_len, causal, stream)
        "nsb_flash_fwd": [p] * 6 + [i] * 4 + [f, i, i, u, f, u, i, p],
        # (q, k, v, o, dout, lse, dlse, seed, drow, dq, dk, dv, BH, H, T,
        #  D, sm_scale, dtype, dropout on, threshold, keep scale,
        #  hash_seq_len, causal, mode, stream)
        "nsb_flash_bwd": [p] * 12 + [i] * 4 + [f, i, i, u, f, u, i, i, p],
        # The non-causal bf16 K4-K7 on wgmma and TMA:
        # (q, k, v, o, lse, seed, BH, H, T, D, sm_scale, dropout on,
        #  threshold, keep scale, hash_seq_len, stream)
        "nsb_flash_fwd_sm90": [p] * 6 + [i] * 4 + [f, i, u, f, u, p],
        # (q, k, v, o, dout, lse, dlse, seed, stats, dq_acc, dq, dk, dv,
        #  BH, H, T, D, sm_scale, dropout on, threshold, keep scale,
        #  hash_seq_len, mode (0 K5, 1 K6, 2 K7), stream)
        "nsb_flash_bwd_sm90": [p] * 13 + [i] * 4 + [f, i, u, f, u, i, p],
        # (mode (-1 K4, else as above), BH, T, D, out int[4]): grid,
        #  threads, blocks an SM
        "nsb_flash_sm90_shape": [i] * 4 + [p],
        # The non-causal fp32 K4-K7 of flash_ring_f32.cuh: (mode (-1 K4,
        #  0 K5, 1 K6, 2 K7), BH, T, D, out int[6]): grid, threads, blocks
        #  an SM, dynamic shared memory bytes, registers a thread
        "nsb_flash_ring_f32_shape": [i] * 4 + [p],
    }


def _target(src: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for path in (src, *HEADERS):
        with open(path, "rb") as fh:
            h.update(fh.read())
    stem = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(BUILD_DIR, f"nsb_{stem}_{h.hexdigest()[:16]}.so")


def library() -> types.SimpleNamespace:
    """Every kernel entry point, declared, as attributes of one object;
    the libraries are built on the first call of the process (and reused
    from ``build/`` when identical builds exist)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        tracecheck.global_registry().check(BUDGET_NAME)
        t0 = time.monotonic()
        libs = []
        procs = []
        for src in SOURCES:
            out = _target(src)
            entry = {"source": os.path.relpath(src, REPO_ROOT), "path": out,
                     "log": out[:-3] + ".log", "built": False}
            libs.append(entry)
            if not os.path.exists(out):
                # lockcheck: disable=blocking-under-lock -- build once:
                # the lock makes one thread run nvcc while the others
                # wait for the libraries instead of racing it.
                os.makedirs(BUILD_DIR, exist_ok=True)
                tmp = f"{out}.{os.getpid()}.tmp"
                cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, src, *LINK_FLAGS]
                procs.append((entry, cmd, tmp, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True)))
        failed = []
        for entry, cmd, tmp, proc in procs:
            stdout, stderr = proc.communicate()
            with open(entry["log"], "w") as fh:
                fh.write(" ".join(cmd) + "\n" + stdout + stderr)
            if proc.returncode != 0:
                failed.append(f"{entry['source']} ({proc.returncode}):\n"
                              f"{stderr[-4000:]}")
            else:
                os.replace(tmp, entry["path"])
                entry["built"] = True
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        sigs = _signatures()
        fns = {}
        for entry in libs:
            cdll = ctypes.CDLL(entry["path"])
            for name, argtypes in sigs.items():
                if hasattr(cdll, name):
                    fn = getattr(cdll, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                    fns[name] = fn
        missing = sorted(set(sigs) - set(fns))
        if missing:
            raise RuntimeError(f"kernel libraries lack {missing}")
        _lib = types.SimpleNamespace(**fns)
        tracecheck.global_registry().bump(BUDGET_NAME)
        build_info.update(libs=libs, seconds=time.monotonic() - t0)
        return _lib
