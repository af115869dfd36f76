"""Times the dense flash decode (K3, flash_decode_kernel) of the tree it
runs in at three shapes (H 12, D 64): phase 3's (B 8, L 1024, lengths
[1024, 1, 517, 300, 16, 17, 1, 1]), the dense server's steady state
(8 rows x 512, L 512) and the offline sampler's at --num_samples=1 and
full block size (1 row x 1024, L 1024), under a bf16 and an fp32 query
over every pool (fp32, bf16, int8, int4). Each case is checked against
the plain version first (chip_smoke.DECODE_TOL; the 1024-position row
also equal bits on two calls), then timed by chip_smoke.time_ms (cold L2,
median of 25) beside its bound. It also times the floor of that timing,
a one-element fill.

    cd <a checkout of the repository> && python3 <path>/k3_times.py \\
        [--split=256,512,1024,2048]

Each variant is a build of flash_decode.cu alone, all built at once
before the timing: the tree's own, then with --split one for each P,
made with -DNSB_K3_SPLIT=<P> (every pool mode splits a row of len
positions over min(S, ceil(len / P)) blocks; a tree without the macro
ignores it). The script imports chip_smoke and
nanosandbox_tpu_torch from the working directory, so the same script
times two commits in turns.
"""
import ctypes
import os
import subprocess
import sys
import types

import numpy as np
import torch

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402
from nanosandbox_tpu_torch.ops import _build  # noqa: E402
from nanosandbox_tpu_torch.ops import flash_decode as fd  # noqa: E402

H, D = 12, 64
SHAPES = {"phase3": (1024, [1024, 1, 517, 300, 16, 17, 1, 1]),
          "8x512": (512, [512] * 8),
          "1x1024": (1024, [1024])}
QUERIES = (torch.bfloat16, torch.float32)

variants = {"tree": []}
for arg in sys.argv[1:]:
    name, _, value = arg.partition("=")
    if name == "--split":
        variants.update({f"P={p}": [f"-DNSB_K3_SPLIT={int(p)}"]
                         for p in value.split(",")})
    else:
        raise SystemExit(f"unknown argument {arg!r} (--split=256,512)")


def build(variants: dict) -> dict:
    """{label: library namespace holding nsb_flash_decode}: flash_decode.cu
    built with each label's extra nvcc flags, one nvcc each, in parallel;
    prints each build's registers and spill stores of the D 64 instances."""
    src = next(s for s in _build.SOURCES if s.endswith("flash_decode.cu"))
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    procs = {}
    for label, flags in variants.items():
        out = os.path.join(_build.BUILD_DIR,
                           f"k3_times_{label.replace('=', '')}.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o", out, src,
               *_build.LINK_FLAGS]
        procs[label] = (out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    argtypes = _build._signatures()["nsb_flash_decode"]
    libs = {}
    for label, (out, proc) in procs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{label}: nvcc failed:\n{stderr[-3000:]}")
        report = {n: rs for n, rs in cs.ptxas_report(stdout + stderr).items()
                  if "flash_decode_kernel" in n and "Li64E" in n}
        print(f"{label} ({' '.join(variants[label]) or 'no flags'}): D 64 "
              f"instances {len(report)}, registers "
              f"{sorted({r for r, _ in report.values()})}, max spill stores "
              f"{max((s for _, s in report.values()), default=0)} bytes",
              flush=True)
        fn = ctypes.CDLL(out).nsb_flash_decode
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        libs[label] = types.SimpleNamespace(nsb_flash_decode=fn)
    return libs


print(cs.nvidia_smi(), flush=True)
libs = build(variants)
rng = np.random.default_rng(cs.SEED + 14)
data = {}
for shape, (L, lens) in SHAPES.items():
    B = len(lens)
    k, v = (torch.from_numpy(rng.standard_normal(
        (B, H, L, D), dtype=np.float32)).to("cuda") for _ in range(2))
    q = torch.from_numpy(rng.standard_normal((B, H, D), dtype=np.float32))
    data[shape] = (q.to("cuda"), k, v,
                   torch.tensor(lens, dtype=torch.int32, device="cuda"))
    split = (fd.dense_decode_splits(B, H, L, fd._sm_count(k.device))
             if hasattr(fd, "dense_decode_splits") else "one block a row")
    print(f"{shape}: B {B}, L {L}, (S, Ls) {split}", flush=True)
tiny = torch.zeros(1, device="cuda")
print(f"floor: one-element fill {cs.time_ms(lambda: tiny.zero_()):.5f} ms",
      flush=True)
for label, lib in libs.items():
    _build._lib = lib
    for shape, (q32, k, v, n) in data.items():
        row = []
        for qdt in QUERIES:
            q = q32.to(qdt)
            for mode in fd.KV_MODES:
                (kk, ks), (vv, vs) = (cs.pool_in_mode(k, mode),
                                      cs.pool_in_mode(v, mode))
                kw = {} if ks is None else dict(k_scale=ks, v_scale=vs)
                got = fd.flash_decode(q, kk, vv, n, **kw)
                tag = f"{label} {shape} q {str(qdt)[6:]} kv {mode}"
                cs.check_limits(tag, got, fd.torch_decode_attention(
                    q, kk, vv, n, **kw), qdt)
                if shape == "1x1024" and not torch.equal(
                        got, fd.flash_decode(q, kk, vv, n, **kw)):
                    raise SystemExit(f"{tag}: two calls differ")
                ms = cs.time_ms(lambda: fd.flash_decode(q, kk, vv, n, **kw))
                nbytes = cs.decode_bytes(int(n.clamp(min=0).sum()), H, D,
                                         mode, q.numel() * q.element_size())
                bound = 1e3 * nbytes / cs.HBM_BYTES_PER_S
                row.append(f"{'bf16' if qdt == torch.bfloat16 else 'fp32'}"
                           f"/{mode} {ms:.5f} ({100 * bound / ms:.1f}%)")
        print(f"{label} {shape} ms (% of bound): " + "; ".join(row),
              flush=True)
