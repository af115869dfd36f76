"""Probes the dense flash decode (K3, csrc/flash_decode.cu) of the tree it
runs in, on a GPU, at the shapes of scripts/k3_times.py (H 12, D 64):
phase 3's lengths, 8 x 512 and 1 x 1024, under a bf16 query over a bf16
pool and an fp32 query over fp32, int8 and int4 pools.

    python3 scripts/k3_probe.py        (from the repository root)

1. Ring geometries: flash_decode.cu rebuilt with other (kStages, kGroups)
   constants (stages of the ring, row groups a warp takes from a stage),
   each checked against the plain version and timed (chip_smoke.time_ms:
   cold L2, median of 25); the tree's geometry also with the grid's split
   slots S forced to 1, which leaves no block that returns at once.
2. Clocks: a copy of the tree's kernel that stamps, in the first thread of
   every block, %globaltimer and clock64 at entry, after the barrier
   set-up and the length read, when its first stage has landed, after the
   walk and after the merge; one cold-L2 call each, printed as the medians
   over the blocks that walked keys, with the walk's rate a block in GB/s
   (the bytes of its stages after the first over their time).

Only flash_decode.cu is built (each variant at once, in parallel). The
variants are text edits of the tree's source: the script fails if a
pattern it edits is missing.
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

CSRC = os.path.join("nanosandbox_tpu_torch", "csrc")
SRC = open(os.path.join(CSRC, "flash_decode.cu")).read()
OUT = os.path.join(_build.BUILD_DIR, "k3_probe")
H, D = 12, 64
SHAPES = {"phase3": (1024, [1024, 1, 517, 300, 16, 17, 1, 1]),
          "8x512": (512, [512] * 8), "1x1024": (1024, [1024])}
PAIRS = ((torch.bfloat16, "bf16"), (torch.float32, "fp32"),
         (torch.float32, "int8"), (torch.float32, "int4"))
TREE = (int(SRC.split("constexpr int kStages = ")[1].split(";")[0]),
        int(SRC.split("constexpr int kGroups = ")[1].split(";")[0]))


def edit(s: str, old: str, new: str) -> str:
    if old not in s:
        raise SystemExit(f"k3_probe: {old!r} not in flash_decode.cu")
    return s.replace(old, new)


def geometry(stages: int, groups: int) -> str:
    s = edit(SRC, f"constexpr int kStages = {TREE[0]};",
             f"constexpr int kStages = {stages};")
    return edit(s, f"constexpr int kGroups = {TREE[1]};",
                f"constexpr int kGroups = {groups};")


def clocked() -> str:
    """The tree's kernel with per-block stamps into g_probe[8 a block]:
    entry time, end time, cycles of set-up + length, of the first stage,
    of the rest of the walk and of the merge, the stages, and a flag."""
    s = edit(SRC, '#include "mma_common.cuh"\n',
             '#include "mma_common.cuh"\n__device__ unsigned long long* '
             'g_probe;\n__device__ __forceinline__ unsigned long long gt() '
             '{ unsigned long long x; asm volatile("mov.u64 %0, '
             '%%globaltimer;" : "=l"(x)); return x; }\n')
    s = edit(s, "  if (t == 0) {\n    for (int i = 0; i < kStages; ++i) {",
             "  const unsigned long long T0 = gt();\n  const long long C0 = "
             "clock64();\n  if (t == 0) {\n    for (int i = 0; i < kStages; "
             "++i) {")
    s = edit(s, "  if (s > 0 && s >= n_act) return;",
             "  const long long C1 = clock64();\n  if (s > 0 && s >= n_act) "
             "return;")
    s = edit(s, "  float m = kNegInf, l = 0.f;\n  for (int st = 0;",
             "  float m = kNegInf, l = 0.f;\n  long long C2 = C1;\n  for (int "
             "st = 0;")
    s = edit(s, "    mbar_wait(full0 + 8 * i, (st / kStages) & 1);\n",
             "    mbar_wait(full0 + 8 * i, (st / kStages) & 1);\n    if (st "
             "== 0) C2 = clock64();\n")
    s = edit(s, "  finish_split<TQ, D, kN>(m, l, acc, n_act, out, part, "
             "tickets, row, s, S);\n}",
             "  const long long C3 = clock64();\n  finish_split<TQ, D, kN>(m, "
             "l, acc, n_act, out, part, tickets, row, s, S);\n  if (t == 0) "
             "{\n    unsigned long long* p = g_probe + 8 * ((blockIdx.z * "
             "gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x);\n    p[0] = "
             "T0; p[1] = gt(); p[2] = C1 - C0; p[3] = C2 - C1; p[4] = C3 - "
             "C2; p[5] = clock64() - C3; p[6] = n_st; p[7] = 1;\n  }\n}")
    return edit(s, 'extern "C" {\n', 'extern "C" {\nint nsb_k3_probe_set(void*'
                ' p) { return (int)cudaMemcpyToSymbol(g_probe, &p, sizeof(p));'
                ' }\n')


def build(sources: dict) -> dict:
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for label, text in sources.items():
        src, lib = (os.path.join(OUT, f"{label}.cu"),
                    os.path.join(OUT, f"{label}.so"))
        with open(src, "w") as f:
            f.write(text)
        procs[label] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", CSRC, "-o", lib, src,
             *_build.LINK_FLAGS], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    libs = {}
    for label, (lib, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{label}: nvcc failed:\n{err[-3000:]}")
        cdll = ctypes.CDLL(lib)
        fn = cdll.nsb_flash_decode
        fn.argtypes = _build._signatures()["nsb_flash_decode"]
        fn.restype = ctypes.c_int
        libs[label] = (cdll, types.SimpleNamespace(nsb_flash_decode=fn))
    return libs


def pools(k, v, mode):
    (kk, ks), (vv, vs) = cs.pool_in_mode(k, mode), cs.pool_in_mode(v, mode)
    return kk, vv, {} if ks is None else dict(k_scale=ks, v_scale=vs)


geoms = [TREE] + [g for g in ((6, 2), (3, 4), (2, 8)) if g != TREE]
sources = {f"s{st}g{gr}": geometry(st, gr) for st, gr in geoms}
sources["clocked"] = clocked()
print(cs.nvidia_smi(), flush=True)
libs = build(sources)
rng = np.random.default_rng(cs.SEED + 15)
data = {}
for shape, (L, lens) in SHAPES.items():
    q = torch.from_numpy(rng.standard_normal((len(lens), H, D),
                                             dtype=np.float32)).to("cuda")
    k, v = (torch.from_numpy(rng.standard_normal(
        (len(lens), H, L, D), dtype=np.float32)).to("cuda") for _ in range(2))
    data[shape] = (q, k, v, torch.tensor(lens, dtype=torch.int32,
                                         device="cuda"))
splits = fd.dense_decode_splits
tree = f"s{TREE[0]}g{TREE[1]}"
for label in sources:
    if label == "clocked":
        continue
    _build._lib = libs[label][1]
    for one_slot in ((False, True) if label == tree else (False,)):
        fd.dense_decode_splits = ((lambda B, H, L, sms: (1, -(-L // 64) * 64))
                                  if one_slot else splits)
        row = []
        for shape, (q32, k, v, n) in data.items():
            for qdt, mode in PAIRS:
                q = q32.to(qdt)
                kk, vv, kw = pools(k, v, mode)
                cs.check_limits(f"{label} {shape} {mode}",
                                fd.flash_decode(q, kk, vv, n, **kw),
                                fd.torch_decode_attention(q, kk, vv, n, **kw),
                                qdt)
                ms = cs.time_ms(lambda: fd.flash_decode(q, kk, vv, n, **kw))
                row.append(f"{shape} {mode} {ms:.5f}")
        print(f"{label}{' S=1' if one_slot else ''} ms: " + "; ".join(row),
              flush=True)
fd.dense_decode_splits = splits

cdll, lib = libs["clocked"]
_build._lib = lib
probe = torch.zeros(8 * 1024, dtype=torch.int64, device="cuda")
cdll.nsb_k3_probe_set.argtypes = [ctypes.c_void_p]
if cdll.nsb_k3_probe_set(probe.data_ptr()) != 0:
    raise SystemExit("k3_probe: cudaMemcpyToSymbol failed")
flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
for shape, (q32, k, v, n) in data.items():
    for qdt, mode in PAIRS:
        q = q32.to(qdt)
        kk, vv, kw = pools(k, v, mode)
        fd.flash_decode(q, kk, vv, n, **kw)
        probe.zero_()
        flush.zero_()
        torch.cuda.synchronize()
        fd.flash_decode(q, kk, vv, n, **kw)
        torch.cuda.synchronize()
        p = probe.view(-1, 8).cpu().numpy()
        p = p[p[:, 7] == 1]
        act = p[p[:, 6] > 0]
        ns = (act[:, 1] - act[:, 0]).astype(np.float64)
        ghz = np.median((act[:, 2] + act[:, 3] + act[:, 4] + act[:, 5])
                        / ns)
        # A stage: 8 warps x kGroups x 512 bytes of K and of V, and a quantized
        # pool's two f32 scales for each of its positions.
        row_bytes = D * {"fp32": 4, "bf16": 2, "int8": 1, "int4": 0.5}[mode]
        sp = 8 * TREE[1] * 512 / row_bytes
        stage = 2 * 8 * TREE[1] * 512 + (8 * sp if mode in ("int8", "int4")
                                          else 0)
        long = act[act[:, 6] == act[:, 6].max()]
        rate = ((long[:, 6] - 1) * stage / (long[:, 4] / ghz)).mean()
        print(f"clocks {shape} {mode}: {len(act)} blocks walked keys; "
              f"end of the last {(p[:, 1].max() - p[:, 0].min()) / 1e3:.2f} "
              f"us after the first start; cycles (median, max): set-up and "
              f"length {np.median(act[:, 2]):.0f} ({act[:, 2].max()}), "
              f"first stage {np.median(act[:, 3]):.0f} ({act[:, 3].max()}), "
              f"rest of the walk {np.median(act[:, 4]):.0f} "
              f"({act[:, 4].max()}) over up to {act[:, 6].max()} stages, "
              f"merge {np.median(act[:, 5]):.0f} ({act[:, 5].max()}); "
              f"{ghz:.2f} GHz; the longest walks' rate after their first "
              f"stage {rate:.1f} GB/s a block", flush=True)
