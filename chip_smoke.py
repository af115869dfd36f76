"""Drive the PyTorch/CUDA port on one GPU and check it end to end.

    python3 chip_smoke.py [--phases=2,3,7]

Phases (each prints what it found; any failure exits non-zero; --phases
runs phase 1 and the kernel phases named, 2, 3 or 7, and prints no
result line):

  1. device   torch / CUDA versions, the card's name and power limit;
  2. build    the CUDA kernels from nanosandbox_tpu_torch/csrc (into
              build/), with nvcc's register and spill report, and for
              each tensor-core instance (TENSOR_CORE_INSTANCES: bf16 K4,
              K5, K6 and K7, and K1 under a bf16 query over bf16, int8
              and int4 pools, at head_dim 32, 64, 128; all must be found)
              its registers, spill stores (must be 0) and HMMA/HGMMA
              count in the SASS (cuobjdump; must not be 0), and the
              registers and spill stores (must be 0) of each CUDA-core
              instance (CUDA_CORE_INSTANCES: the fp32 K4 with 32- and
              64-query blocks, K5, K6, K7, K1 in each of its f32 (query,
              pool) pairs, and K2 in every (query, pool) pair, at every
              head_dim; all must be found);
  3. kernels  each kernel against its plain PyTorch version on the card
              at GPT-2 124M shapes, under fp32 and bf16 queries: K2 and
              K1 (H 12, D 64, page 16, 512 blocks, 64 table entries per
              row; K2 also at the serving steady state, 8 rows x 512
              positions; K1 at B 2, T 128 and 256, starts [0, 64], and the
              8 x 512 admission wave) over a pool in the query's dtype
              and over int8 and int4 pools, K3 (flash_decode_kernel) over
              contiguous (8, 12, 1024, 64) slot rows at K2's lengths in
              the fp32, bf16, int8 and int4 modes. Both sides take the
              same pool; fp32 queries within 1e-5, bf16 within 2e-2
              (compared in f32), each also within the relative limits of
              phase 7; each case timed beside its bound and
              F.scaled_dot_product_attention on K/V gathered into
              contiguous rows and dequantized beforehand (a yardstick
              that excludes both); then, correctness only at the same
              limits, K1, K2 and K3 at head_dim 32, 64 and 128 in every
              (query, kv mode) pair (K1 also at T 100, starts [0, 37],
              and at B 8, H 12, T 160, where the f32 one takes 64-query
              blocks; K2 also at lengths Ls - 1, Ls, Ls + 1 and the full
              capacity of its splits, equal bits on two calls),
              and K2 and K3 on decode rows of length 0 and -1 in every
              kv mode (zeros out, finite);
  4. engine   GPT-2 124M in fp32 (seeded random weights) through the
              paged engine: greedy tokens must equal a no-cache
              full-sequence recompute of the same model with the plain
              attention, TF32 off;
  5. server   GPT-2 124M in bf16 served by `python -m
              nanosandbox_tpu_torch.serve`'s code path on an ephemeral
              port: 6 /generate requests (one a prefix hit), /healthz,
              /stats;
  6. counts   kernel launches of phase 5 (the serving path, counts reset
              just before it); the plain versions make no CUDA call there;
  7. train kernels  the flash-attention kernels (forward K4, fused
              backward K5, split backward K6 + K7) against their plain
              versions at the 124M training shape (B 16, H 12, T 1024,
              D 64): fp32 (TF32 off) within 1e-5 on o / lse and 1e-4 on
              dq / dk / dv (the looser bound covers K5's atomic dQ
              order), bf16 within 2e-2 (compared in f32), and every
              output's max |err| and ||err|| within a relative limit of
              its reference (1e-4 fp32, 2e-2 bf16); dropout 0.1 with a
              fixed seed, head_dim 32 and 128, and T = 200 (not a tile
              multiple), correctness only; in bf16 also T = 1000 (B 1,
              H 12), T = 1 and 17 (B 1, H 1; at T = 1 dq and dk are 0 in
              exact arithmetic and meet the absolute limit alone) and
              head_dim 128 with dropout 0.1; the split backward must
              give equal bits twice; then each kernel's time on the bf16
              and on the fp32 inputs just checked (TF32 off), beside its
              bound, its plain version and F.scaled_dot_product_attention
              (is_causal; forward, and forward+backward minus forward,
              which the fused backward and the split pair K6 + K7 are
              printed against);
  8. train parity  GPT-2 124M in fp32 (TF32 off) on a 2 x 1024 batch,
              without dropout and with dropout 0.1 (masks from alike-
              seeded generators): loss and every parameter gradient with
              the kernels, through the fused backward and through the
              split one, against the same model with the plain attention
              on the card;
  9. trainer  `python -m nanosandbox_tpu_torch.train`'s main() with
              configs/train_gpt2_124m_englishprose_bpe.py at full width
              (bf16, batch 16) on the byte-tokenized committed corpus:
              30 steps with the fused backward (the loss must fall by 2
              nats by iter 25, ckpt/30 must exist), then a resume to 35
              with the split backward; launch counts of both runs (the
              training path, counts reset just before it); the step's
              time, tok/s and MFU; a torch.profiler split of one step;
              then, as a control, the first run's 30 steps with the
              plain attention (loss trajectory printed, not checked);
 10. pools    phase 4's model and prompts through a dense-pool fp32
              engine (tokens equal to phase 4's paged engine and to the
              recompute; K3 and the K4 prefill launched), then fp32
              engines over int8 and int4 pools, paged and dense, each
              token-identical to the same engine with the kernels swapped
              for their plain versions, with the share of tokens that
              agree with the fp32-KV engine; launch counts of each run;
 11. servers  phase 5's requests against bf16 servers with --paged=off,
              --kv_dtype=int8 and --kv_dtype=int4 (every answer 200 and
              in vocabulary; K3 or the int8/int4 instances launched, no
              plain version on the card); decode tok/s, TTFT p50 and
              TPOT p50 per mode beside phase 5's;
 12. sampler  `python -m nanosandbox_tpu_torch.sample`'s main() on phase
              9's checkpoint (K4 prefill, K3 decode steps launched), then
              fp32 greedy generate() over 32 tokens on the same weights
              equal to a no-cache argmax loop.

The last line is {"ok": true, "device": {...}}; the line before it is a
JSON object with one entry per kernel instance timed (K1 twice for each
pool and query: phase 3's B 2, T 256 case and the wave; K2 twice: phase
3's lengths and the serving steady state). Needs one CUDA
GPU; without one it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import re
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12            # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12,  # dense bf16 tensor cores
              torch.float32: 67e12}    # fp32 outside the tensor cores
SEED = 1234
DEVICE = "cuda"
# GPTConfig overrides for the model of phases 4, 5, 10 and 11; empty =
# GPT-2 124M (the defaults). A CPU rehearsal of the phases sets a tiny
# model here.
MODEL: dict = {}
# Extra train CLI flags for phase 9, after its own; empty = the config's
# full width. A CPU rehearsal sets a tiny model here.
TRAIN: list = []
TRAIN_CONFIG = "configs/train_gpt2_124m_englishprose_bpe.py"
CORPUS = "data/fixtures/english_prose.txt"


def prompt_vocab(cfg) -> int:
    """Prompt tokens are drawn below GPT-2's 50257 real tokens (the
    vocabulary is padded to 50304), or below a smaller model's vocab."""
    return min(50257, cfg.vocab_size)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def sync() -> None:
    if DEVICE != "cpu":
        torch.cuda.synchronize()


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30, check=True).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, reps: int = 25) -> float:
    """Median device time of one call, from CUDA events. Before each call
    the L2 is flushed (the serving path finds each layer's pool cold) and
    the stream is kept busy while the host enqueues, so the events time
    the call's kernels and not the host's launch latency."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=DEVICE)
    fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(20_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


# ---------------------------------------------------------------------------
# phase 2: the build
# ---------------------------------------------------------------------------

# The kernels on the tensor cores, by the name their symbols carry.
TENSOR_CORE_KERNELS = ("flash_fwd_mma_kernel", "flash_bwd_mma_kernel",
                       "flash_bwd_dq_mma_kernel", "paged_prefill_mma_kernel")
# CUDA-core kernels whose instances phase 2 holds to 0 spill bytes: the
# f32 ones and K2.
CUDA_CORE_KERNELS = ("flash_fwd_f32_kernel", "flash_bwd_kv_kernel",
                     "flash_bwd_dq_f32_kernel", "paged_prefill_f32_kernel",
                     "paged_decode_kernel")
HEAD_DIMS = (32, 64, 128)
# The template instances phase 2 must find, as kernel_label names them:
# K4, K6 (bf16), K5 and K7 (bf16, with and without dQ), and K1 under a
# bf16 query over each bf16, int8 and int4 pool.
TENSOR_CORE_INSTANCES = tuple(sorted(
    [f"flash_fwd_mma_kernel<D={d}>" for d in HEAD_DIMS]
    + [f"flash_bwd_dq_mma_kernel<D={d}>" for d in HEAD_DIMS]
    + [f"flash_bwd_mma_kernel<D={d}, dq={w}>" for d in HEAD_DIMS
       for w in (0, 1)]
    + [f"paged_prefill_mma_kernel<{kv}, D={d}>" for d in HEAD_DIMS
       for kv in ("bf16", "int8", "int4")]))
# The (query, pool) pairs of the f32 K1: an fp32 query over every pool,
# a bf16 query over an fp32 pool.
F32_PREFILL_PAIRS = (("fp32", "fp32"), ("fp32", "bf16"), ("fp32", "int8"),
                     ("fp32", "int4"), ("bf16", "fp32"))
# The fp32 K4 and K1 in each of its f32 pairs, with 32- and 64-query
# blocks (BQ); the fp32 K5 and K7 (with and without dQ), the fp32 K6; K2
# in every (query, pool) pair.
CUDA_CORE_INSTANCES = tuple(sorted(
    [f"flash_fwd_f32_kernel<D={d}, BQ={bq}>" for d in HEAD_DIMS
     for bq in (32, 64)]
    + [f"flash_bwd_kv_kernel<D={d}, dq={w}>" for d in HEAD_DIMS
       for w in (0, 1)]
    + [f"flash_bwd_dq_f32_kernel<D={d}>" for d in HEAD_DIMS]
    + [f"paged_prefill_f32_kernel<q={qd}, kv={kv}, D={d}, BQ={bq}>"
       for d in HEAD_DIMS for qd, kv in F32_PREFILL_PAIRS
       for bq in (32, 64)]
    + [f"paged_decode_kernel<q={qd}, kv={kv}, D={d}>" for d in HEAD_DIMS
       for qd in ("fp32", "bf16")
       for kv in ("fp32", "bf16", "int8", "int4")]))


def mangled_pair(args: str) -> tuple[str, str]:
    """The (query, pool) template arguments that open a paged kernel's
    mangled arguments: float is f, __nv_bfloat16 13__nv_bfloat16 (or,
    repeated, a substitution S<n>_), int8_t (signed char) a, nsb::Int4 a
    nested name ending in 4Int4E."""
    types = args[1:].split("Li", 1)[0]
    if types.startswith("f"):
        qd, kv = "fp32", types[1:]
    elif types.startswith("13__nv_bfloat16"):
        qd, kv = "bf16", types[len("13__nv_bfloat16"):]
    else:
        return "?", "?"
    kv = ("fp32" if kv == "f" else "int8" if kv == "a"
          else "int4" if "4Int4" in kv
          else "bf16" if kv == "13__nv_bfloat16" or re.fullmatch(r"S\w*_", kv)
          else "?")
    return qd, kv


def ptxas_report(log: str) -> dict:
    """{mangled kernel name: (registers, spill store bytes)} from an
    nvcc -Xptxas -v log."""
    out = {}
    for block in log.split("Compiling entry function '")[1:]:
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores", block)
        out[block.split("'", 1)[0]] = (int(regs.group(1)) if regs else 0,
                                       int(spill.group(1)) if spill else 0)
    return out


def sass_mma_counts(sass: str) -> dict:
    """{mangled kernel name: tensor-core instructions (HMMA / HGMMA)} in
    cuobjdump -sass output."""
    return {block.split()[0]: len(re.findall(r"\bHG?MMA\.", block))
            for block in sass.split("Function : ")[1:]}


def cuobjdump_sass(lib_path: str, nvcc: str) -> str:
    import os

    return subprocess.run(
        [os.path.join(os.path.dirname(nvcc), "cuobjdump"), "-sass",
         lib_path], capture_output=True, text=True, timeout=300,
        check=True).stdout


def kernel_label(mangled: str) -> str:
    """name<template arguments> of a kernel's mangled symbol: the head_dim
    (the first integer argument), the pool's storage type of the paged
    prefill (bf16, int8 = signed char, int4 = nsb::Int4) and, for the f32
    one, the query's type and the queries a block (its second integer),
    and whether the backward computes dQ (its bool argument)."""
    name = next(n for n in TENSOR_CORE_KERNELS + CUDA_CORE_KERNELS
                if n in mangled)
    args = mangled.split(name, 1)[1]
    head_dim = re.search(r"Li(\d+)E", args).group(1)
    if name == "paged_prefill_f32_kernel":
        qd, kv = mangled_pair(args)
        bq = re.findall(r"Li(\d+)E", args)[1]
        return f"{name}<q={qd}, kv={kv}, D={head_dim}, BQ={bq}>"
    if name == "paged_decode_kernel":
        qd, kv = mangled_pair(args)
        return f"{name}<q={qd}, kv={kv}, D={head_dim}>"
    if name == "flash_fwd_f32_kernel":
        bq = re.findall(r"Li(\d+)E", args)[1]
        return f"{name}<D={head_dim}, BQ={bq}>"
    if name == "paged_prefill_mma_kernel":
        kv = ("bf16" if args.startswith("I13__nv_bfloat16") else
              "int8" if args.startswith("Ia") else
              "int4" if "4Int4" in args.split("Li", 1)[0] else "?")
        return f"{name}<{kv}, D={head_dim}>"
    if name in ("flash_bwd_mma_kernel", "flash_bwd_kv_kernel"):
        dq = re.search(r"Lb([01])E", args).group(1)
        return f"{name}<D={head_dim}, dq={dq}>"
    return f"{name}<D={head_dim}>"


def check_build(_build) -> None:
    """Builds the kernels; prints each library's ptxas summary, and the
    registers, spill stores and SASS tensor-core instructions of every
    tensor-core kernel and the registers and spill stores of the f32
    CUDA-core kernels (K1 under an fp32 query or over an fp32 pool, K5,
    K6, K7). Fails if an instance is missing, if a tensor-core kernel has
    no HMMA / HGMMA, or if one of either spills."""
    _build.library()
    info = _build.build_info
    print(f"  {len(info['libs'])} libraries in {info['seconds']:.1f} s "
          "(one nvcc per source, in parallel)")
    tc, cc = [], []
    for lib in info["libs"]:
        with open(lib["log"]) as f:
            report = ptxas_report(f.read())
        regs = [r for r, _ in report.values()]
        print(f"  {lib['source']} -> {lib['path']} "
              f"({'built' if lib['built'] else 'cached'}); ptxas: "
              f"{len(report)} kernels, registers {min(regs, default=0)}-"
              f"{max(regs, default=0)}, max spill stores "
              f"{max((s for _, s in report.values()), default=0)} bytes")
        names = [n for n in report
                 if any(k in n for k in TENSOR_CORE_KERNELS)]
        if names:
            mma = sass_mma_counts(cuobjdump_sass(lib["path"],
                                                 _build._nvcc()))
            tc += [(kernel_label(n), *report[n], mma.get(n, 0))
                   for n in names]
        cc += [(kernel_label(n), *report[n]) for n in report
               if any(k in n for k in CUDA_CORE_KERNELS)]
    for kind, want, got in (("tensor-core", TENSOR_CORE_INSTANCES, tc),
                            ("CUDA-core", CUDA_CORE_INSTANCES, cc)):
        found = tuple(sorted(t[0] for t in got))
        if found != want:
            fail(f"expected the {kind} instances {want}, found {found}")
    for label, regs, spill, mma in sorted(tc):
        print(f"  {label}: {regs} registers, {spill} bytes spill stores, "
              f"{mma} HMMA/HGMMA instructions in SASS")
        if mma == 0 or spill:
            fail(f"{label}: {mma} tensor-core instructions in its SASS, "
                 f"{spill} bytes spilled (needs > 0 and 0)")
    for label, regs, spill in sorted(cc):
        print(f"  {label} (CUDA cores): {regs} registers, {spill} bytes "
              "spill stores")
        if spill:
            fail(f"{label}: {spill} bytes spilled (needs 0)")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def make_case(rng, B, lengths, H=12, D=64, page=16, N=512, nb=64,
              sentinel_rows=()):
    """Random (N, H, page, D) pool and a (B, nb) table giving row b
    distinct blocks for its first lengths[b] positions; the other
    entries, and whole sentinel rows, hold the sentinel N."""
    k = torch.from_numpy(rng.standard_normal((N, H, page, D),
                                             dtype=np.float32))
    v = torch.from_numpy(rng.standard_normal((N, H, page, D),
                                             dtype=np.float32))
    table = np.full((B, nb), N, np.int32)
    free = list(rng.permutation(N))
    for b in range(B):
        if b in sentinel_rows:
            continue
        n = -(-int(lengths[b]) // page)
        table[b, :n] = [free.pop() for _ in range(n)]
    return k.to(DEVICE), v.to(DEVICE), torch.from_numpy(table).to(DEVICE)


def case(kernel, dtype, shape, err, tol, fn, plain_fn, library_fn, nbytes,
         flops) -> dict:
    """One timed kernel case: its times beside the least time the card
    could take, the larger of bytes over the memory rate and operations
    over the peak rate for the inputs' type."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return dict(kernel=kernel, dtype=str(dtype)[6:], shape=shape,
                max_abs_err=err, tol=tol, ms=time_ms(fn),
                plain_ms=time_ms(plain_fn), library_ms=time_ms(library_fn),
                bytes=nbytes, flops=flops, bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def gathered(pool, table, L):
    """(B, H, L, D) contiguous rows of each row's chain (the library
    yardstick's input; built outside its timing)."""
    N, H, page, D = pool.shape
    tbl = table.clamp(max=N - 1).long()
    return (pool[tbl].permute(0, 2, 1, 3, 4)
            .reshape(table.shape[0], H, -1, D)[:, :, :L].contiguous())


# Phase 3's limits by query dtype: max |err| (both sides take the same
# pool, so only the summation order differs), and the relative limits of
# phase 7.
DECODE_TOL = {torch.float32: dict(abs=1e-5, rel=1e-4),
              torch.bfloat16: dict(abs=2e-2, rel=2e-2)}
KV_ELEMENT_BYTES = {"fp32": 4, "bf16": 2, "int8": 1, "int4": 0.5}


def pool_in_mode(x, mode):
    """(values, scales) of fp32 x in a kv mode: cast, or quantized with
    the port's quantizers (scales None for the fp modes)."""
    from nanosandbox_tpu_torch.ops import flash_decode as fd

    if mode == "int8":
        return fd.quantize_kv_rows(x)
    if mode == "int4":
        return fd.quantize_kv_rows_int4(x)
    return x.to(torch.bfloat16 if mode == "bf16" else torch.float32), None


def dequantized(x, scale, dtype):
    """The values a pool stands for, in dtype (the yardstick's input)."""
    from nanosandbox_tpu_torch.ops import flash_decode as fd

    if scale is None:
        return x.to(dtype)
    if x.dtype == torch.uint8:
        x = fd.unpack_int4(x)
    return (x.float() * scale[..., None]).to(dtype)


def check_limits(name, got, ref, dtype) -> float:
    """max |err| of got against ref, failing past DECODE_TOL."""
    e = errors(got, ref)
    tol = DECODE_TOL[dtype]
    if not (e["err"] <= tol["abs"] and e["err"] <= tol["rel"] * e["ref"]
            and e["norm"] <= tol["rel"]):
        fail(f"{name}: max |err| {e['err']} (limit {tol['abs']}), max |ref| "
             f"{e['ref']}, ||err|| / ||ref|| {e['norm']} (relative limit "
             f"{tol['rel']})")
    return e["err"]


def decode_bytes(tot, H, D, mode, q_bytes) -> int:
    """Bytes one decode call must move: K and V of the visited positions
    (and their two f32 scales in the quantized modes), q read, out
    written."""
    per_pos = 2 * D * KV_ELEMENT_BYTES[mode] + (8 if mode in ("int8", "int4")
                                                else 0)
    return int(tot * H * per_pos + 2 * q_bytes)


def check_kernels(fd) -> dict:
    import torch.nn.functional as F

    rng = np.random.default_rng(SEED)
    H, D, page, N, nb = 12, 64, 16, 512, 64
    decode_len = np.array([1024, 1, 517, 300, 16, 17, 1, 1], np.int32)
    dk, dv, dtbl = make_case(rng, 8, decode_len, sentinel_rows=(6, 7))
    dq = torch.from_numpy(rng.standard_normal((8, H, D),
                                              dtype=np.float32)).to(DEVICE)
    dlen = torch.from_numpy(decode_len).to(DEVICE)
    # K2 at the serve profile's steady state: 8 slots x 512 positions.
    serve_len = np.full(8, 512, np.int32)
    sk, sv, stbl = make_case(rng, 8, serve_len)
    slen = torch.from_numpy(serve_len).to(DEVICE)
    smask = (torch.arange(512, device=DEVICE)[None, None, None, :]
             < slen[:, None, None, None])
    # K1: B 2 with row 0 cold (start 0) and row 1 after a 64-token hit, at
    # T 128 and 256; and a full admission wave of the default server (8
    # slots x 512 tokens, start 0: serve/profile.py's), under either query.
    prefill = []
    for B, T, s0 in ((2, 128, [0, 64]), (2, 256, [0, 64]), (8, 512, [0] * 8)):
        start = np.array(s0, np.int32)
        pk, pv, ptbl = make_case(rng, B, start + T)
        pq = torch.from_numpy(rng.standard_normal((B, H, T, D),
                                                  dtype=np.float32)).to(DEVICE)
        prefill.append((T, start, pq, pk, pv, ptbl,
                        torch.from_numpy(start).to(DEVICE)))
    # K3's contiguous (B, H, L, D) slot rows, at K2's lengths.
    L, tot = int(decode_len.max()), int(decode_len.sum())
    ck, cv = (torch.from_numpy(rng.standard_normal(
        (8, H, L, D), dtype=np.float32)).to(DEVICE) for _ in range(2))
    dmask = (torch.arange(L, device=DEVICE)[None, None, None, :]
             < dlen[:, None, None, None])
    lens = f"lengths={decode_len.tolist()}"

    def one(name, dtype, shape, pools, fn, plain, library_qkv, nbytes,
            flops):
        """fn against plain on ``pools`` ((k, k_scale), (v, v_scale)),
        then all three timed (the library call on K/V dequantized
        beforehand, in the query's dtype)."""
        (k, ks), (v, vs) = pools
        kw = {} if ks is None else dict(k_scale=ks, v_scale=vs)
        err = check_limits(f"{name} q {dtype} {shape}", fn(k, v, **kw),
                           plain(k, v, **kw), dtype)
        gq, gk, gv, mask = library_qkv(dequantized(k, ks, dtype),
                                       dequantized(v, vs, dtype))
        return case(name, dtype, shape, err, DECODE_TOL[dtype]["abs"],
                    lambda: fn(k, v, **kw), lambda: plain(k, v, **kw),
                    lambda: F.scaled_dot_product_attention(
                        gq, gk, gv, attn_mask=mask), nbytes, flops)

    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        q = dq.to(dtype)
        qb = q.numel() * q.element_size()
        fp = "fp32" if dtype == torch.float32 else "bf16"
        # K3 over contiguous slot rows, in every kv mode.
        for mode in ("fp32", "bf16", "int8", "int4"):
            cases.append(one(
                f"flash_decode_kernel<{mode}>", dtype,
                f"B=8 H={H} D={D} L={L} {lens}",
                (pool_in_mode(ck, mode), pool_in_mode(cv, mode)),
                lambda k, v, **kw: fd.flash_decode(q, k, v, dlen, **kw),
                lambda k, v, **kw: fd.torch_decode_attention(q, k, v, dlen,
                                                             **kw),
                lambda k, v: (q[:, :, None], k, v, dmask),
                decode_bytes(tot, H, D, mode, qb), 4 * H * D * tot))
        # K2 at the serving decode shape, and K1: over a pool in the
        # query's dtype and over int8 and int4 pools. Under a bf16 query K1
        # is the tensor-core kernel, under an fp32 query the f32 one.
        for mode in (fp, "int8", "int4"):
            tag = "" if mode == fp else f"<{mode}>"
            k1 = (f"paged_prefill_mma_kernel<{mode}>"
                  if dtype == torch.bfloat16
                  else f"paged_prefill_f32_kernel<{mode}>")
            for kk, vv, tbl, n, mask, Lg, shape, total in (
                    (dk, dv, dtbl, dlen, dmask, L, lens, tot),
                    (sk, sv, stbl, slen, smask, 512, "lengths=8x512",
                     int(serve_len.sum()))):
                cases.append(one(
                    f"paged_decode_kernel{tag}", dtype,
                    f"B=8 H={H} D={D} {shape}",
                    (pool_in_mode(kk, mode), pool_in_mode(vv, mode)),
                    lambda k, v, tbl=tbl, n=n, **kw: fd.flash_decode_paged(
                        q, k, v, tbl, n, **kw),
                    lambda k, v, tbl=tbl, n=n, **kw:
                        fd.torch_decode_attention_paged(q, k, v, tbl, n,
                                                        **kw),
                    lambda k, v, tbl=tbl, Lg=Lg, mask=mask: (
                        q[:, :, None], gathered(k, tbl, Lg),
                        gathered(v, tbl, Lg), mask),
                    decode_bytes(total, H, D, mode, qb), 4 * H * D * total))
            for T, start, pq, pk, pv, ptbl, pstart in prefill:
                qT = pq.to(dtype)
                Lp = int((start + T).max())
                qpos = pstart[:, None] + torch.arange(T, device=DEVICE)[None]
                mask = (torch.arange(Lp, device=DEVICE)[None, None, None, :]
                        <= qpos[:, None, :, None])
                cases.append(one(
                    k1, dtype,
                    f"B={len(start)} H={H} T={T} D={D} "
                    f"start={start.tolist()}",
                    (pool_in_mode(pk, mode), pool_in_mode(pv, mode)),
                    lambda k, v, **kw: fd.flash_prefill_paged(
                        qT, k, v, ptbl, pstart, **kw),
                    lambda k, v, **kw: fd.torch_prefill_attention_paged(
                        qT, k, v, ptbl, pstart, **kw),
                    lambda k, v: (qT, gathered(k, ptbl, Lp),
                                  gathered(v, ptbl, Lp), mask),
                    decode_bytes(int((start + T).sum()), H, D, mode,
                                 qT.numel() * qT.element_size()),
                    int(sum(4 * H * D * (s * T + T * T / 2)
                            for s in start))))
    print("  kernel                           dtype     shape"
          + " " * 49 + "max|err|   ms       bound_ms  %bound  plain_ms "
          "library_ms")
    for c in cases:
        print(f"  {c['kernel']:<32} {c['dtype']:<9} {c['shape']:<53} "
              f"{c['max_abs_err']:.2e} {c['ms']:.5f}  {c['bound_ms']:.5f}  "
              f"{100 * c['bound_ms'] / c['ms']:5.1f}%  {c['plain_ms']:.5f}  "
              f"{c['library_ms']:.5f}  [{c['bound_by']}]")
    print("  library_ms: F.scaled_dot_product_attention on K/V gathered into "
          "contiguous rows and dequantized beforehand (it excludes the "
          "gather and the dequantization)")
    check_other_instances(fd, rng)
    return {"cases": cases}


def check_other_instances(fd, rng) -> None:
    """The kernels' other template instances, correctness only, at the
    limits of the timed cases (DECODE_TOL): K1, K2 and K3 at head_dim 32,
    64 and 128 over fp32, bf16, int8 and int4 pools under fp32 and bf16
    queries (a bf16 query over an fp32 pool is --kv_dtype=fp32 under bf16
    compute, which must attend in f32); K1 also at T 100 with starts
    [0, 37] (a start off the page grid, a ragged last query tile, a chunk
    that spans blocks) and at B 8, H 12, T 160 (the f32 K1's 64-query
    blocks); and K2 and K3 on decode rows with lengths 0 and -1
    in every kv mode, which see no key and must return 0."""
    def randn(shape, dtype=torch.float32):
        return torch.from_numpy(rng.standard_normal(
            shape, dtype=np.float32)).to(DEVICE, dtype)

    def pools(a, b, mode):
        """k, v and their scale kwargs of fp32 a, b in a kv mode."""
        (k, ks), (v, vs) = pool_in_mode(a, mode), pool_in_mode(b, mode)
        return k, v, {} if ks is None else dict(k_scale=ks, v_scale=vs)

    worst = {}
    for D in fd.HEAD_DIMS:
        lengths = np.array([130, 1, 77], np.int32)
        n = torch.from_numpy(lengths).to(DEVICE)
        empty = torch.tensor([0, 130, -1], dtype=torch.int32, device=DEVICE)
        pk, pv, tbl = make_case(rng, 3, lengths + 40, H=4, D=D, N=64, nb=16)
        ek, ev, etbl = make_case(rng, 3, [0, 130, 0], H=4, D=D, N=64, nb=16)
        ck, cv = randn((3, 4, 256, D)), randn((3, 4, 256, D))
        rstart = np.array([0, 37], np.int32)
        rk, rv, rtbl = make_case(rng, 2, rstart + 100, H=4, D=D, N=64, nb=16)
        rs = torch.from_numpy(rstart).to(DEVICE)
        # B 8, H 12, T 160: the f32 K1's 64-query blocks (288 of them fill
        # the 132 SMs twice over), a ragged last tile, starts off the grid.
        wstart = np.array([0, 37, 0, 16, 5, 0, 64, 100], np.int32)
        wk, wv, wtbl = make_case(rng, 8, wstart + 160, H=12, D=D, N=160,
                                 nb=20)
        ws = torch.from_numpy(wstart).to(DEVICE)
        # K2's split boundaries: rows of lengths Ls - 1, Ls, Ls + 1 and the
        # full capacity, Ls the split length of a (4, 12) call over 64
        # pages of 16 on this card (an H100's 132 SMs in a CPU rehearsal).
        sms = 132 if DEVICE == "cpu" else fd._sm_count(torch.device(DEVICE))
        Ls = fd.decode_splits(4, 12, 64, 16, sms)[1]
        blens = np.array([Ls - 1, Ls, Ls + 1, 64 * 16], np.int32)
        bk, bv, btbl = make_case(rng, 4, blens, H=12, D=D, N=128, nb=64)
        bn = torch.from_numpy(blens).to(DEVICE)
        for qdt in (torch.float32, torch.bfloat16):
            q1, qT = randn((3, 4, D), qdt), randn((3, 4, 40, D), qdt)
            qs = randn((4, 12, D), qdt)
            q100 = randn((2, 4, 100, D), qdt)
            q160 = randn((8, 12, 160, D), qdt)
            for mode in fd.KV_MODES:
                k, v, s = pools(pk, pv, mode)
                k2, v2, s2 = pools(rk, rv, mode)
                k4, v4, s4 = pools(wk, wv, mode)
                k3, v3, s3 = pools(ck, cv, mode)
                ke, ve, se = pools(ek, ev, mode)
                k5, v5, s5 = pools(bk, bv, mode)
                runs = (
                    ("paged decode", fd.flash_decode_paged,
                     fd.torch_decode_attention_paged, (q1, k, v, tbl, n), s),
                    (f"paged decode, lengths {blens.tolist()}",
                     fd.flash_decode_paged, fd.torch_decode_attention_paged,
                     (qs, k5, v5, btbl, bn), s5),
                    ("paged prefill", fd.flash_prefill_paged,
                     fd.torch_prefill_attention_paged, (qT, k, v, tbl, n), s),
                    ("paged prefill, T 100, start [0, 37]",
                     fd.flash_prefill_paged, fd.torch_prefill_attention_paged,
                     (q100, k2, v2, rtbl, rs), s2),
                    ("paged prefill, B 8, H 12, T 160",
                     fd.flash_prefill_paged, fd.torch_prefill_attention_paged,
                     (q160, k4, v4, wtbl, ws), s4),
                    ("decode", fd.flash_decode, fd.torch_decode_attention,
                     (q1, k3, v3, n), s3),
                    ("paged decode, lengths [0, 130, -1]",
                     fd.flash_decode_paged, fd.torch_decode_attention_paged,
                     (q1, ke, ve, etbl, empty), se),
                    ("decode, lengths [0, 130, -1]", fd.flash_decode,
                     fd.torch_decode_attention, (q1, k3, v3, empty), s3))
                for name, fn, plain, args, scales in runs:
                    got = fn(*args, **scales)
                    tag = f"{name} D={D} q={str(qdt)[6:]} kv={mode}"
                    err = check_limits(tag, got, plain(*args, **scales), qdt)
                    if not bool(torch.isfinite(got).all()):
                        fail(f"{tag}: non-finite output")
                    if "[0, 130, -1]" in name and (got[0].any()
                                                   or got[2].any()):
                        fail(f"{tag}: a row with no key did not return 0")
                    if (fn is fd.flash_decode_paged
                            and not torch.equal(got, fn(*args, **scales))):
                        fail(f"{tag}: two calls differ")
                    worst[name] = max(worst.get(name, 0.0), err)
    print(f"  other instances (D {fd.HEAD_DIMS}, q fp32/bf16, kv "
          f"{fd.KV_MODES}; empty rows zero and finite), worst max "
          "|err| vs plain: " + "; ".join(f"{k} {e:.1e}"
                                         for k, e in worst.items()))


# ---------------------------------------------------------------------------
# phase 4: the fp32 engine against a no-cache recompute
# ---------------------------------------------------------------------------

ENGINE_NEW = 32    # greedy tokens per prompt in phases 4 and 10


def fp32_model_and_prompts():
    """GPT-2 124M in fp32 (seeded random weights) and phase 4's prompts."""
    from nanosandbox_tpu_torch.config import GPTConfig
    from nanosandbox_tpu_torch.models.gpt import GPT

    cfg = GPTConfig(**MODEL, compute_dtype="float32")
    model = GPT(cfg, device=DEVICE,
                generator=torch.Generator(device=DEVICE).manual_seed(SEED))
    rng = np.random.default_rng(SEED + 1)
    prompts = [[int(t) for t in rng.integers(0, prompt_vocab(cfg), n)]
               for n in (16, 77, 160, 300)]
    return model, prompts


def recompute(model, prompts, new=ENGINE_NEW) -> list:
    """Greedy continuations by a no-cache full-sequence forward per token
    (cropped to the last block_size tokens), with the plain attention."""
    out = []
    with torch.no_grad():
        for p in prompts:
            seq = list(p)
            for _ in range(new):
                ctx = seq[-model.cfg.block_size:]
                logits = model(torch.tensor([ctx], device=DEVICE),
                               plain_attention=True)[0, -1]
                seq.append(int(torch.argmax(logits)))
            out.append(seq[len(p):])
    return out


def run_engine(model, prompts, **kw) -> dict:
    """One engine (8 slots x 1024) drained over the prompts, greedy, with
    every count reset just before: tokens per prompt, wall time, the
    decode kernels' launches and plain-version calls on the card, and
    the flash forward's launches (the dense prefill's K4)."""
    from nanosandbox_tpu_torch.ops import attention as at
    from nanosandbox_tpu_torch.ops import flash_decode as fd
    from nanosandbox_tpu_torch.serve.engine import Engine

    engine = Engine(model, num_slots=8, max_len=1024, device=DEVICE, **kw)
    fd.reset_counts()
    at.reset_counts()
    t0 = time.monotonic()
    rids = [engine.submit(p, ENGINE_NEW) for p in prompts]
    done = {r.rid: r for r in engine.drain()}
    sync()
    out = {"tokens": [done[r].tokens for r in rids],
           "wall_s": time.monotonic() - t0,
           "launches": {k: n for k, n in fd.launches.items() if n},
           "k4_launches": at.launches["flash_attention_fwd"],
           "plain_cuda_calls": {**fd.plain_cuda_calls,
                                **at.plain_cuda_calls}}
    del engine
    if DEVICE != "cpu":
        torch.cuda.empty_cache()
    return out


def need_launches(name: str, run: dict, keys) -> None:
    """Fail unless every kernel instance in keys launched in the run, and
    no plain version ran on the card."""
    missing = [k for k in keys if not run["launches"].get(k)]
    if missing:
        fail(f"{name} bypassed a kernel: {missing} never launched "
             f"({run['launches']})")
    if any(run["plain_cuda_calls"].values()):
        fail(f"{name}: plain versions ran on the card: "
             f"{run['plain_cuda_calls']}")


def check_engine_fp32(model, prompts, ref) -> dict:
    """The paged fp32 engine's greedy tokens against the recompute."""
    run = run_engine(model, prompts)
    mismatches = sum(got != want for got, want in zip(run["tokens"], ref))
    print(f"  fp32 engine: {len(prompts)} prompts (lengths "
          f"{[len(p) for p in prompts]}), {ENGINE_NEW} greedy tokens each, "
          f"{run['wall_s']:.3f} s; launches {run['launches']}; token "
          f"mismatches vs no-cache recompute: {mismatches}")
    if mismatches:
        fail("fp32 engine greedy tokens differ from the recompute")
    need_launches("the fp32 engine", run, ("flash_decode_paged/fp32",
                                           "flash_prefill_paged/fp32"))
    return run


# ---------------------------------------------------------------------------
# phase 5: the bf16 server
# ---------------------------------------------------------------------------

def post(base, body, timeout=300):
    req = urllib.request.Request(base + "/generate",
                                 data=json.dumps(body).encode())
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def check_server(fd, smi: str, flags=(), need=("flash_decode_paged/bf16",
                                               "flash_prefill_paged/bf16"),
                 ) -> dict:
    """GPT-2 124M in bf16 behind the server's own code path, with extra
    server flags (phase 5: none; phase 11: --paged=off, --kv_dtype=...):
    6 requests in two rounds, every answer 200 with in-vocab tokens, and
    the kernel instances ``need`` launched with no plain version on the
    card. Paged servers must also show a prefix hit."""
    from nanosandbox_tpu_torch.checkpoint import save_for_serving
    from nanosandbox_tpu_torch.config import GPTConfig
    from nanosandbox_tpu_torch.models.gpt import GPT
    from nanosandbox_tpu_torch.ops import attention as at
    from nanosandbox_tpu_torch.serve.__main__ import build_server

    cfg = GPTConfig(**MODEL)                     # bf16 compute
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as out_dir:
        model = GPT(cfg, device=DEVICE, generator=torch.Generator(
            device=DEVICE).manual_seed(SEED))
        save_for_serving(out_dir, cfg, model.state_dict())
        del model
        # The serving path is the main path: counts start here.
        fd.reset_counts()
        at.reset_counts()
        server, loop, engine = build_server([
            f"--out_dir={out_dir}", "--host=127.0.0.1", "--port=0",
            "--num_slots=8", "--max_len=1024", "--kv_page_size=16",
            f"--device={DEVICE}", *flags])
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    rng = np.random.default_rng(SEED + 2)

    def toks(n):
        return [int(t) for t in rng.integers(0, prompt_vocab(cfg), n)]

    shared = toks(128)
    new = 64
    rounds = [
        [dict(prompt_tokens=shared + toks(40), temperature=0.0),
         dict(prompt_tokens=toks(200), temperature=0.8, top_k=40, seed=1),
         dict(prompt_tokens=toks(60), temperature=0.0)],
        # After round 1 the shared 128-token prefix is in the radix
        # cache: the first request here prefills only its suffix.
        [dict(prompt_tokens=shared + toks(30), temperature=0.8, top_k=40,
              seed=2),
         dict(prompt_tokens=toks(250), temperature=0.0),
         dict(prompt_tokens=toks(20), temperature=0.8, top_k=40, seed=3)],
    ]
    answers = []
    try:
        t0 = time.monotonic()
        for bodies in rounds:
            got = [None] * len(bodies)

            def one(i, body):
                got[i] = post(base, dict(body, max_new_tokens=new))

            ths = [threading.Thread(target=one, args=(i, b))
                   for i, b in enumerate(bodies)]
            for t in ths:
                t.start()
            for t in ths:
                t.join(timeout=600)
            answers += got
        wall = time.monotonic() - t0
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            health = (r.status, json.loads(r.read()))
        with urllib.request.urlopen(base + "/stats", timeout=30) as r:
            stats = json.loads(r.read())
        sync()
        launches = {k: n for k, n in fd.launches.items() if n}
        launches["flash_attention_fwd"] = at.launches["flash_attention_fwd"]
        plain = {**fd.plain_cuda_calls, **at.plain_cuda_calls}
    finally:
        server.shutdown()
        server.server_close()
        loop.stop()
        loop.join(timeout=60)
        th.join(timeout=60)
    for i, a in enumerate(answers):
        if a is None or a[0] != 200:
            fail(f"request {i}: {a}")
        t = a[1]["tokens"]
        if len(t) != new or not all(0 <= x < cfg.vocab_size for x in t):
            fail(f"request {i}: {len(t)} tokens, in-vocab "
                 f"{all(0 <= x < cfg.vocab_size for x in t)}")
    if health != (200, {"ok": True}):
        fail(f"/healthz {health}")
    label = (f"bf16 server ({'paged' if stats['paged'] else 'dense'}, "
             f"kv {stats['kv_dtype']})")
    need_launches(f"the {label}", {"launches": launches,
                                   "plain_cuda_calls": plain}, need)
    hits = "none (dense pool)"
    if stats["paged"]:
        hits = stats["kv_pool"]["prefix_hit_requests"]
        if hits < 1:
            fail(f"no prefix hit: {stats['kv_pool']}")
        hits = f"{hits} ({stats['kv_pool']['prefix_hit_tokens']} tokens)"
    total = sum(len(a[1]["tokens"]) for a in answers)
    print(f"  {label}: 6/6 answered 200 with {new} in-vocab tokens, "
          f"/healthz ok, prefix hits {hits}; launches {launches}")
    print(f"  [{smi}] decode {stats['decode_tokens_per_sec']:.1f} tok/s "
          f"(engine window), {total / wall:.1f} tok/s end to end over "
          f"{wall:.3f} s; TTFT p50 {stats['ttft_s']['p50'] * 1e3:.2f} ms; "
          f"TPOT p50 {stats['tpot_s']['p50'] * 1e3:.3f} ms; decode steps "
          f"{stats['decode_steps']}, prefill waves {stats['prefill_waves']}")
    return {"launches": launches, "plain_cuda_calls": plain,
            "stats": stats, "wall_s": wall, "tokens": total}


# ---------------------------------------------------------------------------
# phase 7: the training kernels against their plain versions
# ---------------------------------------------------------------------------

def qkv(rng, B, H, T, D, dtype):
    """q, k, v ~ N(0, 1) and dO ~ 0.1 N(0, 1) (a mean loss's gradients
    are small) on the card."""
    return [torch.from_numpy(rng.standard_normal((B, H, T, D),
                                                 dtype=np.float32) * sc)
            .to(DEVICE, dtype) for sc in (1.0, 1.0, 1.0, 0.1)]


# Phase 7's limits per dtype: max |err| on o / lse and on gradients, and
# a relative limit each tensor also meets twice over, max |err| <= rel *
# max |ref| and ||err||_2 <= rel * ||ref||_2 (sized to the data: a kernel
# that got most rows wrong fails it however small their values are).
TRAIN_TOL = {torch.float32: dict(o=1e-5, g=1e-4, rel=1e-4),
             torch.bfloat16: dict(o=2e-2, g=2e-2, rel=2e-2)}


def errors(got, ref) -> dict:
    """max |err|, max |ref| and ||err|| / ||ref||, compared in f32."""
    ref = ref.float()
    diff = got.float() - ref
    return {"err": float(diff.abs().max()), "ref": float(ref.abs().max()),
            "norm": float(diff.norm() / ref.norm().clamp_min(1e-30))}


def check_attention(at, name, q, k, v, do, rate=0.0, seed=None,
                    zero_ref=()) -> dict:
    """K4, K5 and K6 + K7 on one case against the plain versions on the
    same inputs (the backward's: the kernel forward's o and lse). Returns
    the errors of each output; fails past TRAIN_TOL. zero_ref names the
    gradients ("dq", "dk") that are 0 in exact arithmetic (T = 1: one key,
    so the softmax is 1 whatever the score and dS = 0): both sides then
    hold rounding noise of the f32 row term, the relative limits have no
    scale, and those outputs are held to the absolute limit alone."""
    kw = dict(dropout_rate=rate, seed=seed)
    o, lse = at.flash_attention_fwd(q, k, v, **kw)
    ro, rlse = at.torch_flash_attention(q, k, v, **kw)
    ref = at.torch_flash_attention_bwd(q, k, v, o, lse, do, **kw)
    if at.BWD_IMPL != "fused":
        fail(f"BWD_IMPL is {at.BWD_IMPL!r}, phase 7 checks 'fused' as K5")
    fused = at.flash_attention_bwd(q, k, v, o, lse, do, **kw)

    def split_bwd():
        return (at.flash_attention_bwd_dq(q, k, v, o, lse, do, **kw),
                *at.flash_attention_bwd_dkv(q, k, v, o, lse, do, **kw))

    split, split2 = split_bwd(), split_bwd()
    sync()
    errs = {"o": errors(o, ro), "lse": errors(lse, rlse)}
    for impl, got in (("fused", fused), ("split", split)):
        for g_name, g, r in zip(("dq", "dk", "dv"), got, ref):
            errs[f"{impl}_{g_name}"] = errors(g, r)
    name += f" {str(q.dtype)[6:]}" + (f" dropout {rate}" if rate else "")
    tol = TRAIN_TOL[q.dtype]
    for key, e in errs.items():
        lim = tol["o"] if key in ("o", "lse") else tol["g"]
        zero = key.split("_")[-1] in zero_ref
        if not (e["err"] <= lim and (zero or (
                e["err"] <= tol["rel"] * e["ref"]
                and e["norm"] <= tol["rel"]))):
            fail(f"flash attention {name}: {key} max |err| {e['err']} "
                 f"(limit {lim}), max |ref| {e['ref']} (max |err| / max "
                 f"|ref| limit {tol['rel']}), ||err|| / ||ref|| {e['norm']} "
                 f"(limit {tol['rel']})")
    if not all(torch.equal(a, b) for a, b in zip(split, split2)):
        fail(f"flash attention {name}: the split backward is not "
             "deterministic")
    return {"case": name, **errs}


def train_bound(kind, B, H, T, D, es) -> tuple[int, int]:
    """(bytes, flops) one call must move and do: each input read once,
    each output written once; causal, so T(T+1)/2 score elements per
    (row, head), 2 D flops per element per product."""
    bhtd, bht = B * H * T * D, B * H * T
    pairs = B * H * T * (T + 1) // 2
    tensors, products = {"fwd": (4, 2), "fused": (8, 5), "dq": (6, 3),
                         "dkv": (7, 4)}[kind]
    return tensors * bhtd * es + 4 * bht, 2 * D * pairs * products


def check_train_kernels(at) -> dict:
    rng = np.random.default_rng(SEED + 3)
    B, H, T, D = 16, 12, 1024, 64
    shape = f"B={B} H={H} T={T} D={D}"
    # The 124M training shape in bf16 and fp32: the inputs the times below
    # use.
    timed = {torch.bfloat16: qkv(rng, B, H, T, D, torch.bfloat16)}
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        if dtype not in timed:
            timed[dtype] = qkv(rng, B, H, T, D, dtype)
        rows.append(check_attention(at, shape, *timed[dtype]))
        rows.append(check_attention(at, f"B=2 H={H} T={T} D={D}",
                                    *qkv(rng, 2, H, T, D, dtype), rate=0.1,
                                    seed=SEED))
        for d in (32, 128):
            rows.append(check_attention(at, f"B=2 H=4 T=256 D={d}",
                                        *qkv(rng, 2, 4, 256, d, dtype)))
        rows.append(check_attention(at, f"B=2 H=4 T=200 D={D}",
                                    *qkv(rng, 2, 4, 200, D, dtype), rate=0.1,
                                    seed=[7, 0, 0, 3, 5]))
    # bf16 only, the tensor-core kernels' tile edges: a ragged last tile
    # after a long walk, one partial tile, head_dim 128 with dropout.
    bf = torch.bfloat16
    rows.append(check_attention(at, f"B=1 H={H} T=1000 D={D}",
                                *qkv(rng, 1, H, 1000, D, bf)))
    rows.append(check_attention(at, f"B=1 H=1 T=1 D={D}",
                                *qkv(rng, 1, 1, 1, D, bf),
                                zero_ref=("dq", "dk")))
    rows.append(check_attention(at, f"B=1 H=1 T=17 D={D}",
                                *qkv(rng, 1, 1, 17, D, bf)))
    rows.append(check_attention(at, "B=2 H=4 T=256 D=128",
                                *qkv(rng, 2, 4, 256, 128, bf), rate=0.1,
                                seed=SEED))
    print("  each output: max |err| of max |ref| (||err|| / ||ref||)")
    for r in rows:
        print(f"  {r['case']}:\n    " + ", ".join(
            f"{k} {e['err']:.1e} of {e['ref']:.1e} ({e['norm']:.1e})"
            for k, e in r.items() if k != "case"))

    # Times at the 124M training shape on the inputs checked above: every
    # kernel in bf16 and in fp32 (the fp32 engines' dense prefill and phase
    # 8's path; TF32 off) as "fwd_fp32", "fused_fp32", "dq_fp32" and
    # "dkv_fp32".
    kinds = ("fwd", "fused", "dq", "dkv")
    cases = time_train_kernels(at, timed[torch.bfloat16], kinds)
    for kind, c in time_train_kernels(at, timed[torch.float32],
                                      kinds).items():
        cases[f"{kind}_fp32"] = c
    print(f"  times at {shape}: kernel       ms        bound_ms  %bound  "
          "plain_ms  library_ms")
    for kind, c in cases.items():
        lib = ("-" if c["library_ms"] is None
               else f"{c['library_ms']:.5f}")
        print(f"  {kind:<10} {c['ms']:.5f}  {c['bound_ms']:.5f}  "
              f"{100 * c['bound_ms'] / c['ms']:5.1f}%  {c['plain_ms']:.5f}  "
              f"{lib}  [{c['bound_by']}]")
    for dt, tag in (("bf16", ""), ("fp32", "_fp32")):
        split = cases[f"dq{tag}"]["ms"] + cases[f"dkv{tag}"]["ms"]
        print(f"  {dt} backward: fused {cases['fused' + tag]['ms']:.5f} ms, "
              f"split (K6 + K7) {split:.5f} ms, SDPA backward (dQ, dK, dV) "
              f"{cases['fused' + tag]['library_ms']:.5f} ms")
    # The max |err| reported beside each time: that of the timed inputs.
    outputs = {"fwd": ("o", "lse"), "fused": ("fused_dq", "fused_dk",
                                              "fused_dv"),
               "dq": ("split_dq",), "dkv": ("split_dk", "split_dv")}
    for kind, c in cases.items():
        base, _, fp32 = kind.partition("_")
        row = next(r for r in rows if r["case"] == f"{shape} "
                   + ("float32" if fp32 else "bfloat16"))
        c["max_abs_err"] = max(row[n]["err"] for n in outputs[base])
    return cases


def time_train_kernels(at, inputs, kinds) -> dict:
    """Each kind's ("fwd", "fused", "dq", "dkv") time on (q, k, v, dO),
    beside its bound, its plain version and F.scaled_dot_product_attention
    (is_causal; forward, and forward+backward minus forward; none for dQ
    or dK/dV alone)."""
    import torch.nn.functional as F

    q, k, v, do = inputs
    B, H, T, D = q.shape
    dtype = q.dtype
    o, lse = at.flash_attention_fwd(q, k, v)
    qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa(), (qg, kg, vg), do)

    with torch.no_grad():
        sdpa_fwd = time_ms(sdpa)
    sdpa_bwd = time_ms(sdpa_fwd_bwd) - sdpa_fwd
    plain_bwd = time_ms(lambda: at.torch_flash_attention_bwd(q, k, v, o, lse,
                                                             do))
    runs = {"fwd": (lambda: at.flash_attention_fwd(q, k, v),
                    lambda: at.torch_flash_attention(q, k, v), sdpa_fwd),
            "fused": (lambda: at.flash_attention_bwd(q, k, v, o, lse, do),
                      None, sdpa_bwd),
            "dq": (lambda: at.flash_attention_bwd_dq(q, k, v, o, lse, do),
                   None, None),
            "dkv": (lambda: at.flash_attention_bwd_dkv(q, k, v, o, lse, do),
                    None, None)}
    cases = {}
    for kind in kinds:
        fn, plain, library = runs[kind]
        nbytes, flops = train_bound(kind, B, H, T, D, q.element_size())
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
        with torch.no_grad():
            plain_ms = time_ms(plain) if plain is not None else plain_bwd
        cases[kind] = dict(
            ms=time_ms(fn), plain_ms=plain_ms, library_ms=library,
            bytes=nbytes, flops=flops, bound_ms=1e3 * max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            dtype=str(dtype)[6:], shape=f"B={B} H={H} T={T} D={D}")
    return cases


# ---------------------------------------------------------------------------
# phase 8: the fp32 124M loss and gradients, kernels against plain
# ---------------------------------------------------------------------------

def check_train_parity(at) -> dict:
    """Without dropout, and with dropout 0.1: the kernels with the fused
    backward (K5), the kernels with the split one (K6 + K7) and the plain
    attention each draw their per-layer attention seeds and residual
    masks from generators seeded alike, so they drop the same elements
    and must agree as closely. Returns the kernel passes' launches (the
    fp32 K4-K7), summed."""
    from nanosandbox_tpu_torch.config import GPTConfig
    from nanosandbox_tpu_torch.models.gpt import GPT, cross_entropy_loss

    rng = np.random.default_rng(SEED + 4)
    kernel_launches: dict = {}
    need = {"fused": ("flash_attention_fwd", "flash_attention_bwd_fused"),
            "split": ("flash_attention_fwd", "flash_attention_bwd_dq",
                      "flash_attention_bwd_dkv")}
    for dropout in (0.0, 0.1):
        cfg = GPTConfig(**MODEL, compute_dtype="float32", dropout=dropout)
        model = GPT(cfg, device=DEVICE, generator=torch.Generator(
            device=DEVICE).manual_seed(SEED))
        x, y = (torch.from_numpy(rng.integers(0, prompt_vocab(cfg),
                                              (2, cfg.block_size)))
                .to(DEVICE) for _ in range(2))
        params = [p for _, p in model.named_parameters()]
        out = {}
        for impl in ("fused", "split", "plain"):
            gen = (torch.Generator(device=DEVICE).manual_seed(SEED + 5)
                   if dropout else None)
            at.reset_counts()
            at.BWD_IMPL = "split" if impl == "split" else "fused"
            try:
                loss = cross_entropy_loss(model(
                    x, plain_attention=impl == "plain",
                    dropout_generator=gen), y)
                grads = torch.autograd.grad(loss, params)
                sync()
            finally:
                at.BWD_IMPL = "fused"
            out[impl] = (float(loss.detach()), grads, dict(at.launches),
                         dict(at.plain_cuda_calls))
        lp, gp, _, plain_calls = out["plain"]
        for impl in ("fused", "split"):
            lk, gk, launches, _ = out[impl]
            rel = abs(lk - lp) / abs(lp)
            worst = max((float((a - b).abs().max())
                         / max(float(b.abs().max()), 1e-30), n)
                        for (n, _), a, b in zip(model.named_parameters(), gk,
                                                gp))
            name = (f"fp32 124M, 2 x {cfg.block_size}, dropout {dropout}, "
                    f"{impl} backward")
            print(f"  {name}: loss kernels {lk:.7f} plain {lp:.7f} (rel "
                  f"{rel:.1e}); worst gradient max|diff|/max|ref| "
                  f"{worst[0]:.1e} ({worst[1]}); kernel launches "
                  f"{launches}, plain CUDA calls {plain_calls}")
            if not rel <= 1e-5:
                fail(f"{name}: loss kernels {lk} vs plain {lp}: rel {rel} > "
                     "1e-5")
            if not worst[0] <= 1e-3:
                fail(f"{name}: gradient {worst[1]}: max|diff| / max|ref| "
                     f"{worst[0]} > 1e-3")
            if any(launches[k] < cfg.n_layer for k in need[impl]):
                fail(f"{name}: the kernel pass bypassed a kernel: {launches}")
            for key, n in launches.items():
                kernel_launches[key] = kernel_launches.get(key, 0) + n
        if not plain_calls["torch_flash_attention"]:
            fail(f"fp32 124M, dropout {dropout}: the plain pass did not run "
                 f"the plain attention: {plain_calls}")
        del model, out, gp
        torch.cuda.empty_cache()
    return kernel_launches


# ---------------------------------------------------------------------------
# phase 9: the trainer
# ---------------------------------------------------------------------------

def prepare_bytes(root: str, dataset: str) -> None:
    """The committed corpus as UTF-8 bytes: train.bin / val.bin (90/10,
    uint16) and meta.pkl, the layout data.prepare writes."""
    import os
    import pickle

    with open(CORPUS, "rb") as f:
        data = np.frombuffer(f.read(), dtype=np.uint8).astype(np.uint16)
    os.makedirs(os.path.join(root, dataset))
    n = int(0.9 * len(data))
    data[:n].tofile(os.path.join(root, dataset, "train.bin"))
    data[n:].tofile(os.path.join(root, dataset, "val.bin"))
    with open(os.path.join(root, dataset, "meta.pkl"), "wb") as f:
        pickle.dump({"vocab_size": 256, "kind": "byte"}, f)


def kernel_kind(name: str) -> str:
    if "flash_fwd" in name:
        return "flash forward"
    if "flash_bwd" in name:
        return "flash backward"
    low = name.lower()
    if any(w in low for w in ("gemm", "gemv", "cutlass", "sm90", "nvjet")):
        return "GEMMs"
    return "the rest"


def profile_step(trainer, x, y) -> dict:
    """Device time of one train step by kernel class (torch.profiler),
    and the device's idle share of the step's synchronised wall time."""
    from torch.profiler import ProfilerActivity, profile

    def step():
        sync()
        t0 = time.perf_counter()
        trainer.train_step(x, y)
        sync()
        return time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    walls = [step() for _ in range(3)]
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
    by_kind: dict = {}
    by_name: dict = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or 0
        if us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            kind = kernel_kind(e.key)
            by_kind[kind] = by_kind.get(kind, 0.0) + us / 1e3
            by_name[e.key] = by_name.get(e.key, 0.0) + us / 1e3
    wall_ms = 1e3 * float(np.median(walls))
    dev_ms = sum(by_kind.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"step_wall_ms": wall_ms, "device_ms": dev_ms,
            "device_ms_by_kind": by_kind, "peak_memory_gb": peak_gb,
            "top_kernels_ms": {k[:80]: v for k, v in top},
            "idle_share": 1 - dev_ms / wall_ms if by_kind else None}


def check_trainer(at, fd, smi: str, tmp: str) -> dict:
    """Phase 9 in ``tmp``: the corpus, the runs' out_dirs (phase 12 samples
    from <tmp>/out) and the control run."""
    import os

    from nanosandbox_tpu_torch import train
    from nanosandbox_tpu_torch.config import load_config

    prepare_bytes(tmp, "english_prose_bpe")
    out_dir = os.path.join(tmp, "out")
    flags = [TRAIN_CONFIG, f"--data_dir={tmp}", f"--out_dir={out_dir}",
             "--max_iters=30", "--lr_decay_iters=30", "--warmup_iters=5",
             "--eval_interval=15", "--eval_iters=4", "--log_interval=5",
             "--profile_steps=", f"--device={DEVICE}", *TRAIN]
    # The training path is the main path: counts start here. The
    # first run takes the fused backward (K5), the resume the split
    # one (K6 + K7).
    at.reset_counts()
    fd.reset_counts()
    t0 = time.monotonic()
    first = train.main(flags)
    at.BWD_IMPL = "split"
    try:
        # Every resumed step is logged: the split backward's step time.
        resumed = train.main(
            [f for f in flags if not f.startswith(("--max_iters=",
                                                   "--log_interval="))]
            + ["--max_iters=35", "--init_from=resume", "--log_interval=1"])
    finally:
        at.BWD_IMPL = "fused"
    sync()
    wall = time.monotonic() - t0
    launches = dict(at.launches)
    plain = {**at.plain_cuda_calls, **fd.plain_cuda_calls}
    ckpts = sorted(os.listdir(os.path.join(out_dir, "ckpt")))
    cfg = load_config(flags)
    losses = {r["iter"]: r["loss"] for r in first["log"]}
    print(f"  {cfg.n_layer}L/{cfg.n_head}H/{cfg.n_embd}d, block "
          f"{cfg.block_size}, vocab {cfg.vocab_size}, batch "
          f"{cfg.batch_size}, {cfg.compute_dtype}: losses "
          f"{ {i: round(v, 4) for i, v in losses.items()} }; resumed "
          f"to {resumed['iter_num']} (losses "
          f"{[round(r['loss'], 4) for r in resumed['log']]}); "
          f"checkpoints {ckpts}; {wall:.1f} s")
    if not losses[25] <= losses[0] - 2.0:
        fail(f"the loss fell from {losses[0]} to {losses[25]} by iter "
             "25, less than 2 nats")
    if "30" not in ckpts or first["iter_num"] != 30:
        fail(f"no checkpoint at 30: {ckpts}")
    if resumed["iter_num"] != 35 or resumed["log"][0]["iter"] != 30:
        fail(f"the resume did not continue at 30: {resumed['log']}")
    steps = 35
    need = {"flash_attention_fwd": cfg.n_layer * steps,
            "flash_attention_bwd_fused": cfg.n_layer * 30,
            "flash_attention_bwd_dq": cfg.n_layer * 5,
            "flash_attention_bwd_dkv": cfg.n_layer * 5}
    print(f"  kernel launches {launches}; plain versions on CUDA "
          f"{plain}")
    if any(launches[k] < n for k, n in need.items()):
        fail(f"the training path bypassed a kernel: {launches}, each "
             f"needs at least {need}")
    if any(plain.values()):
        fail(f"plain versions ran on the card in the training path: "
             f"{plain}")
    # Steady-state windows: iter 0 includes the first-call setup.
    rest = [r for r in first["log"] if r["iter"] > 0]
    ms = float(np.median([r["ms"] for r in rest]))
    toks = float(np.median([r["tok_s"] for r in rest]))
    mfu = float(np.median([r["mfu"] for r in rest]))
    # The resume's first step carries its process's first-call setup.
    split_ms = float(np.median([r["ms"] for r in resumed["log"][1:]]))
    print(f"  [{smi}] step {ms:.2f} ms (median of the logged windows "
          f"after iter 0), {toks:,.0f} tok/s, MFU {100 * mfu:.2f}%; the "
          f"resume's step with the split backward (K6 + K7) {split_ms:.2f} "
          "ms (median after its first)")
    trainer = train.Trainer(cfg)
    xb, yb = trainer.dataset.sample_batch("train", 0, cfg.batch_size,
                                          cfg.block_size)
    prof = profile_step(trainer, trainer.to_device(xb),
                        trainer.to_device(yb))
    print(f"  profiled step: wall {prof['step_wall_ms']:.2f} ms, device "
          f"{prof['device_ms']:.2f} ms ("
          + ", ".join(f"{k} {v:.2f}" for k, v in sorted(
              prof["device_ms_by_kind"].items(), key=lambda kv: -kv[1]))
          + f"), idle share {prof['idle_share']:.3f}, peak memory "
          f"{prof['peak_memory_gb']:.2f} GiB")
    for name, t in prof["top_kernels_ms"].items():
        print(f"    {t:8.3f} ms  {name}")
    del trainer
    torch.cuda.empty_cache()
    control = control_losses(train, flags, tmp)
    print("  control, the first run's 30 steps with the plain attention "
          "(after the counts; printed, not checked): losses "
          f"{ {i: round(v, 4) for i, v in control.items()} }")
    torch.cuda.empty_cache()
    return {"launches": launches, "plain_cuda_calls": plain, "step_ms": ms,
            "split_step_ms": split_ms, "tok_s": toks, "mfu": mfu,
            "profile": prof}


def control_losses(train, flags, tmp) -> dict:
    """The trainer's first run again with the plain attention in place of
    the kernels: a control for the loss trajectory. The two runs round
    differently in bf16 and part ways, so it is printed, not checked."""
    with plain_kernels():
        out = train.main([f"--out_dir={tmp}/control"
                          if f.startswith("--out_dir=") else f
                          for f in flags])
    return {r["iter"]: r["loss"] for r in out["log"]}


@contextlib.contextmanager
def plain_kernels():
    """The model's attention calls swapped for the kernels' plain
    versions, in this script only: the control runs of phases 9 and 10."""
    from nanosandbox_tpu_torch.models import gpt
    from nanosandbox_tpu_torch.ops import attention as at
    from nanosandbox_tpu_torch.ops import flash_decode as fd

    def causal(q, k, v, *, dropout_rate, seed):
        return at.torch_flash_attention(q, k, v, dropout_rate=dropout_rate,
                                        seed=seed)[0]

    swap = {"causal_attention": causal,
            "flash_decode": fd.torch_decode_attention,
            "flash_decode_paged": fd.torch_decode_attention_paged,
            "flash_prefill_paged": fd.torch_prefill_attention_paged}
    kernels = {name: getattr(gpt, name) for name in swap}
    for name, fn in swap.items():
        setattr(gpt, name, fn)
    try:
        yield
    finally:
        for name, fn in kernels.items():
            setattr(gpt, name, fn)


# ---------------------------------------------------------------------------
# phase 10: the fp32 124M engines over the dense pool and int8/int4 pools
# ---------------------------------------------------------------------------

def check_pools_fp32(model, prompts, ref, paged_fp32) -> dict:
    """The dense fp32 engine against phase 4's paged engine and the
    recompute (identical tokens); then int8 and int4 pools, paged and
    dense, each against the same engine with the kernels swapped for
    their plain versions (identical tokens), with the share of tokens
    that agree with the fp32-KV engine. Launch counts per run."""
    runs = {}
    dense = run_engine(model, prompts, paged=False)
    runs["dense fp32"] = dense
    bad = sum(a != b for a, b in zip(dense["tokens"], ref))
    bad_paged = sum(a != b for a, b in zip(dense["tokens"],
                                           paged_fp32["tokens"]))
    print(f"  dense fp32 engine: {dense['wall_s']:.3f} s; launches "
          f"{dense['launches']}, flash forward (prefill) "
          f"{dense['k4_launches']}; token mismatches vs recompute {bad}, "
          f"vs the paged engine {bad_paged}")
    if bad or bad_paged:
        fail("the dense fp32 engine's greedy tokens differ from the "
             "recompute or the paged engine")
    need = {"dense fp32": ("flash_decode/fp32",)}
    ref_tokens = sum(len(t) for t in ref)
    for mode in ("int8", "int4"):
        for paged in (True, False):
            name = f"{'paged' if paged else 'dense'} {mode}"
            run = run_engine(model, prompts, kv_dtype=mode, paged=paged)
            with plain_kernels():
                plain = run_engine(model, prompts, kv_dtype=mode,
                                   paged=paged)
            runs[name] = run
            bad = sum(a != b for a, b in zip(run["tokens"], plain["tokens"]))
            agree = sum(x == y for a, b in zip(run["tokens"], ref)
                        for x, y in zip(a, b))
            print(f"  {name} engine: {run['wall_s']:.3f} s; launches "
                  f"{run['launches']}; token mismatches vs its plain-version "
                  f"control {bad}; tokens agreeing with the fp32-KV engine "
                  f"{agree}/{ref_tokens} ({100 * agree / ref_tokens:.1f}%)")
            if bad:
                fail(f"the {name} engine's tokens differ from its "
                     "plain-version control")
            need[name] = ((f"flash_decode_paged/{mode}",
                           f"flash_prefill_paged/{mode}")
                          if paged else (f"flash_decode/{mode}",))
    # The launch checks come after every token check.
    for name, keys in need.items():
        need_launches(f"the {name} engine", runs[name], keys)
    if not dense["k4_launches"]:
        fail("the dense fp32 engine's prefill bypassed a kernel: the "
             "flash forward never launched")
    return runs


# ---------------------------------------------------------------------------
# phase 12: the offline sampler on phase 9's checkpoint
# ---------------------------------------------------------------------------

def check_sampler(train_dir: str) -> dict:
    """`python -m nanosandbox_tpu_torch.sample`'s main() on phase 9's
    checkpoint (bf16, the K4 prefill and K3 decode steps), then, on the
    same weights in fp32, greedy generate() over 32 tokens against a
    no-cache argmax loop."""
    import os

    from nanosandbox_tpu_torch import sample
    from nanosandbox_tpu_torch.checkpoint import TrainCheckpointer
    from nanosandbox_tpu_torch.config import GPTConfig, TrainConfig
    from nanosandbox_tpu_torch.models.gpt import GPT
    from nanosandbox_tpu_torch.ops import attention as at
    from nanosandbox_tpu_torch.ops import flash_decode as fd

    out_dir = os.path.join(train_dir, "out")
    # The sampling path is the main path: counts start here.
    fd.reset_counts()
    at.reset_counts()
    t0 = time.monotonic()
    texts = sample.main([f"--out_dir={out_dir}", "--start=The ",
                         "--num_samples=2", "--max_new_tokens=64",
                         f"--device={DEVICE}"])
    sync()
    wall = time.monotonic() - t0
    run = {"launches": {k: n for k, n in fd.launches.items() if n},
           "plain_cuda_calls": {**fd.plain_cuda_calls,
                                **at.plain_cuda_calls}}
    run["launches"]["flash_attention_fwd"] = at.launches[
        "flash_attention_fwd"]
    print(f"  sample CLI: 2 samples of 64 tokens in {wall:.3f} s (the "
          f"model's load included); launches {run['launches']}")
    if len(texts) != 2 or not all(t.startswith("The ") for t in texts):
        fail(f"the sample CLI printed {texts!r}")
    blob = TrainCheckpointer(out_dir).restore()
    cfg = GPTConfig.from_train_config(TrainConfig(**blob["config"]),
                                      blob["model"]["wte.weight"].shape[0])
    cli_mode = "bf16" if cfg.compute_dtype == "bfloat16" else "fp32"
    cfg.compute_dtype = "float32"
    model = GPT(cfg, device=DEVICE)
    model.load_state_dict(blob["model"])
    model.eval()
    with open(CORPUS, "rb") as f:
        prompt = list(f.read(48))
    idx = torch.tensor([prompt], device=DEVICE)
    fd.reset_counts()
    at.reset_counts()
    got = sample.generate(model, idx, 32)[0, len(prompt):].tolist()
    k3, k4 = fd.launches["flash_decode/fp32"], at.launches[
        "flash_attention_fwd"]
    want = recompute(model, [prompt])[0]
    print(f"  fp32 greedy generate, 48-byte prompt, 32 tokens: "
          f"{bytes(got).decode('utf-8', 'replace')!r}; no-cache argmax "
          f"loop {'equal' if got == want else 'DIFFERENT'}; launches "
          f"flash_decode/fp32 {k3}, flash_attention_fwd {k4}")
    if got != want:
        fail(f"fp32 generate {got} != no-cache argmax loop {want}")
    need_launches("the sample CLI", run, (f"flash_decode/{cli_mode}",
                                          "flash_attention_fwd"))
    if not (k3 and k4):
        fail("generate bypassed a kernel: flash_decode/fp32 "
             f"{k3}, flash_attention_fwd {k4}")
    del model
    if DEVICE != "cpu":
        torch.cuda.empty_cache()
    return run


# Phases that stand alone, for a partial run (--phases=2,3,7).
STANDALONE_PHASES = (2, 3, 7)


def main(argv: list[str] | None = None) -> int:
    args = sys.argv[1:] if argv is None else argv
    only = None
    for arg in args:
        name, _, value = arg.partition("=")
        if name != "--phases":
            raise SystemExit(f"chip_smoke: unknown argument {arg!r} (only "
                             "--phases=<comma list of "
                             f"{STANDALONE_PHASES}>)")
        only = {int(p) for p in value.split(",")}
        if not only <= set(STANDALONE_PHASES):
            raise SystemExit(f"chip_smoke: --phases takes phases of "
                             f"{STANDALONE_PHASES}, not {sorted(only)}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch; this script "
              "runs the port on a GPU only", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from nanosandbox_tpu_torch.ops import _build
    from nanosandbox_tpu_torch.ops import attention as at
    from nanosandbox_tpu_torch.ops import flash_decode as fd

    print("== phase 1: device")
    smi = nvidia_smi()
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    print(f"  nvidia-smi: {smi}")
    if only is not None:
        # Phases 2, 3 and 7 alone (the kernels' build, checks and times),
        # with no result line: the full run alone makes one.
        for phase, title, fn in (
                (2, "build", lambda: check_build(_build)),
                (3, "kernels vs plain versions (124M shapes)",
                 lambda: check_kernels(fd)),
                (7, "training kernels vs plain versions",
                 lambda: check_train_kernels(at))):
            if phase in only:
                print(f"== phase {phase}: {title}")
                fn()
        print(f"chip_smoke: phases {sorted(only)} passed (a partial run "
              "prints no result line)")
        return 0

    print("== phase 2: build")
    check_build(_build)

    print("== phase 3: kernels vs plain versions (124M shapes)")
    kern = check_kernels(fd)

    print("== phase 4: fp32 124M engine vs no-cache recompute")
    model, prompts = fp32_model_and_prompts()
    ref = recompute(model, prompts)
    paged_fp32 = check_engine_fp32(model, prompts, ref)

    print("== phase 5: bf16 124M server")
    served = check_server(fd, smi)

    print("== phase 6: launch counts on the serving path")
    print(f"  kernels {served['launches']}; plain versions on CUDA "
          f"{served['plain_cuda_calls']}")

    print("== phase 7: training kernels vs plain versions")
    train_cases = check_train_kernels(at)

    print("== phase 8: fp32 124M loss and gradients, kernels vs plain")
    parity_launches = check_train_parity(at)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        print("== phase 9: the 124M bf16 trainer")
        trained = check_trainer(at, fd, smi, tmp)

        print("== phase 10: fp32 124M engines, dense pool and int8/int4 "
              "pools")
        pools = check_pools_fp32(model, prompts, ref, paged_fp32)
        del model
        torch.cuda.empty_cache()

        print("== phase 11: bf16 124M servers, dense pool and int8/int4 "
              "pools")
        servers = {"paged bf16": served}
        for name, flags, need in (
                ("dense bf16", ["--paged=off"], (
                    "flash_decode/bf16", "flash_attention_fwd")),
                ("paged int8", ["--kv_dtype=int8"], (
                    "flash_decode_paged/int8", "flash_prefill_paged/int8")),
                ("paged int4", ["--kv_dtype=int4"], (
                    "flash_decode_paged/int4", "flash_prefill_paged/int4"))):
            servers[name] = check_server(fd, smi, flags, need)
        print(f"  [{smi}]\n  mode        decode tok/s  TTFT p50 ms  "
              "TPOT p50 ms")
        for name, sv in servers.items():
            st = sv["stats"]
            print(f"  {name:<11} {st['decode_tokens_per_sec']:12.1f}  "
                  f"{st['ttft_s']['p50'] * 1e3:11.2f}  "
                  f"{st['tpot_s']['p50'] * 1e3:11.3f}")

        print("== phase 12: the sampler on phase 9's checkpoint")
        check_sampler(tmp)

    def entry(name, source, replaces, launches, case):
        return {"name": name, "route": "cuda",
                "source": f"nanosandbox_tpu_torch/csrc/{source}",
                "replaces": f"nanosandbox_tpu/ops/{replaces}",
                "launches": launches,
                "max_abs_err": case["max_abs_err"], "ms": case["ms"],
                "plain_ms": case["plain_ms"], "bound_ms": case["bound_ms"],
                "bound_by": case["bound_by"],
                "library_ms": case["library_ms"],
                "case": f"{case['dtype']} {case['shape']}"}

    def timed(kernel, dtype, shape=""):
        """The first phase-3 case of a kernel instance whose shape starts
        with ``shape``."""
        return next(c for c in kern["cases"] if c["kernel"] == kernel
                    and c["dtype"] == dtype and c["shape"].startswith(shape))

    paged, dense = "paged_attention.cu", "flash_decode.cu"
    flash = "flash_attention.cu"
    sl = {name: sv["launches"] for name, sv in servers.items()}
    tl = trained["launches"]
    kernels = []
    # K2 and K1 (the tensor-core instances, a bf16 query) with the paged
    # servers' launches; K1 at phase 3's B 2, T 256 case and at the
    # 8 x 512 admission wave.
    for mode in ("bf16", "int8", "int4"):
        tag = "" if mode == "bf16" else f"<{mode}>"
        k1 = f"paged_prefill_mma_kernel<{mode}>"
        n_k1 = sl[f"paged {mode}"][f"flash_prefill_paged/{mode}"]
        n_k2 = sl[f"paged {mode}"][f"flash_decode_paged/{mode}"]
        kernels += [
            entry(f"paged_decode_kernel{tag}", paged, "flash_decode.py:421",
                  n_k2, timed(f"paged_decode_kernel{tag}", "bfloat16")),
            entry(f"paged_decode_kernel{tag}[serve B=8 len=512]", paged,
                  "flash_decode.py:421", n_k2,
                  timed(f"paged_decode_kernel{tag}", "bfloat16",
                        "B=8 H=12 D=64 lengths=8x512")),
            entry(k1, paged, "flash_decode.py:585", n_k1,
                  timed(k1, "bfloat16", "B=2 H=12 T=256")),
            entry(f"{k1}[wave B=8 T=512]", paged, "flash_decode.py:585",
                  n_k1, timed(k1, "bfloat16", "B=8"))]
    # K2 and K1 under an fp32 query (K1 the f32 kernel), with the paged
    # fp32-compute engines' launches: phase 4's over the fp32 pool, phase
    # 10's over the int8 and int4 pools.
    for mode, run in (("fp32", paged_fp32), ("int8", pools["paged int8"]),
                      ("int4", pools["paged int4"])):
        tag = "" if mode == "fp32" else f"<{mode}>"
        k1 = f"paged_prefill_f32_kernel<{mode}>"
        n_k1 = run["launches"][f"flash_prefill_paged/{mode}"]
        n_k2 = run["launches"][f"flash_decode_paged/{mode}"]
        kernels += [
            entry(f"paged_decode_kernel{tag}[q fp32]", paged,
                  "flash_decode.py:421", n_k2,
                  timed(f"paged_decode_kernel{tag}", "float32")),
            entry(f"paged_decode_kernel{tag}[q fp32, serve B=8 len=512]",
                  paged, "flash_decode.py:421", n_k2,
                  timed(f"paged_decode_kernel{tag}", "float32",
                        "B=8 H=12 D=64 lengths=8x512")),
            entry(k1, paged, "flash_decode.py:585", n_k1,
                  timed(k1, "float32", "B=2 H=12 T=256")),
            entry(f"{k1}[wave B=8 T=512]", paged, "flash_decode.py:585",
                  n_k1, timed(k1, "float32", "B=8"))]
    # K3: the bf16 pool's launches are the dense bf16 server's; the fp32,
    # int8 and int4 pools' are phase 10's fp32-compute dense engines', so
    # their times are taken under an fp32 query.
    kernels.append(entry("flash_decode_kernel<bf16>", dense,
                         "flash_decode.py:244",
                         sl["dense bf16"]["flash_decode/bf16"],
                         timed("flash_decode_kernel<bf16>", "bfloat16")))
    for mode in ("fp32", "int8", "int4"):
        kernels.append(entry(
            f"flash_decode_kernel<{mode}>", dense, "flash_decode.py:244",
            pools[f"dense {mode}"]["launches"][f"flash_decode/{mode}"],
            timed(f"flash_decode_kernel<{mode}>", "float32")))
    kernels += [
        entry("flash_fwd_mma_kernel", flash, "attention.py:180",
              tl["flash_attention_fwd"], train_cases["fwd"]),
        entry("flash_bwd_mma_kernel", flash, "attention.py:556",
              tl["flash_attention_bwd_fused"], train_cases["fused"]),
        entry("flash_bwd_dq_mma_kernel", flash, "attention.py:475",
              tl["flash_attention_bwd_dq"], train_cases["dq"]),
        entry("flash_bwd_mma_kernel<with_dq=false>", flash,
              "attention.py:556", tl["flash_attention_bwd_dkv"],
              train_cases["dkv"]),
        # The fp32 instances, with the launches of phase 8's fp32 path.
        entry("flash_fwd_f32_kernel", flash, "attention.py:180",
              parity_launches["flash_attention_fwd"],
              train_cases["fwd_fp32"]),
        entry("flash_bwd_kv_kernel<float>", flash, "attention.py:556",
              parity_launches["flash_attention_bwd_fused"],
              train_cases["fused_fp32"]),
        entry("flash_bwd_dq_f32_kernel", flash, "attention.py:475",
              parity_launches["flash_attention_bwd_dq"],
              train_cases["dq_fp32"]),
        entry("flash_bwd_kv_kernel<float, with_dq=false>", flash,
              "attention.py:556", parity_launches["flash_attention_bwd_dkv"],
              train_cases["dkv_fp32"])]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
