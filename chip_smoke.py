"""Drive the PyTorch/CUDA port on one GPU and check it end to end.

    python3 chip_smoke.py

Phases (each prints what it found; any failure exits non-zero):

  1. device   torch / CUDA versions, the card's name and power limit;
  2. build    the CUDA kernels from nanosandbox_tpu_torch/csrc (into
              build/), with nvcc's register and spill report;
  3. kernels  each kernel against its plain PyTorch version on the card
              at GPT-2 124M shapes (H 12, D 64, page 16, 512 blocks, 64
              table entries per row), fp32 within 1e-5 and bf16 within
              2e-2 (compared in f32), with its time, its bound and the
              time of F.scaled_dot_product_attention on pre-gathered
              contiguous K/V (a yardstick that excludes the gather);
              then the other template instances (head_dim 32 and 128,
              a bf16 query over an fp32 pool) and decode rows of length
              0 and -1 (zeros out), correctness only;
  4. engine   GPT-2 124M in fp32 (seeded random weights) through the
              paged engine: greedy tokens must equal a no-cache
              full-sequence recompute of the same model with the plain
              attention, TF32 off;
  5. server   GPT-2 124M in bf16 served by `python -m
              nanosandbox_tpu_torch.serve`'s code path on an ephemeral
              port: 6 /generate requests (one a prefix hit), /healthz,
              /stats;
  6. counts   kernel launches of phase 5 (the serving path, counts reset
              just before it); the plain versions make no CUDA call there.

The last line is {"ok": true, "device": {...}}; the line before it is a
JSON object with one entry per kernel. Needs one CUDA GPU; without one it
exits non-zero and prints no result.
"""

from __future__ import annotations

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
# GPTConfig overrides for the model of phases 4 and 5; empty = GPT-2 124M
# (the defaults). A CPU rehearsal of the phases sets a tiny model here.
MODEL: dict = {}


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


def check_kernels(fd) -> dict:
    import torch.nn.functional as F

    rng = np.random.default_rng(SEED)
    H, D, page, N, nb = 12, 64, 16, 512, 64
    cases = []
    decode_len = np.array([1024, 1, 517, 300, 16, 17, 1, 1], np.int32)
    dk, dv, dtbl = make_case(rng, 8, decode_len, sentinel_rows=(6, 7))
    dq = torch.from_numpy(rng.standard_normal((8, H, D),
                                              dtype=np.float32)).to(DEVICE)
    dlen = torch.from_numpy(decode_len).to(DEVICE)
    prefill = []
    for T in (128, 256):
        start = np.array([0, 64], np.int32)
        pk, pv, ptbl = make_case(rng, 2, start + T)
        pq = torch.from_numpy(rng.standard_normal((2, H, T, D),
                                                  dtype=np.float32)).to(DEVICE)
        prefill.append((T, start, pq, pk, pv, ptbl,
                        torch.from_numpy(start).to(DEVICE)))

    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        es = torch.tensor([], dtype=dtype).element_size()
        # K2: decode at the serving decode shape.
        q, k, v = dq.to(dtype), dk.to(dtype), dv.to(dtype)
        out = fd.flash_decode_paged(q, k, v, dtbl, dlen)
        ref = fd.torch_decode_attention_paged(q, k, v, dtbl, dlen)
        sync()
        err = float((out.float() - ref.float()).abs().max())
        if not err <= tol:
            fail(f"paged decode {dtype}: max |err| {err} > {tol}")
        tot = int(decode_len.sum())
        nbytes = 2 * tot * H * D * es + 2 * q.numel() * es
        flops = 4 * H * D * tot
        L = int(decode_len.max())
        gk, gv = gathered(k, dtbl, L), gathered(v, dtbl, L)
        mask = (torch.arange(L, device=DEVICE)[None, None, None, :]
                < dlen[:, None, None, None])
        cases.append(case(
            "paged_decode_kernel", dtype,
            f"B=8 H={H} D={D} lengths={decode_len.tolist()}", err, tol,
            lambda: fd.flash_decode_paged(q, k, v, dtbl, dlen),
            lambda: fd.torch_decode_attention_paged(q, k, v, dtbl, dlen),
            lambda: F.scaled_dot_product_attention(
                q[:, :, None], gk, gv, attn_mask=mask), nbytes, flops))
        # K1: prefill, row 0 cold (start 0), row 1 after a 64-token hit.
        for T, start, pq, pk, pv, ptbl, pstart in prefill:
            q, k, v = pq.to(dtype), pk.to(dtype), pv.to(dtype)
            out = fd.flash_prefill_paged(q, k, v, ptbl, pstart)
            ref = fd.torch_prefill_attention_paged(q, k, v, ptbl, pstart)
            sync()
            err = float((out.float() - ref.float()).abs().max())
            if not err <= tol:
                fail(f"paged prefill {dtype} T={T}: max |err| {err} > {tol}")
            nbytes = (2 * int((start + T).sum()) * H * D * es
                      + 2 * q.numel() * es)
            flops = int(sum(4 * H * D * (s * T + T * T / 2) for s in start))
            L = int((start + T).max())
            gk, gv = gathered(k, ptbl, L), gathered(v, ptbl, L)
            qpos = pstart[:, None] + torch.arange(T, device=DEVICE)[None]
            mask = (torch.arange(L, device=DEVICE)[None, None, None, :]
                    <= qpos[:, None, :, None])
            cases.append(case(
                "paged_prefill_kernel", dtype,
                f"B=2 H={H} T={T} D={D} start={start.tolist()}", err, tol,
                lambda: fd.flash_prefill_paged(q, k, v, ptbl, pstart),
                lambda: fd.torch_prefill_attention_paged(q, k, v, ptbl,
                                                         pstart),
                lambda: F.scaled_dot_product_attention(
                    q, gk, gv, attn_mask=mask), nbytes, flops))
    print("  kernel                dtype     shape"
          + " " * 40 + "max|err|   ms       bound_ms  %bound  plain_ms "
          "library_ms(excl. gather)")
    for c in cases:
        print(f"  {c['kernel']:<21} {c['dtype']:<9} {c['shape']:<44} "
              f"{c['max_abs_err']:.2e} {c['ms']:.5f}  {c['bound_ms']:.5f}  "
              f"{100 * c['bound_ms'] / c['ms']:5.1f}%  {c['plain_ms']:.5f}  "
              f"{c['library_ms']:.5f}  [{c['bound_by']}]")
    check_other_instances(fd, rng)
    return {"cases": cases}


def check_other_instances(fd, rng) -> None:
    """The kernels' other template instances, correctness only: head_dim
    32 and 128 in fp32 and bf16, and a bf16 query over an fp32 pool
    (--kv_dtype=fp32 under bf16 compute), which must attend in f32; and
    decode rows with lengths 0 and -1, which see no key and return 0."""
    errs = []
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        lengths = np.array([0, 130, -1], np.int32)
        k, v, tbl = make_case(rng, 3, np.maximum(lengths, 0), H=4, N=64,
                              nb=16)
        q = torch.from_numpy(rng.standard_normal((3, 4, 64),
                                                 dtype=np.float32))
        args = (q.to(DEVICE, dtype), k.to(dtype), v.to(dtype), tbl,
                torch.from_numpy(lengths).to(DEVICE))
        got = fd.flash_decode_paged(*args)
        ref = fd.torch_decode_attention_paged(*args)
        err = float((got.float() - ref.float()).abs().max())
        errs.append(f"decode lengths {lengths.tolist()} {str(dtype)[6:]} "
                    f"{err:.1e}")
        if not (err <= tol and bool(torch.isfinite(got).all())
                and not got[0].any() and not got[2].any()):
            fail(f"paged decode {dtype} with empty rows: max |err| {err}, "
                 f"finite {bool(torch.isfinite(got).all())}")
    for D, qdt, kvdt, tol in ((32, torch.float32, torch.float32, 1e-5),
                              (32, torch.bfloat16, torch.bfloat16, 2e-2),
                              (128, torch.float32, torch.float32, 1e-5),
                              (128, torch.bfloat16, torch.bfloat16, 2e-2),
                              (64, torch.bfloat16, torch.float32, 2e-2)):
        lengths = np.array([130, 1, 77], np.int32)
        k, v, tbl = make_case(rng, 3, lengths + 40, H=4, D=D, N=64, nb=16)
        k, v = k.to(kvdt), v.to(kvdt)
        n = torch.from_numpy(lengths).to(DEVICE)
        q1, qT = (torch.from_numpy(rng.standard_normal(
            shape, dtype=np.float32)).to(DEVICE, qdt)
            for shape in ((3, 4, D), (3, 4, 40, D)))
        for name, got, ref in (
                ("decode", fd.flash_decode_paged(q1, k, v, tbl, n),
                 fd.torch_decode_attention_paged(q1, k, v, tbl, n)),
                ("prefill", fd.flash_prefill_paged(qT, k, v, tbl, n),
                 fd.torch_prefill_attention_paged(qT, k, v, tbl, n))):
            err = float((got.float() - ref.float()).abs().max())
            errs.append(f"{name} D={D} q={str(qdt)[6:]} kv={str(kvdt)[6:]} "
                        f"{err:.1e}")
            if not err <= tol:
                fail(f"paged {name} D={D} q {qdt} kv {kvdt}: max |err| "
                     f"{err} > {tol}")
    print("  other instances, max |err| vs plain: " + "; ".join(errs))


# ---------------------------------------------------------------------------
# phase 4: the fp32 engine against a no-cache recompute
# ---------------------------------------------------------------------------

def check_engine_fp32(fd) -> dict:
    from nanosandbox_tpu_torch.config import GPTConfig
    from nanosandbox_tpu_torch.models.gpt import GPT
    from nanosandbox_tpu_torch.serve.engine import Engine

    cfg = GPTConfig(**MODEL, compute_dtype="float32")
    model = GPT(cfg, device=DEVICE,
                generator=torch.Generator(device=DEVICE).manual_seed(SEED))
    engine = Engine(model, num_slots=8, max_len=1024, device=DEVICE)
    rng = np.random.default_rng(SEED + 1)
    prompts = [[int(t) for t in rng.integers(0, prompt_vocab(cfg), n)]
               for n in (16, 77, 160, 300)]
    new = 32
    fd.reset_counts()
    t0 = time.monotonic()
    rids = [engine.submit(p, new) for p in prompts]
    done = {r.rid: r for r in engine.drain()}
    sync()
    wall = time.monotonic() - t0
    launches = dict(fd.launches)
    mismatches = 0
    with torch.no_grad():
        for rid, p in zip(rids, prompts):
            seq = list(p)
            for _ in range(new):
                logits = model(torch.tensor([seq], device=DEVICE))[0, -1]
                seq.append(int(torch.argmax(logits)))
            if done[rid].tokens != seq[len(p):]:
                mismatches += 1
                print(f"  prompt len {len(p)}: engine {done[rid].tokens} "
                      f"!= recompute {seq[len(p):]}")
    print(f"  fp32 engine: {len(prompts)} prompts (lengths "
          f"{[len(p) for p in prompts]}), {new} greedy tokens each, "
          f"{wall:.3f} s; launches {launches}; token mismatches vs "
          f"no-cache recompute: {mismatches}")
    if mismatches:
        fail("fp32 engine greedy tokens differ from the recompute")
    if min(launches.values()) == 0:
        fail(f"the fp32 engine bypassed a kernel: {launches}")
    del engine, model
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 5: the bf16 server
# ---------------------------------------------------------------------------

def post(base, body, timeout=300):
    req = urllib.request.Request(base + "/generate",
                                 data=json.dumps(body).encode())
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def check_server(fd, smi: str) -> dict:
    from nanosandbox_tpu_torch.checkpoint import save_for_serving
    from nanosandbox_tpu_torch.config import GPTConfig
    from nanosandbox_tpu_torch.models.gpt import GPT
    from nanosandbox_tpu_torch.serve.__main__ import build_server

    cfg = GPTConfig(**MODEL)                     # bf16 compute
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as out_dir:
        model = GPT(cfg, device=DEVICE, generator=torch.Generator(
            device=DEVICE).manual_seed(SEED))
        save_for_serving(out_dir, cfg, model.state_dict())
        del model
        # The serving path is the main path: counts start here.
        fd.reset_counts()
        server, loop, engine = build_server([
            f"--out_dir={out_dir}", "--host=127.0.0.1", "--port=0",
            "--num_slots=8", "--max_len=1024", "--kv_page_size=16",
            f"--device={DEVICE}"])
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
        launches = dict(fd.launches)
        plain = dict(fd.plain_cuda_calls)
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
    hits = stats["kv_pool"]["prefix_hit_requests"]
    if hits < 1:
        fail(f"no prefix hit: {stats['kv_pool']}")
    if min(launches.values()) == 0:
        fail(f"the serving path bypassed a kernel: {launches}")
    if any(plain.values()):
        fail(f"plain versions ran on the card in the serving path: {plain}")
    total = sum(len(a[1]["tokens"]) for a in answers)
    print(f"  bf16 server: 6/6 answered 200 with {new} in-vocab tokens, "
          f"/healthz ok, prefix hits {hits} "
          f"({stats['kv_pool']['prefix_hit_tokens']} tokens)")
    print(f"  [{smi}] decode {stats['decode_tokens_per_sec']:.1f} tok/s "
          f"(engine window), {total / wall:.1f} tok/s end to end over "
          f"{wall:.3f} s; TTFT p50 {stats['ttft_s']['p50'] * 1e3:.2f} ms; "
          f"TPOT p50 {stats['tpot_s']['p50'] * 1e3:.3f} ms; decode steps "
          f"{stats['decode_steps']}, prefill waves {stats['prefill_waves']}")
    return {"launches": launches, "plain_cuda_calls": plain,
            "stats": stats, "wall_s": wall, "tokens": total}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch; this script "
              "runs the port on a GPU only", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from nanosandbox_tpu_torch.ops import _build
    from nanosandbox_tpu_torch.ops import flash_decode as fd

    print("== phase 1: device")
    smi = nvidia_smi()
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    print(f"  nvidia-smi: {smi}")

    print("== phase 2: build")
    _build.library()
    info = _build.build_info
    with open(info["log"]) as f:
        ptx = f.read()
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", ptx)]
    spills = [int(s) for s in re.findall(r"(\d+) bytes spill stores", ptx)]
    print(f"  {info['path']} ({'built' if info['built'] else 'cached'}) "
          f"in {info['seconds']:.1f} s; ptxas: {len(regs)} kernels, "
          f"registers {min(regs, default=0)}-{max(regs, default=0)}, "
          f"max spill stores {max(spills, default=0)} bytes")

    print("== phase 3: kernels vs plain versions (124M shapes)")
    kern = check_kernels(fd)

    print("== phase 4: fp32 124M engine vs no-cache recompute")
    check_engine_fp32(fd)

    print("== phase 5: bf16 124M server")
    served = check_server(fd, smi)

    print("== phase 6: launch counts on the serving path")
    print(f"  kernels {served['launches']}; plain versions on CUDA "
          f"{served['plain_cuda_calls']}")

    def entry(name, wrapper, line, case):
        return {"name": name, "route": "cuda",
                "source": "nanosandbox_tpu_torch/csrc/paged_attention.cu",
                "replaces": f"nanosandbox_tpu/ops/flash_decode.py:{line}",
                "launches": served["launches"][wrapper],
                "max_abs_err": case["max_abs_err"], "ms": case["ms"],
                "plain_ms": case["plain_ms"], "bound_ms": case["bound_ms"],
                "bound_by": case["bound_by"],
                "library_ms": case["library_ms"],
                "case": f"{case['dtype']} {case['shape']}"}

    bf = [c for c in kern["cases"] if c["dtype"] == "bfloat16"]
    dec = next(c for c in bf if c["kernel"] == "paged_decode_kernel")
    pre = [c for c in bf if c["kernel"] == "paged_prefill_kernel"][-1]
    print(smi)
    print(json.dumps({"kernels": [
        entry("paged_decode_kernel", "flash_decode_paged", 421, dec),
        entry("paged_prefill_kernel", "flash_prefill_paged", 585, pre)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
