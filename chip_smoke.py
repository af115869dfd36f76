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
              multiple), correctness only; then each kernel's time on
              the bf16 inputs just checked, beside its bound, its plain
              version and F.scaled_dot_product_attention (is_causal;
              forward, and forward+backward minus forward);
  8. train parity  GPT-2 124M in fp32 (TF32 off) on a 2 x 1024 batch,
              without dropout and with dropout 0.1 (masks from alike-
              seeded generators): loss and every parameter gradient with
              the kernels against the same model with the plain attention
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
              plain attention (loss trajectory printed, not checked).

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
                logits = model(torch.tensor([seq], device=DEVICE),
                               plain_attention=True)[0, -1]
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


def check_attention(at, name, q, k, v, do, rate=0.0, seed=None) -> dict:
    """K4, K5 and K6 + K7 on one case against the plain versions on the
    same inputs (the backward's: the kernel forward's o and lse). Returns
    the errors of each output; fails past TRAIN_TOL."""
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
        if not (e["err"] <= lim and e["err"] <= tol["rel"] * e["ref"]
                and e["norm"] <= tol["rel"]):
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
    import torch.nn.functional as F

    rng = np.random.default_rng(SEED + 3)
    B, H, T, D = 16, 12, 1024, 64
    shape = f"B={B} H={H} T={T} D={D}"
    # The 124M training shape in bf16: the inputs the times below use.
    timed = qkv(rng, B, H, T, D, torch.bfloat16)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        rows.append(check_attention(
            at, shape, *(timed if dtype == torch.bfloat16
                         else qkv(rng, B, H, T, D, dtype))))
        rows.append(check_attention(at, f"B=2 H={H} T={T} D={D}",
                                    *qkv(rng, 2, H, T, D, dtype), rate=0.1,
                                    seed=SEED))
        for d in (32, 128):
            rows.append(check_attention(at, f"B=2 H=4 T=256 D={d}",
                                        *qkv(rng, 2, 4, 256, d, dtype)))
        rows.append(check_attention(at, f"B=2 H=4 T=200 D={D}",
                                    *qkv(rng, 2, 4, 200, D, dtype), rate=0.1,
                                    seed=[7, 0, 0, 3, 5]))
    print("  each output: max |err| of max |ref| (||err|| / ||ref||)")
    for r in rows:
        print(f"  {r['case']}:\n    " + ", ".join(
            f"{k} {e['err']:.1e} of {e['ref']:.1e} ({e['norm']:.1e})"
            for k, e in r.items() if k != "case"))

    # Times at the 124M training shape, bf16, on the inputs checked above.
    dtype = torch.bfloat16
    q, k, v, do = timed
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
    cases = {}
    for kind, fn, plain, library in (
            ("fwd", lambda: at.flash_attention_fwd(q, k, v),
             lambda: at.torch_flash_attention(q, k, v), sdpa_fwd),
            ("fused", lambda: at.flash_attention_bwd(q, k, v, o, lse, do),
             None, sdpa_bwd),
            ("dq", lambda: at.flash_attention_bwd_dq(q, k, v, o, lse, do),
             None, None),
            ("dkv", lambda: at.flash_attention_bwd_dkv(q, k, v, o, lse, do),
             None, None)):
        nbytes, flops = train_bound(kind, B, H, T, D, 2)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
        with torch.no_grad():
            plain_ms = time_ms(plain) if plain is not None else plain_bwd
        cases[kind] = dict(
            ms=time_ms(fn), plain_ms=plain_ms, library_ms=library,
            bytes=nbytes, flops=flops, bound_ms=1e3 * max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            shape=f"{shape} bf16")
    print(f"  times at B={B} H={H} T={T} D={D} bf16: kernel  ms        "
          f"bound_ms  %bound  plain_ms  library_ms")
    for kind, c in cases.items():
        lib = ("-" if c["library_ms"] is None
               else f"{c['library_ms']:.5f}")
        print(f"  {kind:<5} {c['ms']:.5f}  {c['bound_ms']:.5f}  "
              f"{100 * c['bound_ms'] / c['ms']:5.1f}%  {c['plain_ms']:.5f}  "
              f"{lib}  [{c['bound_by']}]")
    split = cases["dq"]["ms"] + cases["dkv"]["ms"]
    print(f"  backward: fused {cases['fused']['ms']:.5f} ms, split (K6 + K7) "
          f"{split:.5f} ms, SDPA {sdpa_bwd:.5f} ms")
    # The max |err| reported beside each time: that of the timed inputs.
    bf = next(r for r in rows if r["case"] == f"{shape} bfloat16")
    outputs = {"fwd": ("o", "lse"), "fused": ("fused_dq", "fused_dk",
                                              "fused_dv"),
               "dq": ("split_dq",), "dkv": ("split_dk", "split_dv")}
    for kind in cases:
        cases[kind]["max_abs_err"] = max(bf[n]["err"] for n in outputs[kind])
    return cases


# ---------------------------------------------------------------------------
# phase 8: the fp32 124M loss and gradients, kernels against plain
# ---------------------------------------------------------------------------

def check_train_parity(at) -> None:
    """Without dropout, and with dropout 0.1: both passes draw their
    per-layer attention seeds and residual masks from generators seeded
    alike, so they drop the same elements and must agree as closely."""
    from nanosandbox_tpu_torch.config import GPTConfig
    from nanosandbox_tpu_torch.models.gpt import GPT, cross_entropy_loss

    rng = np.random.default_rng(SEED + 4)
    for dropout in (0.0, 0.1):
        cfg = GPTConfig(**MODEL, compute_dtype="float32", dropout=dropout)
        model = GPT(cfg, device=DEVICE, generator=torch.Generator(
            device=DEVICE).manual_seed(SEED))
        x, y = (torch.from_numpy(rng.integers(0, prompt_vocab(cfg),
                                              (2, cfg.block_size)))
                .to(DEVICE) for _ in range(2))
        params = [p for _, p in model.named_parameters()]
        out = {}
        for plain in (False, True):
            gen = (torch.Generator(device=DEVICE).manual_seed(SEED + 5)
                   if dropout else None)
            at.reset_counts()
            loss = cross_entropy_loss(model(x, plain_attention=plain,
                                            dropout_generator=gen), y)
            grads = torch.autograd.grad(loss, params)
            sync()
            out[plain] = (float(loss.detach()), grads, dict(at.launches),
                          dict(at.plain_cuda_calls))
        (lk, gk, launches, _), (lp, gp, _, plain_calls) = out[False], out[True]
        rel = abs(lk - lp) / abs(lp)
        worst = max((float((a - b).abs().max())
                     / max(float(b.abs().max()), 1e-30), n)
                    for (n, _), a, b in zip(model.named_parameters(), gk, gp))
        name = f"fp32 124M, 2 x {cfg.block_size}, dropout {dropout}"
        print(f"  {name}: loss kernels {lk:.7f} plain {lp:.7f} (rel "
              f"{rel:.1e}); worst gradient max|diff|/max|ref| {worst[0]:.1e} "
              f"({worst[1]}); kernel launches {launches}, plain CUDA calls "
              f"{plain_calls}")
        if not rel <= 1e-5:
            fail(f"{name}: loss kernels {lk} vs plain {lp}: rel {rel} > 1e-5")
        if not worst[0] <= 1e-3:
            fail(f"{name}: gradient {worst[1]}: max|diff| / max|ref| "
                 f"{worst[0]} > 1e-3")
        if launches["flash_attention_fwd"] < cfg.n_layer or \
                launches["flash_attention_bwd_fused"] < cfg.n_layer:
            fail(f"{name}: the kernel pass bypassed a kernel: {launches}")
        if not plain_calls["torch_flash_attention"]:
            fail(f"{name}: the plain pass did not run the plain attention: "
                 f"{plain_calls}")
        del model, gk, gp
        torch.cuda.empty_cache()


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
    if "flash_fwd_kernel" in name:
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


def check_trainer(at, fd, smi: str) -> dict:
    import os

    from nanosandbox_tpu_torch import train
    from nanosandbox_tpu_torch.config import load_config

    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
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
            resumed = train.main(
                [f for f in flags if not f.startswith("--max_iters=")]
                + ["--max_iters=35", "--init_from=resume"])
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
        print(f"  [{smi}] step {ms:.2f} ms (median of the logged windows "
              f"after iter 0), {toks:,.0f} tok/s, MFU {100 * mfu:.2f}%")
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
        control = control_losses(train, at, flags, tmp)
        print("  control, the first run's 30 steps with the plain attention "
              "(after the counts; printed, not checked): losses "
              f"{ {i: round(v, 4) for i, v in control.items()} }")
    torch.cuda.empty_cache()
    return {"launches": launches, "plain_cuda_calls": plain, "step_ms": ms,
            "tok_s": toks, "mfu": mfu, "profile": prof}


def control_losses(train, at, flags, tmp) -> dict:
    """The trainer's first run again with the plain attention in place of
    the kernels: a control for the loss trajectory. The two runs round
    differently in bf16 and part ways, so it is printed, not checked."""
    from nanosandbox_tpu_torch.models import gpt

    kernels = gpt.causal_attention

    def plain(q, k, v, *, dropout_rate, seed):
        return at.torch_flash_attention(q, k, v, dropout_rate=dropout_rate,
                                        seed=seed)[0]

    gpt.causal_attention = plain
    try:
        out = train.main([f"--out_dir={tmp}/control"
                          if f.startswith("--out_dir=") else f
                          for f in flags])
    finally:
        gpt.causal_attention = kernels
    return {r["iter"]: r["loss"] for r in out["log"]}


def main() -> int:
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

    print("== phase 2: build")
    _build.library()
    info = _build.build_info
    print(f"  {len(info['libs'])} libraries in {info['seconds']:.1f} s "
          "(one nvcc per source, in parallel)")
    for lib in info["libs"]:
        with open(lib["log"]) as f:
            ptx = f.read()
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", ptx)]
        spills = [int(s) for s in re.findall(r"(\d+) bytes spill stores",
                                             ptx)]
        print(f"  {lib['source']} -> {lib['path']} "
              f"({'built' if lib['built'] else 'cached'}); ptxas: "
              f"{len(regs)} kernels, registers {min(regs, default=0)}-"
              f"{max(regs, default=0)}, max spill stores "
              f"{max(spills, default=0)} bytes")

    print("== phase 3: kernels vs plain versions (124M shapes)")
    kern = check_kernels(fd)

    print("== phase 4: fp32 124M engine vs no-cache recompute")
    check_engine_fp32(fd)

    print("== phase 5: bf16 124M server")
    served = check_server(fd, smi)

    print("== phase 6: launch counts on the serving path")
    print(f"  kernels {served['launches']}; plain versions on CUDA "
          f"{served['plain_cuda_calls']}")

    print("== phase 7: training kernels vs plain versions")
    train_cases = check_train_kernels(at)

    print("== phase 8: fp32 124M loss and gradients, kernels vs plain")
    check_train_parity(at)

    print("== phase 9: the 124M bf16 trainer")
    trained = check_trainer(at, fd, smi)

    def entry(name, source, replaces, launches, case):
        return {"name": name, "route": "cuda",
                "source": f"nanosandbox_tpu_torch/csrc/{source}",
                "replaces": f"nanosandbox_tpu/ops/{replaces}",
                "launches": launches,
                "max_abs_err": case["max_abs_err"], "ms": case["ms"],
                "plain_ms": case["plain_ms"], "bound_ms": case["bound_ms"],
                "bound_by": case["bound_by"],
                "library_ms": case["library_ms"],
                "case": f"{case.get('dtype', 'bfloat16')} {case['shape']}"}

    bf = [c for c in kern["cases"] if c["dtype"] == "bfloat16"]
    dec = next(c for c in bf if c["kernel"] == "paged_decode_kernel")
    pre = [c for c in bf if c["kernel"] == "paged_prefill_kernel"][-1]
    paged, flash = "paged_attention.cu", "flash_attention.cu"
    tl = trained["launches"]
    print(smi)
    print(json.dumps({"kernels": [
        entry("paged_decode_kernel", paged, "flash_decode.py:421",
              served["launches"]["flash_decode_paged"], dec),
        entry("paged_prefill_kernel", paged, "flash_decode.py:585",
              served["launches"]["flash_prefill_paged"], pre),
        entry("flash_fwd_kernel", flash, "attention.py:180",
              tl["flash_attention_fwd"], train_cases["fwd"]),
        entry("flash_bwd_kv_kernel<with_dq>", flash, "attention.py:556",
              tl["flash_attention_bwd_fused"], train_cases["fused"]),
        entry("flash_bwd_dq_kernel", flash, "attention.py:475",
              tl["flash_attention_bwd_dq"], train_cases["dq"]),
        entry("flash_bwd_kv_kernel", flash, "attention.py:556",
              tl["flash_attention_bwd_dkv"], train_cases["dkv"])]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
