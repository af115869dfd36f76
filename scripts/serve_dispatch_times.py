"""The serving table of PERF.md section 5: the decode step of GPT-2 124M
in bf16 at 8 slots of 512-token prompts, in every pool mode (paged bf16,
dense bf16, paged int8, paged int4, dense int8) and every dispatch mode:

  eager sync   this tree's decode body run from Python every step,
               synchronously (the engine's private entry, graphs
               bypassed);
  sync         `python -m nanosandbox_tpu_torch.serve.profile
               --no_pipeline --scan_k=1` (one graph replay a step, read
               back before the next);
  pipelined    the profile at its defaults (one chunk in flight);
  scan_k 8     the profile at --scan_k=8;
  parent       with --parent=DIR, the profile of the checkout in DIR (an
               earlier commit, its own engine), in a process of its own,
               run before and after this tree's rows of the pool.

The profile's rows run its main() with those flags, the eager row its
measure_decode; every row's window writes the same positions. Then the
sampler's cost: the paged bf16 engine's 8-step graph with the plain and
with the filtering sampler (the top_k / top_p sort), replayed from the
same slot state and timed with CUDA events (sampler_cost). Writes every
result to --out (default build/serve_dispatch_times.json) and prints one
line a row: wall and device ms a decode step, idle share, kernels a
step, and the card's name and power limit.

    cd <a checkout of the repository>
    python3 scripts/serve_dispatch_times.py [--parent=DIR] [--out=PATH]

A parent checkout without a build/ directory shares this tree's (the
libraries are named by their sources' hash, so a changed kernel builds
anew).
"""
import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, ".")
from nanosandbox_tpu_torch.config import GPTConfig  # noqa: E402
from nanosandbox_tpu_torch.models.gpt import (  # noqa: E402
    GPT, cast_for_serving)
from nanosandbox_tpu_torch.ops import _build  # noqa: E402
from nanosandbox_tpu_torch.serve import profile as sp  # noqa: E402
from nanosandbox_tpu_torch.serve.engine import Engine  # noqa: E402

POOLS = (("paged bf16", []), ("dense bf16", ["--paged=off"]),
         ("paged int8", ["--kv_dtype=int8"]),
         ("paged int4", ["--kv_dtype=int4"]),
         ("dense int8", ["--paged=off", "--kv_dtype=int8"]))
MODES = (("sync", ["--no_pipeline", "--scan_k=1"]), ("pipelined", []),
         ("scan_k 8", ["--scan_k=8"]))
SAMPLER_REPS = 20    # replays of the 8-step graph a timed block


def bf16_model() -> GPT:
    return cast_for_serving(GPT(GPTConfig(), device="cuda",
                                generator=torch.Generator(
                                    device="cuda").manual_seed(sp.SEED)))


def eager_sync(flags: list) -> dict:
    """measure_decode on a synchronous scan_k=1 engine whose decode body
    runs from Python (no graph replay), as the profile builds it."""
    kv = next((f.split("=")[1] for f in flags if f.startswith("--kv_dtype")),
              None)
    engine = Engine(bf16_model(), num_slots=8, max_len=1024, kv_dtype=kv,
                    paged="--paged=off" not in flags, pipeline=False,
                    device="cuda")
    engine._replay = False
    engine.submit([0], 2)
    engine.drain()
    return sp.measure_decode(engine, np.random.default_rng(sp.SEED))


def parent_profile(parent: str, flags: list) -> dict:
    """The parent checkout's `python -m nanosandbox_tpu_torch.serve.profile
    <flags>` in its own process: its JSON object."""
    out = subprocess.run(
        [sys.executable, "-m", "nanosandbox_tpu_torch.serve.profile",
         *flags], cwd=parent, capture_output=True, text=True, timeout=600)
    if out.returncode:
        raise RuntimeError(f"parent profile {flags}: {out.stderr[-3000:]}")
    return json.loads(out.stdout[out.stdout.index("\n{") + 1:]
                      if not out.stdout.startswith("{") else out.stdout)


def sampler_cost() -> dict:
    """Device ms a decode step of the paged bf16 engine's 8-step graph,
    with the plain sampler and with the filtering one, every slot
    holding a 512-token greedy request: each block replays one graph
    SAMPLER_REPS times back to back from the same slot state (positions
    and tokens restored before it), in the order plain, filtered,
    filtered, plain; CUDA events around each block."""
    engine = Engine(bf16_model(), num_slots=8, max_len=1024, scan_k=8,
                    device="cuda")
    rng = np.random.default_rng(sp.SEED)
    for _ in range(engine.num_slots):
        engine.submit(rng.integers(0, 50257, sp.PROMPT_LEN).tolist(), 64)
    engine.step()                    # the prefill wave + one chunk
    torch.cuda.synchronize()
    pos, tok = engine._pos.clone(), engine._tok.clone()
    blocks: dict = {"plain": [], "filtered": []}
    for filtered in (False, True, True, False):
        graph = engine._graphs[(8, filtered)]
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "ab")
        for _ in range(2):           # the first block untimed
            engine._pos.copy_(pos)
            engine._tok.copy_(tok)
            start.record()
            for _ in range(SAMPLER_REPS):
                graph.replay()
            end.record()
            end.synchronize()
        blocks["filtered" if filtered else "plain"].append(
            start.elapsed_time(end) / (SAMPLER_REPS * 8))
    del engine
    plain, filt = (float(np.mean(blocks[k])) for k in ("plain", "filtered"))
    return {"plain_ms": plain, "filtered_ms": filt,
            "filtered_minus_plain_ms": filt - plain, "blocks_ms": blocks}


def main() -> None:
    ap = argparse.ArgumentParser(prog="scripts/serve_dispatch_times.py")
    ap.add_argument("--parent", default=None)
    ap.add_argument("--out", default="build/serve_dispatch_times.json")
    args = ap.parse_args()
    card = sp._card()
    _build.library()
    if args.parent and not os.path.exists(os.path.join(args.parent,
                                                       "build")):
        os.symlink(os.path.abspath(_build.BUILD_DIR),
                   os.path.join(args.parent, "build"))
    rows = {}
    for pool, flags in POOLS:
        if args.parent:
            rows[f"{pool} / parent"] = parent_profile(args.parent, flags)
        rows[f"{pool} / eager sync"] = eager_sync(flags)
        torch.cuda.empty_cache()
        for mode, extra in MODES:
            rows[f"{pool} / {mode}"] = sp.main(flags + extra)
            torch.cuda.empty_cache()
        if args.parent:
            rows[f"{pool} / parent, again"] = parent_profile(args.parent,
                                                             flags)
    sampler = sampler_cost()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card, "rows": rows, "sampler": sampler}, f,
                  indent=1)
    print(f"card: {card}")
    for name, r in rows.items():
        # The parent's profile names its first-step key and its median
        # synchronised step its own way.
        first = r.get("prefill_wave_plus_first_chunk_ms",
                      r.get("prefill_wave_plus_first_decode_ms"))
        synced = r.get("decode_step_ms_synchronised", r["decode_step_ms"])
        print(f"{name:<26} wall {r['decode_step_ms']:.3f} ms "
              f"(synchronised {synced:.3f}), device "
              f"{r['device_ms_per_step']:.3f} ms, idle "
              f"{r['device_idle_share']:.3f}, kernels "
              f"{r['kernels_per_step']:.1f}, wave+first {first:.2f} ms "
              f"[{card}]")
    print(f"sampler, device ms a decode step of the 8-step graph (paged "
          f"bf16, 8 slots): plain {sampler['plain_ms']:.4f}, filtering "
          f"{sampler['filtered_ms']:.4f}, difference "
          f"{sampler['filtered_minus_plain_ms']:.4f}; blocks "
          f"{sampler['blocks_ms']} [{card}]")


if __name__ == "__main__":
    main()
