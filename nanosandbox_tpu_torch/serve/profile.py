"""Where a serving step's time goes, on the GPU.

    python -m nanosandbox_tpu_torch.serve.profile [--num_slots=8]
        [--paged=on|off] [--kv_dtype=fp32|bf16|int8|int4]

Builds GPT-2 124M (seeded random weights, bf16) behind the Engine (the
paged pool by default, or the dense one; the pool in --kv_dtype, default
the compute dtype), runs one untimed one-token request (CUDA library
setup), fills
every slot with a PROMPT_LEN-token greedy request (one prefill wave),
then traces STEPS batched decode steps with torch.profiler, and last a
second wave of fresh prompts. Prints one JSON object: the card
(nvidia-smi name and power limit), the prefill wave's wall time, the
decode step's wall time (host clock around a synchronised step, median
of 10 unprofiled steps), the device time per step by kernel (from the
trace), the device's idle share of the unprofiled step, and the traced
wave's device time by kernel beside its (profiled) wall time.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch


PROMPT_LEN = 512
STEPS = 20
SEED = 1234


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30, check=True).stdout.strip().splitlines()[0]


def _kind(name: str) -> str:
    for kernel in ("paged_decode_kernel", "paged_prefill_mma_kernel",
                   "paged_prefill_f32_kernel", "flash_decode_kernel",
                   "flash_fwd_mma_kernel", "flash_fwd_f32_kernel"):
        if kernel in name:
            return kernel
    low = name.lower()
    if any(w in low for w in ("gemm", "gemv", "cutlass", "sm90", "nvjet")):
        return "matmul"
    if "sort" in low or "scan" in low or "radix" in low:
        return "sort/scan"
    return "other"


def main(argv: list[str] | None = None) -> dict:
    from torch.profiler import ProfilerActivity, profile

    from nanosandbox_tpu_torch.config import GPTConfig, resolve_device
    from nanosandbox_tpu_torch.models.gpt import GPT, cast_for_serving
    from nanosandbox_tpu_torch.serve.engine import Engine

    ap = argparse.ArgumentParser(
        prog="python -m nanosandbox_tpu_torch.serve.profile")
    ap.add_argument("--num_slots", type=int, default=8)
    ap.add_argument("--device", default="auto")
    ap.add_argument("--paged", default="on", choices=("on", "off"))
    ap.add_argument("--kv_dtype", default=None,
                    choices=("fp32", "bf16", "int8", "int4"))
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device.type != "cuda":
        raise SystemExit("the profile measures the GPU: run it on one")

    cfg = GPTConfig()
    model = cast_for_serving(GPT(cfg, device=device, generator=torch.Generator(
        device=device).manual_seed(SEED)))
    engine = Engine(model, num_slots=args.num_slots, max_len=cfg.block_size,
                    kv_dtype=args.kv_dtype, paged=args.paged == "on",
                    device=device)
    engine.submit([0], 2)            # first-call library setup, untimed
    engine.drain()
    rng = np.random.default_rng(SEED)
    new = STEPS + 16
    for _ in range(args.num_slots):
        engine.submit(rng.integers(0, 50257, PROMPT_LEN).tolist(), new)

    def timed_step() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.step()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    first = timed_step()             # the prefill wave + one decode step
    decode_only = [timed_step() for _ in range(10)]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        walls = [timed_step() for _ in range(STEPS)]
    engine.drain()
    for _ in range(args.num_slots):  # fresh prompts: no prefix hit
        engine.submit(rng.integers(0, 50257, PROMPT_LEN).tolist(), 2)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as wave_prof:
        wave_wall = timed_step()
    engine.drain()
    wave_by_kind: dict = {}
    for e in wave_prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or 0
        if us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            wave_by_kind[_kind(e.key)] = (wave_by_kind.get(_kind(e.key), 0.0)
                                          + us / 1e3)

    by_name: dict = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or 0
        if us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.key] = by_name.get(e.key, 0.0) + us
    n = STEPS
    wall_ms = 1e3 * float(np.mean(walls))
    step_ms = 1e3 * float(np.median(decode_only))
    dev_ms = sum(by_name.values()) / 1e3 / n
    by_kind: dict = {}
    for name, us in by_name.items():
        by_kind[_kind(name)] = by_kind.get(_kind(name), 0.0) + us / 1e3 / n
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    out = {
        "card": _card(),
        "config": f"GPT-2 124M bf16, {args.num_slots} slots, prompt "
                  f"{PROMPT_LEN}, "
                  + (f"paged page {engine.kv_page_size}" if engine.paged
                     else "dense pool")
                  + f", kv {engine.kv_dtype}",
        "prefill_wave_plus_first_decode_ms": 1e3 * first,
        "decode_step_ms": step_ms,
        "decode_step_ms_under_profiler": wall_ms,
        "device_ms_per_step": dev_ms if by_name else "not measured",
        # Kernel time under the profiler against the unprofiled step:
        # the profiler slows the host, not the kernels.
        "device_idle_share": (1 - dev_ms / step_ms) if by_name
        else "not measured",
        "device_ms_per_step_by_kind": by_kind,
        "top_kernels_ms_per_step": {k[:90]: us / 1e3 / n for k, us in top},
        "kernels_per_step": sum(
            e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA) / n,
        # The second wave + first decode under the profiler (its wall is
        # slowed by the profiler on the host; the device times are not).
        "traced_wave_wall_ms": 1e3 * wave_wall,
        "traced_wave_device_ms": (sum(wave_by_kind.values())
                                  if wave_by_kind else "not measured"),
        "traced_wave_device_ms_by_kind": wave_by_kind,
    }
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
