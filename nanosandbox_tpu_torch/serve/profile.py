"""Where a serving step's time goes, on the GPU.

    python -m nanosandbox_tpu_torch.serve.profile [--num_slots=8]
        [--paged=on|off] [--kv_dtype=fp32|bf16|int8|int4]
        [--scan_k=K] [--no_pipeline]

Builds GPT-2 124M (seeded random weights, bf16) behind the Engine (the
paged pool by default, or the dense one; the pool in --kv_dtype, default
the compute dtype; the engine's dispatch modes as the serve CLI sets
them), runs one untimed one-token request (CUDA library setup), then
measures the decode step (measure_decode): three passes, each filling
every slot with the same PROMPT_LEN-token greedy requests (one prefill
wave), running LEAD decode steps and then a window of WINDOW decode
steps, timed unprofiled, then as single synchronised engine steps, then
under torch.profiler; the windows write the same positions in every
pass and for every --scan_k that divides LEAD and WINDOW. Last, a second
wave of fresh prompts under the profiler. An engine step dispatches one
decode chunk of k steps (one CUDA graph replay), so every decode figure
is per decode step, a token for each row: a window's wall or device
time over its WINDOW steps. Prints one JSON object: the card
(nvidia-smi name and power limit), the prefill wave's wall time, the
decode wall per step (host clock around the unprofiled window,
synchronised at its ends, and the median of single steps each
synchronised), the device time per step by kernel (from the traced
window), the device's idle share of the unprofiled window, and the
traced wave's device time by kernel beside its (profiled) wall time.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch


PROMPT_LEN = 512
LEAD = 8             # decode steps before a window
WINDOW = 80          # decode steps a window
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


def _device_ms_by_name(prof) -> dict:
    """{kernel name: device ms} of a torch.profiler run."""
    out: dict = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or 0
        if us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            out[e.key] = out.get(e.key, 0.0) + us / 1e3
    return out


def measure_decode(engine, rng, prompt_len: int = PROMPT_LEN) -> dict:
    """Three passes over an idle ``engine``, each filling every slot with
    the same prompt_len-token greedy requests, running LEAD decode steps,
    measuring a window of WINDOW decode steps and draining: the window
    timed unprofiled, then in single engine steps each synchronised,
    then traced. The windows cover the same positions in every pass and
    for every scan_k that divides LEAD and WINDOW, so the traced device
    time and the timed wall describe the same work. Per decode step (a
    token for each row): the timed wall, the median single step, the
    traced wall and device time by kernel, the device's idle share and
    the kernels launched."""
    from torch.profiler import ProfilerActivity, profile

    k = engine.scan_k
    lead, window = -(-LEAD // k) * k, -(-WINDOW // k) * k
    # Every row's budget outlasts the window, so the chunk policy
    # dispatches scan_k steps throughout.
    new = lead + window + 2 * k + 1
    prompts = [rng.integers(0, 50257, prompt_len).tolist()
               for _ in range(engine.num_slots)]

    def steps(n: int) -> tuple:
        """(wall s, engine steps) of the engine steps that dispatch n
        decode steps, synchronised at the ends only, so that a
        pipelined chunk overlaps the host."""
        torch.cuda.synchronize()
        s0, t0, m = engine.chunk_steps, time.perf_counter(), 0
        while engine.chunk_steps - s0 < n:
            engine.step()
            m += 1
        torch.cuda.synchronize()
        if engine.chunk_steps - s0 != n:
            raise RuntimeError(f"dispatched {engine.chunk_steps - s0} "
                               f"decode steps, not {n}")
        return time.perf_counter() - t0, m

    def run_pass(measure):
        for p in prompts:
            engine.submit(p, new)
        first = steps(k)[0]          # the prefill wave + one chunk
        steps(lead - k)
        got = measure()
        engine.drain()
        return first, got

    def traced_window():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            traced_wall = steps(window)[0]
        return prof, traced_wall

    first, (wall, n_dispatch) = run_pass(lambda: steps(window))
    _, singles = run_pass(lambda: [steps(k)[0] / k
                                   for _ in range(window // k)])
    _, (prof, traced_wall) = run_pass(traced_window)
    by_name = _device_ms_by_name(prof)
    step_ms = 1e3 * wall / window
    dev_ms = sum(by_name.values()) / window
    by_kind: dict = {}
    for name, ms in by_name.items():
        by_kind[_kind(name)] = by_kind.get(_kind(name), 0.0) + ms / window
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    start = prompt_len + lead       # the window's first write
    return {
        "prefill_wave_plus_first_chunk_ms": 1e3 * first,
        "window_positions": [start, start + window],
        "decode_step_ms": step_ms,
        # Each engine step synchronised on its own: no overlap across
        # steps, a chunk's wall over its length.
        "decode_step_ms_synchronised": 1e3 * float(np.median(singles)),
        "decode_step_ms_under_profiler": 1e3 * traced_wall / window,
        "decode_steps_per_dispatch": window / n_dispatch,
        "device_ms_per_step": dev_ms if by_name else "not measured",
        # Kernel time under the profiler against the unprofiled window
        # at the same positions: the profiler slows the host, not the
        # kernels.
        "device_idle_share": (1 - dev_ms / step_ms) if by_name
        else "not measured",
        "device_ms_per_step_by_kind": by_kind,
        "top_kernels_ms_per_step": {k[:90]: ms / window for k, ms in top},
        "kernels_per_step": sum(
            e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA) / window,
    }


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
    ap.add_argument("--scan_k", type=int, default=1)
    ap.add_argument("--no_pipeline", action="store_true")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device.type != "cuda":
        raise SystemExit("the profile measures the GPU: run it on one")

    cfg = GPTConfig()
    model = cast_for_serving(GPT(cfg, device=device, generator=torch.Generator(
        device=device).manual_seed(SEED)))
    engine = Engine(model, num_slots=args.num_slots, max_len=cfg.block_size,
                    kv_dtype=args.kv_dtype, paged=args.paged == "on",
                    pipeline=not args.no_pipeline, scan_k=args.scan_k,
                    device=device)
    engine.submit([0], 2)            # first-call library setup, untimed
    engine.drain()
    rng = np.random.default_rng(SEED)
    decode = measure_decode(engine, rng)
    for _ in range(args.num_slots):  # fresh prompts: no prefix hit
        engine.submit(rng.integers(0, 50257, PROMPT_LEN).tolist(), 2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as wave_prof:
        t0 = time.perf_counter()
        engine.step()
        torch.cuda.synchronize()
        wave_wall = time.perf_counter() - t0
    engine.drain()
    wave_by_kind: dict = {}
    for name, ms in _device_ms_by_name(wave_prof).items():
        wave_by_kind[_kind(name)] = wave_by_kind.get(_kind(name), 0.0) + ms
    out = {
        "card": _card(),
        "config": f"GPT-2 124M bf16, {args.num_slots} slots, prompt "
                  f"{PROMPT_LEN}, "
                  + (f"paged page {engine.kv_page_size}" if engine.paged
                     else "dense pool")
                  + f", kv {engine.kv_dtype}, pipeline "
                  + ("on" if engine.pipeline else "off")
                  + f", scan_k {engine.scan_k}",
        **decode,
        # The second wave + first chunk under the profiler (its wall is
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
