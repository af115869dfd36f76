"""Times the non-causal fp32 flash forward (K4) and fused backward (K5,
given an lse cotangent) of the tree it runs in, at ring attention's block
(H 12, T 1024, D 64) for each batch of --batches (default 1, 2, 4, 8),
each checked against the plain version first at phase 7's fp32 limits
(chip_smoke.TRAIN_TOL), then timed by chip_smoke.time_ms (cold L2, median
of 25): ms and % of bound, with the grid, blocks an SM, waves, registers
and shared memory where the tree reports them; then each kernel of one
call, by torch.profiler's device time (warm L2, 10 calls).

    cd <a checkout of the repository> && python3 <path>/ring_f32_times.py

It imports chip_smoke and nanosandbox_tpu_torch from the working
directory, so the same script times two commits in turns.
"""
import re
import sys

import numpy as np
import torch

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402
from nanosandbox_tpu_torch.ops import attention as at  # noqa: E402

H, T, D = 12, 1024, 64
batches = [1, 2, 4, 8]
for arg in sys.argv[1:]:
    name, _, value = arg.partition("=")
    if name != "--batches":
        raise SystemExit(f"unknown argument {arg!r} (--batches=1,4)")
    batches = [int(b) for b in value.split(",")]
torch.backends.cuda.matmul.allow_tf32 = False
rng = np.random.default_rng(cs.SEED + 12)
sms = torch.cuda.get_device_properties(0).multi_processor_count
print(cs.nvidia_smi(), flush=True)
for B in batches:
    q, k, v, do = cs.qkv(rng, B, H, T, D, torch.float32)
    dlse = torch.from_numpy(0.1 * rng.standard_normal(
        (B, H, T), dtype=np.float32)).to("cuda")
    o, lse = at.flash_attention_fwd(q, k, v, causal=False)
    ro, rlse = at.torch_flash_attention(q, k, v, causal=False)
    got = at.flash_attention_bwd(q, k, v, o, lse, do, causal=False,
                                 dlse=dlse)
    ref = at.torch_flash_attention_bwd(q, k, v, o, lse, do, causal=False,
                                       dlse=dlse)
    tol = cs.TRAIN_TOL[torch.float32]
    errs = []
    for name, g, r, lim in (("o", o, ro, tol["o"]), ("lse", lse, rlse,
                                                     tol["o"]),
                            *((n, g, r, tol["g"]) for n, g, r in
                              zip(("dq", "dk", "dv"), got, ref))):
        e = cs.errors(g, r)
        errs.append(f"{name} {e['err']:.2e}")
        if not (e["err"] <= lim and e["err"] <= tol["rel"] * e["ref"]
                and e["norm"] <= tol["rel"]):
            raise SystemExit(f"B={B} {name}: {e} past the limits")
    print(f"B={B} max |err| against the plain version: " + ", ".join(errs))
    calls = {"fwd": lambda: at.flash_attention_fwd(q, k, v, causal=False),
             "fused": lambda: at.flash_attention_bwd(
                 q, k, v, o, lse, do, causal=False, dlse=dlse)}
    for kind, fn in calls.items():
        ms = cs.time_ms(fn)
        nbytes, flops = cs.train_bound(kind, B, H, T, D, 4, False, True)
        bound = 1e3 * max(nbytes / cs.HBM_BYTES_PER_S,
                          flops / cs.PEAK_FLOPS[torch.float32])
        shape = ""
        if hasattr(at, "ring_f32_launch_shape"):
            sh = at.ring_f32_launch_shape(kind, B * H, T, D)
            n = sh["grid"][0] * sh["grid"][1]
            waves = n / (sh["blocks_per_sm"] * sms)
            shape = (f", grid {n} x {sh['threads']}, "
                     f"{sh['blocks_per_sm']} an SM, {waves:.2f} waves, "
                     f"{sh['registers']} registers, {sh['smem']} B smem")
        print(f"B={B} {kind}: {ms:.5f} ms, bound {bound:.5f} "
              f"({100 * bound / ms:.1f}%){shape}", flush=True)
        from torch.profiler import ProfilerActivity, profile

        fn()
        cs.sync()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fn()
            cs.sync()
        us = {re.sub(r"\(anonymous namespace\)::", "",
                     e.key).split("(")[0]: e.self_device_time_total / 10
              for e in prof.key_averages() if e.self_device_time_total > 0}
        print("  a call's kernels (us, warm L2): " + ", ".join(
            f"{n} {t:.2f}" for n, t in sorted(us.items(),
                                              key=lambda kv: -kv[1])),
              flush=True)
