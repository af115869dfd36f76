"""Times the non-causal fp32 flash forward (K4), fused backward (K5) and
split backward (K6, K7; the backwards given an lse cotangent) of the tree
it runs in, at ring attention's block (H 12, T 1024, D 64) for each batch
of --batches (default 1, 2, 4, 8), each checked against the plain version
first at phase 7's fp32 limits (chip_smoke.TRAIN_TOL; the split backward
also equal bits on two calls), then timed by chip_smoke.time_ms (cold L2,
median of 25), and warm (10 calls back to back, CUDA events): ms and %
of bound, with the grid, blocks an SM, waves, registers and shared memory
where the tree reports them; then each kernel of one call, by
torch.profiler's device time (warm L2, 10 calls).

    cd <a checkout of the repository> && python3 <path>/ring_f32_times.py \\
        [--batches=1,4] [--kinds=dq,dkv] [--tile=32|64]

--tile builds the kernels with -DNSB_RING_TILE=<tile>, so that K5 and K7
take that key block and K6 that query block at every batch (a tree
without the macro ignores it).
It imports chip_smoke and nanosandbox_tpu_torch from the working
directory, so the same script times two commits in turns.
"""
import re
import sys

import numpy as np
import torch

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402
from nanosandbox_tpu_torch.ops import _build  # noqa: E402
from nanosandbox_tpu_torch.ops import attention as at  # noqa: E402

H, T, D = 12, 1024, 64
KINDS = ("fwd", "fused", "dq", "dkv")
batches, kinds = [1, 2, 4, 8], KINDS
for arg in sys.argv[1:]:
    name, _, value = arg.partition("=")
    if name == "--batches":
        batches = [int(b) for b in value.split(",")]
    elif name == "--kinds" and set(value.split(",")) <= set(KINDS):
        kinds = tuple(value.split(","))
    elif name == "--tile" and value in ("32", "64"):
        _build.NVCC_FLAGS = _build.NVCC_FLAGS + (f"-DNSB_RING_TILE={value}",)
    else:
        raise SystemExit(f"unknown argument {arg!r} (--batches=1,4, "
                         "--kinds=fwd,fused,dq,dkv, --tile=32|64)")
torch.backends.cuda.matmul.allow_tf32 = False
rng = np.random.default_rng(cs.SEED + 12)
sms = torch.cuda.get_device_properties(0).multi_processor_count
print(cs.nvidia_smi(), flush=True)
tol = cs.TRAIN_TOL[torch.float32]


def check(B, name, got, ref, lim):
    e = cs.errors(got, ref)
    if not (e["err"] <= lim and e["err"] <= tol["rel"] * e["ref"]
            and e["norm"] <= tol["rel"]):
        raise SystemExit(f"B={B} {name}: {e} past the limits")
    return f"{name} {e['err']:.2e}"


def warm_ms(fn, calls=10):
    """Device time of one of ``calls`` calls back to back (warm L2), by
    CUDA events, the stream kept busy while the host enqueues."""
    fn()
    cs.sync()
    torch.cuda._sleep(20_000_000)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(calls):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / calls


def launch_shape(kind, BH):
    """The kernel's launch shape, where this tree reports it for the
    kind (an older one may report none, or not for every kind)."""
    try:
        sh = at.ring_f32_launch_shape(kind, BH, T, D)
    except (AttributeError, RuntimeError):
        return ""
    n = sh["grid"][0] * sh["grid"][1]
    return (f", grid {n} x {sh['threads']}, {sh['blocks_per_sm']} an SM, "
            f"{n / (sh['blocks_per_sm'] * sms):.2f} waves, "
            f"{sh['registers']} registers, {sh['smem']} B smem")


for B in batches:
    q, k, v, do = cs.qkv(rng, B, H, T, D, torch.float32)
    dlse = torch.from_numpy(0.1 * rng.standard_normal(
        (B, H, T), dtype=np.float32)).to("cuda")
    bkw = dict(causal=False, dlse=dlse)
    o, lse = at.flash_attention_fwd(q, k, v, causal=False)
    ro, rlse = at.torch_flash_attention(q, k, v, causal=False)
    ref = at.torch_flash_attention_bwd(q, k, v, o, lse, do, **bkw)
    calls = {"fwd": lambda: at.flash_attention_fwd(q, k, v, causal=False),
             "fused": lambda: at.flash_attention_bwd(q, k, v, o, lse, do,
                                                     **bkw),
             "dq": lambda: at.flash_attention_bwd_dq(q, k, v, o, lse, do,
                                                     **bkw),
             "dkv": lambda: at.flash_attention_bwd_dkv(q, k, v, o, lse, do,
                                                       **bkw)}
    errs = [check(B, "o", o, ro, tol["o"]), check(B, "lse", lse, rlse,
                                                  tol["o"])]
    got = {kind: calls[kind]() for kind in ("fused", "dq", "dkv")}
    for kind, names, outs, refs in (
            ("fused", ("dq", "dk", "dv"), got["fused"], ref),
            ("dq", ("dq",), (got["dq"],), ref[:1]),
            ("dkv", ("dk", "dv"), got["dkv"], ref[1:])):
        errs += [check(B, f"{kind} {n}", g, r, tol["g"])
                 for n, g, r in zip(names, outs, refs)]
    again = (calls["dq"](), *calls["dkv"]())
    if not all(torch.equal(a, b) for a, b in
               zip((got["dq"], *got["dkv"]), again)):
        raise SystemExit(f"B={B}: the split backward differs between two "
                         "calls")
    print(f"B={B} max |err| against the plain version: " + ", ".join(errs))
    for kind in kinds:
        fn = calls[kind]
        ms, warm = cs.time_ms(fn), warm_ms(fn)
        nbytes, flops = cs.train_bound(kind, B, H, T, D, 4, False, True)
        bound = 1e3 * max(nbytes / cs.HBM_BYTES_PER_S,
                          flops / cs.PEAK_FLOPS[torch.float32])
        print(f"B={B} {kind}: {ms:.5f} ms, bound {bound:.5f} "
              f"({100 * bound / ms:.1f}%), warm {warm:.5f} ms"
              f"{launch_shape(kind, B * H)}", flush=True)
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
