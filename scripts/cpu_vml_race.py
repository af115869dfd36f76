"""The CPU race behind a flaky plain-attention test: MKL VML's first call.

torch computes exp, log and erf of float CPU tensors through MKL's
vector math library (VML), which picks its code path once a process, at
its first call. This script starts many fresh processes at once (the
load under which the race shows); each takes the first exp of its life
over the plain attention's scores (B 2, H 2, T 128, D 32, causal, two
intra-op threads, so each thread takes one batch row) and holds every
thread's share against float64. A share that is off is saved and then
compared, bit for bit, with ``vmsExp`` in VML's enhanced-performance
mode (``VML_EP``) on the AVX2 code path, in a process started with
``MKL_ENABLE_INSTRUCTIONS=AVX2``.

Three arms run in turns: ``bare`` takes the first exp with nothing
before it; ``one_thread`` does so at one intra-op thread; ``port``
imports ``nanosandbox_tpu_torch.ops`` first, whose one serial VML call
(a log, not an exp) settles the choice before any parallel one.

    cd <a checkout of the repository>
    python3 scripts/cpu_vml_race.py [--procs=32] [--rounds=3]

Prints, per arm, the processes run and those with a share off by more
than 1e-6 relative, and how many of the off shares equal the AVX2
``VML_EP`` output. CPU only; it needs the MKL that torch links.
"""

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, H, T, D = 2, 2, 128, 32
VML_EP = 0x3
# ATen's own flags beside the accuracy mode: VML_FTZDAZ_OFF and
# VML_ERRMODE_IGNORE (aten/src/ATen/cpu/vml.h).
VML_FLAGS = 0x140000 | 0x100


def _scores():
    import torch

    rng = np.random.default_rng(0)
    q, k = (torch.from_numpy(rng.standard_normal((B, H, T, D),
                                                 dtype=np.float32))
            for _ in range(2))
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * D ** -0.5
    return s.masked_fill(~torch.ones(T, T, dtype=torch.bool).tril(), -1e30)


def child(arm: str, save: str) -> None:
    if arm == "port":
        sys.path.insert(0, REPO)
        import nanosandbox_tpu_torch.ops  # noqa: F401
    import torch

    torch.set_num_threads(1 if arm == "one_thread" else 2)
    s = _scores()
    e = torch.exp(s).numpy()               # the process's first parallel exp
    x = s.numpy()
    ref = np.exp(x.astype(np.float64))
    bad = [b for b in range(B)
           if (np.abs(e[b] - ref[b]) / np.maximum(ref[b], 1e-300)).max()
           > 1e-6]
    if bad:
        np.save(save, np.stack([x[bad[0]], e[bad[0]]]))
    print(len(bad))


def vml_ep_matches(paths) -> int:
    """Run in a process with MKL_ENABLE_INSTRUCTIONS=AVX2: how many saved
    shares equal vmsExp(VML_EP) of their inputs bit for bit."""
    import torch

    lib = ctypes.CDLL(os.path.join(os.path.dirname(torch.__file__), "lib",
                                   "libtorch_cpu.so"))
    n = 0
    for path in paths:
        x, got = np.load(path)
        x = np.ascontiguousarray(x)
        out = np.empty_like(x)
        lib.vmsExp(ctypes.c_int(x.size), x.ctypes.data_as(ctypes.c_void_p),
                   out.ctypes.data_as(ctypes.c_void_p),
                   ctypes.c_longlong(VML_EP | VML_FLAGS))
        n += bool(np.array_equal(out, got))
    return n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--procs", type=int, default=32)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--child", choices=("bare", "one_thread", "port"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--save", help=argparse.SUPPRESS)
    ap.add_argument("--check", nargs="*", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        child(args.child, args.save)
        return 0
    if args.check is not None:
        print(vml_ep_matches(args.check))
        return 0
    tally = {arm: [0, 0] for arm in ("bare", "one_thread", "port")}
    with tempfile.TemporaryDirectory() as tmp:
        saved = {arm: [] for arm in tally}
        for r in range(args.rounds):
            for arm in tally:
                procs = []
                for i in range(args.procs):
                    save = os.path.join(tmp, f"{arm}_{r}_{i}.npy")
                    procs.append((save, subprocess.Popen(
                        [sys.executable, __file__, f"--child={arm}",
                         f"--save={save}"], stdout=subprocess.PIPE,
                        text=True)))
                for save, p in procs:
                    out, _ = p.communicate()
                    if p.returncode != 0:
                        raise RuntimeError(f"child {arm} failed")
                    tally[arm][0] += 1
                    if int(out.split()[-1]):
                        tally[arm][1] += 1
                        saved[arm].append(save)
        for arm, (ran, off) in tally.items():
            match = 0
            if saved[arm]:
                env = dict(os.environ, MKL_ENABLE_INSTRUCTIONS="AVX2")
                match = int(subprocess.run(
                    [sys.executable, __file__, "--check", *saved[arm]],
                    env=env, capture_output=True, text=True,
                    check=True).stdout.split()[-1])
            print(f"{arm}: {off} of {ran} processes had a thread's share "
                  f"off; {match} of {off} equal AVX2 vmsExp(VML_EP) bit "
                  "for bit")
    return 0


if __name__ == "__main__":
    sys.exit(main())
