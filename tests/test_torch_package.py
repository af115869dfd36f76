"""Package-level contracts of the PyTorch port.

* nanosandbox_tpu_torch imports neither jax nor nanosandbox_tpu: a fresh
  interpreter imports every module of it and finds neither in
  sys.modules, and an AST scan finds no such import statement anywhere
  in the package (the runs-without-jax idiom of tests/test_analysis.py).
* The entry points run on the GPU unless asked for the CPU: with no CUDA
  device, device='auto' raises instead of quietly choosing the CPU, and
  chip_smoke.py exits non-zero without printing a result; its engine and
  server phases rehearse on the CPU up to the launch-count check.
* Paths not ported yet raise instead of running something else; the
  dense and int8/int4 pools construct.
* The port's copies of BlockPool and SlotScheduler pass an admit / hit /
  release round trip.
"""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from nanosandbox_tpu_torch import config as tconfig
from nanosandbox_tpu_torch.config import GPTConfig, resolve_device
from nanosandbox_tpu_torch.models.gpt import GPT
from nanosandbox_tpu_torch.serve.engine import Engine
from nanosandbox_tpu_torch.serve.paged import BlockPool
from nanosandbox_tpu_torch.serve.scheduler import (SlotScheduler,
                                                   admit_ladder,
                                                   default_buckets)

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "nanosandbox_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "nanosandbox_tpu")


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Tiny models gain nothing from torch's full intra-op thread pool,
    and the suite's other workers run timing-sensitive tests beside
    these; two threads keep this module from oversubscribing the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import nanosandbox_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(len(names), bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                          capture_output=True, text=True, timeout=120,
                          env=env)
    assert proc.returncode == 0, proc.stderr
    n, bad = proc.stdout.strip().split(" ", 1)
    assert int(n) >= 12 and bad == "[]", proc.stdout


def test_no_jax_import_statements_in_the_package():
    offenders = []
    for path in PKG.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{path.relative_to(REPO)}: {n}"
                          for n in names if _forbidden(n)]
    assert not offenders, offenders


def test_auto_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(tconfig.torch.cuda, "is_available", lambda: False)
    for name in ("auto", "cuda"):
        with pytest.raises(RuntimeError, match="--device=cpu"):
            resolve_device(name)
    model = GPT(GPTConfig(n_layer=1, n_head=2, n_embd=64, block_size=32,
                          vocab_size=16, compute_dtype="float32"))
    with pytest.raises(RuntimeError, match="--device=cpu"):
        Engine(model, num_slots=1, max_len=32)
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unknown device"):
        resolve_device("tpu")


def test_chip_smoke_refuses_to_run_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=str(REPO),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_phases_rehearse_on_cpu(monkeypatch, tmp_path):
    """chip_smoke.py's engine, server, trainer, pool and sampler phases,
    run on the CPU at a tiny width: every check before the launch counts
    passes (greedy tokens equal the recompute, the dense and quantized
    engines' tokens equal the paged engine's and their plain-version
    controls', 6/6 answers on each server, a prefix hit on the paged
    ones; the trainer's loss falls by 2 nats by iter 25, ckpt/30 exists,
    the resume continues at 30; the sample CLI prints its samples and
    generate equals the argmax loop), and the launch check then refuses
    each run, because on the CPU no kernel launched."""
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    from nanosandbox_tpu_torch.ops import attention as at
    from nanosandbox_tpu_torch.ops import flash_decode as fd

    monkeypatch.chdir(REPO)
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "MODEL", dict(
        n_layer=2, n_head=2, n_embd=64, block_size=1024, vocab_size=256))
    # A tiny width learns too slowly at the config's rate to fall 2 nats
    # in 25 steps over 50304 logits; 256 logits at 1e-2 do.
    monkeypatch.setattr(chip_smoke, "TRAIN", [
        "--n_layer=2", "--n_head=2", "--n_embd=64", "--block_size=64",
        "--batch_size=4", "--vocab_size=256", "--learning_rate=1e-2"])
    model, prompts = chip_smoke.fp32_model_and_prompts()
    ref = chip_smoke.recompute(model, prompts)
    paged = {"tokens": ref}
    for phase in (lambda: chip_smoke.check_engine_fp32(model, prompts, ref),
                  lambda: chip_smoke.check_server(fd, "cpu"),
                  lambda: chip_smoke.check_server(fd, "cpu",
                                                  ["--paged=off"]),
                  lambda: chip_smoke.check_pools_fp32(model, prompts, ref,
                                                      paged),
                  lambda: chip_smoke.check_trainer(at, fd, "cpu",
                                                   str(tmp_path)),
                  lambda: chip_smoke.check_sampler(str(tmp_path))):
        with pytest.raises(SystemExit, match="bypassed a kernel"):
            phase()


def test_chip_smoke_instance_checks_rehearse_on_cpu(monkeypatch):
    """chip_smoke.py's checks of the other kernel instances (every head
    dim and (query, kv mode) pair, and rows with no key) run on the CPU,
    where both sides are the plain versions, and pass."""
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    from nanosandbox_tpu_torch.ops import flash_decode as fd

    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    chip_smoke.check_other_instances(fd, np.random.default_rng(0))


def test_chip_smoke_build_report_parsers():
    """Phase 2 reads each tensor-core kernel's registers and spills from
    ptxas's -v log and its HMMA/HGMMA count from cuobjdump -sass; both
    parsers, on text in those tools' formats."""
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    fwd = "_ZN12_GLOBAL__N_120flash_fwd_mma_kernelILi64ELi8EEEvPK13bf16"
    log = (f"ptxas info    : Compiling entry function '{fwd}' for "
           "'sm_90a'\nptxas info    : Function properties for x\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
           "loads\nptxas info    : Used 128 registers, 384 bytes cmem[0]\n"
           "ptxas info    : Compiling entry function '_Zold' for 'sm_90a'\n"
           "    8 bytes stack frame, 12 bytes spill stores, 12 bytes spill "
           "loads\nptxas info    : Used 255 registers\n")
    assert chip_smoke.ptxas_report(log) == {fwd: (128, 0), "_Zold": (255, 12)}
    sass = (f"\tcode for sm_90a\n\t\tFunction : {fwd}\n"
            "        /*0100*/  HMMA.16816.F32.BF16 R4, R8, R12, R4 ;\n"
            "        /*0110*/  HMMA.16816.F32.BF16 R8, R8, R14, R8 ;\n"
            "\t\tFunction : _Zold\n        /*0000*/  FFMA R1, R2, R3, R1 ;\n")
    assert chip_smoke.sass_mma_counts(sass) == {fwd: 2, "_Zold": 0}
    assert chip_smoke.kernel_label(fwd) == "flash_fwd_mma_kernel<D=64>"
    # K7 (the backward without dQ) and K1 over each pool's storage type:
    # bf16, int8 (signed char) and int4 (nsb::Int4, a substitution).
    labels = {
        "_ZN12_GLOBAL__N_120flash_bwd_mma_kernelILi128ELb0EEEvPK13__nv_"
        "bfloat16S3_": "flash_bwd_mma_kernel<D=128, dq=0>",
        "_ZN12_GLOBAL__N_120flash_bwd_mma_kernelILi32ELb1EEEvPK13__nv_"
        "bfloat16S3_": "flash_bwd_mma_kernel<D=32, dq=1>",
        "_ZN3nsb12_GLOBAL__N_124paged_prefill_mma_kernelI13__nv_bfloat16"
        "Li64EEEvPKS2_": "paged_prefill_mma_kernel<bf16, D=64>",
        "_ZN3nsb12_GLOBAL__N_124paged_prefill_mma_kernelIaLi32EEEvPK13__nv_"
        "bfloat16": "paged_prefill_mma_kernel<int8, D=32>",
        "_ZN3nsb12_GLOBAL__N_124paged_prefill_mma_kernelINS_4Int4ELi128EEEv"
        "PK13__nv_bfloat16": "paged_prefill_mma_kernel<int4, D=128>",
        "_ZN12_GLOBAL__N_123flash_bwd_dq_mma_kernelILi64EEEvPK13__nv_"
        "bfloat16S3_": "flash_bwd_dq_mma_kernel<D=64>"}
    for mangled, label in labels.items():
        assert chip_smoke.kernel_label(mangled) == label
        assert label in chip_smoke.TENSOR_CORE_INSTANCES
    assert len(chip_smoke.TENSOR_CORE_INSTANCES) == 21
    # The kernels on CUDA cores: held to 0 spills, no HMMA asked. The fp32
    # K4 with 32- and 64-query blocks, the fp32 K5/K7 and K6, K1 in each
    # of its f32 (query, pool) pairs with 32- and 64-query blocks, and K2
    # in every (query, pool) pair (a repeated bf16 is a substitution).
    pf = ("_ZN3nsb51_GLOBAL__N__737eb1aa_18_paged_attention_cu_2415576824"
          "paged_prefill_f32_kernel")
    labels = {
        "_ZN12_GLOBAL__N_119flash_bwd_kv_kernelILi128ELb0EEEvPKfS2_":
        "flash_bwd_kv_kernel<D=128, dq=0>",
        "_ZN51_GLOBAL__N__5ee34151_18_flash_attention_cu_bc8f9a2a23flash_bwd_"
        "dq_f32_kernelILi64EEEvPKfS2_S2_S2_S2_S2_PfiifNS_11DropoutArgsE":
        "flash_bwd_dq_f32_kernel<D=64>",
        pf + "IffLi64ELi32EEEvPKT_PKNS_2KVIT0_E1SESA_PKfSC_PKiSE_PS2_iiiiif":
        "paged_prefill_f32_kernel<q=fp32, kv=fp32, D=64, BQ=32>",
        pf + "If13__nv_bfloat16Li32ELi64EEEvPKT_PKNS_2KVIT0_E1SESB_PKfSD_"
        "PKiSF_PS3_iiiiif":
        "paged_prefill_f32_kernel<q=fp32, kv=bf16, D=32, BQ=64>",
        pf + "IfaLi128ELi32EEEvPKT_PKNS_2KVIT0_E1SESA_PKfSC_PKiSE_PS2_iiiiif":
        "paged_prefill_f32_kernel<q=fp32, kv=int8, D=128, BQ=32>",
        pf + "IfNS_4Int4ELi64ELi64EEEvPKT_PKNS_2KVIT0_E1SESB_PKfSD_PKiSF_PS3_"
        "iiiiif": "paged_prefill_f32_kernel<q=fp32, kv=int4, D=64, BQ=64>",
        pf + "I13__nv_bfloat16fLi64ELi32EEEvPKT_PKNS_2KVIT0_E1SESB_PKfSD_"
        "PKiSF_PS3_iiiiif":
        "paged_prefill_f32_kernel<q=bf16, kv=fp32, D=64, BQ=32>",
        "_ZN12_GLOBAL__N_120flash_fwd_f32_kernelILi128ELi32EEEvPKfS1_S1_PfS2_"
        "iifNS_11DropoutArgsE": "flash_fwd_f32_kernel<D=128, BQ=32>",
        "_ZN12_GLOBAL__N_120flash_fwd_f32_kernelILi64ELi64EEEvPKfS1_S1_PfS2_"
        "iifNS_11DropoutArgsE": "flash_fwd_f32_kernel<D=64, BQ=64>",
        "_ZN3nsb12_GLOBAL__N_119paged_decode_kernelI13__nv_bfloat16S2_Li64EE"
        "EvPKT_": "paged_decode_kernel<q=bf16, kv=bf16, D=64>",
        "_ZN3nsb12_GLOBAL__N_119paged_decode_kernelIfNS_4Int4ELi32EEEvPKT_":
        "paged_decode_kernel<q=fp32, kv=int4, D=32>",
        "_ZN3nsb12_GLOBAL__N_119paged_decode_kernelI13__nv_bfloat16aLi128EEE"
        "vPKT_": "paged_decode_kernel<q=bf16, kv=int8, D=128>",
        "_ZN3nsb12_GLOBAL__N_119paged_decode_kernelIffLi64EEEvPKT_":
        "paged_decode_kernel<q=fp32, kv=fp32, D=64>"}
    for mangled, label in labels.items():
        assert chip_smoke.kernel_label(mangled) == label
        assert label in chip_smoke.CUDA_CORE_INSTANCES
    assert len(chip_smoke.CUDA_CORE_INSTANCES) == 69


def test_chip_smoke_kernel_names_are_kernels_in_the_sources():
    """Every kernel name phase 2 looks for is a __global__ function of
    the port's CUDA sources, so a renamed kernel fails here and not after
    a chip run."""
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    kernels = set()
    for path in (PKG / "csrc").glob("*.cu"):
        kernels |= set(re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?"
            r"(\w+)\s*\(", path.read_text()))
    names = chip_smoke.TENSOR_CORE_KERNELS + chip_smoke.CUDA_CORE_KERNELS
    assert set(names) <= kernels, sorted(set(names) - kernels)
    # Each instance phase 2 expects names one of those kernels.
    for label in (chip_smoke.TENSOR_CORE_INSTANCES
                  + chip_smoke.CUDA_CORE_INSTANCES):
        assert label.split("<", 1)[0] in names, label


def test_unported_paths_raise():
    """The dense pool and the int8/int4 pools are ported and construct;
    speculative verify (T > 1 at a nonzero cache_index) and the
    sampler's --spec / --spec_k are not, and raise."""
    from nanosandbox_tpu_torch import sample
    from nanosandbox_tpu_torch.models.gpt import init_cache

    model = GPT(GPTConfig(n_layer=1, n_head=2, n_embd=64, block_size=32,
                          vocab_size=16, compute_dtype="float32"))
    for kvd in ("fp32", "int8", "int4"):
        for paged in (True, False):
            eng = Engine(model, num_slots=1, max_len=32, kv_dtype=kvd,
                         paged=paged, device="cpu")
            assert eng.stats()["kv_dtype"] == kvd
            assert eng.stats()["paged"] == paged
    with torch.no_grad(), pytest.raises(NotImplementedError,
                                        match="not ported yet"):
        model(torch.zeros(1, 3, dtype=torch.int64),
              cache=init_cache(model.cfg, 1, 32), cache_index=5)
    for flag in ("--spec=ngram", "--spec_k=4"):
        with pytest.raises(NotImplementedError, match="not ported yet"):
            sample.main([flag, "--out_dir=nowhere"])


def test_block_pool_and_scheduler_round_trip():
    assert admit_ladder(6) == [1, 2, 4, 6]
    assert default_buckets(100) == [16, 32, 64, 100]
    sched = SlotScheduler(2, [8, 16])
    pool = BlockPool(6, 4)
    first = tuple(range(10))
    a = pool.admit(first, 2)                    # 3 blocks, no hit
    assert a.n_hit == 0 and len(a.table) == 3
    pool.check([a])
    pool.release(a)                             # donates 2 full blocks
    pool.check([])
    assert pool.match_len(first[:8] + (99, 98)) == 8
    b = pool.admit(first[:8] + (99, 98), 2)     # hit the 2 donated blocks
    assert b.n_hit == 2 and b.table[:2] == a.table[:2]
    c = pool.admit((7,) * 9, 7)                 # needs 4: evicts the trie
    assert c is None                            # ...but the hit is pinned
    pool.check([b])
    pool.release(b, donate=False)
    c = pool.admit((7,) * 9, 7)
    assert c is not None and len(c.table) == 4
    pool.check([c])
    assert pool.stats()["prefix_hit_requests"] == 1

    class R:
        def __init__(self, n):
            self.prompt = (0,) * n

    for n in (5, 7, 12):
        sched.enqueue(R(n))
    items, slots, bucket = sched.next_admission_wave()
    assert [len(i.prompt) for i in items] == [5, 7] and bucket == 8
    assert sched.next_admission_wave() is None      # no free slot
    sched.release(slots[0])
    items, _, bucket = sched.next_admission_wave()
    assert len(items[0].prompt) == 12 and bucket == 16
    sched.release(slots[1])
    with pytest.raises(ValueError, match="twice"):
        sched.release(slots[1])
