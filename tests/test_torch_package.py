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
import json
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
        "import importlib, json, pkgutil, sys\n"
        "import nanosandbox_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(json.dumps([names, bad]))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                          capture_output=True, text=True, timeout=120,
                          env=env)
    assert proc.returncode == 0, proc.stderr
    names, bad = json.loads(proc.stdout.strip().splitlines()[-1])
    assert len(names) >= 15 and bad == [], proc.stdout
    # Ring attention, the multi-process modules (FSDP's sharding and the
    # HF converter among them), the scheduling modules (the SLO ledger,
    # the brownout ladder), speculative decoding and recovery (the fault
    # plan, the watchdogs, the supervisor), and multi-replica serving
    # (the router, the fleet, the prefill/decode pair) are among them.
    for mod in ("ops.ring_attention", "parallel.distributed",
                "parallel.mesh", "parallel.sharding", "models.convert",
                "obs.slo", "serve.brownout",
                "serve.scheduler", "serve.faults", "serve.spec",
                "serve.drafters", "serve.recovery", "obs.flight",
                "obs.registry", "obs.tracer", "obs.vitals",
                "utils.profiler", "serve.router", "serve.fleet",
                "serve.disagg"):
        assert f"nanosandbox_tpu_torch.{mod}" in names, names


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
    ones; the trainer's dataset is the JAX package's bins, its loss
    falls by 2 nats by iter 25, ckpt/30 exists, the resume continues at
    30, the memory report and the profiler trace are written, and the
    remat legs' iter 0 losses are the first run's bits; the sample CLI
    prints its samples and generate equals the argmax loop), and the
    launch check then refuses each run, because on the CPU no kernel
    launched. Phase 17 (observability) passes its /metrics, /trace,
    /debug, /profile, watchdog, /drain and telemetry-cost checks first;
    phase 18 (multi-replica serving) its DisaggPair, Fleet and HTTP
    router checks (tokens equal to the colocated engine's, bit-identical
    copies, one terminal a request through both replica_down kills, the
    migration counters on both pods); phase 21 (the schedule fuzz) its
    instrumented runs' tokens and sync names equal to the plain ones and
    its fuzz clean.
    The trainer phase prepares its BPE dataset from a 200 KB
    slice of the XL corpus, held to the sha256s of the JAX package's
    prepare of the same slice, so the test never BPE-encodes 25 MB."""
    import hashlib

    from nanosandbox_tpu.data.prepare import \
        prepare_english_prose_bpe_dataset as jax_prepare

    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    from nanosandbox_tpu_torch.ops import attention as at
    from nanosandbox_tpu_torch.ops import flash_decode as fd

    corpus = tmp_path / "slice.txt"
    with open(REPO / chip_smoke.BPE_CORPUS, encoding="utf-8") as f:
        corpus.write_text(f.read(200_000), encoding="utf-8")
    jax_prepare(str(tmp_path / "jax_bpe"), source_file=str(corpus))
    sha = {name: hashlib.sha256(
        (tmp_path / "jax_bpe" / name).read_bytes()).hexdigest()
        for name in ("train.bin", "val.bin")}
    monkeypatch.chdir(REPO)
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "BPE_CORPUS", str(corpus))
    monkeypatch.setattr(chip_smoke, "BPE_SHA256", sha)
    monkeypatch.setattr(chip_smoke, "MODEL", dict(
        n_layer=2, n_head=2, n_embd=64, block_size=1024, vocab_size=256))
    # A tiny width learns too slowly at the config's rate to fall 2 nats
    # in 25 steps; at 1e-2 it does, over the config's 50304 logits.
    # Batch 2 keeps the CPU steps over those logits short.
    # Phase 18's control flow does not depend on its budget, nor phase
    # 21's fuzz on its load (the card's load would take the CPU minutes).
    monkeypatch.setattr(chip_smoke, "FLEET_NEW", 16)
    monkeypatch.setattr(chip_smoke, "SCHED_FUZZ_NEW", 4)
    monkeypatch.setattr(chip_smoke, "SCHED_FUZZ_PER_SLOT", 1)
    monkeypatch.setattr(chip_smoke, "TRAIN", [
        "--n_layer=2", "--n_head=2", "--n_embd=64", "--block_size=64",
        "--batch_size=2", "--learning_rate=1e-2"])
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
                  lambda: chip_smoke.check_sampler(str(tmp_path)),
                  lambda: chip_smoke.check_observability(fd, "cpu",
                                                         str(tmp_path)),
                  lambda: chip_smoke.check_fleet_serving(fd, at, "cpu"),
                  lambda: chip_smoke.check_schedcheck(fd, at, "cpu")):
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
    ptxas's -v log and its HMMA and HGMMA counts from cuobjdump -sass;
    both parsers, on text in those tools' formats."""
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    fwd = "_ZN12_GLOBAL__N_120flash_fwd_mma_kernelILi64ELi8ELb1EEEvPK13bf16"
    log = (f"ptxas info    : Compiling entry function '{fwd}' for "
           "'sm_90a'\nptxas info    : Function properties for x\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
           "loads\nptxas info    : Used 128 registers, 384 bytes cmem[0]\n"
           "ptxas info    : Compiling entry function '_Zold' for 'sm_90a'\n"
           "    8 bytes stack frame, 12 bytes spill stores, 12 bytes spill "
           "loads\nptxas info    : Used 255 registers\n")
    assert chip_smoke.ptxas_report(log) == {fwd: (128, 0), "_Zold": (255, 12)}
    wg = ("_ZN3nsb12_GLOBAL__N_122flash_fwd_wgmma_kernelILi64EEEv14CUtensor"
          "Map_stS2_S2_P13__nv_bfloat16PfiifNS_11DropoutArgsE")
    sass = (f"\tcode for sm_90a\n\t\tFunction : {fwd}\n"
            "        /*0100*/  HMMA.16816.F32.BF16 R4, R8, R12, R4 ;\n"
            "        /*0110*/  HMMA.16816.F32.BF16 R8, R8, R14, R8 ;\n"
            "\t\tFunction : _Zold\n        /*0000*/  FFMA R1, R2, R3, R1 ;\n"
            f"\t\tFunction : {wg}\n        /*0200*/  HGMMA.64x64x16.F32.BF16 "
            "R24, gdesc[UR4], RZ, !UPT ;\n")
    assert chip_smoke.sass_mma_counts(sass) == {fwd: (2, 0), "_Zold": (0, 0),
                                                 wg: (0, 1)}
    assert chip_smoke.kernel_label(wg) == "flash_fwd_wgmma_kernel<D=64>"
    assert chip_smoke.kernel_label(fwd) == "flash_fwd_mma_kernel<D=64>"
    # K5 and K7 (the backward with and without dQ), causal on mma.sync and
    # non-causal on wgmma (K7's dq_acc map a std::conditional type), K6
    # non-causal on wgmma, and K1 over each pool's storage type: bf16, int8
    # (signed char) and int4 (nsb::Int4, a substitution).
    labels = {
        "_ZN12_GLOBAL__N_120flash_bwd_mma_kernelILi128ELb0EEEvPK13__nv_"
        "bfloat16S3_": "flash_bwd_mma_kernel<D=128, dq=0>",
        "_ZN12_GLOBAL__N_120flash_bwd_mma_kernelILi32ELb1EEEvPK13__nv_"
        "bfloat16S3_": "flash_bwd_mma_kernel<D=32, dq=1>",
        "_ZN3nsb12_GLOBAL__N_122flash_bwd_wgmma_kernelILi32ELb1EEEv14CUtensor"
        "Map_stS2_S2_S2_S2_NSt11conditionalIXT0_ES2_NS0_5NoMapEE4typeEP13__nv"
        "_bfloat16S8_iifNS_11DropoutArgsE":
        "flash_bwd_wgmma_kernel<D=32, dq=1>",
        "_ZN3nsb12_GLOBAL__N_122flash_bwd_wgmma_kernelILi128ELb0EEEv14CUtensor"
        "Map_stS2_S2_S2_S2_NSt11conditionalIXT0_ES2_NS0_5NoMapEE4typeEP13__nv"
        "_bfloat16S8_iifNS_11DropoutArgsE":
        "flash_bwd_wgmma_kernel<D=128, dq=0>",
        "_ZN3nsb12_GLOBAL__N_125flash_bwd_dq_wgmma_kernelILi64EEEv14CUtensor"
        "Map_stS2_S2_S2_PK13__nv_bfloat16S5_PKfS7_PS3_iifNS_11DropoutArgsE":
        "flash_bwd_dq_wgmma_kernel<D=64>",
        "_ZN3nsb12_GLOBAL__N_124paged_prefill_mma_kernelI13__nv_bfloat16"
        "Li64EEEvPKS2_": "paged_prefill_mma_kernel<bf16, D=64>",
        "_ZN3nsb12_GLOBAL__N_124paged_prefill_mma_kernelIaLi32EEEvPK13__nv_"
        "bfloat16": "paged_prefill_mma_kernel<int8, D=32>",
        "_ZN3nsb12_GLOBAL__N_124paged_prefill_mma_kernelINS_4Int4ELi128EEEv"
        "PK13__nv_bfloat16": "paged_prefill_mma_kernel<int4, D=128>",
        "_ZN12_GLOBAL__N_123flash_bwd_dq_mma_kernelILi64ELb1EEEvPK13__nv_"
        "bfloat16S3_": "flash_bwd_dq_mma_kernel<D=64, dlse=1>"}
    for mangled, label in labels.items():
        assert chip_smoke.kernel_label(mangled) == label
        assert label in chip_smoke.TENSOR_CORE_INSTANCES
    # K4, K5 and K7 x 3 head_dims x mma.sync (causal) or wgmma
    # (non-causal), K6 x 3 on mma.sync (causal) x dlse or not and on wgmma
    # (non-causal), K1 x 9: the wgmma K6 and K7 took the places of the
    # non-causal mma.sync K6 (two, dlse or not) and K7, so 39 became 36.
    # The bf16 kernels have no causal flag left.
    assert len(chip_smoke.TENSOR_CORE_INSTANCES) == 36
    assert not [i for i in chip_smoke.TENSOR_CORE_INSTANCES if "causal" in i]
    for d in chip_smoke.HEAD_DIMS:
        assert {f"flash_bwd_dq_wgmma_kernel<D={d}>",
                f"flash_bwd_wgmma_kernel<D={d}, dq=0>"} <= set(
                    chip_smoke.TENSOR_CORE_INSTANCES)
    # The kernels on CUDA cores: held to 0 spills, no HMMA asked. The
    # causal fp32 K4 with 32- and 64-query blocks, the non-causal fp32
    # K4-K7 of ring attention's blocks (csrc/flash_ring_f32.cuh) with and
    # without dropout, the causal fp32 K5, K7 and K6, K1 in each of its
    # f32 (query, pool) pairs with 32- and 64-query blocks, and K2 in
    # every (query, pool) pair (a repeated bf16 is a substitution).
    pf = ("_ZN3nsb51_GLOBAL__N__737eb1aa_18_paged_attention_cu_2415576824"
          "paged_prefill_f32_kernel")
    labels = {
        "_ZN12_GLOBAL__N_119flash_bwd_kv_kernelILi128ELb0EEEvPKfS1_":
        "flash_bwd_kv_kernel<D=128, dq=0>",
        "_ZN51_GLOBAL__N__5ee34151_18_flash_attention_cu_bc8f9a2a23flash_bwd_"
        "dq_f32_kernelILi64EEEvPKfS2_S2_S2_S2_S2_S2_PfiifNS_11DropoutArgsE":
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
        "_ZN12_GLOBAL__N_120flash_fwd_f32_kernelILi128ELi32EEEvPKfS1_S1_"
        "PfS2_iifNS_11DropoutArgsE":
        "flash_fwd_f32_kernel<D=128, BQ=32>",
        "_ZN12_GLOBAL__N_120flash_fwd_f32_kernelILi64ELi64EEEvPKfS1_S1_"
        "PfS2_iifNS_11DropoutArgsE":
        "flash_fwd_f32_kernel<D=64, BQ=64>",
        "_ZN12_GLOBAL__N_125flash_fwd_ring_f32_kernelILi64ELb1EEEvPKfS1_S1_"
        "PfS2_iifN3nsb11DropoutArgsE":
        "flash_fwd_ring_f32_kernel<D=64, drop=1>",
        "_ZN12_GLOBAL__N_125flash_fwd_ring_f32_kernelILi32ELb0EEEvPKfS1_S1_"
        "PfS2_iifN3nsb11DropoutArgsE":
        "flash_fwd_ring_f32_kernel<D=32, drop=0>",
        "_ZN12_GLOBAL__N_125flash_bwd_ring_f32_kernelILi128ELi32ELb0ELb0EEEv"
        "PKfS1_S1_S1_S1_S1_PfS2_S2_iifN3nsb11DropoutArgsE":
        "flash_bwd_ring_f32_kernel<D=128, BK=32, dq=0, drop=0>",
        "_ZN12_GLOBAL__N_125flash_bwd_ring_f32_kernelILi64ELi64ELb1ELb1EEEv"
        "PKfS1_S1_S1_S1_S1_PfS2_S2_iifN3nsb11DropoutArgsE":
        "flash_bwd_ring_f32_kernel<D=64, BK=64, dq=1, drop=1>",
        "_ZN12_GLOBAL__N_125flash_bwd_ring_f32_kernelILi32ELi64ELb0ELb1EEEv"
        "PKfS1_S1_S1_S1_S1_PfS2_S2_iifN3nsb11DropoutArgsE":
        "flash_bwd_ring_f32_kernel<D=32, BK=64, dq=0, drop=1>",
        "_ZN12_GLOBAL__N_128flash_bwd_dq_ring_f32_kernelILi64ELi32ELb1EEEvPKf"
        "S1_S1_S1_S1_S1_S1_PfiifN3nsb11DropoutArgsE":
        "flash_bwd_dq_ring_f32_kernel<D=64, BQ=32, drop=1>",
        "_ZN12_GLOBAL__N_128flash_bwd_dq_ring_f32_kernelILi128ELi64ELb0EEEvPK"
        "fS1_S1_S1_S1_S1_S1_PfiifN3nsb11DropoutArgsE":
        "flash_bwd_dq_ring_f32_kernel<D=128, BQ=64, drop=0>",
        "_ZN3nsb12_GLOBAL__N_119paged_decode_kernelI13__nv_bfloat16S2_Li64EE"
        "EvPKT_": "paged_decode_kernel<q=bf16, kv=bf16, D=64>",
        "_ZN3nsb12_GLOBAL__N_119paged_decode_kernelIfNS_4Int4ELi32EEEvPKT_":
        "paged_decode_kernel<q=fp32, kv=int4, D=32>",
        "_ZN3nsb12_GLOBAL__N_119paged_decode_kernelI13__nv_bfloat16aLi128EEE"
        "vPKT_": "paged_decode_kernel<q=bf16, kv=int8, D=128>",
        "_ZN3nsb12_GLOBAL__N_119paged_decode_kernelIffLi64EEEvPKT_":
        "paged_decode_kernel<q=fp32, kv=fp32, D=64>",
        "_ZN3nsb12_GLOBAL__N_119flash_decode_kernelI13__nv_bfloat16S2_Li64EE"
        "EvPKT_": "flash_decode_kernel<q=bf16, kv=bf16, D=64>",
        "_ZN3nsb12_GLOBAL__N_119flash_decode_kernelIfNS_4Int4ELi32EEEvPKT_":
        "flash_decode_kernel<q=fp32, kv=int4, D=32>",
        "_ZN3nsb12_GLOBAL__N_119flash_decode_kernelIfaLi128EEEvPKT_":
        "flash_decode_kernel<q=fp32, kv=int8, D=128>"}
    for mangled, label in labels.items():
        assert chip_smoke.kernel_label(mangled) == label
        assert label in chip_smoke.CUDA_CORE_INSTANCES
    # The ring K7 (12: K5's kernel without dQ, x 3 head_dims x 32- or
    # 64-key blocks x dropout or not) and K6 (12: x 3 head_dims x 32- or
    # 64-query blocks x dropout or not) took the places of the non-causal
    # fp32 K7 (3, flash_bwd_kv_kernel<D, false, false>) and K6 (3,
    # flash_bwd_dq_f32_kernel<D, false>): 93 became 111. The causal flag
    # left the 9 remaining instances of those two kernels. No instance of
    # a flash kernel of csrc/flash_attention.cu is non-causal any more.
    # K3 (flash_decode_kernel, 24: 2 queries x 4 pools x 3 head_dims)
    # joined when its redesign gave it a ring to hold without spilling:
    # 111 became 135.
    assert len(chip_smoke.CUDA_CORE_INSTANCES) == 135
    assert {f"flash_decode_kernel<q={qd}, kv={kv}, D={d}>"
            for d in chip_smoke.HEAD_DIMS for qd in ("fp32", "bf16")
            for kv in ("fp32", "bf16", "int8", "int4")} <= set(
                chip_smoke.CUDA_CORE_INSTANCES)
    assert not [i for i in chip_smoke.CUDA_CORE_INSTANCES if "causal" in i]
    assert {f"flash_bwd_ring_f32_kernel<D={d}, BK={bk}, dq={q}, drop={w}>"
            for d in chip_smoke.HEAD_DIMS for bk in (32, 64) for q in (0, 1)
            for w in (0, 1)} | {
                f"flash_bwd_dq_ring_f32_kernel<D={d}, BQ={bq}, drop={w}>"
                for d in chip_smoke.HEAD_DIMS for bq in (32, 64)
                for w in (0, 1)} <= set(
                    chip_smoke.CUDA_CORE_INSTANCES)


def test_chip_smoke_kernel_names_are_kernels_in_the_sources():
    """Every kernel name phase 2 looks for is a __global__ function of
    the port's CUDA sources (a .cu, or a .cuh one includes), so a renamed
    kernel fails here and not after a chip run."""
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    kernels = set()
    for path in (PKG / "csrc").glob("*.cu*"):
        kernels |= set(re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?"
            r"(\w+)\s*\(", path.read_text()))
    names = chip_smoke.TENSOR_CORE_KERNELS + chip_smoke.CUDA_CORE_KERNELS
    assert set(names) <= kernels, sorted(set(names) - kernels)
    # The kernels held to HGMMA are tensor-core kernels of their own file.
    assert set(chip_smoke.WGMMA_KERNELS) <= set(chip_smoke.TENSOR_CORE_KERNELS)
    sm90 = (PKG / "csrc" / "flash_attention_sm90.cu").read_text()
    assert all(f"{n}(" in sm90 for n in chip_smoke.WGMMA_KERNELS)
    # The non-causal fp32 K4-K7 live in a header that the flash library's
    # source includes (its entry points route to them), one kind each.
    ring = (PKG / "csrc" / "flash_ring_f32.cuh").read_text()
    assert [k for k, _ in chip_smoke.RING_F32_KERNELS] == [
        "fwd", "fused", "dq", "dkv"]
    assert all(f"\n{n}(" in ring for _, n in chip_smoke.RING_F32_KERNELS)
    assert "\nflash_bwd_dq_ring_f32_kernel(" in ring
    assert "flash_bwd_dq_ring_f32_kernel" in chip_smoke.CUDA_CORE_KERNELS
    assert '#include "flash_ring_f32.cuh"' in (
        PKG / "csrc" / "flash_attention.cu").read_text()
    # Each instance phase 2 expects names one of those kernels.
    for label in (chip_smoke.TENSOR_CORE_INSTANCES
                  + chip_smoke.CUDA_CORE_INSTANCES):
        assert label.split("<", 1)[0] in names, label


def test_build_compiles_every_source_and_hashes_every_header():
    """ops/_build.py builds every csrc/*.cu into a library and keys each
    library by every csrc/*.cuh, so that no kernel source is left out of
    the build and an edited header rebuilds what includes it."""
    from nanosandbox_tpu_torch.ops import _build

    csrc = PKG / "csrc"
    assert {Path(p).name for p in _build.SOURCES} == {
        p.name for p in csrc.glob("*.cu")}
    assert {Path(p).name for p in _build.HEADERS} == {
        p.name for p in csrc.glob("*.cuh")}
    for p in _build.SOURCES:
        for inc in re.findall(r'#include "(\w+\.cuh)"', Path(p).read_text()):
            assert str(csrc / inc) in _build.HEADERS, (p, inc)
    # Every C entry point the wrappers call is declared with its argtypes.
    sigs = _build._signatures()
    entry = set()
    for p in _build.SOURCES:
        entry |= set(re.findall(r"^int (nsb_\w+)\(", Path(p).read_text(),
                                re.M))
    assert entry == set(sigs), sorted(entry ^ set(sigs))


def test_unported_paths_raise(tmp_path):
    """The dense pool and the int8/int4 pools are ported and construct,
    and so does an engine with a watchdog dump directory; a dense T > 1
    call at a nonzero scalar cache_index (speculative verify is per-row
    and ported) and tensor-parallel shards across cards (ROADMAP A10)
    are not, and raise; the serve CLI parses the fleet's --role, --router and
    --replicas and refuses an unknown role, and an unknown --spec value
    raises."""
    from nanosandbox_tpu_torch.models.gpt import init_cache
    from nanosandbox_tpu_torch.serve.__main__ import build_parser
    from nanosandbox_tpu_torch.serve.drafters import drafter_from_flag

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
    eng = Engine(model, num_slots=1, max_len=32, device="cpu",
                 watchdog_dir=str(tmp_path / "dumps"))
    assert eng.watchdog.dump_dir == str(tmp_path / "dumps")
    with pytest.raises(NotImplementedError, match="not ported yet"):
        Engine(model, num_slots=1, max_len=32, device="cpu", tp=2,
               tp_devices=["cuda:0", "cuda:1"])
    # The fleet's flags parse: the replica tiers and the router.
    args = build_parser().parse_args([
        "--role=decode", "--router", "--replicas=http://127.0.0.1:1",
        "--router_page=32", "--health_interval_s=0.5", "--no_affinity"])
    assert (args.role, args.router, args.replicas, args.router_page,
            args.health_interval_s, args.no_affinity) == (
        "decode", True, "http://127.0.0.1:1", 32, 0.5, True)
    with pytest.raises(SystemExit):
        build_parser().parse_args(["--role=both_tiers"])
    with pytest.raises(ValueError, match="unknown --spec"):
        drafter_from_flag("bogus")


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
