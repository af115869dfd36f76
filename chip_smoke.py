"""Drive the PyTorch/CUDA port on one GPU and check it end to end.

    python3 chip_smoke.py [--phases=2,3,7,9,13,14,15,16,17,18,19,20]

Phases (each prints what it found; any failure exits non-zero; --phases
runs phase 1 and the phases named, 2, 3, 7, 9 (with 12 after it), 13,
14, 15, 16, 17, 18, 19 or 20, and prints no result line):

  1. device   torch / CUDA versions, the card's name and power limit;
  2. build    the CUDA kernels from nanosandbox_tpu_torch/csrc (into
              build/), with nvcc's register and spill report, and for
              each tensor-core instance (TENSOR_CORE_INSTANCES: bf16 K4,
              K5, K6 and K7, and K1 under a bf16 query over bf16, int8
              and int4 pools, at head_dim 32, 64, 128; all must be found)
              its registers, spill stores (must be 0) and HMMA and HGMMA
              counts in the SASS (cuobjdump; must not be 0, and the
              wgmma kernels' HGMMA count must not be 0), and the
              registers and spill stores (must be 0) of each CUDA-core
              instance (CUDA_CORE_INSTANCES: the causal fp32 K4 with 32-
              and 64-query blocks, K5, K6 and K7, the non-causal fp32
              K4-K7 of ring attention's blocks with and without dropout,
              K1 in each of its f32 (query, pool) pairs, and K2 and K3 in
              every (query, pool) pair, at every head_dim; all must be
              found), the registers, shared memory and blocks an SM of
              the non-causal fp32 K4-K7, and K3's registers, shared
              memory (its ring and the static rest), blocks an SM and
              split length in every (query, pool) pair and head_dim;
  3. kernels  each kernel against its plain PyTorch version on the card
              at GPT-2 124M shapes, under fp32 and bf16 queries: K2 and
              K1 (H 12, D 64, page 16, 512 blocks, 64 table entries per
              row; K2 also at the serving steady state, 8 rows x 512
              positions; K1 at B 2, T 128 and 256, starts [0, 64], and the
              8 x 512 admission wave) over a pool in the query's dtype
              and over int8 and int4 pools, K3 (flash_decode_kernel) over
              contiguous (8, 12, 1024, 64) slot rows at K2's lengths, at
              8 rows x 512 (L 512) and at 1 row x 1024, in the fp32,
              bf16, int8 and int4 modes (two calls on the 1024-position
              row give equal bits). Both sides take the
              same pool; fp32 queries within 1e-5, bf16 within 2e-2
              (compared in f32), each also within the relative limits of
              phase 7; each case timed beside its bound and
              F.scaled_dot_product_attention on K/V gathered into
              contiguous rows and dequantized beforehand (a yardstick
              that excludes both); then, correctness only at the same
              limits, K1, K2 and K3 at head_dim 32, 64 and 128 in every
              (query, kv mode) pair (K1 also at T 100, starts [0, 37],
              and at B 8, H 12, T 160, where the f32 one takes 64-query
              blocks; K2 also at lengths Ls - 1, Ls, Ls + 1 and the full
              capacity of its splits, K3 at L 1000 and 1001 and on rows
              long enough to split in every mode, both equal bits on two
              calls),
              and K2 and K3 on decode rows of length 0 and -1 in every
              kv mode (zeros out, finite);
  4. engine   GPT-2 124M in fp32 (seeded random weights) through the
              paged engine: greedy tokens must equal a no-cache
              full-sequence recompute of the same model with the plain
              attention, TF32 off;
  5. server   GPT-2 124M in bf16 served by `python -m
              nanosandbox_tpu_torch.serve`'s code path on an ephemeral
              port, after its default warmup (--warmup=full): 6
              /generate requests (one a prefix hit), /healthz, /stats;
  6. counts   kernel launches of phase 5 (the serving path, counts reset
              just after the warmup; the decode kernels' are each CUDA
              graph's capture-time launches times its replays); the
              plain versions make no CUDA call there;
  7. train kernels  the flash-attention kernels (forward K4, fused
              backward K5, split backward K6 + K7) against their plain
              versions at the 124M training shape (B 16, H 12, T 1024,
              D 64): fp32 (TF32 off) within 1e-5 on o / lse and 1e-4 on
              dq / dk / dv (the looser bound covers K5's atomic dQ
              order), bf16 within 2e-2 (compared in f32), and every
              output's max |err| and ||err|| within a relative limit of
              its reference (1e-4 fp32, 2e-2 bf16); dropout 0.1 with a
              fixed seed, head_dim 32 and 128, and T = 200 (not a tile
              multiple), correctness only; in bf16 also T = 1000 (B 1,
              H 12), T = 1 and 17 (B 1, H 1; at T = 1 dq and dk are 0 in
              exact arithmetic and meet the absolute limit alone) and
              head_dim 128 with dropout 0.1; the split backward must
              give equal bits twice; then each kernel's time on the bf16
              and on the fp32 inputs just checked (TF32 off), beside its
              bound, its plain version and F.scaled_dot_product_attention
              (is_causal; forward, and forward+backward minus forward,
              which the fused backward and the split pair K6 + K7 are
              printed against); then ring attention's blocks (B 1 and 4,
              H 12, T 1024, D 64): K4 non-causal with its lse, K5 and
              K6 + K7 non-causal given a random lse cotangent, bf16
              without and with dropout, fp32 without (and at B 1 with)
              it, at the same limits, timed beside their bound and
              non-causal SDPA, with the grid, blocks an SM and waves of
              the wgmma K4, K5, K6 and K7 and of the non-causal fp32
              ones, and each kernel of one K4, K5 and split-backward call
              in bf16 and fp32 (torch.profiler; the fp32 calls must run
              the kernels of csrc/flash_ring_f32.cuh alone); the fp32
              fused backward's dK and dV must be the same bits on two
              calls; and, correctness only,
              the bf16 and the fp32 ones at head_dim 32 and 128 and at
              ragged, partial and one-key tiles, with and without dlse
              and dropout;
  8. train parity  GPT-2 124M in fp32 (TF32 off) on a 2 x 1024 batch,
              without dropout and with dropout 0.1 (masks from alike-
              seeded generators): loss and every parameter gradient with
              the kernels, through the fused backward and through the
              split one, against the same model with the plain attention
              on the card;
  9. trainer  english_prose_bpe prepared from the committed XL corpus
              by the port's data.prepare (its seconds; train.bin and
              val.bin must hash to BPE_SHA256, the JAX package's bins),
              then `python -m nanosandbox_tpu_torch.train`'s main() with
              configs/train_gpt2_124m_englishprose_bpe.py at full width
              (bf16, batch 16; cut to 30 iters, warmup 5, eval every 15
              on 4 batches, a log every 5): 30 steps with the fused
              backward, --profile_steps=20:22 and --memory_report=True
              (the loss must fall by 2 nats by iter 25, ckpt/30, the
              memory report's keys and the Chrome trace must exist, the
              trace must name the flash kernels, the window's host syncs
              by ledger name must be its log readbacks and one drain;
              the loader's host time a batch printed; the report printed
              beside the run's measured peak), then a resume to 35 with
              the split backward; then the remat legs (REMAT_LEGS, on
              the same batches): 5 steps with --remat=True under
              'save_attention' and 2 under 'full', each with iter 0's
              loss the first run's bits, its grad norm within
              SP_BF16_NORM_REL of it and its peak memory below the first
              run's; launch counts of every run (the training path,
              counts reset just before it; the remat legs exactly: the
              forward n_layer a step under 'save_attention', 2 n_layer
              under 'full'); the step's time, tok/s and MFU (median of
              the logged windows outside iter 0 and the profiled iters);
              a torch.profiler split of one step; the trainer's
              registry (train_loss equal to the loss logged at the last
              log iter, train_iters_total that iter + 1) and its spans
              (eval, checkpoint_save, profiler_window, none left open);
              then, as a control, the first run's 30 steps with the
              plain attention (loss trajectory printed, not checked);
 10. pools    phase 4's model and prompts through a dense-pool fp32
              engine (tokens equal to phase 4's paged engine and to the
              recompute; K3 and the K4 prefill launched), then fp32
              engines over int8 and int4 pools, paged and dense, each
              token-identical to the same engine with the kernels swapped
              for their plain versions, with the share of tokens that
              agree with the fp32-KV engine; launch counts of each run;
 11. servers  phase 5's requests against bf16 servers with --paged=off,
              --kv_dtype=int8 and --kv_dtype=int4 (every answer 200 and
              in vocabulary; K3 or the int8/int4 instances launched, no
              plain version on the card); decode tok/s, TTFT p50 and
              TPOT p50 per mode beside phase 5's;
 12. sampler  `python -m nanosandbox_tpu_torch.sample`'s main() on phase
              9's checkpoint (K4 prefill, K3 decode steps launched; the
              prompt and samples through the dataset's BPE tokenizer),
              then fp32 greedy generate() over 32 tokens from a 48-token
              BPE prompt on the same weights equal to a no-cache argmax
              loop;
 13. sequence parallel  openwebtext made by the port's data.prepare
              from the committed corpus (--tokenizer=bpe; the download is
              not ported), then four ranks of `python -m
              nanosandbox_tpu_torch.train configs/train_longcontext_8k.py`
              (mesh_sp 4, ring attention, the config's remat under
              save_attention) on one card, gloo with host-staged
              exchanges, against one process at mesh_sp 1 without
              remat on the same batches: bf16 at full width (step 0 with the split
              backward, then a resume with the fused one), fp32 at 2
              layers in both layouts, and
              configs/train_longcontext_8k_dropout.py (dropout 0.1) in
              fp32 at 2 layers, zigzag; every step's loss and grad norm,
              and the q/k/v rows of the attention projections' gradients
              at steps 0-1, within the stated limits, every rank's launch
              counts equal to the ring schedule, no plain version on the
              card; step time, tok/s, peak memory a rank and exchange
              costs (the K/V rotations, the share remat's recompute ran
              again, the all-reduce); rank 0 traces one bf16 step of the
              fused leg (torch.profiler): its wall and the device ms of
              the non-causal ring blocks, of the other flash kernels and
              of everything else; the one-process runs share the card
              with the bf16 SP legs, and the three fp32 SP runs run at
              once, as phase 19's waves do;
 14. dispatch modes  the engine's eager synchronous step (its private
              entry: the decode body run from Python every step) against
              replayed CUDA graph chunks at scan_k 1 and 8 with the
              pipeline on: greedy and sampled tokens identical, on the
              bf16 124M paged engine (phase 5's requests) and the fp32
              paged and dense engines (phase 4's prompts); in the k=8
              runs the decode kernels in a torch.profiler trace equal
              each graph's capture-time launches times its replays, one
              8-step chunk replayed alone launches K2 (paged) or K3
              (dense) 8 x n_layer times, and no plain version runs on
              the card; then the bf16 engine's decode wall per step and
              device idle share in each mode (serve/profile.py
              measure_decode, on the bf16 token runs' engines), beside
              the card's name and power limit;
 15. scheduling  phase 4's fp32 model through the paged engine at
              prefill_chunk 128 on phase 4's prompts and a 900-token one
              (tokens equal to the same engine's without chunking; K1
              launches, traced and counted, equal its prefill dispatches,
              waves and pieces, x n_layer; a decoding row takes tokens
              between the long prompt's first piece and its last), then
              preemption on 2 slots: paged, two batch requests and an
              interactive one with a 0.05 s deadline (a preemption, at
              least one block donated, the resume a prefix hit) and a
              request whose 1e-4 s deadline expires in the queue (shed),
              dense with a preemption forced at step 8; tokens equal to
              a 4-slot twin without preemption, no resume record left,
              no plain version on the card; then the bf16 server at
              --prefill_chunk=256 (phase 5's requests with slo_class,
              priority and deadline_s, and 8 blockers, two of them
              chunked, answer 200; with every slot busy a 1e-4 s
              deadline answers 429 with Retry-After; /stats carries the
              scheduling keys; the share of tokens equal to phase 5's
              answers printed); last, the bf16 paged engine at the CLI's
              defaults with 4 rows decoding when four 512-token prompts
              arrive, at prefill_chunk off, 256 and 128: the longest and
              median step wall while they are admitted, the device ms a
              step (a traced pass) and their TTFTs, beside the card's
              name and power limit.

 16. spec and recovery  phase 4's fp32 model: the paged engine with
              NGramDrafter(k=4) and with an oracle ModelDrafter (the
              target's own weights), greedy tokens equal to phase 4's,
              each verify graph's K1 launches n_layer at capture and in a
              trace of one replay (the (8, 5) block), no plain version,
              target forwards per emitted token (< 1 under the oracle);
              the dense engine with NGram on phase 4's prompts and a
              992-token one (its last blocks run past max_len), tokens
              equal to phase 10's and the recompute; a supervised paged
              engine on 4 slots under chaos-smoke plus a slow_step the
              stalled_step watchdog catches, tokens equal to the no-fault
              run, one terminal a request, a flush recovery and decode
              replays after it; a drafter_fault streak that disables
              spec with phase 4's tokens; an engine whose graph
              capture meets a collection of a dropped engine (in a
              reference cycle) still captures and decodes the dropped
              one's tokens; the bf16 server with
              --spec=ngram on phase 5's requests (acceptance, the share
              of tokens equal to phase 5's, TPOT p50 beside phase 5's);
              K1 at the verify shape (S 8, T 5, bf16 and fp32) timed
              against its plain version, its bound and SDPA.
 17. observability  the paged bf16 124M server (phase 5's flags, the
              CLI's defaults, --watchdog_dir), serving inside the
              --warmup=full freeze (its serve_compile_traces_total
              unchanged to the end): /metrics scraped before
              and after phase 5's rounds (the exposition parses, the
              families of OBS_FAMILIES are there, the submitted,
              completed, admitted and token counters move by what was
              sent and agree with /stats; the rounds' host syncs one
              decode-readback a decode chunk and admission readbacks,
              printed a chunk by name); /trace of every request (one
              generate and one queued span, decode steps overlapping by
              the pipeline's lag; an unknown rid 404); the /debug views'
              shapes; POST /profile {"steps": 16} while a 900-token
              request decodes, then a wave of two requests admitted in
              the window: its torch.profiler trace must hold
              paged_decode_kernel launched by graph replays and
              paged_prefill_mma_kernel; a forced ttft_spike trip and its
              dump (flight JSONL, spans, stats; no post_freeze_retrace
              while serving); POST /drain (readiness 503 at once, a new
              request 503, the 900-token request finishes); then the
              engine with telemetry on and off (runs on, off, on, off):
              tokens, graph replays, counted launches and one traced
              step's kernels equal, and the median step walls printed
              beside the card's name and power limit.
 18. multi-replica serving  (a) phase 5's bf16 model and requests
              through a DisaggPair (a prefill and a decode engine, 8
              slots x 1024, on the one card) over bf16, int8 and int4
              pools: tokens equal to a colocated paged engine's, every
              adopted block's codes and scales the source's bits, the
              decode tier's K1 launches 0 (eager and in its graphs) and
              its prefill dispatches 0, its K2 launches > 0, the
              prefill tier's K1 > 0; the bytes moved a request, the
              migration's host wall p50 and one chain's copy timed on
              the card, beside the card's name and power limit; then, on
              phase 4's fp32 model, replica_down in the migration window
              of four late requests while four decode: each request
              ends once with the colocated engine's tokens (restitched
              and fallen back); (b) a Fleet of two bf16 engines: three
              followers of a 128-token prefix route by affinity to the
              warm replica, tokens equal to a colocated engine served
              alike; a Fleet of two fp32 engines under replica_down with
              eight requests decoding: failover, one terminal a
              namespaced rid, the colocated engine's tokens; (c) a
              --role=prefill and a --role=decode server behind an
              in-process RouterFrontend on loopback: phase 5's 60-token
              greedy request migrates with phase 5's server's tokens,
              serve_migrated_out_total >= 1 on the prefill pod and
              serve_adopted_in_total >= 1 on the decode pod, which ran
              no prefill. The launch checks come last.
 19. data parallel and FSDP  ranks of `python -m nanosandbox_tpu_torch
              .train` on one card (gloo, host-staged exchanges) on
              phase 13's openwebtext, each against one process on the
              same batches (every step's loss and grad norm within the
              stated limits): (a) configs/train_gpt2_124m_owt_multihost
              .py as written at full width and depth in bf16 over 2
              ranks (mesh_dp = -1), at accumulation 1 and 2, and in fp32
              at 2 layers; the ranks' parameters equal after the last
              step; (b) configs/train_gpt2_1p5b_fsdp.py at full width
              (shard_params, remat) at mesh_fsdp 2 and 4 layers: each
              rank's parameter and moment bytes beside one process's,
              then rank 0's checkpoint restored bit for bit in one
              process and at mesh_dp 2; (c) configs/train_longcontext_
              8k.py at mesh_dp 2 x mesh_sp 2, fp32, 2 layers, the ring
              schedule's launches a rank; (d) a GPT-2 124M HF directory
              written by the port's exporter from seeded weights, 2
              steps of configs/finetune_gpt2_owt.py from it at 2 ranks
              (step 0's loss against one process), then the export CLI
              and load_hf_gpt2: fp32 logits on the card bit-equal to the
              checkpoint's. Each rank's causal K4 and K5 launches equal
              a layer's forward per micro-batch and eval batch and its
              backward per micro-batch, no plain version runs on the
              card; step wall, tok/s, peak memory a rank, all-reduce,
              gather and scatter bytes and host seconds a step, and the
              phase's seconds. The runs whose times are printed run
              alone; the references and second legs share the card.
 20. tensor parallelism  the model mesh axis at tp 2, every shard and
              rank on the one card: (e) K2, K1 and K3 at a shard's 6
              heads against their plain versions, timed beside bound and
              library; (a) the bf16 124M paged engine at tp 1 and 2 on
              phase 5's requests: the answers equal, the no-cache
              logits' max |diff|, TPOT p50 of both; (b) phase 4's fp32
              model at tp 2 against tp 1 over paged fp32, int8 and int4,
              dense fp32, scan_k 4 and NGram spec (tokens identical, as
              many graphs), a supervised nan_logits step and a forced
              preemption against a clean tp 2 run; (c) Fleet(2 replicas,
              tp 2) and a DisaggPair with a tp 2 prefill tier and a tp 1
              decode tier against the colocated engine; (d) launches: a
              captured decode step's K2 (K3 dense) = rung x n_layer x
              tp, K1 = n_layer x tp a prefill dispatch; (f) the 124M
              width at 4 layers, mesh_tp 2, fp32 and bf16, (g) fp32 at
              mesh_fsdp 2 x mesh_tp 2 and the 8k dropout config at
              mesh_sp 2 x mesh_tp 2 (2 layers), each against one process
              with phase 19's limits (phase 13's for the ring), each
              rank's parameter and moment bytes and its tp exchange
              bytes and seconds a step; (h) the tp 2 checkpoint restored
              bit for bit in one process. The training ranks run in two
              waves beside (b) and (c).
 21. schedule fuzz  the bf16 124M model (4 slots x 256, a pool of 40
              blocks: 2.5 slots' worth) as an Engine under an
              EngineLoop, a 2-replica Fleet and a DisaggPair: each
              served greedy requests uninstrumented, then again with
              every lock swapped for schedcheck's seeded-preemption
              wrapper (its prefix caches flushed between): tokens, K1
              and K2 launches (eager plus graph replays) and the sync
              ledger's names equal; then utils/schedcheck.py's fuzz
              loops, 2 seeds each, inside the frozen capture budgets,
              at load: twice as many requests as the target has slots,
              60-200 token prompts over the model's vocab, 32 new tokens
              each, half of them interactive with a 0.1 s deadline
              behind one shared 48-token prefix and half batch, so slots
              stay full, admission waits behind decode and the
              deadline policy preempts batch rows and sheds late heads;
              no order violation, no crashed thread, the program counts
              unchanged. Prints each seed's instrumented acquires,
              injected preemptions and the engines' own preemptions and
              sheds.

The last line is {"ok": true, "device": {...}}; the line before it is a
JSON object with one entry per kernel instance timed (K1 twice for each
pool and query: phase 3's B 2, T 256 case and the wave, and once more in
bf16 and fp32 at phase 16's verify shape; K2 twice: phase
3's lengths and the serving steady state; K3 three times: phase 3's
lengths, 8 x 512 and 1 x 1024; K1, K2 and K3 again at phase 20's shard
shape). Needs one CUDA
GPU; without one it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import re
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12            # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12,  # dense bf16 tensor cores
              torch.float32: 67e12}    # fp32 outside the tensor cores
SEED = 1234
T_START = time.monotonic()
DEVICE = "cuda"
# GPTConfig overrides for the model of phases 4, 5, 10, 11, 14 and 19's HF
# directory; empty =
# GPT-2 124M (the defaults). A CPU rehearsal of the phases sets a tiny
# model here.
MODEL: dict = {}
# Extra train CLI flags for phase 9, after its own; empty = the config's
# full width. A CPU rehearsal sets a tiny model here.
TRAIN: list = []
TRAIN_CONFIG = "configs/train_gpt2_124m_englishprose_bpe.py"
CORPUS = "data/fixtures/english_prose.txt"
# Phase 9's dataset: english_prose_bpe prepared from this corpus by the
# port's data.prepare, whose train.bin and val.bin must have these
# sha256s. They are what the JAX package's prepare_english_prose_bpe_
# dataset (HF tokenizers) writes from it, computed on the CPU;
# tests/test_torch_data.py recomputes them. A CPU rehearsal points both
# at a slice of the corpus.
BPE_CORPUS = "data/fixtures/english_prose_xl.txt"
BPE_SHA256 = {
    "train.bin":
        "7846504d0359b61a8a3deffc787582c7cb78aee4fb350e552864036b2923e3d8",
    "val.bin":
        "cabcae4c111726dfe60b6c75eaa6792bba2836752484aecb91275fef32c93878"}
# Phase 9's profiler window (the first run's --profile_steps).
PROFILE_STEPS = (20, 22)


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
# phase 2: the build
# ---------------------------------------------------------------------------

# The kernels on the tensor cores, by the name their symbols carry.
TENSOR_CORE_KERNELS = ("flash_fwd_mma_kernel", "flash_bwd_mma_kernel",
                       "flash_bwd_dq_mma_kernel", "paged_prefill_mma_kernel",
                       "flash_fwd_wgmma_kernel", "flash_bwd_wgmma_kernel",
                       "flash_bwd_dq_wgmma_kernel")
# Of those, the ones on wgmma (csrc/flash_attention_sm90.cu: the
# non-causal bf16 K4-K7): their SASS must hold HGMMA, not only HMMA.
WGMMA_KERNELS = ("flash_fwd_wgmma_kernel", "flash_bwd_wgmma_kernel",
                 "flash_bwd_dq_wgmma_kernel")
# CUDA-core kernels whose instances phase 2 holds to 0 spill bytes: the
# f32 ones, K2 and K3.
CUDA_CORE_KERNELS = ("flash_fwd_f32_kernel", "flash_bwd_kv_kernel",
                     "flash_bwd_dq_f32_kernel", "paged_prefill_f32_kernel",
                     "paged_decode_kernel", "flash_fwd_ring_f32_kernel",
                     "flash_bwd_ring_f32_kernel",
                     "flash_bwd_dq_ring_f32_kernel", "flash_decode_kernel")
# Of those, the non-causal fp32 K4-K7 of ring attention's blocks
# (csrc/flash_ring_f32.cuh) by their kinds for ring_f32_launch_shape, each
# with a dropout instance (its last bool template argument); K5 and K7
# are one kernel (its first bool argument says dQ or not), in 32- and
# 64-key blocks (its second integer one), K6 in 32- and 64-query blocks
# (its second integer one). The fp32 K4-K7 of csrc/flash_attention.cu
# are causal only, as are all its bf16 ones (the non-causal bf16 K4-K7
# are on wgmma): no kernel has a causal flag.
RING_F32_KERNELS = (("fwd", "flash_fwd_ring_f32_kernel"),
                    ("fused", "flash_bwd_ring_f32_kernel"),
                    ("dq", "flash_bwd_dq_ring_f32_kernel"),
                    ("dkv", "flash_bwd_ring_f32_kernel"))
HEAD_DIMS = (32, 64, 128)
# The template instances phase 2 must find, as kernel_label names them:
# the bf16 K4, K5 (with dQ), K6 (mma.sync with and without reading dlse)
# and K7 (without dQ), causal on mma.sync and non-causal on wgmma, and K1
# under a bf16 query over each bf16, int8 and int4 pool.
TENSOR_CORE_INSTANCES = tuple(sorted(
    [f"flash_fwd_mma_kernel<D={d}>" for d in HEAD_DIMS]
    + [f"flash_fwd_wgmma_kernel<D={d}>" for d in HEAD_DIMS]
    + [f"flash_bwd_dq_mma_kernel<D={d}, dlse={w}>" for d in HEAD_DIMS
       for w in (0, 1)]
    + [f"flash_bwd_dq_wgmma_kernel<D={d}>" for d in HEAD_DIMS]
    + [f"flash_bwd_{k}mma_kernel<D={d}, dq={w}>" for d in HEAD_DIMS
       for k in ("", "wg") for w in (0, 1)]
    + [f"paged_prefill_mma_kernel<{kv}, D={d}>" for d in HEAD_DIMS
       for kv in ("bf16", "int8", "int4")]))
# The (query, pool) pairs of the f32 K1: an fp32 query over every pool,
# a bf16 query over an fp32 pool.
F32_PREFILL_PAIRS = (("fp32", "fp32"), ("fp32", "bf16"), ("fp32", "int8"),
                     ("fp32", "int4"), ("bf16", "fp32"))
# The causal fp32 K4 and K1 in each of its f32 pairs, with 32- and
# 64-query blocks (BQ); the non-causal fp32 K4, K5 and K7 (the ring
# kernels; K5 and K7 in 32- and 64-key blocks) and K6 (in 32- and
# 64-query blocks), each with and without dropout; the causal fp32 K5
# and K7 of flash_bwd_kv_kernel and K6; K2 and K3 in every (query, pool)
# pair.
CUDA_CORE_INSTANCES = tuple(sorted(
    [f"flash_fwd_f32_kernel<D={d}, BQ={bq}>" for d in HEAD_DIMS
     for bq in (32, 64)]
    + [f"flash_fwd_ring_f32_kernel<D={d}, drop={w}>" for d in HEAD_DIMS
       for w in (0, 1)]
    + [f"flash_bwd_ring_f32_kernel<D={d}, BK={bk}, dq={q}, drop={w}>"
       for d in HEAD_DIMS for bk in (32, 64) for q in (0, 1)
       for w in (0, 1)]
    + [f"flash_bwd_dq_ring_f32_kernel<D={d}, BQ={bq}, drop={w}>"
       for d in HEAD_DIMS for bq in (32, 64) for w in (0, 1)]
    + [f"flash_bwd_kv_kernel<D={d}, dq={w}>" for d in HEAD_DIMS
       for w in (0, 1)]
    + [f"flash_bwd_dq_f32_kernel<D={d}>" for d in HEAD_DIMS]
    + [f"paged_prefill_f32_kernel<q={qd}, kv={kv}, D={d}, BQ={bq}>"
       for d in HEAD_DIMS for qd, kv in F32_PREFILL_PAIRS
       for bq in (32, 64)]
    + [f"{k}<q={qd}, kv={kv}, D={d}>" for d in HEAD_DIMS
       for k in ("paged_decode_kernel", "flash_decode_kernel")
       for qd in ("fp32", "bf16")
       for kv in ("fp32", "bf16", "int8", "int4")]))


def mangled_pair(args: str) -> tuple[str, str]:
    """The (query, pool) template arguments that open a paged kernel's
    mangled arguments: float is f, __nv_bfloat16 13__nv_bfloat16 (or,
    repeated, a substitution S<n>_), int8_t (signed char) a, nsb::Int4 a
    nested name ending in 4Int4E."""
    types = args[1:].split("Li", 1)[0]
    if types.startswith("f"):
        qd, kv = "fp32", types[1:]
    elif types.startswith("13__nv_bfloat16"):
        qd, kv = "bf16", types[len("13__nv_bfloat16"):]
    else:
        return "?", "?"
    kv = ("fp32" if kv == "f" else "int8" if kv == "a"
          else "int4" if "4Int4" in kv
          else "bf16" if kv == "13__nv_bfloat16" or re.fullmatch(r"S\w*_", kv)
          else "?")
    return qd, kv


def ptxas_report(log: str) -> dict:
    """{mangled kernel name: (registers, spill store bytes)} from an
    nvcc -Xptxas -v log."""
    out = {}
    for block in log.split("Compiling entry function '")[1:]:
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores", block)
        out[block.split("'", 1)[0]] = (int(regs.group(1)) if regs else 0,
                                       int(spill.group(1)) if spill else 0)
    return out


def sass_mma_counts(sass: str) -> dict:
    """{mangled kernel name: (HMMA, HGMMA) instruction counts} in
    cuobjdump -sass output: mma.sync's and wgmma's tensor-core
    instructions."""
    return {block.split()[0]: (len(re.findall(r"\bHMMA\.", block)),
                               len(re.findall(r"\bHGMMA\.", block)))
            for block in sass.split("Function : ")[1:]}


def cuobjdump_sass(lib_path: str, nvcc: str) -> str:
    import os

    return subprocess.run(
        [os.path.join(os.path.dirname(nvcc), "cuobjdump"), "-sass",
         lib_path], capture_output=True, text=True, timeout=300,
        check=True).stdout


def kernel_label(mangled: str) -> str:
    """name<template arguments> of a kernel's mangled symbol: the head_dim
    (the first integer argument), the pool's storage type of the paged
    prefill (bf16, int8 = signed char, int4 = nsb::Int4) and, for the f32
    one, the query's type and the queries a block (its second integer),
    whether the backward computes dQ or the mma.sync K6 reads dlse (its
    first bool argument), or a ring kernel is the dropout instance (its
    last) and the keys a block of the ring K5 and K7 or the queries a
    block of the ring K6 (its second integer)."""
    name = next(n for n in TENSOR_CORE_KERNELS + CUDA_CORE_KERNELS
                if n in mangled)
    args = mangled.split(name, 1)[1]
    head_dim = re.search(r"Li(\d+)E", args).group(1)
    bools = re.findall(r"Lb([01])E", args)
    if name == "paged_prefill_f32_kernel":
        qd, kv = mangled_pair(args)
        bq = re.findall(r"Li(\d+)E", args)[1]
        return f"{name}<q={qd}, kv={kv}, D={head_dim}, BQ={bq}>"
    if name in ("paged_decode_kernel", "flash_decode_kernel"):
        qd, kv = mangled_pair(args)
        return f"{name}<q={qd}, kv={kv}, D={head_dim}>"
    if name == "flash_fwd_f32_kernel":
        bq = re.findall(r"Li(\d+)E", args)[1]
        return f"{name}<D={head_dim}, BQ={bq}>"
    if name == "flash_fwd_ring_f32_kernel":
        return f"{name}<D={head_dim}, drop={bools[0]}>"
    if name == "flash_bwd_dq_ring_f32_kernel":
        bq = re.findall(r"Li(\d+)E", args)[1]
        return f"{name}<D={head_dim}, BQ={bq}, drop={bools[0]}>"
    if name == "flash_bwd_ring_f32_kernel":
        bk = re.findall(r"Li(\d+)E", args)[1]
        return (f"{name}<D={head_dim}, BK={bk}, dq={bools[0]}, "
                f"drop={bools[1]}>")
    if name == "paged_prefill_mma_kernel":
        kv = ("bf16" if args.startswith("I13__nv_bfloat16") else
              "int8" if args.startswith("Ia") else
              "int4" if "4Int4" in args.split("Li", 1)[0] else "?")
        return f"{name}<{kv}, D={head_dim}>"
    if name in ("flash_bwd_mma_kernel", "flash_bwd_kv_kernel",
                "flash_bwd_wgmma_kernel"):
        return f"{name}<D={head_dim}, dq={bools[0]}>"
    if name == "flash_bwd_dq_mma_kernel":
        return f"{name}<D={head_dim}, dlse={bools[0]}>"
    return f"{name}<D={head_dim}>"


def check_build(_build) -> None:
    """Builds the kernels; prints each library's ptxas summary, and the
    registers, spill stores and SASS tensor-core instructions of every
    tensor-core kernel and the registers and spill stores of the f32
    CUDA-core kernels (K1 under an fp32 query or over an fp32 pool, K5,
    K6, K7). Fails if an instance is missing, if a tensor-core kernel has
    no HMMA / HGMMA (a wgmma kernel no HGMMA), or if one of either
    spills."""
    _build.library()
    info = _build.build_info
    print(f"  {len(info['libs'])} libraries in {info['seconds']:.1f} s "
          "(one nvcc per source, in parallel)")
    tc, cc = [], []
    for lib in info["libs"]:
        with open(lib["log"]) as f:
            report = ptxas_report(f.read())
        regs = [r for r, _ in report.values()]
        print(f"  {lib['source']} -> {lib['path']} "
              f"({'built' if lib['built'] else 'cached'}); ptxas: "
              f"{len(report)} kernels, registers {min(regs, default=0)}-"
              f"{max(regs, default=0)}, max spill stores "
              f"{max((s for _, s in report.values()), default=0)} bytes")
        names = [n for n in report
                 if any(k in n for k in TENSOR_CORE_KERNELS)]
        if names:
            mma = sass_mma_counts(cuobjdump_sass(lib["path"],
                                                 _build._nvcc()))
            tc += [(kernel_label(n), *report[n], mma.get(n, (0, 0)))
                   for n in names]
        cc += [(kernel_label(n), *report[n]) for n in report
               if any(k in n for k in CUDA_CORE_KERNELS)]
    for kind, want, got in (("tensor-core", TENSOR_CORE_INSTANCES, tc),
                            ("CUDA-core", CUDA_CORE_INSTANCES, cc)):
        found = tuple(sorted(t[0] for t in got))
        if found != want:
            fail(f"expected the {kind} instances {want}, found {found}")
    for label, regs, spill, (hmma, hgmma) in sorted(tc):
        print(f"  {label}: {regs} registers, {spill} bytes spill stores, "
              f"{hmma} HMMA and {hgmma} HGMMA instructions in SASS")
        wgmma = label.split("<", 1)[0] in WGMMA_KERNELS
        if (hgmma if wgmma else hmma + hgmma) == 0 or spill:
            fail(f"{label}: {hmma} HMMA and {hgmma} HGMMA instructions in "
                 f"its SASS, {spill} bytes spilled (needs > 0 "
                 f"{'HGMMA' if wgmma else 'of either'} and 0)")
    for label, regs, spill in sorted(cc):
        print(f"  {label} (CUDA cores): {regs} registers, {spill} bytes "
              "spill stores")
        if spill:
            fail(f"{label}: {spill} bytes spilled (needs 0)")
    from nanosandbox_tpu_torch.ops import attention as at
    from nanosandbox_tpu_torch.ops import flash_decode as fd

    for d in HEAD_DIMS:
        shapes = []
        for qd, qdt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            for kv in fd.KV_MODES:
                sh = fd.dense_decode_launch_shape(qdt, kv, d)
                shapes.append(
                    f"q={qd}, kv={kv}: {sh['registers']} registers, "
                    f"{sh['smem']} + {sh['static_smem']} bytes of shared "
                    f"memory (ring + static), {sh['blocks_per_sm']} blocks "
                    f"an SM, split at {sh['split_at']} positions")
        print(f"  flash_decode_kernel at D={d} ({sh['threads']} threads): "
              + "; ".join(shapes))
    for B, kind, name in ((1, "fwd", "flash_fwd_ring_f32_kernel"),
                          (1, "dq", "flash_bwd_dq_ring_f32_kernel<BQ=32>"),
                          (4, "dq", "flash_bwd_dq_ring_f32_kernel<BQ=64>"),
                          *((b, kind, f"flash_bwd_ring_f32_kernel<BK={bk}, "
                             f"dq={w}>")
                            for kind, w in (("fused", 1), ("dkv", 0))
                            for b, bk in ((1, 32), (4, 64)))):
        for d in HEAD_DIMS:
            sh = at.ring_f32_launch_shape(kind, 12 * B, 1024, d)
            print(f"  {name} at D={d}, B={B} H=12 T=1024 (no dropout): "
                  f"{sh['registers']} registers, {sh['smem']} bytes of "
                  f"shared memory, {sh['threads']} threads, "
                  f"{sh['blocks_per_sm']} blocks an SM")


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


# Phase 3's limits by query dtype: max |err| (both sides take the same
# pool, so only the summation order differs), and the relative limits of
# phase 7.
DECODE_TOL = {torch.float32: dict(abs=1e-5, rel=1e-4),
              torch.bfloat16: dict(abs=2e-2, rel=2e-2)}
KV_ELEMENT_BYTES = {"fp32": 4, "bf16": 2, "int8": 1, "int4": 0.5}
# K3's long rows in check_other_instances: more than twice the positions
# after which any kv mode splits a row (csrc/flash_decode.cu SplitAt).
LONG_ROW = 4200


def pool_in_mode(x, mode):
    """(values, scales) of fp32 x in a kv mode: cast, or quantized with
    the port's quantizers (scales None for the fp modes)."""
    from nanosandbox_tpu_torch.ops import flash_decode as fd

    if mode == "int8":
        return fd.quantize_kv_rows(x)
    if mode == "int4":
        return fd.quantize_kv_rows_int4(x)
    return x.to(torch.bfloat16 if mode == "bf16" else torch.float32), None


def dequantized(x, scale, dtype):
    """The values a pool stands for, in dtype (the yardstick's input)."""
    from nanosandbox_tpu_torch.ops import flash_decode as fd

    if scale is None:
        return x.to(dtype)
    if x.dtype == torch.uint8:
        x = fd.unpack_int4(x)
    return (x.float() * scale[..., None]).to(dtype)


def check_limits(name, got, ref, dtype) -> float:
    """max |err| of got against ref, failing past DECODE_TOL."""
    e = errors(got, ref)
    tol = DECODE_TOL[dtype]
    if not (e["err"] <= tol["abs"] and e["err"] <= tol["rel"] * e["ref"]
            and e["norm"] <= tol["rel"]):
        fail(f"{name}: max |err| {e['err']} (limit {tol['abs']}), max |ref| "
             f"{e['ref']}, ||err|| / ||ref|| {e['norm']} (relative limit "
             f"{tol['rel']})")
    return e["err"]


def decode_bytes(tot, H, D, mode, q_bytes) -> int:
    """Bytes one decode call must move: K and V of the visited positions
    (and their two f32 scales in the quantized modes), q read, out
    written."""
    per_pos = 2 * D * KV_ELEMENT_BYTES[mode] + (8 if mode in ("int8", "int4")
                                                else 0)
    return int(tot * H * per_pos + 2 * q_bytes)


def check_kernels(fd) -> dict:
    import torch.nn.functional as F

    rng = np.random.default_rng(SEED)
    H, D, page, N, nb = 12, 64, 16, 512, 64
    decode_len = np.array([1024, 1, 517, 300, 16, 17, 1, 1], np.int32)
    dk, dv, dtbl = make_case(rng, 8, decode_len, sentinel_rows=(6, 7))
    dq = torch.from_numpy(rng.standard_normal((8, H, D),
                                              dtype=np.float32)).to(DEVICE)
    dlen = torch.from_numpy(decode_len).to(DEVICE)
    # K2 at the serve profile's steady state: 8 slots x 512 positions.
    serve_len = np.full(8, 512, np.int32)
    sk, sv, stbl = make_case(rng, 8, serve_len)
    slen = torch.from_numpy(serve_len).to(DEVICE)
    smask = (torch.arange(512, device=DEVICE)[None, None, None, :]
             < slen[:, None, None, None])
    # K1: B 2 with row 0 cold (start 0) and row 1 after a 64-token hit, at
    # T 128 and 256; and a full admission wave of the default server (8
    # slots x 512 tokens, start 0: serve/profile.py's), under either query.
    prefill = []
    for B, T, s0 in ((2, 128, [0, 64]), (2, 256, [0, 64]), (8, 512, [0] * 8)):
        start = np.array(s0, np.int32)
        pk, pv, ptbl = make_case(rng, B, start + T)
        pq = torch.from_numpy(rng.standard_normal((B, H, T, D),
                                                  dtype=np.float32)).to(DEVICE)
        prefill.append((T, start, pq, pk, pv, ptbl,
                        torch.from_numpy(start).to(DEVICE)))
    # K3's contiguous (B, H, L, D) slot rows: at K2's lengths; at the dense
    # server's steady state, 8 rows x 512 (L 512); and at the sampler's,
    # --num_samples=1 at full block size (1 row x 1024).
    L, tot = int(decode_len.max()), int(decode_len.sum())
    lens = f"lengths={decode_len.tolist()}"
    dense = []
    for rows, Ld, shape in ((decode_len, L, lens),
                            (serve_len, 512, "lengths=8x512"),
                            (np.array([1024], np.int32), 1024,
                             "lengths=[1024]")):
        ck, cv = (torch.from_numpy(rng.standard_normal(
            (len(rows), H, Ld, D), dtype=np.float32)).to(DEVICE)
                  for _ in range(2))
        cq = torch.from_numpy(rng.standard_normal(
            (len(rows), H, D), dtype=np.float32)).to(DEVICE)
        cn = torch.from_numpy(rows).to(DEVICE)
        dense.append((cq, ck, cv, cn, int(rows.sum()),
                      f"B={len(rows)} H={H} D={D} L={Ld} {shape}",
                      torch.arange(Ld, device=DEVICE)[None, None, None, :]
                      < cn[:, None, None, None]))
    dmask = dense[0][6]  # K2's at phase 3's lengths too

    def one(name, dtype, shape, pools, fn, plain, library_qkv, nbytes,
            flops):
        """fn against plain on ``pools`` ((k, k_scale), (v, v_scale)),
        then all three timed (the library call on K/V dequantized
        beforehand, in the query's dtype)."""
        (k, ks), (v, vs) = pools
        kw = {} if ks is None else dict(k_scale=ks, v_scale=vs)
        err = check_limits(f"{name} q {dtype} {shape}", fn(k, v, **kw),
                           plain(k, v, **kw), dtype)
        gq, gk, gv, mask = library_qkv(dequantized(k, ks, dtype),
                                       dequantized(v, vs, dtype))
        return case(name, dtype, shape, err, DECODE_TOL[dtype]["abs"],
                    lambda: fn(k, v, **kw), lambda: plain(k, v, **kw),
                    lambda: F.scaled_dot_product_attention(
                        gq, gk, gv, attn_mask=mask), nbytes, flops)

    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        q = dq.to(dtype)
        qb = q.numel() * q.element_size()
        fp = "fp32" if dtype == torch.float32 else "bf16"
        # K3 over contiguous slot rows, in every kv mode, at its three
        # shapes; on the 1024-position row two calls must give equal bits.
        for cq, ck, cv, cn, total, shape, cmask in dense:
            q3 = cq.to(dtype)
            for mode in ("fp32", "bf16", "int8", "int4"):
                pools = (pool_in_mode(ck, mode), pool_in_mode(cv, mode))
                cases.append(one(
                    f"flash_decode_kernel<{mode}>", dtype, shape, pools,
                    lambda k, v, q3=q3, cn=cn, **kw: fd.flash_decode(
                        q3, k, v, cn, **kw),
                    lambda k, v, q3=q3, cn=cn, **kw:
                        fd.torch_decode_attention(q3, k, v, cn, **kw),
                    lambda k, v, q3=q3, cmask=cmask: (q3[:, :, None], k, v,
                                                      cmask),
                    decode_bytes(total, H, D, mode,
                                 q3.numel() * q3.element_size()),
                    4 * H * D * total))
                if shape.endswith("lengths=[1024]"):
                    (k, ks), (v, vs) = pools
                    kw = {} if ks is None else dict(k_scale=ks, v_scale=vs)
                    if not torch.equal(fd.flash_decode(q3, k, v, cn, **kw),
                                       fd.flash_decode(q3, k, v, cn, **kw)):
                        fail(f"flash_decode_kernel<{mode}> q {dtype} {shape}:"
                             " two calls differ")
        # K2 at the serving decode shape, and K1: over a pool in the
        # query's dtype and over int8 and int4 pools. Under a bf16 query K1
        # is the tensor-core kernel, under an fp32 query the f32 one.
        for mode in (fp, "int8", "int4"):
            tag = "" if mode == fp else f"<{mode}>"
            k1 = (f"paged_prefill_mma_kernel<{mode}>"
                  if dtype == torch.bfloat16
                  else f"paged_prefill_f32_kernel<{mode}>")
            for kk, vv, tbl, n, mask, Lg, shape, total in (
                    (dk, dv, dtbl, dlen, dmask, L, lens, tot),
                    (sk, sv, stbl, slen, smask, 512, "lengths=8x512",
                     int(serve_len.sum()))):
                cases.append(one(
                    f"paged_decode_kernel{tag}", dtype,
                    f"B=8 H={H} D={D} {shape}",
                    (pool_in_mode(kk, mode), pool_in_mode(vv, mode)),
                    lambda k, v, tbl=tbl, n=n, **kw: fd.flash_decode_paged(
                        q, k, v, tbl, n, **kw),
                    lambda k, v, tbl=tbl, n=n, **kw:
                        fd.torch_decode_attention_paged(q, k, v, tbl, n,
                                                        **kw),
                    lambda k, v, tbl=tbl, Lg=Lg, mask=mask: (
                        q[:, :, None], gathered(k, tbl, Lg),
                        gathered(v, tbl, Lg), mask),
                    decode_bytes(total, H, D, mode, qb), 4 * H * D * total))
            for T, start, pq, pk, pv, ptbl, pstart in prefill:
                qT = pq.to(dtype)
                Lp = int((start + T).max())
                qpos = pstart[:, None] + torch.arange(T, device=DEVICE)[None]
                mask = (torch.arange(Lp, device=DEVICE)[None, None, None, :]
                        <= qpos[:, None, :, None])
                cases.append(one(
                    k1, dtype,
                    f"B={len(start)} H={H} T={T} D={D} "
                    f"start={start.tolist()}",
                    (pool_in_mode(pk, mode), pool_in_mode(pv, mode)),
                    lambda k, v, **kw: fd.flash_prefill_paged(
                        qT, k, v, ptbl, pstart, **kw),
                    lambda k, v, **kw: fd.torch_prefill_attention_paged(
                        qT, k, v, ptbl, pstart, **kw),
                    lambda k, v: (qT, gathered(k, ptbl, Lp),
                                  gathered(v, ptbl, Lp), mask),
                    decode_bytes(int((start + T).sum()), H, D, mode,
                                 qT.numel() * qT.element_size()),
                    int(sum(4 * H * D * (s * T + T * T / 2)
                            for s in start))))
    print("  kernel                           dtype     shape"
          + " " * 49 + "max|err|   ms       bound_ms  %bound  plain_ms "
          "library_ms")
    for c in cases:
        print(f"  {c['kernel']:<32} {c['dtype']:<9} {c['shape']:<53} "
              f"{c['max_abs_err']:.2e} {c['ms']:.5f}  {c['bound_ms']:.5f}  "
              f"{100 * c['bound_ms'] / c['ms']:5.1f}%  {c['plain_ms']:.5f}  "
              f"{c['library_ms']:.5f}  [{c['bound_by']}]")
    print("  library_ms: F.scaled_dot_product_attention on K/V gathered into "
          "contiguous rows and dequantized beforehand (it excludes the "
          "gather and the dequantization)")
    check_other_instances(fd, rng)
    return {"cases": cases}


def check_other_instances(fd, rng) -> None:
    """The kernels' other template instances, correctness only, at the
    limits of the timed cases (DECODE_TOL): K1, K2 and K3 at head_dim 32,
    64 and 128 over fp32, bf16, int8 and int4 pools under fp32 and bf16
    queries (a bf16 query over an fp32 pool is --kv_dtype=fp32 under bf16
    compute, which must attend in f32); K1 also at T 100 with starts
    [0, 37] (a start off the page grid, a ragged last query tile, a chunk
    that spans blocks) and at B 8, H 12, T 160 (the f32 K1's 64-query
    blocks); K3 also at L 1000 and 1001 (neither a multiple of 64 nor of
    4: ragged chunks and stages, scales off the 16-byte grid) and on rows
    of LONG_ROW positions, which split in every kv mode (the phase fails
    if a mode's split length P no longer makes them split), two calls
    giving equal bits; and K2 and K3 on decode rows with lengths 0 and -1
    in every kv mode, which see no key and must return 0."""
    def randn(shape, dtype=torch.float32):
        return torch.from_numpy(rng.standard_normal(
            shape, dtype=np.float32)).to(DEVICE, dtype)

    def pools(a, b, mode):
        """k, v and their scale kwargs of fp32 a, b in a kv mode."""
        (k, ks), (v, vs) = pool_in_mode(a, mode), pool_in_mode(b, mode)
        return k, v, {} if ks is None else dict(k_scale=ks, v_scale=vs)

    worst = {}
    for D in fd.HEAD_DIMS:
        lengths = np.array([130, 1, 77], np.int32)
        n = torch.from_numpy(lengths).to(DEVICE)
        empty = torch.tensor([0, 130, -1], dtype=torch.int32, device=DEVICE)
        pk, pv, tbl = make_case(rng, 3, lengths + 40, H=4, D=D, N=64, nb=16)
        ek, ev, etbl = make_case(rng, 3, [0, 130, 0], H=4, D=D, N=64, nb=16)
        ck, cv = randn((3, 4, 256, D)), randn((3, 4, 256, D))
        # K3 at L 1000 and 1001, and on long rows (B 2, H 4).
        odd = [(randn((2, 4, Lo, D)), randn((2, 4, Lo, D)),
                torch.tensor(n, dtype=torch.int32, device=DEVICE), label)
               for Lo, n, label in (
                   (1000, [1000, 999], "L 1000"),
                   (1001, [1001, 513], "L 1001"),
                   (LONG_ROW, [LONG_ROW, LONG_ROW - 63],
                    f"L {LONG_ROW}, split rows"))]
        rstart = np.array([0, 37], np.int32)
        rk, rv, rtbl = make_case(rng, 2, rstart + 100, H=4, D=D, N=64, nb=16)
        rs = torch.from_numpy(rstart).to(DEVICE)
        # B 8, H 12, T 160: the f32 K1's 64-query blocks (288 of them fill
        # the 132 SMs twice over), a ragged last tile, starts off the grid.
        wstart = np.array([0, 37, 0, 16, 5, 0, 64, 100], np.int32)
        wk, wv, wtbl = make_case(rng, 8, wstart + 160, H=12, D=D, N=160,
                                 nb=20)
        ws = torch.from_numpy(wstart).to(DEVICE)
        # K2's split boundaries: rows of lengths Ls - 1, Ls, Ls + 1 and the
        # full capacity, Ls the split length of a (4, 12) call over 64
        # pages of 16 on this card (an H100's 132 SMs in a CPU rehearsal).
        sms = 132 if DEVICE == "cpu" else fd._sm_count(torch.device(DEVICE))
        Ls = fd.decode_splits(4, 12, 64, 16, sms)[1]
        blens = np.array([Ls - 1, Ls, Ls + 1, 64 * 16], np.int32)
        bk, bv, btbl = make_case(rng, 4, blens, H=12, D=D, N=128, nb=64)
        bn = torch.from_numpy(blens).to(DEVICE)
        for qdt in (torch.float32, torch.bfloat16):
            q1, qT = randn((3, 4, D), qdt), randn((3, 4, 40, D), qdt)
            q2 = randn((2, 4, D), qdt)
            qs = randn((4, 12, D), qdt)
            q100 = randn((2, 4, 100, D), qdt)
            q160 = randn((8, 12, 160, D), qdt)
            for mode in fd.KV_MODES:
                if DEVICE != "cpu":
                    P = fd.dense_decode_launch_shape(qdt, mode, D)[
                        "split_at"]
                    if 2 * P >= LONG_ROW:
                        fail(f"flash_decode_kernel q {qdt} kv {mode} D {D} "
                             f"splits a row at {P} positions: rows of "
                             f"{LONG_ROW} no longer split")
                k, v, s = pools(pk, pv, mode)
                k2, v2, s2 = pools(rk, rv, mode)
                k4, v4, s4 = pools(wk, wv, mode)
                k3, v3, s3 = pools(ck, cv, mode)
                ke, ve, se = pools(ek, ev, mode)
                k5, v5, s5 = pools(bk, bv, mode)
                odd_pools = [(pools(a, b, mode), n, label)
                             for a, b, n, label in odd]
                runs = (
                    ("paged decode", fd.flash_decode_paged,
                     fd.torch_decode_attention_paged, (q1, k, v, tbl, n), s),
                    (f"paged decode, lengths {blens.tolist()}",
                     fd.flash_decode_paged, fd.torch_decode_attention_paged,
                     (qs, k5, v5, btbl, bn), s5),
                    ("paged prefill", fd.flash_prefill_paged,
                     fd.torch_prefill_attention_paged, (qT, k, v, tbl, n), s),
                    ("paged prefill, T 100, start [0, 37]",
                     fd.flash_prefill_paged, fd.torch_prefill_attention_paged,
                     (q100, k2, v2, rtbl, rs), s2),
                    ("paged prefill, B 8, H 12, T 160",
                     fd.flash_prefill_paged, fd.torch_prefill_attention_paged,
                     (q160, k4, v4, wtbl, ws), s4),
                    ("decode", fd.flash_decode, fd.torch_decode_attention,
                     (q1, k3, v3, n), s3),
                    ("paged decode, lengths [0, 130, -1]",
                     fd.flash_decode_paged, fd.torch_decode_attention_paged,
                     (q1, ke, ve, etbl, empty), se),
                    ("decode, lengths [0, 130, -1]", fd.flash_decode,
                     fd.torch_decode_attention, (q1, k3, v3, empty), s3),
                    *((f"decode, {label}", fd.flash_decode,
                       fd.torch_decode_attention, (q2, ko, vo, n), so)
                      for (ko, vo, so), n, label in odd_pools))
                for name, fn, plain, args, scales in runs:
                    got = fn(*args, **scales)
                    tag = f"{name} D={D} q={str(qdt)[6:]} kv={mode}"
                    err = check_limits(tag, got, plain(*args, **scales), qdt)
                    if not bool(torch.isfinite(got).all()):
                        fail(f"{tag}: non-finite output")
                    if "[0, 130, -1]" in name and (got[0].any()
                                                   or got[2].any()):
                        fail(f"{tag}: a row with no key did not return 0")
                    if not torch.equal(got, fn(*args, **scales)) and (
                            fn is fd.flash_decode_paged
                            or fn is fd.flash_decode):
                        fail(f"{tag}: two calls differ")
                    worst[name] = max(worst.get(name, 0.0), err)
    print(f"  other instances (D {fd.HEAD_DIMS}, q fp32/bf16, kv "
          f"{fd.KV_MODES}; empty rows zero and finite), worst max "
          "|err| vs plain: " + "; ".join(f"{k} {e:.1e}"
                                         for k, e in worst.items()))


# ---------------------------------------------------------------------------
# phase 4: the fp32 engine against a no-cache recompute
# ---------------------------------------------------------------------------

ENGINE_NEW = 32    # greedy tokens per prompt in phases 4 and 10


def fp32_model_and_prompts():
    """GPT-2 124M in fp32 (seeded random weights) and phase 4's prompts."""
    from nanosandbox_tpu_torch.config import GPTConfig
    from nanosandbox_tpu_torch.models.gpt import GPT

    cfg = GPTConfig(**MODEL, compute_dtype="float32")
    model = GPT(cfg, device=DEVICE,
                generator=torch.Generator(device=DEVICE).manual_seed(SEED))
    rng = np.random.default_rng(SEED + 1)
    prompts = [[int(t) for t in rng.integers(0, prompt_vocab(cfg), n)]
               for n in (16, 77, 160, 300)]
    return model, prompts


def recompute(model, prompts, new=ENGINE_NEW) -> list:
    """Greedy continuations by a no-cache full-sequence forward per token
    (cropped to the last block_size tokens), with the plain attention."""
    out = []
    with torch.no_grad():
        for p in prompts:
            seq = list(p)
            for _ in range(new):
                ctx = seq[-model.cfg.block_size:]
                logits = model(torch.tensor([ctx], device=DEVICE),
                               plain_attention=True)[0, -1]
                seq.append(int(torch.argmax(logits)))
            out.append(seq[len(p):])
    return out


def replay_counts(engine, per_graph: dict) -> dict:
    """The counts of an engine's CUDA graph replays: each graph's
    capture-time counts in ``per_graph`` (``engine.graph_launches`` or
    ``engine.graph_plain_calls``; the wrappers count a capture, not a
    replay) times its replays since they were last zeroed."""
    out: dict = {}
    for graph, n in engine.graph_replays.items():
        for key, per_replay in per_graph[graph].items():
            out[key] = out.get(key, 0) + per_replay * n
    return out


def zero_replays(engine) -> None:
    for graph in engine.graph_replays:
        engine.graph_replays[graph] = 0


def counted_launches(fd, engine) -> dict:
    """Every decode-kernel launch since the counts were zeroed: the
    wrappers' own (eager calls) plus the graph replays'."""
    out = {k: n for k, n in fd.launches.items() if n}
    for key, n in replay_counts(engine, engine.graph_launches).items():
        out[key] = out.get(key, 0) + n
    return out


def counted_plain(fd, at, engine) -> dict:
    """Every plain-version call on the card since the counts were zeroed:
    the plain functions' own (eager calls) plus the graph replays'."""
    out = {**fd.plain_cuda_calls, **at.plain_cuda_calls}
    for key, n in replay_counts(engine, engine.graph_plain_calls).items():
        out[key] += n
    return out


# Kernel names by the instances they count, in a profiler trace.
TRACED_KERNELS = {"K1": "paged_prefill_", "K2": "paged_decode_kernel",
                  "K3": "flash_decode_kernel", "K4": "flash_fwd_"}


# Spin kernels that open every trace: a trace can lose its first records
# (in full runs of this script a one-chunk trace lacked the chunk's
# first ~40 kernels, and a 10 ms spin before it was lost too; a later
# run lost all of a 512-kernel preamble and ~550 records after it).
TRACE_PREAMBLE = 4096


def trace_preamble() -> None:
    """Short kernels that take the place of the records a trace loses;
    no kernel of the traced call ("spin_kernel")."""
    for _ in range(TRACE_PREAMBLE):
        torch.cuda._sleep(1)


def traced_kernels(fn) -> dict:
    """{K1..K4: kernels launched, "all": {kernel: launches}} in a
    torch.profiler trace of fn() (all zero on the CPU, where there is no
    device to trace)."""
    out: dict = dict.fromkeys(TRACED_KERNELS, 0)
    out["all"] = {}
    if DEVICE == "cpu":
        fn()
        return out
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        trace_preamble()
        fn()
        sync()
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        out["all"][e.key[:70]] = e.count
        for k, name in TRACED_KERNELS.items():
            if name in e.key:
                out[k] += e.count
    return out


def graph_trace(name: str, engine) -> dict:
    """Every CUDA graph of an idle engine replayed once over its parked
    slots, under one trace: each graph's capture-time count of its decode
    kernel (K2 paged, K3 dense) must be its rung x n_layer x tp (one
    launch a layer and shard), and the trace
    must show their sum. So a launch count taken as capture counts x
    replays (counted_launches) is what the card ran. Returns the kernel,
    the captured sum and the traced count ({} without graphs: the CPU)."""
    if not engine._graphs:
        return {}
    kernel = "K2" if engine.paged else "K3"
    key = (f"flash_decode{'_paged' if engine.paged else ''}/"
           f"{engine.kv_dtype}")
    captured = {g: engine.graph_launches[g].get(key, 0)
                for g in engine._graphs}
    want = {g: g[0] * engine.cfg.n_layer * engine.tp for g in engine._graphs}

    def replay_all():
        for g in engine._graphs:
            engine._copied_wait(engine._dispatch(*g))

    if engine.has_work():
        fail(f"{name}: graph_trace on a busy engine")
    traced = traced_kernels(replay_all)
    out = {"kernel": kernel, "captured": sum(captured.values()),
           "traced": traced[kernel]}
    if captured != want or out["traced"] != out["captured"]:
        fail(f"{name}: {key} launches captured per graph {captured} (want "
             f"rung x n_layer x tp {want}), traced over one replay of each "
             f"{out['traced']}; the trace: {traced['all']}")
    return out


def run_engine(model, prompts, *, sampling=None, new=ENGINE_NEW,
               eager=False, trace=False, graphs=True, keep=False,
               **kw) -> dict:
    """One engine (8 slots x 1024) drained over the prompts (greedy, or
    each with its keywords from ``sampling``), with every count reset
    just before: tokens per prompt, wall time, the decode kernels'
    launches (counted_launches) and plain-version calls on the card, and
    the flash forward's launches (the dense prefill's K4). ``eager``
    runs the decode body without its graphs (the engine's private entry,
    phase 14's reference); ``trace`` counts the run's kernels in a
    torch.profiler trace. Then, unless ``graphs`` is False (the plain
    controls, whose graphs hold no kernel), each of the engine's graphs
    replayed once under a trace (graph_trace). ``keep`` returns the
    idle engine too, under "engine"."""
    from nanosandbox_tpu_torch.ops import attention as at
    from nanosandbox_tpu_torch.ops import flash_decode as fd
    from nanosandbox_tpu_torch.serve.engine import Engine

    engine = Engine(model, num_slots=8, max_len=1024, device=DEVICE, **kw)
    if eager:
        engine._replay = False
    fd.reset_counts()
    at.reset_counts()
    rids: list = []
    done: dict = {}

    def drain():
        rids.extend(engine.submit(p, new, **(sampling[i] if sampling
                                              else {}))
                    for i, p in enumerate(prompts))
        done.update((r.rid, r) for r in engine.drain())
        sync()

    t0 = time.monotonic()
    traced = traced_kernels(drain) if trace else drain()
    out = {"tokens": [done[r].tokens for r in rids],
           "wall_s": time.monotonic() - t0,
           "launches": counted_launches(fd, engine),
           "k4_launches": at.launches["flash_attention_fwd"],
           "plain_cuda_calls": counted_plain(fd, at, engine),
           "stats": engine.stats()}
    if trace:
        out["traced"] = traced
    if graphs:
        out["graph_trace"] = graph_trace(f"the engine {kw}", engine)
    if keep:
        out["engine"] = engine
    del engine
    if DEVICE != "cpu" and not keep:
        torch.cuda.empty_cache()
    return out


def need_launches(name: str, run: dict, keys) -> None:
    """Fail unless every kernel instance in keys launched in the run, and
    no plain version ran on the card."""
    missing = [k for k in keys if not run["launches"].get(k)]
    if missing:
        fail(f"{name} bypassed a kernel: {missing} never launched "
             f"({run['launches']})")
    if any(run["plain_cuda_calls"].values()):
        fail(f"{name}: plain versions ran on the card: "
             f"{run['plain_cuda_calls']}")


def check_engine_fp32(model, prompts, ref) -> dict:
    """The paged fp32 engine's greedy tokens against the recompute."""
    run = run_engine(model, prompts)
    mismatches = sum(got != want for got, want in zip(run["tokens"], ref))
    print(f"  fp32 engine: {len(prompts)} prompts (lengths "
          f"{[len(p) for p in prompts]}), {ENGINE_NEW} greedy tokens each, "
          f"{run['wall_s']:.3f} s; launches {run['launches']}; token "
          f"mismatches vs no-cache recompute: {mismatches}; each graph "
          f"replayed once, traced {run['graph_trace']}")
    if mismatches:
        fail("fp32 engine greedy tokens differ from the recompute")
    need_launches("the fp32 engine", run, ("flash_decode_paged/fp32",
                                           "flash_prefill_paged/fp32"))
    return run


# ---------------------------------------------------------------------------
# phase 5: the bf16 server
# ---------------------------------------------------------------------------

def post(base, body, timeout=300):
    req = urllib.request.Request(base + "/generate",
                                 data=json.dumps(body).encode())
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def server_rounds(cfg) -> list:
    """Phase 5's requests, two rounds of three /generate bodies (greedy
    and top-k sampled); the second round's first request shares a
    128-token prefix with the first round's first."""
    rng = np.random.default_rng(SEED + 2)

    def toks(n):
        return [int(t) for t in rng.integers(0, prompt_vocab(cfg), n)]

    shared = toks(128)
    return [
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


def check_server(fd, smi: str, flags=(), need=("flash_decode_paged/bf16",
                                               "flash_prefill_paged/bf16"),
                 ) -> dict:
    """GPT-2 124M in bf16 behind the server's own code path, with extra
    server flags (phase 5: none; phase 11: --paged=off, --kv_dtype=...):
    6 requests in two rounds, every answer 200 with in-vocab tokens, and
    the kernel instances ``need`` launched with no plain version on the
    card. Paged servers must also show a prefix hit."""
    from nanosandbox_tpu_torch.checkpoint import save_for_serving
    from nanosandbox_tpu_torch.config import GPTConfig
    from nanosandbox_tpu_torch.models.gpt import GPT
    from nanosandbox_tpu_torch.ops import attention as at
    from nanosandbox_tpu_torch.serve.__main__ import build_server

    cfg = GPTConfig(**MODEL)                     # bf16 compute
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as out_dir:
        model = GPT(cfg, device=DEVICE, generator=torch.Generator(
            device=DEVICE).manual_seed(SEED))
        save_for_serving(out_dir, cfg, model.state_dict())
        del model
        server, loop, engine = build_server([
            f"--out_dir={out_dir}", "--host=127.0.0.1", "--port=0",
            "--num_slots=8", "--max_len=1024", "--kv_page_size=16",
            f"--device={DEVICE}", *flags])
    # The serving path is the main path: counts start after the warmup,
    # with the loop idle.
    fd.reset_counts()
    at.reset_counts()
    zero_replays(engine)
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    new = 64
    rounds = server_rounds(cfg)
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
        launches = counted_launches(fd, engine)
        launches["flash_attention_fwd"] = at.launches["flash_attention_fwd"]
        plain = counted_plain(fd, at, engine)
    finally:
        server.shutdown()
        server.server_close()
        loop.stop()
        loop.join(timeout=60)
        th.join(timeout=60)
    engine.drain()
    graphs = graph_trace(f"the server {list(flags)}", engine)
    for i, a in enumerate(answers):
        if a is None or a[0] != 200:
            fail(f"request {i}: {a}")
        t = a[1]["tokens"]
        if len(t) != new or not all(0 <= x < cfg.vocab_size for x in t):
            fail(f"request {i}: {len(t)} tokens, in-vocab "
                 f"{all(0 <= x < cfg.vocab_size for x in t)}")
    if health != (200, {"ok": True}):
        fail(f"/healthz {health}")
    label = (f"bf16 server ({'paged' if stats['paged'] else 'dense'}, "
             f"kv {stats['kv_dtype']})")
    need_launches(f"the {label}", {"launches": launches,
                                   "plain_cuda_calls": plain}, need)
    hits = "none (dense pool)"
    if stats["paged"]:
        hits = stats["kv_pool"]["prefix_hit_requests"]
        if hits < 1:
            fail(f"no prefix hit: {stats['kv_pool']}")
        hits = f"{hits} ({stats['kv_pool']['prefix_hit_tokens']} tokens)"
    total = sum(len(a[1]["tokens"]) for a in answers)
    print(f"  {label}: 6/6 answered 200 with {new} in-vocab tokens, "
          f"/healthz ok, prefix hits {hits}; launches {launches}; each "
          f"graph replayed once, traced {graphs}")
    print(f"  [{smi}] decode {stats['decode_tokens_per_sec']:.1f} tok/s "
          f"(engine window), {total / wall:.1f} tok/s end to end over "
          f"{wall:.3f} s; TTFT p50 {stats['ttft_s']['p50'] * 1e3:.2f} ms; "
          f"TPOT p50 {stats['tpot_s']['p50'] * 1e3:.3f} ms; decode steps "
          f"{stats['decode_steps']}, prefill waves {stats['prefill_waves']}")
    return {"launches": launches, "plain_cuda_calls": plain,
            "stats": stats, "wall_s": wall, "tokens": total,
            "answers": [a[1]["tokens"] for a in answers]}


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


def check_attention(at, name, q, k, v, do, rate=0.0, seed=None,
                    zero_ref=(), causal=True, dlse=None,
                    hash_seq_len=None) -> dict:
    """K4, K5 and K6 + K7 on one case against the plain versions on the
    same inputs (the backward's: the kernel forward's o and lse), causal
    or not, the backward given the lse cotangent dlse if any. Returns the
    errors of each output; fails past TRAIN_TOL, if the split backward
    differs between two calls, or if the non-causal fp32 fused backward's
    dK or dV (flash_bwd_ring_f32_kernel) does. zero_ref names the
    gradients ("dq", "dk") that are 0 in exact arithmetic (T = 1: one key,
    so the softmax is 1 whatever the score and dS = 0): both sides then
    hold rounding noise of the f32 row term, the relative limits have no
    scale, and those outputs are held to the absolute limit alone."""
    fwd_kw = dict(dropout_rate=rate, seed=seed, causal=causal,
                  hash_seq_len=hash_seq_len)
    kw = dict(fwd_kw, dlse=dlse)
    o, lse = at.flash_attention_fwd(q, k, v, **fwd_kw)
    ro, rlse = at.torch_flash_attention(q, k, v, **fwd_kw)
    ref = at.torch_flash_attention_bwd(q, k, v, o, lse, do, **kw)
    if at.BWD_IMPL != "fused":
        fail(f"BWD_IMPL is {at.BWD_IMPL!r}, phase 7 checks 'fused' as K5")
    fused = at.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    ring_f32 = q.dtype == torch.float32 and not causal
    fused2 = at.flash_attention_bwd(q, k, v, o, lse, do, **kw) if ring_f32 \
        else fused

    def split_bwd():
        return (at.flash_attention_bwd_dq(q, k, v, o, lse, do, **kw),
                *at.flash_attention_bwd_dkv(q, k, v, o, lse, do, **kw))

    split, split2 = split_bwd(), split_bwd()
    sync()
    errs = {"o": errors(o, ro), "lse": errors(lse, rlse)}
    for impl, got in (("fused", fused), ("split", split)):
        for g_name, g, r in zip(("dq", "dk", "dv"), got, ref):
            errs[f"{impl}_{g_name}"] = errors(g, r)
    name += (f" {str(q.dtype)[6:]}" + ("" if causal else " non-causal")
             + ("" if dlse is None else " dlse")
             + (f" dropout {rate}" if rate else ""))
    tol = TRAIN_TOL[q.dtype]
    for key, e in errs.items():
        lim = tol["o"] if key in ("o", "lse") else tol["g"]
        zero = key.split("_")[-1] in zero_ref
        if not (e["err"] <= lim and (zero or (
                e["err"] <= tol["rel"] * e["ref"]
                and e["norm"] <= tol["rel"]))):
            fail(f"flash attention {name}: {key} max |err| {e['err']} "
                 f"(limit {lim}), max |ref| {e['ref']} (max |err| / max "
                 f"|ref| limit {tol['rel']}), ||err|| / ||ref|| {e['norm']} "
                 f"(limit {tol['rel']})")
    if not all(torch.equal(a, b) for a, b in zip(split, split2)):
        fail(f"flash attention {name}: the split backward is not "
             "deterministic")
    if not all(torch.equal(a, b) for a, b in zip(fused[1:], fused2[1:])):
        fail(f"flash attention {name}: the fused backward's dK or dV "
             "differs between two calls")
    return {"case": name, **errs}


def train_bound(kind, B, H, T, D, es, causal=True,
                dlse=False) -> tuple[int, int]:
    """(bytes, flops) one call must move and do: each input read once,
    each output written once (lse, and a backward's dlse, 4 bytes a row);
    causal, T(T+1)/2 score elements per (row, head), else T^2; 2 D flops
    per element per product."""
    bhtd, bht = B * H * T * D, B * H * T
    pairs = B * H * T * (T + 1) // 2 if causal else B * H * T * T
    tensors, products = {"fwd": (4, 2), "fused": (8, 5), "dq": (6, 3),
                         "dkv": (7, 4)}[kind]
    stats = 4 * bht * (2 if dlse and kind != "fwd" else 1)
    return tensors * bhtd * es + stats, 2 * D * pairs * products


def check_train_kernels(at) -> dict:
    rng = np.random.default_rng(SEED + 3)
    B, H, T, D = 16, 12, 1024, 64
    shape = f"B={B} H={H} T={T} D={D}"
    # The 124M training shape in bf16 and fp32: the inputs the times below
    # use.
    timed = {torch.bfloat16: qkv(rng, B, H, T, D, torch.bfloat16)}
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        if dtype not in timed:
            timed[dtype] = qkv(rng, B, H, T, D, dtype)
        rows.append(check_attention(at, shape, *timed[dtype]))
        rows.append(check_attention(at, f"B=2 H={H} T={T} D={D}",
                                    *qkv(rng, 2, H, T, D, dtype), rate=0.1,
                                    seed=SEED))
        for d in (32, 128):
            rows.append(check_attention(at, f"B=2 H=4 T=256 D={d}",
                                        *qkv(rng, 2, 4, 256, d, dtype)))
        rows.append(check_attention(at, f"B=2 H=4 T=200 D={D}",
                                    *qkv(rng, 2, 4, 200, D, dtype), rate=0.1,
                                    seed=[7, 0, 0, 3, 5]))
    # bf16 only, the tensor-core kernels' tile edges: a ragged last tile
    # after a long walk, one partial tile, head_dim 128 with dropout.
    bf = torch.bfloat16
    rows.append(check_attention(at, f"B=1 H={H} T=1000 D={D}",
                                *qkv(rng, 1, H, 1000, D, bf)))
    rows.append(check_attention(at, f"B=1 H=1 T=1 D={D}",
                                *qkv(rng, 1, 1, 1, D, bf),
                                zero_ref=("dq", "dk")))
    rows.append(check_attention(at, f"B=1 H=1 T=17 D={D}",
                                *qkv(rng, 1, 1, 17, D, bf)))
    rows.append(check_attention(at, "B=2 H=4 T=256 D=128",
                                *qkv(rng, 2, 4, 256, 128, bf), rate=0.1,
                                seed=SEED))
    print("  each output: max |err| of max |ref| (||err|| / ||ref||)")
    for r in rows:
        print(f"  {r['case']}:\n    " + ", ".join(
            f"{k} {e['err']:.1e} of {e['ref']:.1e} ({e['norm']:.1e})"
            for k, e in r.items() if k != "case"))

    # Times at the 124M training shape on the inputs checked above: every
    # kernel in bf16 and in fp32 (the fp32 engines' dense prefill and phase
    # 8's path; TF32 off) as "fwd_fp32", "fused_fp32", "dq_fp32" and
    # "dkv_fp32".
    kinds = ("fwd", "fused", "dq", "dkv")
    cases = time_train_kernels(at, timed[torch.bfloat16], kinds)
    for kind, c in time_train_kernels(at, timed[torch.float32],
                                      kinds).items():
        cases[f"{kind}_fp32"] = c
    print(f"  times at {shape}: kernel       ms        bound_ms  %bound  "
          "plain_ms  library_ms")
    for kind, c in cases.items():
        lib = ("-" if c["library_ms"] is None
               else f"{c['library_ms']:.5f}")
        print(f"  {kind:<10} {c['ms']:.5f}  {c['bound_ms']:.5f}  "
              f"{100 * c['bound_ms'] / c['ms']:5.1f}%  {c['plain_ms']:.5f}  "
              f"{lib}  [{c['bound_by']}]")
    for dt, tag in (("bf16", ""), ("fp32", "_fp32")):
        split = cases[f"dq{tag}"]["ms"] + cases[f"dkv{tag}"]["ms"]
        print(f"  {dt} backward: fused {cases['fused' + tag]['ms']:.5f} ms, "
              f"split (K6 + K7) {split:.5f} ms, SDPA backward (dQ, dK, dV) "
              f"{cases['fused' + tag]['library_ms']:.5f} ms")
    # The max |err| reported beside each time: that of the timed inputs.
    outputs = {"fwd": ("o", "lse"), "fused": ("fused_dq", "fused_dk",
                                              "fused_dv"),
               "dq": ("split_dq",), "dkv": ("split_dk", "split_dv")}
    for kind, c in cases.items():
        base, _, fp32 = kind.partition("_")
        row = next(r for r in rows if r["case"] == f"{shape} "
                   + ("float32" if fp32 else "bfloat16"))
        c["max_abs_err"] = max(row[n]["err"] for n in outputs[base])
    return cases


# Ring attention's block shapes: phase 13's run (B 1, H 12, a zigzag
# half-chunk of the 8192-token sequence over 4 ranks: 1024, D 64), and the
# same at configs/train_longcontext_8k.py's committed batch_size = 4
# (phase 13 cuts it to 1).
RING_BLOCKS = ((1, 12, 1024, 64), (4, 12, 1024, 64))
RING_T = 8192
# Correctness only, bf16, the non-causal wgmma K4, K5, K6 and K7 at
# their tile edges: (B, H, T, D, with dlse, dropout rate): head_dim 32 and
# 128, ragged and partial tiles, a single key, several rows and heads.
RING_EDGES = ((2, 4, 256, 32, True, 0.0), (2, 4, 256, 128, True, 0.1),
              (2, 4, 200, 64, False, 0.1), (1, 1, 17, 64, False, 0.0),
              (1, 1, 1, 64, True, 0.0), (1, 12, 1000, 64, True, 0.0),
              (3, 2, 33, 32, True, 0.1), (1, 3, 65, 128, False, 0.0))
# The same for the fp32 ones (the non-causal K4-K7 of
# csrc/flash_ring_f32.cuh), at phase 7's fp32 limits:
# head_dim 32 and 128, a ragged last tile after a long walk, ragged key
# and query tiles, a tail of one, a partial tile, a single key.
RING_EDGES_F32 = ((2, 4, 256, 32, True, 0.0), (2, 4, 256, 128, True, 0.1),
                  (1, 12, 1000, 64, True, 0.0), (2, 4, 200, 64, False, 0.1),
                  (1, 3, 65, 128, False, 0.0), (3, 2, 65, 32, True, 0.1),
                  (1, 1, 17, 64, True, 0.0), (1, 1, 1, 64, True, 0.0),
                  (1, 2, 1, 32, False, 0.1))


def print_ring_shapes(at) -> None:
    """The grid, blocks an SM (the occupancy the kernel's registers and
    shared memory allow) and waves of the wgmma K4, K5, K6 and K7 and of
    the non-causal fp32 ones at each ring block shape."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for B, H, T, D in RING_BLOCKS:
        for kind, name, shape in (
                ("fwd", "flash_fwd_wgmma_kernel", at.wgmma_launch_shape),
                ("fused", "flash_bwd_wgmma_kernel<dq=1>",
                 at.wgmma_launch_shape),
                ("dq", "flash_bwd_dq_wgmma_kernel", at.wgmma_launch_shape),
                ("dkv", "flash_bwd_wgmma_kernel<dq=0>",
                 at.wgmma_launch_shape),
                *((kind, f"{name} ({kind})", at.ring_f32_launch_shape)
                  for kind, name in RING_F32_KERNELS)):
            sh = shape(kind, B * H, T, D)
            n = sh["grid"][0] * sh["grid"][1]
            print(f"  {name} at B={B} H={H} T={T} D={D}: grid "
                  f"{sh['grid']} = {n} blocks of {sh['threads']} threads, "
                  f"{sh['blocks_per_sm']} blocks an SM, "
                  f"{n / (sh['blocks_per_sm'] * sms):.2f} waves on {sms} "
                  "SMs")


def check_ring_edges(at, rng, dtype, edges, rows: list) -> None:
    """The non-causal kernels in ``dtype`` at each (B, H, T, D, with dlse,
    dropout rate) of ``edges`` against their plain versions (check_attention;
    at T 1 dq and dk are 0 in exact arithmetic), rows appended to
    ``rows``."""
    for B, H, T, D, with_dlse, rate in edges:
        inputs = qkv(rng, B, H, T, D, dtype)
        dlse = (torch.from_numpy(0.1 * rng.standard_normal(
            (B, H, T), dtype=np.float32)).to(DEVICE) if with_dlse else None)
        seed = torch.tensor([SEED, 0, 0, 5 * T, 2 * T], device=DEVICE)
        rows.append(check_attention(
            at, f"B={B} H={H} T={T} D={D}", *inputs, causal=False, dlse=dlse,
            rate=rate, seed=seed, hash_seq_len=RING_T,
            zero_ref=("dq", "dk") if T == 1 else ()))


# The kernels of one non-causal fp32 call of each kind, by name: all of
# csrc/flash_ring_f32.cuh, and every one of them launched.
RING_F32_CALL_KERNELS = {
    "fwd": {"flash_fwd_ring_f32_kernel"},
    "fused": {"flash_bwd_ring_prep_kernel", "flash_bwd_ring_f32_kernel"},
    "split": {"flash_bwd_dq_ring_f32_kernel", "flash_bwd_ring_prep_kernel",
              "flash_bwd_ring_f32_kernel"}}


def profile_ring_calls(at, rng, calls: int = 10) -> None:
    """Each kernel of one non-causal K4 call, K5 call and split backward
    (K6 then K7; the backwards given a random lse cotangent) in bf16 and
    fp32 at each of RING_BLOCKS, by torch.profiler's device time (warm L2,
    ``calls`` calls, no launch gaps): what of a call's time_ms lies in its
    kernels. Fails unless an fp32 call's kernels are RING_F32_CALL_KERNELS
    of its kind."""
    from torch.profiler import ProfilerActivity, profile

    for (B, H, T, D), dtype in [(b, dt) for b in RING_BLOCKS for dt in (
            torch.bfloat16, torch.float32)]:
        q, k, v, do = qkv(rng, B, H, T, D, dtype)
        dlse = torch.from_numpy(0.1 * rng.standard_normal(
            (B, H, T), dtype=np.float32)).to(DEVICE)
        o, lse = at.flash_attention_fwd(q, k, v, causal=False)
        for kind, fn in (
                ("fwd", lambda: at.flash_attention_fwd(q, k, v,
                                                       causal=False)),
                ("fused", lambda: at.flash_attention_bwd(
                    q, k, v, o, lse, do, causal=False, dlse=dlse)),
                ("split", lambda: (at.flash_attention_bwd_dq(
                    q, k, v, o, lse, do, causal=False, dlse=dlse),
                    at.flash_attention_bwd_dkv(
                        q, k, v, o, lse, do, causal=False, dlse=dlse)))):
            fn()
            sync()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                trace_preamble()
                for _ in range(calls):
                    fn()
                sync()
            us = {re.sub(r"\(anonymous namespace\)::", "",
                         e.key).split("(")[0]: e.self_device_time_total / calls
                  for e in prof.key_averages()
                  if e.self_device_time_total > 0
                  and "spin_kernel" not in e.key}
            names = {n.removeprefix("void ").split("<")[0] for n in us}
            want = RING_F32_CALL_KERNELS[kind]
            if dtype == torch.float32 and names != want:
                fail(f"the non-causal fp32 {kind} call at B={B} launched "
                     f"{sorted(names)}, not {sorted(want)}")
            print(f"  {kind} {str(dtype)[6:]} at B={B} H={H} T={T} D={D}, a "
                  "call's kernels (us, warm L2): " + ", ".join(
                      f"{n} {t:.2f}" for n, t in sorted(
                          us.items(), key=lambda kv: -kv[1])))


def check_ring_blocks(at) -> dict:
    """The instances ring attention adds (ops/ring_attention.py): K4
    non-causal with its lse, K5 and K6 + K7 non-causal given a random lse
    cotangent, at each of RING_BLOCKS: in bf16 without and with dropout
    0.1 (seed words of a late-half query block against an early-half key
    block, hashed over the global 8192 positions), in fp32 (TF32 off)
    without (and at B 1 with) it. Each is held to its plain version at
    TRAIN_TOL and timed beside its bound (T^2 score elements), its plain
    version and SDPA (is_causal=False, no dropout, no lse cotangent); then
    the RING_EDGES and RING_EDGES_F32 cases, correctness only. Returns the
    timed cases keyed "<kind>[_fp32][_dropout][_b4]", with the max |err|
    of their check."""
    rng = np.random.default_rng(SEED + 13)
    cases, rows = {}, []
    outputs = {"fwd": ("o", "lse"), "fused": ("fused_dq", "fused_dk",
                                              "fused_dv"),
               "dq": ("split_dq",), "dkv": ("split_dk", "split_dv")}
    for B, H, T, D in RING_BLOCKS:
        shape = f"B={B} H={H} T={T} D={D} non-causal"
        btag = "" if B == 1 else f"_b{B}"
        for dtype, tag, rates in ((torch.bfloat16, "", (0.0, 0.1)),
                                  (torch.float32, "_fp32",
                                   (0.0, 0.1) if B == 1 else (0.0,))):
            for rate in rates:
                inputs = qkv(rng, B, H, T, D, dtype)
                dlse = torch.from_numpy(0.1 * rng.standard_normal(
                    (B, H, T), dtype=np.float32)).to(DEVICE)
                # The seed words on the card, as the ring makes them: a
                # host list would be copied in every timed call, behind
                # the stream.
                seed = torch.tensor([SEED, 0, 0, 5 * T, 2 * T],
                                    device=DEVICE)
                kw = dict(rate=rate, seed=seed, hash_seq_len=RING_T)
                row = check_attention(at, shape, *inputs, causal=False,
                                      dlse=dlse, **kw)
                rows.append(row)
                timed = time_train_kernels(at, inputs, ("fwd", "fused", "dq",
                                                        "dkv"),
                                           causal=False, dlse=dlse, **kw)
                for kind, c in timed.items():
                    c["max_abs_err"] = max(row[n]["err"]
                                           for n in outputs[kind])
                    c["shape"] = shape + (" dlse" if kind != "fwd" else "")
                    cases[kind + tag + ("_dropout" if rate else "")
                          + btag] = c
    for dtype, edges in ((torch.bfloat16, RING_EDGES),
                         (torch.float32, RING_EDGES_F32)):
        check_ring_edges(at, rng, dtype, edges, rows)
    print("  ring blocks, each output: max |err| of max |ref| "
          "(||err|| / ||ref||)")
    for r in rows:
        print(f"  {r['case']}:\n    " + ", ".join(
            f"{k} {e['err']:.1e} of {e['ref']:.1e} ({e['norm']:.1e})"
            for k, e in r.items() if k != "case"))
    print_ring_shapes(at)
    print("  times of the ring blocks (backward with dlse; SDPA: "
          "non-causal, no dropout, no lse cotangent):\n  kernel"
          "                 ms        bound_ms  %bound  plain_ms  "
          "library_ms")
    for kind, c in cases.items():
        lib = ("-" if c["library_ms"] is None
               else f"{c['library_ms']:.5f}")
        print(f"  {kind:<21} {c['ms']:.5f}  {c['bound_ms']:.5f}  "
              f"{100 * c['bound_ms'] / c['ms']:5.1f}%  {c['plain_ms']:.5f}  "
              f"{lib}  [{c['bound_by']}]  {c['shape']}")
    for dt, tag in [(dt, tag + ("" if b[0] == 1 else f"_b{b[0]}"))
                    for b in RING_BLOCKS
                    for dt, tag in (("bf16", ""), ("fp32", "_fp32"))]:
        split = cases[f"dq{tag}"]["ms"] + cases[f"dkv{tag}"]["ms"]
        fused = cases["fused" + tag]
        print(f"  {dt} ring-block backward at {fused['shape']}: fused "
              f"{fused['ms']:.5f} ms, split (K6 + K7) {split:.5f} ms, SDPA "
              f"backward (dQ, dK, dV; no dlse) {fused['library_ms']:.5f} ms")
    profile_ring_calls(at, rng)
    return cases


def time_train_kernels(at, inputs, kinds, causal=True, dlse=None, rate=0.0,
                       seed=None, hash_seq_len=None) -> dict:
    """Each kind's ("fwd", "fused", "dq", "dkv") time on (q, k, v, dO),
    causal or not (the backward with dlse if given, dropout at ``rate``),
    beside its bound, its plain version and F.scaled_dot_product_attention
    (is_causal as the kernels, no dropout and no lse cotangent; forward,
    and forward+backward minus forward; none for dQ or dK/dV alone)."""
    import torch.nn.functional as F

    q, k, v, do = inputs
    B, H, T, D = q.shape
    dtype = q.dtype
    fkw = dict(causal=causal, dropout_rate=rate, seed=seed,
               hash_seq_len=hash_seq_len)
    bkw = dict(fkw, dlse=dlse)
    o, lse = at.flash_attention_fwd(q, k, v, **fkw)
    qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal)

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa(), (qg, kg, vg), do)

    with torch.no_grad():
        sdpa_fwd = time_ms(sdpa)
    sdpa_bwd = time_ms(sdpa_fwd_bwd) - sdpa_fwd
    plain_bwd = time_ms(lambda: at.torch_flash_attention_bwd(q, k, v, o, lse,
                                                             do, **bkw))
    runs = {"fwd": (lambda: at.flash_attention_fwd(q, k, v, **fkw),
                    lambda: at.torch_flash_attention(q, k, v, **fkw),
                    sdpa_fwd),
            "fused": (lambda: at.flash_attention_bwd(q, k, v, o, lse, do,
                                                     **bkw),
                      None, sdpa_bwd),
            "dq": (lambda: at.flash_attention_bwd_dq(q, k, v, o, lse, do,
                                                     **bkw),
                   None, None),
            "dkv": (lambda: at.flash_attention_bwd_dkv(q, k, v, o, lse, do,
                                                       **bkw),
                    None, None)}
    cases = {}
    for kind in kinds:
        fn, plain, library = runs[kind]
        nbytes, flops = train_bound(kind, B, H, T, D, q.element_size(),
                                    causal, dlse is not None)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
        with torch.no_grad():
            plain_ms = time_ms(plain) if plain is not None else plain_bwd
        cases[kind] = dict(
            ms=time_ms(fn), plain_ms=plain_ms, library_ms=library,
            bytes=nbytes, flops=flops, bound_ms=1e3 * max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            dtype=str(dtype)[6:], shape=f"B={B} H={H} T={T} D={D}")
    return cases


# ---------------------------------------------------------------------------
# phase 8: the fp32 124M loss and gradients, kernels against plain
# ---------------------------------------------------------------------------

def check_train_parity(at) -> dict:
    """Without dropout, and with dropout 0.1: the kernels with the fused
    backward (K5), the kernels with the split one (K6 + K7) and the plain
    attention each draw their per-layer attention seeds and residual
    masks from generators seeded alike, so they drop the same elements
    and must agree as closely. Returns the kernel passes' launches (the
    fp32 K4-K7), summed."""
    from nanosandbox_tpu_torch.config import GPTConfig
    from nanosandbox_tpu_torch.models.gpt import GPT, cross_entropy_loss

    rng = np.random.default_rng(SEED + 4)
    kernel_launches: dict = {}
    need = {"fused": ("flash_attention_fwd", "flash_attention_bwd_fused"),
            "split": ("flash_attention_fwd", "flash_attention_bwd_dq",
                      "flash_attention_bwd_dkv")}
    for dropout in (0.0, 0.1):
        cfg = GPTConfig(**MODEL, compute_dtype="float32", dropout=dropout)
        model = GPT(cfg, device=DEVICE, generator=torch.Generator(
            device=DEVICE).manual_seed(SEED))
        x, y = (torch.from_numpy(rng.integers(0, prompt_vocab(cfg),
                                              (2, cfg.block_size)))
                .to(DEVICE) for _ in range(2))
        params = [p for _, p in model.named_parameters()]
        out = {}
        for impl in ("fused", "split", "plain"):
            gen = (torch.Generator(device=DEVICE).manual_seed(SEED + 5)
                   if dropout else None)
            at.reset_counts()
            at.BWD_IMPL = "split" if impl == "split" else "fused"
            try:
                loss = cross_entropy_loss(model(
                    x, plain_attention=impl == "plain",
                    dropout_generator=gen), y)
                grads = torch.autograd.grad(loss, params)
                sync()
            finally:
                at.BWD_IMPL = "fused"
            out[impl] = (float(loss.detach()), grads, dict(at.launches),
                         dict(at.plain_cuda_calls))
        lp, gp, _, plain_calls = out["plain"]
        for impl in ("fused", "split"):
            lk, gk, launches, _ = out[impl]
            rel = abs(lk - lp) / abs(lp)
            worst = max((float((a - b).abs().max())
                         / max(float(b.abs().max()), 1e-30), n)
                        for (n, _), a, b in zip(model.named_parameters(), gk,
                                                gp))
            name = (f"fp32 124M, 2 x {cfg.block_size}, dropout {dropout}, "
                    f"{impl} backward")
            print(f"  {name}: loss kernels {lk:.7f} plain {lp:.7f} (rel "
                  f"{rel:.1e}); worst gradient max|diff|/max|ref| "
                  f"{worst[0]:.1e} ({worst[1]}); kernel launches "
                  f"{launches}, plain CUDA calls {plain_calls}")
            if not rel <= 1e-5:
                fail(f"{name}: loss kernels {lk} vs plain {lp}: rel {rel} > "
                     "1e-5")
            if not worst[0] <= 1e-3:
                fail(f"{name}: gradient {worst[1]}: max|diff| / max|ref| "
                     f"{worst[0]} > 1e-3")
            if any(launches[k] < cfg.n_layer for k in need[impl]):
                fail(f"{name}: the kernel pass bypassed a kernel: {launches}")
            for key, n in launches.items():
                kernel_launches[key] = kernel_launches.get(key, 0) + n
        if not plain_calls["torch_flash_attention"]:
            fail(f"fp32 124M, dropout {dropout}: the plain pass did not run "
                 f"the plain attention: {plain_calls}")
        del model, out, gp
        torch.cuda.empty_cache()
    return kernel_launches


# ---------------------------------------------------------------------------
# phase 9: the trainer
# ---------------------------------------------------------------------------

def prepare_bpe(root: str) -> float:
    """<root>/english_prose_bpe from BPE_CORPUS by the port's own
    data.prepare (english_prose_bpe with --source_file); its bins must
    hash to BPE_SHA256. Returns the seconds it took."""
    import hashlib
    import os

    from nanosandbox_tpu_torch.data.prepare import \
        prepare_english_prose_bpe_dataset

    out = os.path.join(root, "english_prose_bpe")
    t0 = time.monotonic()
    stats = prepare_english_prose_bpe_dataset(out, source_file=BPE_CORPUS)
    secs = time.monotonic() - t0
    got = {}
    for name in BPE_SHA256:
        with open(os.path.join(out, name), "rb") as f:
            got[name] = hashlib.sha256(f.read()).hexdigest()
    print(f"  prepared english_prose_bpe from {BPE_CORPUS} with the port's "
          f"data.prepare: {stats} in {secs:.1f} s; sha256 "
          + ", ".join(f"{k} {v[:16]}" for k, v in got.items()))
    if got != BPE_SHA256:
        fail(f"the port's english_prose_bpe bins {got} are not the JAX "
             f"package's {BPE_SHA256}")
    return secs


def kernel_kind(name: str) -> str:
    if "flash_fwd" in name:
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


def peak_gb() -> float | None:
    """torch.cuda's peak allocation since the last reset, in GiB, and a
    new reset; None on the CPU."""
    if DEVICE == "cpu":
        return None
    sync()
    peak = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    return peak


def logged_windows(run: dict, skip: tuple) -> list:
    """The run's logged records after iter 0 (whose window holds the
    first-call setup) whose windows miss the iters [a, b) of ``skip``:
    a record at iter i times the iters since the last log or eval, at
    most log_interval of them."""
    log = run["log"]
    every = log[1]["iter"] - log[0]["iter"] if len(log) > 1 else 1
    a, b = skip
    return [r for r in log if r["iter"] > 0
            and not a <= r["iter"] < b + every]


def check_trainer(at, fd, smi: str, tmp: str) -> dict:
    """Phase 9 in ``tmp``: the dataset, the runs' out_dirs (phase 12
    samples from <tmp>/out) and the control run."""
    import os

    from nanosandbox_tpu_torch import train
    from nanosandbox_tpu_torch.config import load_config

    prepare_s = prepare_bpe(tmp)
    out_dir = os.path.join(tmp, "out")
    flags = [TRAIN_CONFIG, f"--data_dir={tmp}", f"--out_dir={out_dir}",
             "--max_iters=30", "--lr_decay_iters=30", "--warmup_iters=5",
             "--eval_interval=15", "--eval_iters=4", "--log_interval=5",
             f"--device={DEVICE}", *TRAIN]
    a, b = PROFILE_STEPS
    # The training path is the main path: counts start here. The
    # first run takes the fused backward (K5), the resume the split
    # one (K6 + K7).
    at.reset_counts()
    fd.reset_counts()
    peak_gb()
    t0 = time.monotonic()
    # train.main's body, keeping the Trainer: its registry and spans are
    # read below.
    trainer = train.Trainer(load_config(flags + [
        f"--profile_steps={a}:{b}", "--memory_report=True"]))
    try:
        first = trainer.run()
    finally:
        train.distributed.shutdown()
    first_peak = peak_gb()
    at.BWD_IMPL = "split"
    try:
        # Every resumed step is logged: the split backward's step time.
        resumed = train.main(
            [f for f in flags if not f.startswith(("--max_iters=",
                                                   "--log_interval="))]
            + ["--max_iters=35", "--init_from=resume", "--log_interval=1"])
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
    mem = first["memory_report"]
    print("  memory report before iter 0: "
          + ", ".join(f"{k} {v / 2**30:.3f} GiB" for k, v in mem.items())
          + ("" if first_peak is None else
             f"; the first run's measured peak {first_peak:.3f} GiB"))
    if set(mem) != ({"params_bytes", "state_bytes"} if DEVICE == "cpu"
                    else {"params_bytes", "state_bytes", "temp_bytes",
                          "total_bytes"}):
        fail(f"the memory report's keys are {sorted(mem)}")
    trace = os.path.join(out_dir, "runs", "profile",
                         f"iters_{a}_{b}.trace.json")
    if not os.path.exists(trace):
        fail(f"--profile_steps={a}:{b} wrote no trace at {trace}")
    # The trainer's registry: train_loss is the loss logged at the last
    # log iter; the eval, checkpoint and profile windows are spans.
    snap = trainer.metrics.snapshot()
    spans = sorted({s.name for s in trainer.tracer.spans()})
    last = first["log"][-1]
    gauges = {k: snap[k]["series"][0]["value"] for k in (
        "train_loss", "train_iters_total", "checkpoint_saves_total")}
    print(f"  the trainer's registry: {gauges} (logged loss at iter "
          f"{last['iter']}: {last['loss']}), eval_loss "
          f"{ {s['labels']['split']: s['value'] for s in snap['eval_loss']['series']} }"
          f"; spans {spans}")
    if (gauges["train_loss"] != last["loss"]
            or gauges["train_iters_total"] != last["iter"] + 1
            or not {"eval", "checkpoint_save", "profiler_window"}
            <= set(spans) or trainer.tracer.open_count()):
        fail(f"the trainer's registry {gauges} or spans {spans} disagree "
             f"with its log {last}")
    del trainer
    remat = check_remat_legs(at, flags, first, first_peak, tmp)

    # The launch checks come after every other check of the phase.
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
    for name, (got, want) in remat["launches"].items():
        if got != want:
            fail(f"the remat leg '{name}' bypassed a kernel or ran it "
                 f"again: launches {got}, needs {want}")
    # The window's deliberate syncs by ledger name (utils/tracecheck.py):
    # its log steps' readbacks before the last iter, and the drain.
    window = first["host_syncs_in_window"]
    want = {"profile-window-drain": 1}
    n_log = sum(i % 5 == 0 for i in range(a, b - 1))   # --log_interval=5
    if n_log:
        want["train-log-readback"] = n_log
    print(f"  profile window [{a}:{b}): host_syncs_in_window {window}")
    if window != want:
        fail(f"the profile window's host syncs {window}, expected {want}")
    with open(trace) as f:
        text = f.read()
    named = {k: k in text for k in ("flash_fwd", "flash_bwd")}
    print(f"  profiler trace {trace}: {os.path.getsize(trace) / 2**20:.1f} "
          f"MiB, names the flash kernels {named}")
    if not all(named.values()):
        fail(f"the profiler trace of iters [{a}:{b}) names no flash "
             f"kernel: {named}")
    # Steady-state windows: not iter 0's (the first-call setup) and not
    # the profiled ones.
    rest = logged_windows(first, PROFILE_STEPS)
    ms = float(np.median([r["ms"] for r in rest]))
    toks = float(np.median([r["tok_s"] for r in rest]))
    mfu = float(np.median([r["mfu"] for r in rest]))
    # The resume's first step carries its process's first-call setup.
    split_ms = float(np.median([r["ms"] for r in resumed["log"][1:]]))
    print(f"  [{smi}] step {ms:.2f} ms (median of the logged windows at "
          f"iters {[r['iter'] for r in rest]}), {toks:,.0f} tok/s, MFU "
          f"{100 * mfu:.2f}%; the resume's step with the split backward "
          f"(K6 + K7) {split_ms:.2f} ms (median after its first); "
          f"english_prose_bpe prepared in {prepare_s:.1f} s")
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
    gather = loader_times(trainer.dataset, cfg)
    print(f"  [{smi}] loader, host (native xorshift128+ offsets and "
          f"gather, the memmap warm): sample_batch "
          f"{gather['sample_batch_ms']:.4f} ms a batch of "
          f"{cfg.batch_size} x {cfg.block_size + 1} tokens, the gather "
          f"alone {gather['gather_ms']:.4f} ms (medians of "
          f"{gather['n']})")
    del trainer
    torch.cuda.empty_cache()
    control = control_losses(train, flags, tmp)
    print("  control, the first run's 30 steps with the plain attention "
          "(after the counts; printed, not checked): losses "
          f"{ {i: round(v, 4) for i, v in control.items()} }")
    torch.cuda.empty_cache()
    return {"launches": launches, "plain_cuda_calls": plain, "step_ms": ms,
            "split_step_ms": split_ms, "tok_s": toks, "mfu": mfu,
            "profile": prof, "remat": remat, "prepare_s": prepare_s}


def loader_times(dataset, cfg, n: int = 200) -> dict:
    """Host time of the loader's batch (BinDataset.sample_batch: the
    native offsets, the native gather, the int32 cast) and of the native
    gather alone, at the config's batch and block, medians of n draws
    (the memmap warm: each draw is timed after a first untimed one)."""
    from nanosandbox_tpu_torch.utils import native

    data = dataset.splits["train"]
    width = cfg.block_size + 1
    dataset.sample_batch("train", 0, cfg.batch_size, cfg.block_size)
    t_batch, t_gather = [], []
    for i in range(n):
        t0 = time.perf_counter()
        dataset.sample_batch("train", i, cfg.batch_size, cfg.block_size)
        t_batch.append(time.perf_counter() - t0)
        offsets = native.sample_offsets(SEED, i, data.shape[0], width,
                                        cfg.batch_size)
        t0 = time.perf_counter()
        native.gather_windows(data, offsets, width)
        t_gather.append(time.perf_counter() - t0)
    return {"sample_batch_ms": 1e3 * float(np.median(t_batch)),
            "gather_ms": 1e3 * float(np.median(t_gather)), "n": n}


# Remat legs of phase 9: (name, extra flags, steps, forward launches a
# layer and step). The first run's config with activation checkpointing,
# on its batches: 'save_attention' recomputes no attention forward,
# 'full' runs it again in the backward.
REMAT_LEGS = (("save_attention", ["--remat_policy=save_attention"], 5, 1),
              ("full", ["--remat_policy=full"], 2, 2))


def check_remat_legs(at, flags: list, first: dict, first_peak, tmp: str
                     ) -> dict:
    """The first run's config with --remat=True: iter 0's loss must be
    the first run's bits (the same forward), its grad norm within
    SP_BF16_NORM_REL of it (K5's dQ atomics rule out bits), and its peak
    memory below the first run's; the launch counts are returned for the
    caller to check after its other checks: the forward n_layer times a
    step under 'save_attention' and twice that under 'full', plus one a
    layer for each of the closing evaluation's 2 batches."""
    import os

    from nanosandbox_tpu_torch import train
    from nanosandbox_tpu_torch.config import load_config

    out = {"launches": {}, "peak_gb": {}, "step_ms": {}}
    for name, extra, steps, per_step in REMAT_LEGS:
        leg = [f for f in flags if not f.startswith((
            "--out_dir=", "--max_iters=", "--eval_interval=",
            "--eval_iters=", "--log_interval="))] + [
            f"--out_dir={os.path.join(tmp, 'remat_' + name)}",
            f"--max_iters={steps}", "--eval_interval=0", "--eval_iters=1",
            "--log_interval=1", "--remat=True", *extra]
        layers = load_config(leg).n_layer
        at.reset_counts()
        peak_gb()
        run = train.main(leg)
        peak = peak_gb()
        got, ref = run["log"][0], first["log"][0]
        rel = abs(got["grad_norm"] - ref["grad_norm"]) / ref["grad_norm"]
        ms = float(np.median([r["ms"] for r in run["log"][1:]]))
        print(f"  remat '{name}', {steps} steps: iter 0 loss "
              f"{got['loss']!r} (the first run's {ref['loss']!r}), grad "
              f"norm {got['grad_norm']:.6g} ({rel:.1e} from the first "
              f"run's {ref['grad_norm']:.6g}); losses "
              f"{[round(r['loss'], 4) for r in run['log']]}; step "
              f"{ms:.2f} ms (median after iter 0); peak "
              + ("not measured on the CPU" if peak is None else
                 f"{peak:.3f} GiB against the first run's "
                 f"{first_peak:.3f} GiB"))
        if got["loss"] != ref["loss"]:
            fail(f"remat '{name}': iter 0's loss {got['loss']!r} is not the "
                 f"first run's {ref['loss']!r}")
        if not rel <= SP_BF16_NORM_REL:
            fail(f"remat '{name}': iter 0's grad norm is {rel:.2e} from "
                 f"the first run's (limit {SP_BF16_NORM_REL:.0e})")
        if peak is not None and not peak < first_peak:
            fail(f"remat '{name}': peak memory {peak:.3f} GiB is not "
                 f"below the first run's {first_peak:.3f} GiB")
        fwd = at.launches["flash_attention_fwd"]
        bwd = at.launches["flash_attention_bwd_fused"]
        out["launches"][name] = ((fwd, bwd), (layers * (per_step * steps + 2),
                                              layers * steps))
        out["peak_gb"][name] = peak
        out["step_ms"][name] = ms
    return out


def control_losses(train, flags, tmp) -> dict:
    """The trainer's first run again with the plain attention in place of
    the kernels: a control for the loss trajectory. The two runs round
    differently in bf16 and part ways, so it is printed, not checked."""
    with plain_kernels():
        out = train.main([f"--out_dir={tmp}/control"
                          if f.startswith("--out_dir=") else f
                          for f in flags])
    return {r["iter"]: r["loss"] for r in out["log"]}


@contextlib.contextmanager
def plain_kernels():
    """The model's attention calls swapped for the kernels' plain
    versions, in this script only: the control runs of phases 9 and 10."""
    from nanosandbox_tpu_torch.models import gpt
    from nanosandbox_tpu_torch.ops import attention as at
    from nanosandbox_tpu_torch.ops import flash_decode as fd

    def causal(q, k, v, *, dropout_rate, seed):
        return at.torch_flash_attention(q, k, v, dropout_rate=dropout_rate,
                                        seed=seed)[0]

    swap = {"causal_attention": causal,
            "flash_decode": fd.torch_decode_attention,
            "flash_decode_paged": fd.torch_decode_attention_paged,
            "flash_prefill_paged": fd.torch_prefill_attention_paged}
    kernels = {name: getattr(gpt, name) for name in swap}
    for name, fn in swap.items():
        setattr(gpt, name, fn)
    try:
        yield
    finally:
        for name, fn in kernels.items():
            setattr(gpt, name, fn)


# ---------------------------------------------------------------------------
# phase 10: the fp32 124M engines over the dense pool and int8/int4 pools
# ---------------------------------------------------------------------------

def check_pools_fp32(model, prompts, ref, paged_fp32) -> dict:
    """The dense fp32 engine against phase 4's paged engine and the
    recompute (identical tokens); then int8 and int4 pools, paged and
    dense, each against the same engine with the kernels swapped for
    their plain versions (identical tokens), with the share of tokens
    that agree with the fp32-KV engine. Launch counts per run."""
    runs = {}
    dense = run_engine(model, prompts, paged=False)
    runs["dense fp32"] = dense
    bad = sum(a != b for a, b in zip(dense["tokens"], ref))
    bad_paged = sum(a != b for a, b in zip(dense["tokens"],
                                           paged_fp32["tokens"]))
    print(f"  dense fp32 engine: {dense['wall_s']:.3f} s; launches "
          f"{dense['launches']}, flash forward (prefill) "
          f"{dense['k4_launches']}; token mismatches vs recompute {bad}, "
          f"vs the paged engine {bad_paged}; each graph replayed once, "
          f"traced {dense['graph_trace']}")
    if bad or bad_paged:
        fail("the dense fp32 engine's greedy tokens differ from the "
             "recompute or the paged engine")
    need = {"dense fp32": ("flash_decode/fp32",)}
    ref_tokens = sum(len(t) for t in ref)
    for mode in ("int8", "int4"):
        for paged in (True, False):
            name = f"{'paged' if paged else 'dense'} {mode}"
            run = run_engine(model, prompts, kv_dtype=mode, paged=paged)
            with plain_kernels():
                plain = run_engine(model, prompts, kv_dtype=mode,
                                   paged=paged, graphs=False)
            runs[name] = run
            bad = sum(a != b for a, b in zip(run["tokens"], plain["tokens"]))
            agree = sum(x == y for a, b in zip(run["tokens"], ref)
                        for x, y in zip(a, b))
            print(f"  {name} engine: {run['wall_s']:.3f} s; launches "
                  f"{run['launches']}; token mismatches vs its plain-version "
                  f"control {bad}; tokens agreeing with the fp32-KV engine "
                  f"{agree}/{ref_tokens} ({100 * agree / ref_tokens:.1f}%); "
                  f"each graph replayed once, traced {run['graph_trace']}")
            if bad:
                fail(f"the {name} engine's tokens differ from its "
                     "plain-version control")
            need[name] = ((f"flash_decode_paged/{mode}",
                           f"flash_prefill_paged/{mode}")
                          if paged else (f"flash_decode/{mode}",))
    # The launch checks come after every token check.
    for name, keys in need.items():
        need_launches(f"the {name} engine", runs[name], keys)
    if not dense["k4_launches"]:
        fail("the dense fp32 engine's prefill bypassed a kernel: the "
             "flash forward never launched")
    return runs


# ---------------------------------------------------------------------------
# phase 12: the offline sampler on phase 9's checkpoint
# ---------------------------------------------------------------------------

def check_sampler(train_dir: str) -> dict:
    """`python -m nanosandbox_tpu_torch.sample`'s main() on phase 9's
    checkpoint (bf16, the K4 prefill and K3 decode steps), then, on the
    same weights in fp32, greedy generate() over 32 tokens against a
    no-cache argmax loop."""
    import os

    from nanosandbox_tpu_torch import sample
    from nanosandbox_tpu_torch.checkpoint import TrainCheckpointer
    from nanosandbox_tpu_torch.config import GPTConfig, TrainConfig
    from nanosandbox_tpu_torch.data.tokenizer import tokenizer_for_dataset
    from nanosandbox_tpu_torch.models.gpt import GPT
    from nanosandbox_tpu_torch.ops import attention as at
    from nanosandbox_tpu_torch.ops import flash_decode as fd

    out_dir = os.path.join(train_dir, "out")
    # The sampling path is the main path: counts start here.
    fd.reset_counts()
    at.reset_counts()
    t0 = time.monotonic()
    texts = sample.main([f"--out_dir={out_dir}", "--start=The ",
                         "--num_samples=2", "--max_new_tokens=64",
                         f"--device={DEVICE}"])
    sync()
    wall = time.monotonic() - t0
    run = {"launches": {k: n for k, n in fd.launches.items() if n},
           "plain_cuda_calls": {**fd.plain_cuda_calls,
                                **at.plain_cuda_calls}}
    run["launches"]["flash_attention_fwd"] = at.launches[
        "flash_attention_fwd"]
    print(f"  sample CLI: 2 samples of 64 tokens in {wall:.3f} s (the "
          f"model's load included); launches {run['launches']}")
    if len(texts) != 2 or not all(t.startswith("The ") for t in texts):
        fail(f"the sample CLI printed {texts!r}")
    blob = TrainCheckpointer(out_dir).restore()
    tcfg = TrainConfig(**blob["config"])
    cfg = GPTConfig.from_train_config(tcfg,
                                      blob["model"]["wte.weight"].shape[0])
    cli_mode = "bf16" if cfg.compute_dtype == "bfloat16" else "fp32"
    cfg.compute_dtype = "float32"
    model = GPT(cfg, device=DEVICE)
    model.load_state_dict(blob["model"])
    model.eval()
    # The prompt: the corpus's first 48 tokens, through the dataset's
    # tokenizer (the committed BPE for phase 9's checkpoint).
    tok = tokenizer_for_dataset(tcfg.data_dir, tcfg.dataset)
    with open(CORPUS, encoding="utf-8") as f:
        prompt = tok.encode(f.read(1000))[:48]
    idx = torch.tensor([prompt], device=DEVICE)
    fd.reset_counts()
    at.reset_counts()
    got = sample.generate(model, idx, 32)[0, len(prompt):].tolist()
    k3, k4 = fd.launches["flash_decode/fp32"], at.launches[
        "flash_attention_fwd"]
    want = recompute(model, [prompt])[0]
    print(f"  fp32 greedy generate, 48-token prompt, 32 tokens: "
          f"{tok.decode(got)!r}; no-cache argmax "
          f"loop {'equal' if got == want else 'DIFFERENT'}; launches "
          f"flash_decode/fp32 {k3}, flash_attention_fwd {k4}")
    if got != want:
        fail(f"fp32 generate {got} != no-cache argmax loop {want}")
    need_launches("the sample CLI", run, (f"flash_decode/{cli_mode}",
                                          "flash_attention_fwd"))
    if not (k3 and k4):
        fail("generate bypassed a kernel: flash_decode/fp32 "
             f"{k3}, flash_attention_fwd {k4}")
    del model
    if DEVICE != "cpu":
        torch.cuda.empty_cache()
    return run


# ---------------------------------------------------------------------------
# phase 13: the sequence-parallel trainer (ring attention)
# ---------------------------------------------------------------------------

SP_CONFIG = "configs/train_longcontext_8k.py"
SP_DROPOUT_CONFIG = "configs/train_longcontext_8k_dropout.py"
SP_RANKS = 4
# The cuts of the 8k configs on one card (PERF.md section 4): batch 1,
# no accumulation, a few steps with warmup 1 (so the parameters move),
# eval of one batch a split at the end only. Their dataset, openwebtext,
# needs a download: the port's data.prepare makes it from CORPUS
# (--source_file) with the committed BPE vocabulary. The ranks keep each
# config's own remat (save_attention); the one-process reference runs
# without remat (--remat=False), so that remat, its dropout replay
# included, is held against the plain block loop.
SP_CUTS = ["--batch_size=1",
           "--gradient_accumulation_steps=1", "--warmup_iters=1",
           "--eval_interval=0", "--eval_iters=1", "--log_interval=1",
           "--tensorboard=False", "--run_name=r"]
# bf16 limits, relative, on every step's loss and grad norm: the ring
# and one process take the same bf16 products but sum in another order,
# the ring rounds each block's output to bf16 before its f32 merge (as
# JAX's ring does), and K5's dQ atomics make each run's sums differ from
# the last. Read on an H100 (PERF.md section 6) in ten sound runs of
# steps 0-3: losses differed by at most 3.0e-5 and grad norms by at most
# 2.6e-4, and one process's own step-2 loss moved by 1.6e-5 from run to
# run. The limits give those readings 3x and more headroom. Neither sees
# a wrong dq or dk at initialisation (the q/k/v rows below do).
SP_BF16_LOSS_REL = 1e-4
SP_BF16_NORM_REL = 1e-3
# The q, k and v rows of each layer's attention-projection gradient
# (RANK_MAIN), relative, at steps 0 and 1 only: step 0's update has lr 0
# (the warmup starts at 0), so both steps take their gradients at the
# same parameters in both runs. From step 2 on they do not: AdamW's first
# update moves every weight by about lr whatever the size of its
# gradient, so q and k weights whose gradients are mostly rounding take
# different signs in the two runs (q/k rows 12-45% apart at steps 2-4 on
# an H100, PERF.md section 6). Read there at steps 0-1: at most 1.9e-4
# in five sound runs; the limit gives them 5x headroom, and a bf16 K6
# that drops the lse cotangent reads 7.4e-3 at step 0.
SP_BF16_QKV_REL = 1e-3
SP_QKV_STEPS = 2
# A rank runs `python -m nanosandbox_tpu_torch.train` through runpy (what
# -m does), with the backward strategy set first (the module constant
# BWD_IMPL; there is no flag), and reports what only its process knows:
# among it, before every update, the norms of the q, k and v rows of each
# layer's packed attention projection's gradient (clipped; summed over
# the ranks), where the attention backward's dq, dk and dv land first.
# At initialisation attention is near uniform, dq and dk are small, and
# neither moves the loss or the global grad norm visibly. With
# RANK_PROFILE_STEP = n set, the rank also traces one training step with
# torch.profiler: from the pre-hook of its n-th optimizer step to that of
# the next (the step's forward, backward, exchanges and update), each end
# synchronised; it reports the wall and the device ms by kernel class.
RANK_MAIN = r"""
import json, os, runpy, sys, time
import torch
from torch.optim.optimizer import register_optimizer_step_pre_hook
from torch.profiler import ProfilerActivity, profile
from nanosandbox_tpu_torch.ops import attention as at
from nanosandbox_tpu_torch.ops import flash_decode as fd
from nanosandbox_tpu_torch.parallel import distributed
at.BWD_IMPL = sys.argv.pop(1)
qkv = []
prof_at = int(os.environ.get("RANK_PROFILE_STEP", "-1"))
traced = {}
def kernel_class(name):
    if "wgmma" in name or "flash_bwd_prep" in name or "dq_cast" in name:
        return "ring blocks, non-causal (wgmma K4-K7)"
    if "flash_" in name:
        return "flash, other (causal K4-K7)"
    if name.startswith(("Memcpy", "Memset")):
        return "copies (the host-staged exchanges among them)"
    return "other kernels"
def sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()
def trace(n):
    if n == prof_at:
        sync()
        traced["prof"] = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if torch.cuda.is_available() else []))
        traced["prof"].__enter__()
        traced["t0"] = time.perf_counter()
    elif n == prof_at + 1 and "prof" in traced:
        sync()
        wall = time.perf_counter() - traced["t0"]
        prof = traced.pop("prof")
        prof.__exit__(None, None, None)
        ms = {}
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", 0) or 0
            if us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
                k = kernel_class(e.key)
                ms[k] = ms.get(k, 0.0) + us / 1e3
        traced["profile"] = {"wall_ms": 1e3 * wall, "device_ms": ms}
def record(opt, args, kwargs):
    norms = []
    for group in opt.param_groups:
        for p in group["params"]:
            g = p.grad
            if g is not None and g.dim() == 2 and g.shape[0] == 3 * g.shape[1]:
                norms += [x.float().norm() for x in g.chunk(3)]
    qkv.append(torch.stack(norms).tolist() if norms else [])
    trace(len(qkv))
register_optimizer_step_pre_hook(record)
# With RANK_DIGEST set the rank also reports the parameters its AdamW
# steps (its shards under FSDP): their bytes and the sha256 of their f32
# bytes in the optimizer's order, and the bytes of both moments.
opts = []
if os.environ.get("RANK_DIGEST"):
    _adamw_init = torch.optim.AdamW.__init__
    def _keep(self, *a, **k):
        _adamw_init(self, *a, **k)
        opts.append(self)
    torch.optim.AdamW.__init__ = _keep
def digest():
    if not opts:
        return None
    import hashlib
    params = [p for g in opts[-1].param_groups for p in g["params"]]
    h = hashlib.sha256()
    for p in params:
        h.update(p.detach().float().cpu().numpy().tobytes())
    return {"param_sha256": h.hexdigest(),
            "param_bytes": sum(p.numel() * p.element_size() for p in params),
            "moment_bytes": sum(v.numel() * v.element_size()
                                for st in opts[-1].state.values()
                                for k, v in st.items()
                                if k in ("exp_avg", "exp_avg_sq"))}
runpy.run_module("nanosandbox_tpu_torch.train", run_name="__main__",
                 alter_sys=True)
print("RANK_REPORT " + json.dumps({
    "state": digest(),
    "rank": int(os.environ.get("PROCESS_ID", "0")),
    "qkv_grad_norms": qkv,
    "launches": at.launches,
    "plain_cuda_calls": {**at.plain_cuda_calls, **fd.plain_cuda_calls},
    "exchanged": distributed.exchanged,
    "profile": traced.get("profile"),
    "peak_memory_gb": (torch.cuda.max_memory_allocated() / 2**30
                       if torch.cuda.is_available() else 0.0)}))
"""


def start_ranks(n: int, bwd: str, flags: list, log_prefix: str,
                profile_step: int | None = None, digest: bool = False):
    """Start ``n`` processes of RANK_MAIN as the ranks of one run (n = 1:
    one process, no group) on 127.0.0.1 and a free port; returns the
    handle wait_ranks takes. profile_step: rank 0 traces the step after
    its profile_step-th optimizer step; digest: every rank reports its
    parameters' digest (RANK_MAIN)."""
    import os
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    procs = []
    for rank in range(n):
        env = {k: v for k, v in os.environ.items()
               if k not in ("COORDINATOR_ADDRESS", "NUM_PROCESSES",
                            "PROCESS_ID")}
        if n > 1:
            env.update(COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                       NUM_PROCESSES=str(n), PROCESS_ID=str(rank))
        env["PYTHONPATH"] = os.getcwd()
        if profile_step is not None and rank == 0:
            env["RANK_PROFILE_STEP"] = str(profile_step)
        if digest:
            env["RANK_DIGEST"] = "1"
        log = open(f"{log_prefix}.rank{rank}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-c", RANK_MAIN, bwd, *flags], env=env,
            stdout=log, stderr=subprocess.STDOUT), log))
    return log_prefix, procs, time.monotonic()


def wait_ranks(handle, timeout: int = 600) -> list:
    """Wait for the ranks start_ranks started and return their
    RANK_REPORTs, rank 0 first. A failed rank or a hang past ``timeout``
    seconds from the start fails the phase (every rank is killed)."""
    log_prefix, procs, t0 = handle
    try:
        for p, _ in procs:
            p.wait(timeout=max(1.0, timeout - (time.monotonic() - t0)))
    except subprocess.TimeoutExpired:
        fail(f"{log_prefix}: a rank hung past {timeout} s")
    finally:
        for p, log in procs:
            p.kill()
            p.wait()
            log.close()
    reports = []
    for rank, (p, _) in enumerate(procs):
        with open(f"{log_prefix}.rank{rank}.log") as f:
            text = f.read()
        if p.returncode != 0:
            fail(f"{log_prefix}: rank {rank} exited {p.returncode}:\n"
                 f"{text[-3000:]}")
        line = next(ln for ln in text.splitlines()
                    if ln.startswith("RANK_REPORT "))
        report = json.loads(line[len("RANK_REPORT "):])
        report["backend_line"] = next(
            (ln for ln in text.splitlines() if "] backend " in ln), "")
        report["fsdp_line"] = next(
            (ln for ln in text.splitlines() if "a rank holds" in ln), "")
        reports.append(report)
    return sorted(reports, key=lambda r: r["rank"])


def run_ranks(n: int, bwd: str, flags: list, log_prefix: str,
              timeout: int = 600, profile_step: int | None = None) -> list:
    """start_ranks, then wait_ranks: ``n`` ranks of one run, their
    RANK_REPORTs rank 0 first."""
    return wait_ranks(start_ranks(n, bwd, flags, log_prefix, profile_step),
                      timeout)


def read_steps(out_dir: str) -> dict:
    """{step: (loss, grad_norm, tokens/s)} from rank 0's metrics.jsonl."""
    import os

    steps = {}
    with open(os.path.join(out_dir, "runs", "r", "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if "train/loss" in rec:
                steps[rec["step"]] = (rec["train/loss"],
                                      rec["train/grad_norm"],
                                      rec["perf/tokens_per_sec"])
    return steps


def ring_schedule(layout: str, cp: int, rank: int) -> dict:
    """Block calls of one ring attention call on ``rank``, by launch key
    (ops/attention.py): the JAX package's schedules (ring_attention.py
    :199-227 contiguous, :295-326 zigzag). Forward: "fwd" (causal) and
    "fwd/full". Backward: the same blocks, each given its lse cotangent
    but for a block whose lse reaches no merge: rank 0's first diagonal
    block (zigzag's early half, or contiguous rank 0's only block)."""
    if layout == "zigzag":
        full, causal = 2 * cp - 1, 2
    else:
        full, causal = rank, 1
    return {"fwd": causal, "fwd/full": full,
            "bwd/dlse": causal - (rank == 0), "bwd": int(rank == 0),
            "bwd/full/dlse": full}


def expected_launches(layout, cp, rank, layers, steps, evals, bwd) -> dict:
    """The launch counts a rank's run must show: per layer, a ring call
    per training step and eval batch forward, one backward per step."""
    sched = ring_schedule(layout, cp, rank)
    modes = ("fused",) if bwd == "fused" else ("dq", "dkv")
    want = {"flash_attention_fwd": layers * (steps + evals) * sched["fwd"],
            "flash_attention_fwd/full":
                layers * (steps + evals) * sched["fwd/full"]}
    for mode in modes:
        base = f"flash_attention_bwd_{mode}"
        want[base] = layers * steps * sched["bwd"]
        want[base + "/dlse"] = layers * steps * sched["bwd/dlse"]
        want[base + "/full/dlse"] = layers * steps * sched["bwd/full/dlse"]
    return want


def check_sp_trainer(smi: str, tmp: str) -> dict:
    """Phase 13: SP_RANKS ranks train SP_CONFIG (mesh_sp = SP_RANKS, ring
    attention, remat with its save_attention policy) on openwebtext made
    from CORPUS with the committed BPE, on one card (gloo, host-staged
    exchanges): bf16 at full width, step 0 with the split backward (K6 +
    K7) and a resume to 4 with the fused one (K5); fp32 at 2 layers, 2
    steps, zigzag (fused) and contiguous (split); and SP_DROPOUT_CONFIG
    (dropout 0.1) in fp32 at 2 layers, 2 steps, zigzag (fused). Each
    against the same config run by one process at mesh_sp 1 without
    remat (the causal kernels over the whole 8192-token row, the plain
    block loop) on the same batches: every
    step's loss and grad norm, and at steps 0 and 1 (SP_QKV_STEPS) the q,
    k and v rows of each layer's attention-projection gradient
    (RANK_MAIN), where a wrong dq or dk shows; bf16 within
    SP_BF16_LOSS_REL, SP_BF16_NORM_REL and SP_BF16_QKV_REL; fp32 within
    1e-5, 1e-4 and 1e-4 relative. Every rank's launch counts must equal
    the ring schedule (expected_launches: save_attention launches no
    forward again), and no plain version may run on the card. The four
    one-process runs share the card with the bf16 SP legs, then the three
    fp32 SP runs share it: the walls printed are theirs on a shared
    card."""
    import os

    from nanosandbox_tpu_torch.config import load_config
    from nanosandbox_tpu_torch.data.prepare import prepare_bpe_dataset

    t0 = time.monotonic()
    stats = prepare_bpe_dataset(os.path.join(tmp, "openwebtext"),
                                source_files=[CORPUS], tokenizer="bpe")
    print(f"  prepared openwebtext from {CORPUS} (--tokenizer=bpe): "
          f"{stats} in {time.monotonic() - t0:.1f} s")
    base = [f"--data_dir={tmp}", f"--device={DEVICE}", *SP_CUTS]
    results = {}

    def start(name, n, bwd, config, flags, profile_step=None):
        out_dir = os.path.join(tmp, name)
        return out_dir, start_ranks(
            n, bwd, [config, *base, f"--out_dir={out_dir}", *flags],
            out_dir, profile_step=profile_step), time.time()

    def finish(started):
        """(reports, out_dir, wall s): the wall ends at the ranks' last
        log write, however late this waits."""
        out_dir, handle, t_start = started
        reports = wait_ranks(handle)
        end = max(os.path.getmtime(f"{handle[0]}.rank{r}.log")
                  for r in range(len(handle[1])))
        return reports, out_dir, end - t_start

    fp32 = ["--compute_dtype=float32", "--n_layer=2"]
    cases = (
        ("bf16", SP_CONFIG, [], "zigzag", (("split", 1), ("fused", 4))),
        ("fp32 zigzag", SP_CONFIG, fp32, "zigzag", (("fused", 2),)),
        ("fp32 contiguous", SP_CONFIG, fp32 + ["--ring_layout=contiguous"],
         "contiguous", (("split", 2),)),
        ("fp32 dropout", SP_DROPOUT_CONFIG, fp32, "zigzag",
         (("fused", 2),)))

    def sp_leg(case, i):
        name, config, extra, _, legs = case
        bwd, upto = legs[i]
        # bf16, fused: rank 0 traces its second step of the leg.
        traced = name == "bf16" and bwd == "fused"
        return start(f"{name.replace(' ', '_')}_sp", SP_RANKS, bwd, config,
                     extra + [f"--max_iters={upto}",
                              f"--lr_decay_iters={legs[-1][1]}"]
                     + (["--init_from=resume"] if i else []),
                     profile_step=2 if traced else None)

    # Every one-process reference starts now and shares the card with
    # the bf16 SP legs (in order: the second resumes the first); then
    # the fp32 cases' SP runs, one leg each, run at once.
    started = []
    try:
        singles = {}
        for name, config, extra, _, legs in cases:
            singles[name] = start(
                f"{name.replace(' ', '_')}_single", 1, "fused", config,
                extra + ["--mesh_sp=1", "--remat=False",
                         f"--max_iters={legs[-1][1]}",
                         f"--lr_decay_iters={legs[-1][1]}"])
            started.append(singles[name])
        sp_runs = {case[0]: [] for case in cases}
        for i, leg in enumerate(cases[0][4]):
            started.append(sp_leg(cases[0], i))
            sp_runs[cases[0][0]].append((*leg, finish(started[-1])))
        later = [(case, sp_leg(case, 0)) for case in cases[1:]]
        started += [st for _, st in later]
        for case, st in later:
            sp_runs[case[0]].append((*case[4][0], finish(st)))
        singles = {name: finish(st) for name, st in singles.items()}
    finally:
        for _, (_, procs, _), _ in started:
            for p, log in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
                log.close()
    sharing = {"bf16": "SP beside the one-process runs",
               "fp32": "the fp32 SP runs at once; one process beside the "
                       "bf16 SP legs"}
    for name, config, extra, layout, legs in cases:
        c = load_config([config, *base, *extra])
        single, single_dir, single_s = singles[name]
        sp_reports, prev, sp_s, sp_qkv = [], 0, 0.0, []
        for bwd, upto, (reports, sp_dir, secs) in sp_runs[name]:
            traced = name == "bf16" and bwd == "fused"
            if traced and not reports[0]["profile"]:
                fail(f"phase 13 {name}: rank 0 traced no step")
            sp_s += secs
            for rep_ in reports:
                want = expected_launches(layout, SP_RANKS, rep_["rank"],
                                         c.n_layer, upto - prev, 2, bwd)
                got = {k: v for k, v in rep_["launches"].items() if v}
                if got != {k: v for k, v in want.items() if v}:
                    fail(f"phase 13 {name} ({bwd} backward): rank "
                         f"{rep_['rank']} launched {got}, the ring schedule "
                         f"needs {want}")
                if any(rep_["plain_cuda_calls"].values()):
                    fail(f"phase 13 {name}: plain versions ran on the card "
                         f"on rank {rep_['rank']}: "
                         f"{rep_['plain_cuda_calls']}")
            sp_reports.append((bwd, upto - prev, reports))
            sp_qkv += reports[0]["qkv_grad_norms"]
            prev = upto
        got, ref = read_steps(sp_dir), read_steps(single_dir)
        if sorted(got) != sorted(ref) or len(got) != legs[-1][1]:
            fail(f"phase 13 {name}: steps {sorted(got)} vs {sorted(ref)}")
        rel_loss = [abs(got[i][0] - ref[i][0]) / abs(ref[i][0])
                    for i in sorted(got)]
        rel_norm = [abs(got[i][1] - ref[i][1]) / abs(ref[i][1])
                    for i in sorted(got)]
        worst_loss, worst_norm = max(rel_loss), max(rel_norm)
        ref_qkv = np.asarray(single[0]["qkv_grad_norms"])
        if (np.shape(sp_qkv) != ref_qkv.shape
                or ref_qkv.shape[1] != 3 * c.n_layer):
            fail(f"phase 13 {name}: q/k/v gradient norms of shape "
                 f"{np.shape(sp_qkv)} vs {ref_qkv.shape}")
        # (steps, layers, q/k/v): the worst relative difference by step.
        rel_qkv = (np.abs(np.asarray(sp_qkv) - ref_qkv) / ref_qkv).reshape(
            len(ref_qkv), c.n_layer, 3)
        worst_qkv = float(rel_qkv[:SP_QKV_STEPS].max())
        print(f"  {name} ({c.n_layer}L/{c.n_head}H/{c.n_embd}d, block "
              f"{c.block_size}, vocab {c.vocab_size}, batch {c.batch_size}, "
              f"{c.compute_dtype}, {layout}, dropout {c.dropout}, remat "
              f"{c.remat_policy if c.remat else False}): losses SP "
              f"{[round(got[i][0], 6) for i in sorted(got)]} vs one process "
              f"{[round(ref[i][0], 6) for i in sorted(ref)]}; rel by step: "
              f"losses {[f'{x:.1e}' for x in rel_loss]}, grad norms "
              f"{[f'{x:.1e}' for x in rel_norm]}, q/k/v gradient rows (worst "
              f"layer; checked at steps 0-{SP_QKV_STEPS - 1}) q "
              f"{[f'{x:.1e}' for x in rel_qkv[:, :, 0].max(1)]} k "
              f"{[f'{x:.1e}' for x in rel_qkv[:, :, 1].max(1)]} v "
              f"{[f'{x:.1e}' for x in rel_qkv[:, :, 2].max(1)]}; wall SP "
              f"{sp_s:.1f} s, one process {single_s:.1f} s "
              f"({sharing[name.split()[0]]})")
        for bwd, n_steps, reports in sp_reports:
            prof = reports[0]["profile"]
            if prof:
                dev = prof["device_ms"]
                print(f"    [{smi}] rank 0, one {bwd}-backward step traced: "
                      f"wall {prof['wall_ms']:.1f} ms, device "
                      f"{sum(dev.values()):.2f} ms: " + ", ".join(
                          f"{k} {v:.2f} ms" for k, v in sorted(
                              dev.items(), key=lambda kv: -kv[1])))
            for rep_ in reports:
                x = rep_["exchanged"]
                # A training step rotates K/V forward and their gradients
                # back, and remat's recompute rotates K/V forward again
                # (counted apart); each of the 2 eval batches rotates
                # forward only.
                step = 2 / (2 * n_steps + 2)
                ring_b = x["ring_bytes"] - x["recompute_bytes"]
                ring_s = x["ring_seconds"] - x["recompute_seconds"]
                print(f"    {rep_['backend_line'].strip()}; {bwd} backward, "
                      f"{n_steps} steps: launches "
                      f"{ {k: v for k, v in rep_['launches'].items() if v} }"
                      f"; peak {rep_['peak_memory_gb']:.2f} GiB; a training "
                      f"step exchanges: ring {step * ring_b / 2**20:.1f} "
                      f"MiB in {step * ring_s:.3f} s, remat's recompute "
                      f"{x['recompute_bytes'] / n_steps / 2**20:.1f} MiB in "
                      f"{x['recompute_seconds'] / n_steps:.3f} s, all-reduce "
                      f"{x['allreduce_bytes'] / n_steps / 2**20:.1f} MiB in "
                      f"{x['allreduce_seconds'] / n_steps:.3f} s "
                      "(host-staged gloo on one card)")
        lim_loss, lim_norm, lim_qkv = (
            (SP_BF16_LOSS_REL, SP_BF16_NORM_REL, SP_BF16_QKV_REL)
            if c.compute_dtype == "bfloat16" else (1e-5, 1e-4, 1e-4))
        if not (worst_loss <= lim_loss and worst_norm <= lim_norm
                and worst_qkv <= lim_qkv):
            fail(f"phase 13 {name}: SP vs one process: losses {worst_loss:.2e}"
                 f" (limit {lim_loss:.0e}), grad norms {worst_norm:.2e} "
                 f"(limit {lim_norm:.0e}), q/k/v gradient rows "
                 f"{worst_qkv:.2e} (limit {lim_qkv:.0e}) relative")
        # The first logged step carries each process's first-call setup.
        later = [i for i in sorted(got) if i > 0]
        toks = float(np.median([got[i][2] for i in later]))
        ref_toks = float(np.median([ref[i][2] for i in later]))
        print(f"    [{smi}] step {1e3 * c.tokens_per_iter / toks:.1f} ms, "
              f"{toks:,.0f} tok/s global (median after step 0); one "
              f"process {1e3 * c.tokens_per_iter / ref_toks:.1f} ms, "
              f"{ref_toks:,.0f} tok/s")
        results[name] = sp_reports
    return results


def sp_launches(results: dict, name: str, key: str) -> int:
    """A launch key's count summed over phase 13 run ``name``'s ranks."""
    return sum(rep_["launches"].get(key, 0)
               for _, _, reports in results[name]
               for rep_ in reports)


# ---------------------------------------------------------------------------
# phase 19: data-parallel and FSDP training, the HF round trip
# ---------------------------------------------------------------------------

DP_CONFIG = "configs/train_gpt2_124m_owt_multihost.py"
FSDP_CONFIG = "configs/train_gpt2_1p5b_fsdp.py"
HF_CONFIG = "configs/finetune_gpt2_owt.py"
# Every phase 19 run: eval of one batch a split at the end only, every
# step logged (PERF.md section 4).
P19_RUN = ["--eval_interval=0", "--eval_iters=1", "--log_interval=1",
           "--tensorboard=False", "--run_name=r"]
# (a) The 124M multihost config as written (mesh_dp = -1 takes the 2
# ranks), cut to a global batch of 8 rows (of its 128), 4 steps, warmup
# 1; a second leg at accumulation 2 (4-row micro-batches), and fp32 at 2
# of its 12 layers.
DP_CUTS = ["--batch_size=8", "--gradient_accumulation_steps=1",
           "--max_iters=4", "--lr_decay_iters=4", "--warmup_iters=1"]
DP_ACCUM = ["--batch_size=4", "--gradient_accumulation_steps=2"]
DP_FP32 = ["--compute_dtype=float32", "--n_layer=2"]
# (b) The 1.5B config at full width (n_embd 1600, 25 heads of 64, vocab
# 50304, block 1024) with its shard_params and remat, cut to 4 of its 48
# layers, a global batch of 2 rows (of its 32, accumulation 1 of its 4),
# 2 steps, warmup 1 (so step 1 moves the parameters the checkpoint
# holds), and mesh_fsdp 2 of its 16: sixteen ranks would share the one
# card.
FSDP_CUTS = ["--n_layer=4", "--batch_size=2",
             "--gradient_accumulation_steps=1", "--max_iters=2",
             "--lr_decay_iters=2", "--warmup_iters=1", "--mesh_fsdp=2"]
# (c) The 8k config at mesh_dp 2 x mesh_sp 2 (of its 1 x 4), fp32, 2 of
# its 12 layers, batch 2 (of its 4, accumulation 1 of its 8), 2 steps.
DXS_CUTS = ["--mesh_dp=2", "--mesh_sp=2", "--compute_dtype=float32",
            "--n_layer=2", "--batch_size=2", "--gradient_accumulation_steps=1",
            "--max_iters=2", "--lr_decay_iters=2", "--warmup_iters=1"]
# (d) finetune_gpt2_owt.py from a local HF directory instead of OpenAI's
# weights, at batch 4 (of its 8), accumulation 1 (of its 4), 2 steps.
HF_CUTS = ["--batch_size=4", "--gradient_accumulation_steps=1",
           "--max_iters=2", "--lr_decay_iters=2"]
HF_VOCAB = 50257
# bf16 limits, relative, on every step's loss and grad norm against one
# process on the same batches: the ranks sum the gradients and the loss
# in another order and run their GEMMs over half the rows. Read on an
# H100 (PERF.md section 6) in four sound runs of the 124M legs at
# accumulation 1 and 2 and the FSDP leg: losses differed by at most
# 1.3e-5 and grad norms by at most 3.4e-4 (phase 13's readings were
# 3.0e-5 and 2.6e-4 under the same limits); 7x and 2.9x headroom.
DP_BF16_LOSS_REL = 1e-4
DP_BF16_NORM_REL = 1e-3
# fp32 limits, read the same way over the DP fp32 and data x seq legs:
# losses at most 2.2e-7 (2 f32 ulps) and grad norms at most 1.3e-7
# apart (sums in another order); 9x and 15x headroom, 5x and 50x
# tighter than phase 13's fp32 limits.
DP_FP32_LOSS_REL = 2e-6
DP_FP32_NORM_REL = 2e-6


def state_digest(sd: dict) -> str:
    """sha256 of a full state_dict's f32 bytes in the order one process's
    AdamW holds the parameters (>= 2-D first; RANK_MAIN's digest)."""
    import hashlib

    h = hashlib.sha256()
    for two_d in (True, False):
        for t in sd.values():
            if (t.dim() >= 2) == two_d:
                h.update(t.float().numpy().tobytes())
    return h.hexdigest()


def dp_expected(layers: int, micro_steps: int, evals: int = 2) -> dict:
    """A DP or FSDP rank's causal K4 / fused K5 launches: a forward a
    layer for each micro-batch and eval batch, a backward for each
    micro-batch (remat's save_attention replays the forward)."""
    return {"flash_attention_fwd": layers * (micro_steps + evals),
            "flash_attention_bwd_fused": layers * micro_steps}


def compare_steps(name: str, run: dict, ref: dict, loss_rel: float,
                  norm_rel: float) -> dict:
    """Every logged step's loss and grad norm of ``run`` against one
    process's ``ref`` within the relative limits; prints and returns
    the worst."""
    got, want = read_steps(run["out_dir"]), read_steps(ref["out_dir"])
    if sorted(got) != sorted(want) or not got:
        fail(f"phase 19 {name}: steps {sorted(got)} vs {sorted(want)}")
    rel_loss = [abs(got[i][0] - want[i][0]) / abs(want[i][0])
                for i in sorted(got)]
    rel_norm = [abs(got[i][1] - want[i][1]) / abs(want[i][1])
                for i in sorted(got)]
    c = run["cfg"]
    print(f"  {name} ({c.n_layer}L/{c.n_head}H/{c.n_embd}d, block "
          f"{c.block_size}, vocab {c.vocab_size}, batch {c.batch_size} x "
          f"accum {c.gradient_accumulation_steps}, {c.compute_dtype}, "
          f"dropout {c.dropout}, {run['n']} ranks): losses "
          f"{[round(got[i][0], 6) for i in sorted(got)]} vs one process "
          f"{[round(want[i][0], 6) for i in sorted(want)]}; rel by step: "
          f"losses {[f'{x:.1e}' for x in rel_loss]} (limit "
          f"{loss_rel:.0e}), grad norms {[f'{x:.1e}' for x in rel_norm]} "
          f"(limit {norm_rel:.0e})")
    if max(rel_loss) > loss_rel or max(rel_norm) > norm_rel:
        fail(f"phase 19 {name}: against one process: losses "
             f"{max(rel_loss):.2e} (limit {loss_rel:.0e}), grad norms "
             f"{max(rel_norm):.2e} (limit {norm_rel:.0e}) relative")
    return {"loss": max(rel_loss), "norm": max(rel_norm), "steps": got,
            "ref_steps": want}


def print_ranks(smi: str, run: dict, steps: int) -> None:
    """Each rank's backend, launches, peak memory and exchanges a step;
    the step wall and tok/s after step 0 (rank 0's log)."""
    got = read_steps(run["out_dir"])
    later = [i for i in sorted(got) if i > 0]
    toks = float(np.median([got[i][2] for i in later]))
    c = run["cfg"]
    print(f"    [{smi}] {run['name']}: step "
          f"{1e3 * c.tokens_per_iter / toks:.1f} ms, {toks:,.0f} tok/s "
          f"global (median after step 0; {run['note']}); run wall "
          f"{run['wall_s']:.1f} s")
    for rep_ in run["reports"]:
        x = rep_["exchanged"]
        parts = []
        for kind in ("ring", "allreduce", "gather", "scatter"):
            if x[f"{kind}_bytes"]:
                parts.append(f"{kind} {x[kind + '_bytes'] / steps / 2**20:.1f}"
                             f" MiB in {x[kind + '_seconds'] / steps:.3f} s")
        print(f"    {rep_['backend_line'].strip() or 'one process'}: "
              f"launches {({k: v for k, v in rep_['launches'].items() if v})}"
              f"; peak {rep_['peak_memory_gb']:.2f} GiB; a step (the end's "
              "eval included) exchanges: " + (", ".join(parts) or "nothing"))


def export_seeded_gpt2(path: str) -> None:
    """A GPT-2 124M HF directory (vocab 50257, biases) written by the
    port's exporter from seeded random weights."""
    from nanosandbox_tpu_torch.config import GPTConfig
    from nanosandbox_tpu_torch.models.convert import export_hf_gpt2
    from nanosandbox_tpu_torch.models.gpt import GPT

    cfg = GPTConfig(**{**MODEL, "vocab_size": HF_VOCAB, "bias": True})
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    model = GPT(cfg, device=DEVICE, generator=gen)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.normal_(0.0, 0.02, generator=gen)
    export_hf_gpt2(model.state_dict(), cfg, path)


def check_hf_roundtrip(hf_run: dict, tmp: str) -> None:
    """The HF leg's checkpoint through the export CLI and back: the
    re-imported weights' fp32 logits on the card equal the checkpoint's
    bit for bit."""
    import os

    from nanosandbox_tpu_torch.checkpoint import TrainCheckpointer
    from nanosandbox_tpu_torch.config import GPTConfig, TrainConfig
    from nanosandbox_tpu_torch.models.convert import load_hf_gpt2
    from nanosandbox_tpu_torch.models.gpt import GPT

    dest = os.path.join(tmp, "p19_hf_export")
    t0 = time.monotonic()
    subprocess.run([sys.executable, "-m", "nanosandbox_tpu_torch.models"
                    ".convert", f"--out_dir={hf_run['out_dir']}",
                    f"--to={dest}"], check=True, timeout=300)
    export_s = time.monotonic() - t0
    cfg, sd = load_hf_gpt2(dest)
    blob = TrainCheckpointer(hf_run["out_dir"]).restore()
    ckpt_cfg = GPTConfig.from_train_config(
        TrainConfig(**blob["config"]), blob["model"]["wte.weight"].shape[0])
    x = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, size=(2, min(512, cfg.block_size)))).to(DEVICE)
    logits = []
    for c, weights in ((cfg, sd), (ckpt_cfg, blob["model"])):
        c.compute_dtype, c.dropout = "float32", 0.0
        model = GPT(c, device=DEVICE)
        model.load_state_dict(weights)
        with torch.no_grad():
            logits.append(model.eval()(x))
        del model
    if not torch.equal(*logits):
        fail("phase 19 hf: the exported and re-imported checkpoint's fp32 "
             "logits differ from the checkpoint's: max |diff| "
             f"{(logits[0] - logits[1]).abs().max().item():.3e}")
    print(f"  hf round trip: step {blob['iter_num']}'s checkpoint -> "
          f"`python -m nanosandbox_tpu_torch.models.convert` ({export_s:.1f}"
          f" s) -> load_hf_gpt2: fp32 logits of {tuple(x.shape)} tokens on "
          "the card bit-equal to the checkpoint's")


def check_dp_fsdp(smi: str, tmp: str) -> dict:
    """Phase 19 (module docstring) in ``tmp``; returns its runs by name.
    The 124M DP ranks run alone on the card; the other runs (the FSDP
    ranks, the references, the second legs) share it in two waves, and
    their times say so."""
    import os

    from nanosandbox_tpu_torch.config import load_config
    from nanosandbox_tpu_torch.data.prepare import prepare_bpe_dataset

    t_phase = time.monotonic()
    torch.cuda.empty_cache()     # the ranks share the card with this process
    owt = os.path.join(tmp, "openwebtext")
    if not os.path.exists(os.path.join(owt, "train.bin")):
        prepare_bpe_dataset(owt, source_files=[CORPUS], tokenizer="bpe")
    base = [f"--data_dir={tmp}", f"--device={DEVICE}", *P19_RUN]
    runs = {}

    def start(name, n, config, flags, out_dir=None):
        tag = os.path.join(tmp, "p19_" + name.replace(" ", "_"))
        out_dir = out_dir or tag
        handle = start_ranks(n, "fused", [config, *base,
                                          f"--out_dir={out_dir}", *flags],
                             tag, digest=True)
        return {"name": name, "n": n, "out_dir": out_dir, "handle": handle,
                "cfg": load_config([config, *base, *flags])}

    def finish(*started, note="alone on the card"):
        for run in started:
            handle = run.pop("handle")
            run["reports"] = wait_ranks(handle)
            run["wall_s"] = time.monotonic() - handle[2]
            run["note"] = note
            for rep_ in run["reports"]:
                if any(rep_["plain_cuda_calls"].values()):
                    fail(f"phase 19 {run['name']}: plain versions ran on "
                         f"the card on rank {rep_['rank']}: "
                         f"{rep_['plain_cuda_calls']}")
            runs[run["name"]] = run

    # The 124M DP ranks alone (their step wall and exchanges are the
    # phase's DP times), then the rest in two waves that share the card.
    finish(start("dp bf16", 2, DP_CONFIG, DP_CUTS))
    hf_dir = os.path.join(tmp, "p19_hf_gpt2")
    note = "with {} other processes on the card"
    wave = [start(*leg) for leg in (
        ("fsdp", 2, FSDP_CONFIG, FSDP_CUTS),
        ("fsdp one", 1, FSDP_CONFIG, FSDP_CUTS + ["--mesh_fsdp=1"]),
        ("dp bf16 one", 1, DP_CONFIG, DP_CUTS),
        ("dp bf16 accum 2", 2, DP_CONFIG, DP_CUTS + DP_ACCUM),
        ("dp fp32", 2, DP_CONFIG, DP_CUTS + DP_FP32),
        ("dp fp32 one", 1, DP_CONFIG, DP_CUTS + DP_FP32))]
    export_seeded_gpt2(hf_dir)   # while the wave runs
    torch.cuda.empty_cache()
    finish(*wave, note=note.format(sum(r["n"] for r in wave) - 1))
    hf_flags = HF_CUTS + [f"--init_from=hf:{hf_dir}"]
    fsdp_dir = runs["fsdp"]["out_dir"]
    resume = ["--mesh_fsdp=1", "--init_from=resume"]
    wave = [start(*leg) for leg in (
        ("fsdp resume one", 1, FSDP_CONFIG,
         FSDP_CUTS + resume + ["--run_name=resume_one"], fsdp_dir),
        ("fsdp resume dp2", 2, FSDP_CONFIG,
         FSDP_CUTS + resume + ["--mesh_dp=2", "--run_name=resume_dp2"],
         fsdp_dir),
        ("data x seq", 4, SP_CONFIG, DXS_CUTS),
        ("data x seq one", 1, SP_CONFIG,
         DXS_CUTS + ["--mesh_dp=1", "--mesh_sp=1", "--remat=False"]),
        ("hf", 2, HF_CONFIG, hf_flags),
        ("hf one", 1, HF_CONFIG, hf_flags))]
    finish(*wave, note=note.format(sum(r["n"] for r in wave) - 1))

    # (a) and (b): every step against one process; launches; the DP ranks'
    # parameters equal; FSDP's bytes a rank.
    # The accumulation-2 leg draws the same 8 rows a step as the
    # one-process run at accumulation 1 (data/loader.py), so that run is
    # its reference too: the two differ only in the order of the sums.
    for name, ref, lims in (
            ("dp bf16", "dp bf16 one", (DP_BF16_LOSS_REL, DP_BF16_NORM_REL)),
            ("dp bf16 accum 2", "dp bf16 one",
             (DP_BF16_LOSS_REL, DP_BF16_NORM_REL)),
            ("dp fp32", "dp fp32 one", (DP_FP32_LOSS_REL, DP_FP32_NORM_REL)),
            ("fsdp", "fsdp one", (DP_BF16_LOSS_REL, DP_BF16_NORM_REL))):
        run = runs[name]
        compare_steps(name, run, runs[ref], *lims)
        c = run["cfg"]
        micro = c.max_iters * c.gradient_accumulation_steps
        want = dp_expected(c.n_layer, micro)
        for rep_ in run["reports"]:
            got = {k: v for k, v in rep_["launches"].items() if v}
            if got != want and DEVICE != "cpu":   # a CPU rehearsal: none
                fail(f"phase 19 {name}: rank {rep_['rank']} launched {got}, "
                     f"expected {want}")
        shas = {rep_["state"]["param_sha256"] for rep_ in run["reports"]}
        if name != "fsdp" and len(shas) != 1:
            fail(f"phase 19 {name}: the ranks' parameters differ after the "
                 "last step")
        print_ranks(smi, run, c.max_iters)
        if name == "dp bf16":
            print_ranks(smi, runs["dp bf16 one"], c.max_iters)
    one = runs["fsdp one"]["reports"][0]["state"]
    print(f"    {runs['fsdp']['reports'][0]['fsdp_line'].strip()}")
    for rep_ in runs["fsdp"]["reports"]:
        st = rep_["state"]
        print(f"    fsdp rank {rep_['rank']}: parameters "
              f"{st['param_bytes']:,} B, AdamW moments "
              f"{st['moment_bytes']:,} B; one process "
              f"{one['param_bytes']:,} / {one['moment_bytes']:,} B (ratio "
              f"{st['param_bytes'] / one['param_bytes']:.4f} / "
              f"{st['moment_bytes'] / one['moment_bytes']:.4f})")
        if st["param_bytes"] * 2 > one["param_bytes"] * 1.001:
            fail(f"phase 19 fsdp: rank {rep_['rank']} holds "
                 f"{st['param_bytes']} of {one['param_bytes']} parameter "
                 "bytes")
    # (b) rank 0's checkpoint resumed in one process and at mesh_dp 2.
    from nanosandbox_tpu_torch.checkpoint import TrainCheckpointer

    blob = TrainCheckpointer(fsdp_dir).restore()
    want_sha = state_digest(blob["model"])
    for name in ("fsdp resume one", "fsdp resume dp2"):
        for rep_ in runs[name]["reports"]:
            if rep_["state"]["param_sha256"] != want_sha:
                fail(f"phase 19 {name}: rank {rep_['rank']}'s restored "
                     "parameters differ from the checkpoint's")
    print(f"  fsdp checkpoint (step {blob['iter_num']}, written by rank 0) "
          "restored bit for bit in one process and in both mesh_dp=2 ranks")
    # (c) data x seq: one process's losses, the ring schedule a rank.
    run = runs["data x seq"]
    compare_steps("data x seq", run, runs["data x seq one"],
                  DP_FP32_LOSS_REL, DP_FP32_NORM_REL)
    c = run["cfg"]
    for rep_ in run["reports"]:
        want = expected_launches(c.ring_layout, 2, rep_["rank"] % 2,
                                 c.n_layer, c.max_iters, 2, "fused")
        got = {k: v for k, v in rep_["launches"].items() if v}
        if got != {k: v for k, v in want.items() if v} and DEVICE != "cpu":
            fail(f"phase 19 data x seq: rank {rep_['rank']} launched {got}, "
                 f"the ring schedule needs {want}")
    print_ranks(smi, run, c.max_iters)
    # (d) the HF leg: token ids below the HF vocab, step 0 against one
    # process from the same directory, the export round trip.
    top = max(int(np.memmap(os.path.join(owt, f"{s}.bin"), dtype=np.uint16,
                            mode="r").max()) for s in ("train", "val"))
    if top >= HF_VOCAB:
        fail(f"phase 19 hf: token id {top} >= the HF vocab {HF_VOCAB}")
    got = read_steps(runs["hf"]["out_dir"])
    ref = read_steps(runs["hf one"]["out_dir"])
    rel0 = abs(got[0][0] - ref[0][0]) / abs(ref[0][0])
    with open(os.path.join(hf_dir, "config.json")) as f:
        layers = json.load(f)["n_layer"]
    print(f"  hf ({layers} layers from {hf_dir}, dropout "
          f"{runs['hf']['cfg'].dropout}, ids < {top + 1}): step-0 loss "
          f"{got[0][0]:.6f} at 2 ranks vs {ref[0][0]:.6f} one process (rel "
          f"{rel0:.1e}, limit {DP_BF16_LOSS_REL:.0e}); losses "
          f"{[round(got[i][0], 6) for i in sorted(got)]}")
    if rel0 > DP_BF16_LOSS_REL:
        fail(f"phase 19 hf: step-0 loss {rel0:.2e} relative from one "
             "process's")
    check_hf_roundtrip(runs["hf"], tmp)
    print(f"  phase 19: {time.monotonic() - t_phase:.1f} s")
    return runs


def p19_launches(runs: dict, names, key: str) -> int:
    """A launch key's count summed over the ranks of phase 19's runs."""
    return sum(rep_["launches"].get(key, 0) for name in names
               for rep_ in runs[name]["reports"])


# ---------------------------------------------------------------------------
# phase 14: the engine's dispatch modes on the card
# ---------------------------------------------------------------------------

# (label, engine keywords, eager): the eager synchronous step (the
# engine's private entry: its decode body run from Python every step)
# and replayed chunks at scan_k 1 and 8 with the pipeline on.
DISPATCH_MODES = (("eager sync", dict(pipeline=False), True),
                  ("replay k=1", dict(), False),
                  ("replay k=8", dict(scan_k=8), False))


def check_dispatch(fd, smi: str) -> dict:
    """Phase 14: tokens of every DISPATCH_MODES engine equal the eager
    one's (the 124M bf16 paged engine on phase 5's requests, the fp32
    paged and dense engines on phase 4's prompts); in the k=8 runs the
    traced decode kernels equal the capture-time launches times the
    replays, one chunk replayed alone launches K2 (paged) or K3 (dense)
    k x n_layer times, and no plain version runs on the card; then the
    bf16 engine's decode step in each mode (serve/profile.py
    measure_decode: wall per step and idle share), on the engines the
    bf16 token runs used (their prefix caches flushed), so the timing
    builds and captures no engine of its own."""
    from nanosandbox_tpu_torch.config import GPTConfig
    from nanosandbox_tpu_torch.models.gpt import GPT, cast_for_serving
    from nanosandbox_tpu_torch.serve import profile as serve_profile

    cfg = GPTConfig(**MODEL)                     # bf16 compute
    bf16 = cast_for_serving(GPT(cfg, device=DEVICE, generator=torch.Generator(
        device=DEVICE).manual_seed(SEED)))
    bodies = [b for rnd in server_rounds(cfg) for b in rnd]
    fp32, prompts = fp32_model_and_prompts()
    cases = (
        ("bf16 paged", bf16, [b["prompt_tokens"] for b in bodies],
         [{k: v for k, v in b.items() if k != "prompt_tokens"}
          for b in bodies], 64, {}, "K2", "flash_decode_paged/bf16"),
        ("fp32 paged", fp32, prompts, None, ENGINE_NEW, {}, "K2",
         "flash_decode_paged/fp32"),
        ("fp32 dense", fp32, prompts, None, ENGINE_NEW,
         dict(paged=False), "K3", "flash_decode/fp32"))
    runs = {}
    for name, model, ps, sampling, new, kw, kernel, key in cases:
        t0 = time.monotonic()
        got = {}
        for label, mode, eager in DISPATCH_MODES:
            got[label] = run_engine(model, ps, sampling=sampling, new=new,
                                    eager=eager, trace=label == "replay k=8",
                                    keep=model is bf16, **kw, **mode)
        ref = got["eager sync"]["tokens"]
        bad = {label: sum(a != b for a, b in zip(r["tokens"], ref))
               for label, r in got.items()}
        k8 = got["replay k=8"]
        st = k8["stats"]
        print(f"  {name}: token mismatches vs the eager synchronous step "
              f"{bad}; k=8: {st['host_dispatches']['decode']} dispatches, "
              f"{st['decode_chunk_steps']} decode steps, replays "
              f"{st['graph_replays']}, graph pool "
              f"{(st['graph_pool_bytes'] or 0) / 2**20:.1f} MiB; {kernel} "
              f"traced {k8['traced'][kernel]} vs captured x replays "
              f"{k8['launches'].get(key, 0)}; every graph replayed once "
              f"{k8['graph_trace']} ({time.monotonic() - t0:.1f} s)")
        if any(bad.values()):
            fail(f"phase 14 {name}: replayed chunks' tokens differ from "
                 f"the eager step's: {bad}")
        for label, r in got.items():
            need_launches(f"phase 14 {name} {label}", r, (key,))
        if k8["traced"][kernel] != k8["launches"].get(key, 0):
            fail(f"phase 14 {name}: the trace shows {k8['traced'][kernel]} "
                 f"{kernel} launches, the graphs' counts x replays "
                 f"{k8['launches'][key]}")
        runs[name] = got
    del fp32
    times = {}
    t0 = time.monotonic()
    for label, _mode, _eager in DISPATCH_MODES:
        # The token run's engine: 8 slots x 1024, the mode's scan_k and
        # pipeline, the eager one with _replay off.
        engine = runs["bf16 paged"][label].pop("engine")
        engine.reset_prefix_cache()
        times[label] = serve_profile.measure_decode(
            engine, np.random.default_rng(SEED))
        del engine
        torch.cuda.empty_cache()
    print(f"  bf16 paged, 8 slots x 512-token prompts; per decode step "
          f"({time.monotonic() - t0:.1f} s): [{smi}]")
    for label, t in times.items():
        print(f"  {label:<10} wall {t['decode_step_ms']:.3f} ms "
              f"(each step synchronised {t['decode_step_ms_synchronised']:.3f}"
              f"), device {t['device_ms_per_step']:.3f} ms, idle share "
              f"{t['device_idle_share']:.3f}, kernels "
              f"{t['kernels_per_step']:.1f} [{smi}]")
    return {"runs": runs, "times": times}


# ---------------------------------------------------------------------------
# phase 15: scheduling (chunked prefill, preemption, deadlines, 429s)
# ---------------------------------------------------------------------------

CHUNK_LONG = 900        # the long prompt of phase 15's chunked fp32 run


def wrap_release(engine) -> list:
    """Record the blocks each preemption donates (BlockPool.release with
    ``generated``) on a paged engine; returns the list it appends to."""
    donated: list = []
    release = engine.block_pool.release

    def counted(alloc, **kw):
        n = release(alloc, **kw)
        if kw.get("generated"):
            donated.append(n)
        return n

    engine.block_pool.release = counted
    return donated


def sched_counts(fd, at, engine) -> dict:
    """The run's kernel launches and plain-version calls on the card
    (need_launches' input), with the flash forward's launches."""
    launches = counted_launches(fd, engine)
    launches["flash_attention_fwd"] = at.launches["flash_attention_fwd"]
    return {"launches": launches,
            "plain_cuda_calls": counted_plain(fd, at, engine)}


def check_chunked_fp32(fd, at, model, prompts) -> None:
    """Phase 4's fp32 engine (8 slots x 1024) at prefill_chunk 128 on
    phase 4's prompts and a CHUNK_LONG-token one, stepped by hand under
    a trace: tokens equal the same engine's without chunking, traced K1
    launches equal its prefill dispatches (waves and pieces) x n_layer,
    and a decoding row takes tokens between the long prompt's first
    piece and its last."""
    from nanosandbox_tpu_torch.serve.engine import Engine

    rng = np.random.default_rng(SEED + 15)
    prompts = prompts + [[int(t) for t in rng.integers(
        0, prompt_vocab(model.cfg), CHUNK_LONG)]]
    plain = run_engine(model, prompts)
    engine = Engine(model, num_slots=8, max_len=1024, prefill_chunk=128,
                    device=DEVICE)
    fd.reset_counts()
    at.reset_counts()
    rids = [engine.submit(p, ENGINE_NEW) for p in prompts]
    long_rid, done, trace = rids[-1], {}, []

    def drive():
        while engine.has_work():
            for r in engine.step():
                done[r.rid] = r
            lane = next((e for e in engine._chunking
                         if e.req.rid == long_rid), None)
            trace.append((lane.done if lane else None,
                          engine.tokens_generated))
        sync()

    t0 = time.monotonic()
    traced = traced_kernels(drive)
    wall = time.monotonic() - t0
    run = sched_counts(fd, at, engine)
    tokens = [done[r].tokens for r in rids]
    dispatches = engine.waves + engine.prefill_chunks
    want_k1 = dispatches * model.cfg.n_layer
    in_lane = [i for i, (d, _) in enumerate(trace) if d is not None]
    between = (sum(trace[i + 1][1] > trace[i][1]
                   for i in in_lane[:-1]) if in_lane else 0)
    graphs = graph_trace("the chunked fp32 engine", engine)
    bad = sum(a != b for a, b in zip(tokens, plain["tokens"]))
    print(f"  fp32 paged, prefill_chunk 128, prompts "
          f"{[len(p) for p in prompts]}: {engine.waves} waves + "
          f"{engine.prefill_chunks} pieces, traced K1 {traced['K1']} "
          f"(counted {run['launches'].get('flash_prefill_paged/fp32')}; "
          f"want {dispatches} x {model.cfg.n_layer} = {want_k1}); the "
          f"{CHUNK_LONG}-token prompt in the lane for {len(in_lane)} steps, "
          f"decode tokens retired in {between} of them; token mismatches "
          f"vs prefill_chunk off: {bad}; {wall:.3f} s; graphs {graphs}")
    if bad:
        fail("phase 15: chunked prefill changed the fp32 engine's tokens")
    if len(in_lane) < 2 or not between:
        fail(f"phase 15: no decode token between the long prompt's pieces "
             f"({trace})")
    need_launches("phase 15 chunked fp32", run, (
        "flash_decode_paged/fp32", "flash_prefill_paged/fp32"))
    if not engine.prefill_chunks or traced["K1"] != want_k1 \
            or run["launches"].get("flash_prefill_paged/fp32") != want_k1:
        fail(f"phase 15: K1 launches {traced['K1']} traced / "
             f"{run['launches']} counted, want {want_k1}")
    del engine


def check_preemption_fp32(fd, at, model, paged: bool) -> None:
    """Preemption on phase 4's fp32 model over 2 slots. Paged: two batch
    requests and, once they decode, an interactive one with a deadline
    (a natural preemption that donates blocks and resumes as a prefix
    hit), then a request whose deadline expires in the queue (shed).
    Dense: a preemption forced at a fixed step. Tokens equal a 4-slot
    twin's without preemption; no plain version runs on the card."""
    from nanosandbox_tpu_torch.serve.engine import Engine

    rng = np.random.default_rng(SEED + 16)
    vocab = prompt_vocab(model.cfg)
    batch = [[int(t) for t in rng.integers(0, vocab, 64)] for _ in (0, 1)]
    hi = [int(t) for t in rng.integers(0, vocab, 32)]
    name = "paged" if paged else "dense"
    engine = Engine(model, num_slots=2, max_len=1024, paged=paged,
                    device=DEVICE)
    donated = wrap_release(engine) if paged else []
    fd.reset_counts()
    at.reset_counts()
    zero_replays(engine)
    rids = [engine.submit(p, 200, slo_class="batch") for p in batch]
    done: dict = {}
    for _ in range(8):
        done.update((r.rid, r) for r in engine.step())
    shed_rid = None
    if paged:
        rids.append(engine.submit(hi, 16, slo_class="interactive",
                                  deadline_s=0.05))
        while not engine.preemptions and engine.has_work():
            done.update((r.rid, r) for r in engine.step())
        shed_rid = engine.submit([1, 2, 3], 8, slo_class="batch",
                                 deadline_s=1e-4)
    else:
        victim = max(engine._active.values(), key=lambda st: st.req.rid)
        engine._preempt(victim)
    while engine.has_work():
        done.update((r.rid, r) for r in engine.step())
    sync()
    run = sched_counts(fd, at, engine)
    st = engine.stats()
    twin = Engine(model, num_slots=4, max_len=1024, paged=paged,
                  preemption=False, device=DEVICE)
    tids = [twin.submit(p, 200) for p in batch]
    if paged:
        tids.append(twin.submit(hi, 16))
    tw = {r.rid: r.tokens for r in twin.drain()}
    bad = sum(done[r].tokens != tw[t] for r, t in zip(rids, tids))
    hits = st["kv_pool"]["prefix_hit_requests"] if paged else None
    print(f"  fp32 {name}, 2 slots: preemptions {st['preemptions']}, "
          f"blocks donated {donated}, prefix-hit resumes {hits}, "
          f"shed {st['shed']} (deadline 1e-4 s in the queue: "
          f"{done[shed_rid].finish_reason if paged else 'n/a'}), "
          f"resume records left {len(engine._resumed)}; token "
          f"mismatches vs the 4-slot twin without preemption: {bad}; "
          f"launches {run['launches']}")
    if bad or st["preemptions"] < 1 or engine._resumed:
        fail(f"phase 15 {name} preemption: {bad} mismatches, "
             f"{st['preemptions']} preemptions")
    if paged and (not donated or max(donated) < 1 or hits < 1
                  or done[shed_rid].finish_reason != "shed"):
        fail(f"phase 15: donated {donated}, prefix hits {hits}, the "
             f"expired request {done[shed_rid].finish_reason}")
    if paged:
        engine.block_pool.check([])
    need_launches(f"phase 15 {name} preemption", run, (
        ("flash_decode_paged/fp32", "flash_prefill_paged/fp32")
        if paged else ("flash_decode/fp32", "flash_attention_fwd")))
    del engine, twin
    torch.cuda.empty_cache()


def check_sched_server(fd, smi: str, unchunked: list) -> None:
    """The bf16 124M server at --prefill_chunk=256: phase 5's requests
    with slo_class, priority and deadline_s answer 200 (their tokens'
    share equal to ``unchunked``, phase 5's answers, printed); with all 8
    slots busy, a request with a 1e-4 s deadline answers 429 with a
    Retry-After; /stats carries the scheduling keys."""
    from nanosandbox_tpu_torch.checkpoint import save_for_serving
    from nanosandbox_tpu_torch.config import GPTConfig
    from nanosandbox_tpu_torch.models.gpt import GPT
    from nanosandbox_tpu_torch.ops import attention as at
    from nanosandbox_tpu_torch.serve.__main__ import build_server

    cfg = GPTConfig(**MODEL)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as out_dir:
        model = GPT(cfg, device=DEVICE, generator=torch.Generator(
            device=DEVICE).manual_seed(SEED))
        save_for_serving(out_dir, cfg, model.state_dict())
        del model
        server, loop, engine = build_server([
            f"--out_dir={out_dir}", "--host=127.0.0.1", "--port=0",
            "--num_slots=8", "--max_len=1024", "--prefill_chunk=256",
            "--warmup=buckets", f"--device={DEVICE}"])
    fd.reset_counts()
    at.reset_counts()
    zero_replays(engine)
    pieces0 = engine.prefill_chunks         # the warmup's
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    fields = [dict(slo_class="interactive", deadline_s=30.0),
              dict(slo_class="batch", priority=0, deadline_s=60.0),
              dict(slo_class="default", priority=3)]

    def fire(bodies) -> list:
        got = [None] * len(bodies)

        def one(i, body):
            try:
                got[i] = post(base, body)
            except urllib.error.HTTPError as e:
                got[i] = (e.code, json.loads(e.read()),
                          e.headers.get("Retry-After"))

        ths = [threading.Thread(target=one, args=(i, b))
               for i, b in enumerate(bodies)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(timeout=600)
        return got

    rng = np.random.default_rng(SEED + 17)
    try:
        answers = []
        for bodies in server_rounds(cfg):
            answers += fire([dict(b, max_new_tokens=64, **fields[i])
                             for i, b in enumerate(bodies)])
        # 8 blockers fill the slots, two of them long enough (600 tokens)
        # for the chunked lane.
        blockers: list = []
        busy = threading.Thread(target=lambda: blockers.extend(fire([
            dict(prompt_tokens=[int(t) for t in rng.integers(
                0, prompt_vocab(cfg), 600 if i % 4 == 0 else 100)],
                 max_new_tokens=256, temperature=0.0,
                 slo_class="interactive", deadline_s=60.0)
            for i in range(8)])))
        busy.start()
        t0 = time.monotonic()
        seen = []            # (s since t0, active + chunking, queued)
        while True:
            with urllib.request.urlopen(base + "/stats", timeout=30) as r:
                st = json.loads(r.read())
            seen.append((round(time.monotonic() - t0, 3),
                         st["active"] + st["chunking"], st["queued"]))
            if seen[-1][1] == 8:
                break
            if time.monotonic() - t0 > 60:
                changes = [x for i, x in enumerate(seen)
                           if i == 0 or x[1:] != seen[i - 1][1:]]
                fail(f"phase 15: the 8 blockers never filled the slots: "
                     f"{len(seen)} polls, (s, active + chunking, queued) "
                     f"at each change {changes[:40]}; {st}")
            time.sleep(0.002)
        doomed = fire([dict(prompt_tokens=[1, 2, 3], max_new_tokens=8,
                            slo_class="batch", deadline_s=1e-4)])[0]
        busy.join(timeout=600)
        with urllib.request.urlopen(base + "/stats", timeout=30) as r:
            stats = json.loads(r.read())
        sync()
        run = sched_counts(fd, at, engine)
    finally:
        server.shutdown()
        server.server_close()
        loop.stop()
        loop.join(timeout=60)
        th.join(timeout=60)
    for i, a in enumerate(answers + blockers):
        if a is None or a[0] != 200:
            fail(f"phase 15 server: request {i}: {a}")
    if doomed[0] != 429 or not doomed[2] or int(doomed[2]) < 1:
        fail(f"phase 15 server: the expired request answered {doomed}")
    keys = ("shed", "preemptions", "prefill_chunk", "spec_suspended",
            "brownout", "slo")
    if any(k not in stats for k in keys) or stats["prefill_chunk"] != 256:
        fail(f"phase 15 server: /stats lacks {keys}: {sorted(stats)}")
    pieces = stats["prefill_chunks"] - pieces0
    if pieces < 2 * 3:
        fail(f"phase 15 server: the 600-token blockers took {pieces} "
             f"pieces, want 2 x 3")
    agree = sum(x == y for a, u in zip(answers, unchunked)
                for x, y in zip(a[1]["tokens"], u))
    total = sum(len(u) for u in unchunked)
    need_launches("phase 15 server", run, ("flash_decode_paged/bf16",
                                           "flash_prefill_paged/bf16"))
    print(f"  bf16 server, --prefill_chunk=256: {len(answers)} requests "
          f"with slo_class/priority/deadline_s and 8 blockers answered "
          f"200; the 1e-4 s request {doomed[0]} (Retry-After {doomed[2]}, "
          f"{doomed[1]['finish_reason']}); /stats shed {stats['shed']}, "
          f"preemptions {stats['preemptions']}, pieces {pieces}, "
          f"brownout {stats['brownout']['name']}, "
          f"slo {stats['slo']['overall']}; tokens agreeing with the "
          f"unchunked answers {agree}/{total} ({agree / total:.3f}; bf16: "
          f"chunking changes the GEMM shapes) [{smi}]")


# Chunking's effect on the decoding rows: DECODERS rows decoding, then
# STORM prompts of STORM_LEN tokens arriving at once.
DECODERS, STORM, STORM_LEN = 4, 4, 512


def storm_pass(engine, rng, vocab, traced=False) -> dict:
    """DECODERS rows decode 10 steps, then STORM prompts arrive: each
    engine step's wall (host clock) from their arrival until every one of
    them has its first token, and their TTFTs; ``traced``: the kernels'
    device ms in that window too (torch.profiler, which slows the host's
    walls, not the kernels)."""
    for _ in range(DECODERS):
        engine.submit([int(t) for t in rng.integers(0, vocab, 64)], 300)
    for _ in range(10):
        engine.step()
    sync()
    storm = [engine.submit([int(t) for t in rng.integers(0, vocab,
                                                         STORM_LEN)], 8)
             for _ in range(STORM)]
    walls = []
    with (torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) if traced
          else contextlib.nullcontext()) as prof:
        while (engine.sched.queued or engine._chunking
               or any(st.req.rid in storm and not st.tokens
                      for st in engine._active.values())):
            t0 = time.perf_counter()
            engine.step()
            walls.append(time.perf_counter() - t0)
        sync()
    # The TTFT histogram's recent window (obs/registry.py RingStat).
    ttft = list(engine._ttft.peek()._ring._buf)[-STORM:]
    engine.drain()
    engine.reset_prefix_cache()
    out = {"walls_ms": [w * 1e3 for w in walls],
           "ttft_ms": [t * 1e3 for t in ttft]}
    if traced:
        from nanosandbox_tpu_torch.serve import profile as serve_profile

        out["device_ms"] = sum(serve_profile._device_ms_by_name(prof)
                               .values())
    return out


def check_chunk_stalls(smi: str) -> dict:
    """The bf16 124M paged engine at the serve CLI's defaults (pipeline
    on, scan_k 1), prefill_chunk off, 256 and 128, each its own engine:
    a warm pass, the measured one, then a traced one (storm_pass).
    Prints the longest and the median step wall of the decoding rows
    while the storm is admitted, the storm's TTFTs, and the traced
    window's device ms a step against the measured window's wall."""
    from nanosandbox_tpu_torch.config import GPTConfig
    from nanosandbox_tpu_torch.models.gpt import GPT, cast_for_serving
    from nanosandbox_tpu_torch.serve.engine import Engine

    cfg = GPTConfig(**MODEL)
    bf16 = cast_for_serving(GPT(cfg, device=DEVICE, generator=torch.Generator(
        device=DEVICE).manual_seed(SEED)))
    rng = np.random.default_rng(SEED + 18)
    out = {}
    for chunk in (None, 256, 128):
        engine = Engine(bf16, num_slots=8, max_len=1024, prefill_chunk=chunk,
                        device=DEVICE)
        storm_pass(engine, rng, prompt_vocab(cfg))
        out[chunk] = storm_pass(engine, rng, prompt_vocab(cfg))
        if DEVICE != "cpu":     # no device to trace in a CPU rehearsal
            out[chunk]["device_ms"] = storm_pass(
                engine, rng, prompt_vocab(cfg), traced=True)["device_ms"]
        del engine
    torch.cuda.empty_cache()
    print(f"  bf16 paged, 8 slots, pipeline on, scan_k 1: {DECODERS} rows "
          f"decoding when {STORM} {STORM_LEN}-token prompts arrive [{smi}]")
    print("  prefill_chunk  steps  step wall max ms  median ms  "
          "device ms a step (busy share)  TTFT of the prompts ms")
    for chunk, r in out.items():
        w = r["walls_ms"]
        dev = (f"{r['device_ms'] / len(w):10.3f} "
               f"({r['device_ms'] / sum(w):.3f})" if "device_ms" in r
               else "not measured")
        print(f"  {str(chunk or 'off'):<13} {len(w):6d}  {max(w):16.3f}  "
              f"{float(np.median(w)):9.3f}  {dev:<29} "
              + " / ".join(f"{t:.2f}" for t in r["ttft_ms"]))
    return out


def check_scheduling(fd, at, smi: str, unchunked=None) -> None:
    """Phase 15 (module docstring); ``unchunked``: phase 5's answers, or
    None in a partial run (then the same requests through an unchunked
    bf16 engine)."""
    t0 = time.monotonic()
    model, prompts = fp32_model_and_prompts()
    check_chunked_fp32(fd, at, model, prompts)
    for paged in (True, False):
        check_preemption_fp32(fd, at, model, paged)
    del model
    torch.cuda.empty_cache()
    if unchunked is None:
        from nanosandbox_tpu_torch.config import GPTConfig
        from nanosandbox_tpu_torch.models.gpt import GPT, cast_for_serving

        cfg = GPTConfig(**MODEL)
        bf16 = cast_for_serving(GPT(cfg, device=DEVICE,
                                    generator=torch.Generator(
                                        device=DEVICE).manual_seed(SEED)))
        bodies = [b for rnd in server_rounds(cfg) for b in rnd]
        unchunked = run_engine(
            bf16, [b["prompt_tokens"] for b in bodies],
            sampling=[{k: v for k, v in b.items() if k != "prompt_tokens"}
                      for b in bodies], new=64, graphs=False)["tokens"]
        del bf16
    check_sched_server(fd, smi, unchunked)
    check_chunk_stalls(smi)
    print(f"  phase 15: {time.monotonic() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 16: speculative decoding and recovery
# ---------------------------------------------------------------------------

SPEC_K = 4
# K1 at the verify shape: 8 slots' k+1 = 5 queries at these frontiers.
VERIFY_STARTS = (100, 517, 1000, 300, 16, 33, 700, 1019)


def spec_run(model, prompts, *, new=ENGINE_NEW, num_slots=8,
             supervised=False, setup=None, **kw) -> dict:
    """One engine (num_slots x 1024) drained over the prompts, greedy,
    every count reset just before: tokens, wall, the kernel launches
    (the wrappers' own plus captures x replays, verify and draft graphs
    included), plain-version calls on the card and K4's launches, the
    stats, and the engine itself. ``setup(engine)`` runs first;
    ``supervised`` steps it through an EngineSupervisor (backoff 0), and
    a rid ending twice fails."""
    from nanosandbox_tpu_torch.ops import attention as at
    from nanosandbox_tpu_torch.ops import flash_decode as fd
    from nanosandbox_tpu_torch.serve.engine import Engine
    from nanosandbox_tpu_torch.serve.recovery import EngineSupervisor

    engine = Engine(model, num_slots=num_slots, max_len=1024, device=DEVICE,
                    **kw)
    if setup is not None:
        setup(engine)
    fd.reset_counts()
    at.reset_counts()
    rids = [engine.submit(p, new) for p in prompts]
    t0 = time.monotonic()
    sup = EngineSupervisor(engine, backoff_base_s=0.0) if supervised \
        else None
    done: dict = {}
    while engine.has_work():
        for r in (sup or engine).step():
            if r.rid in done:
                fail(f"request {r.rid} ended twice")
            done[r.rid] = r
    sync()
    return {"tokens": [done[r].tokens for r in rids],
            "reasons": [done[r].finish_reason for r in rids],
            "wall_s": time.monotonic() - t0,
            "launches": counted_launches(fd, engine),
            "k4_launches": at.launches["flash_attention_fwd"],
            "plain_cuda_calls": counted_plain(fd, at, engine),
            "stats": engine.stats(), "engine": engine, "supervisor": sup}


def verify_trace(name: str, engine) -> dict:
    """Each verify graph of an idle spec engine replayed once under a
    trace (its rows parked: nothing moves): on a paged pool the capture
    must hold n_layer K1 launches (the (num_slots, k+1) block, one a
    layer) and the trace must show them; no graph may hold a
    plain-version call. Returns {graph: (captured, traced)}."""
    key = f"flash_prefill_paged/{engine.kv_dtype}"
    out = {}
    for g, graph in engine._spec_graphs.items():
        if g[0] != "verify":
            continue
        plain = {k: n for k, n in engine.graph_plain_calls[g].items() if n}
        if plain:
            fail(f"{name}: the {g} graph holds plain-version calls {plain}")
        captured = engine.graph_launches[g].get(key, 0)
        traced = traced_kernels(graph.replay)["K1"]
        want = engine.cfg.n_layer if engine.paged else 0
        if DEVICE != "cpu" and (captured != want or traced != captured):
            fail(f"{name}: the {g} graph captured {captured} {key} "
                 f"launches, traced {traced} (want {want})")
        out["/".join(map(str, g))] = (captured, traced)
    return out


def check_verify_k1(fd, smi: str) -> dict:
    """K1 at the verify shape (S 8, T 5, H 12, D 64, VERIFY_STARTS) over
    fp32 and bf16 pools under a query of the same dtype, against its
    plain version at phase 3's limits, timed beside its bound and SDPA on
    the gathered rows."""
    import torch.nn.functional as F

    rng = np.random.default_rng(SEED + 16)
    H, D, T = 12, 64, SPEC_K + 1
    start = np.array(VERIFY_STARTS, np.int32)
    pk, pv, ptbl = make_case(rng, len(start), start + T)
    pq = torch.from_numpy(rng.standard_normal((len(start), H, T, D),
                                              dtype=np.float32)).to(DEVICE)
    pstart = torch.from_numpy(start).to(DEVICE)
    Lp = int((start + T).max())
    qpos = pstart[:, None] + torch.arange(T, device=DEVICE)[None]
    mask = (torch.arange(Lp, device=DEVICE)[None, None, None, :]
            <= qpos[:, None, :, None])
    shape = f"verify S={len(start)} H={H} T={T} D={D}"
    cases = {}
    for dtype, mode, k1 in ((torch.float32, "fp32",
                             "paged_prefill_f32_kernel<fp32>"),
                            (torch.bfloat16, "bf16",
                             "paged_prefill_mma_kernel<bf16>")):
        q = pq.to(dtype)
        k, v = pk.to(dtype), pv.to(dtype)
        err = check_limits(f"{k1} {shape}",
                           fd.flash_prefill_paged(q, k, v, ptbl, pstart),
                           fd.torch_prefill_attention_paged(q, k, v, ptbl,
                                                            pstart), dtype)
        gk, gv = gathered(k, ptbl, Lp), gathered(v, ptbl, Lp)
        cases[mode] = case(
            k1, dtype, shape, err, DECODE_TOL[dtype]["abs"],
            lambda: fd.flash_prefill_paged(q, k, v, ptbl, pstart),
            lambda: fd.torch_prefill_attention_paged(q, k, v, ptbl, pstart),
            lambda: F.scaled_dot_product_attention(q, gk, gv,
                                                   attn_mask=mask),
            decode_bytes(int((start + T).sum()), H, D, mode,
                         q.numel() * q.element_size()),
            int(sum(4 * H * D * (s * T + T * T / 2) for s in start)))
        c = cases[mode]
        print(f"  K1 {k1} {shape} starts {list(VERIFY_STARTS)}: max|err| "
              f"{err:.2e}, {c['ms']:.5f} ms, bound {c['bound_ms']:.5f} ms "
              f"[{c['bound_by']}] ({100 * c['bound_ms'] / c['ms']:.1f}% of "
              f"bound), plain {c['plain_ms']:.5f} ms, SDPA on gathered rows "
              f"{c['library_ms']:.5f} ms [{smi}]")
    return cases


def check_capture_beside_garbage() -> None:
    """An engine is built while a dropped engine waits in a reference
    cycle, and the cyclic collector runs inside the new engine's first
    graph capture (as an automatic collection can land there). The
    engine must collect before it captures: a dropped engine finalised
    inside a capture frees pinned buffers, events and graphs, and
    invalidates the capture. The new engine must capture and decode the
    dropped one's greedy tokens."""
    import gc

    from nanosandbox_tpu_torch.config import GPTConfig
    from nanosandbox_tpu_torch.models.gpt import GPT
    from nanosandbox_tpu_torch.serve.engine import Engine

    cfg = GPTConfig(n_layer=2, n_head=2, n_embd=128, vocab_size=256,
                    block_size=128, compute_dtype="float32")
    model = GPT(cfg, device=DEVICE, generator=torch.Generator(
        device=DEVICE).manual_seed(SEED))
    kw = dict(num_slots=2, max_len=128, kv_page_size=16, device=DEVICE)
    prompts = ([1, 2, 3], [4, 5, 6, 7])
    collecting = gc.isenabled()
    steps = Engine._steps
    freed = []

    def steps_collecting(self, *a, **k):
        if (not freed and DEVICE != "cpu"
                and torch.cuda.is_current_stream_capturing()):
            freed.append(gc.collect())
        return steps(self, *a, **k)

    gc.disable()
    try:
        dead = Engine(model, **kw)
        rids = [dead.submit(p, 8) for p in prompts]
        done = {r.rid: r.tokens for r in dead.drain()}
        want = [done[r] for r in rids]
        dead.cycle = dead
        del dead
        Engine._steps = steps_collecting
        eng = Engine(model, **kw)
    finally:
        Engine._steps = steps
        if collecting:
            gc.enable()
    rids = [eng.submit(p, 8) for p in prompts]
    done = {r.rid: r.tokens for r in eng.drain()}
    got = [done[r] for r in rids]
    print(f"  capture beside garbage: a collection inside the first "
          f"capture (objects freed {freed}), the engine captured; tokens "
          f"equal to the dropped engine's {got == want}")
    if got != want or (DEVICE != "cpu" and not freed):
        fail(f"capture beside garbage: tokens {got} vs {want}, in-capture "
             f"collections {freed}")


def check_spec_and_recovery(fd, at, smi: str, ref=None, dense_ref=None,
                            served=None) -> dict:
    """Phase 16 (module docstring). ``ref`` / ``dense_ref``: phase 4's
    paged and phase 10's dense fp32 tokens on phase 4's prompts,
    ``served``: phase 5's server run; a standalone run makes them."""
    from nanosandbox_tpu_torch.serve.drafters import ModelDrafter, NGramDrafter
    from nanosandbox_tpu_torch.serve.faults import CANNED, FaultPlan

    t_phase = time.monotonic()
    model, prompts = fp32_model_and_prompts()
    if ref is None:
        ref = spec_run(model, prompts)["tokens"]
    if dense_ref is None:
        dense_ref = spec_run(model, prompts, paged=False)["tokens"]
    n_layer = model.cfg.n_layer
    runs = {}
    # (a) the fp32 paged engine, NGram and an oracle ModelDrafter (the
    # target's own weights).
    oracle, _ = fp32_model_and_prompts()
    for name, drafter in (("paged NGram", NGramDrafter(k=SPEC_K)),
                          ("paged oracle", ModelDrafter(oracle, k=SPEC_K))):
        run = spec_run(model, prompts, spec=drafter)
        st, eng = run["stats"], run["engine"]
        bad = sum(a != b for a, b in zip(run["tokens"], ref))
        emitted = st["tokens_generated"] - st["admitted"]
        per_token = st["host_dispatches"]["verify"] / max(1, emitted)
        trace = verify_trace(f"phase 16 {name}", eng)
        print(f"  fp32 {name} k={SPEC_K}: {run['wall_s']:.3f} s; token "
              f"mismatches vs phase 4 {bad}; acceptance "
              f"{st['spec_acceptance_rate']}, accepted length mean "
              f"{st['spec_accepted_len_mean']}, target forwards per emitted "
              f"token {per_token:.3f} ({st['host_dispatches']['verify']} "
              f"verifies / {emitted}); launches {run['launches']}; verify "
              f"graphs K1 (captured, traced) {trace}; graphs captured "
              f"{eng.tracecheck.counts()} [{smi}]")
        if bad:
            fail(f"phase 16 {name}: greedy tokens differ from phase 4's")
        need = ["flash_prefill_paged/fp32"]
        if name == "paged oracle":
            need.append("flash_decode_paged/fp32")     # the draft steps
            if per_token >= 1:
                fail(f"phase 16 {name}: {per_token} target forwards per "
                     "emitted token under the oracle drafter")
        need_launches(f"phase 16 {name}", run, need)
        runs[name] = run
        del run["engine"], eng
    del oracle
    # (b) the fp32 dense engine with NGram, and a prompt whose frontier
    # comes within k+1 of max_len (its last blocks' columns drop).
    rng = np.random.default_rng(SEED + 16)
    long = [int(t) for t in rng.integers(0, prompt_vocab(model.cfg),
                                         1024 - ENGINE_NEW)]
    long_ref = recompute(model, [long])
    run = spec_run(model, prompts + [long], paged=False,
                   spec=NGramDrafter(k=SPEC_K))
    bad = sum(a != b for a, b in zip(run["tokens"], dense_ref + long_ref))
    trace = verify_trace("phase 16 dense NGram", run["engine"])
    print(f"  fp32 dense NGram k={SPEC_K} (+ a {len(long)}-token prompt to "
          f"max_len): {run['wall_s']:.3f} s; token mismatches vs phase 10 "
          f"and the recompute {bad}; acceptance "
          f"{run['stats']['spec_acceptance_rate']}; launches "
          f"{run['launches']}, flash forward {run['k4_launches']}; verify "
          f"graphs {trace}")
    if bad:
        fail("phase 16 dense NGram: greedy tokens differ")
    if not run["k4_launches"] or any(run["plain_cuda_calls"].values()):
        fail(f"phase 16 dense NGram: flash forward "
             f"{run['k4_launches']}, plain {run['plain_cuda_calls']}")
    del run["engine"]
    runs["dense NGram"] = run
    # (d) supervised chaos: phase 4's prompts and 8 short ones on 4
    # slots, CANNED chaos-smoke plus a stall the watchdog catches; then a
    # drafter-fault streak.
    work = prompts + [[int(t) for t in rng.integers(
        0, prompt_vocab(model.cfg), int(n))] for n in rng.integers(20, 120, 8)]
    clean = spec_run(model, work, num_slots=4)
    del clean["engine"]
    plan = FaultPlan.parse(CANNED["chaos-smoke"] + ",slow_step@9:0.3")
    recoveries = []

    def spy_on(eng):
        """The watchdog's stall limit under the injected stall, and each
        recovery's (cause, flush, decode replays before it)."""
        eng.watchdog.stalled_step_s = 0.2
        recover = eng.recover

        def spy(cause, flush_cache=False):
            recoveries.append([cause, flush_cache, sum(
                n for g, n in eng.graph_replays.items() if g[0] != "verify")])
            return recover(cause, flush_cache=flush_cache)

        eng.recover = spy

    chaos = spec_run(model, work, num_slots=4, faults=plan, supervised=True,
                     setup=spy_on)
    eng = chaos["engine"]
    final = sum(n for g, n in eng.graph_replays.items() if g[0] != "verify")
    sites = sorted({f["site"] for f in plan.fired_log})
    bad = sum(a != b for a, b in zip(chaos["tokens"], clean["tokens"]))
    flushed = [r for r in recoveries if r[1]]
    print(f"  fp32 paged, 4 slots, {len(work)} requests under chaos-smoke + "
          f"slow_step: fired {sites}; recoveries (cause, flush, decode "
          f"replays before) {recoveries}, decode replays at the end "
          f"{final}; supervisor {chaos['supervisor'].stats()['state']}; "
          f"token mismatches vs the no-fault run {bad}; terminals "
          f"{sorted(set(chaos['reasons']))}, one per request")
    if bad or set(chaos["reasons"]) - {"length"}:
        fail("phase 16 chaos: tokens or terminals differ from the no-fault "
             "run")
    if sites != ["alloc_fail", "nan_logits", "preempt_storm", "prefill_exc",
                 "slow_step"] or not flushed or final <= flushed[-1][2]:
        fail(f"phase 16 chaos: sites {sites}, flush recoveries {flushed}, "
             f"decode replays after the last flush {final}")
    need_launches("phase 16 chaos", chaos, ("flash_decode_paged/fp32",
                                            "flash_prefill_paged/fp32"))
    del chaos["engine"], eng
    streak = spec_run(model, prompts, spec=NGramDrafter(k=SPEC_K),
                      faults=FaultPlan.parse("drafter_fault@2x99"))
    st = streak["stats"]
    bad = sum(a != b for a, b in zip(streak["tokens"], ref))
    print(f"  drafter_fault streak: drafter faults {st['drafter_faults']}, "
          f"spec disabled: {st['recovery']['spec_disabled']!r}; decode "
          f"dispatches after it {st['host_dispatches']['decode']}; token "
          f"mismatches vs phase 4 {bad}")
    if bad or st["spec"]["enabled"] or not st["host_dispatches"]["decode"]:
        fail("phase 16: a drafter fault streak did not leave the engine "
             "serving plain decode with phase 4's tokens")
    del streak["engine"]
    del model
    torch.cuda.empty_cache() if DEVICE != "cpu" else None
    check_capture_beside_garbage()
    # (c) the bf16 124M server with --spec=ngram on phase 5's requests.
    if served is None:
        served = check_server(fd, smi)
    spec_served = check_server(fd, smi, ["--spec=ngram", "--warmup=buckets"],
                               need=("flash_prefill_paged/bf16",))
    same = sum(x == y for a, b in zip(spec_served["answers"],
                                      served["answers"])
               for x, y in zip(a, b))
    total = sum(len(a) for a in served["answers"])
    sst, pst = spec_served["stats"], served["stats"]
    print(f"  bf16 server --spec=ngram: acceptance "
          f"{sst['spec_acceptance_rate']}, accepted length mean "
          f"{sst['spec_accepted_len_mean']}; tokens equal to phase 5's "
          f"{same}/{total} ({100 * same / total:.1f}%); TPOT p50 "
          f"{sst['tpot_s']['p50'] * 1e3:.3f} ms vs phase 5's "
          f"{pst['tpot_s']['p50'] * 1e3:.3f} ms [{smi}]")
    # (e) K1 at the verify shape.
    k1 = check_verify_k1(fd, smi)
    print(f"  phase 16: {time.monotonic() - t_phase:.1f} s")
    return {"runs": runs, "server": spec_served, "k1": k1}


# ---------------------------------------------------------------------------
# phase 17: observability on the live server
# ---------------------------------------------------------------------------

OBS_FAMILIES = (   # a sample of the families the CPU tests name
    "serve_ttft_seconds", "serve_tpot_seconds", "serve_queue_wait_steps",
    "serve_requests_submitted_total", "serve_requests_completed_total",
    "serve_tokens_generated_total", "serve_prefill_waves_total",
    "serve_decode_steps_total", "serve_host_dispatches_total",
    "serve_kv_pool_blocks", "serve_prefix_hit_tokens_total",
    "serve_prefix_miss_tokens_total", "serve_prefix_ttft_seconds",
    "serve_slots_active", "serve_queue_depth", "serve_brownout_level",
    "serve_supervisor_state", "serve_loop_waiting",
    "process_resident_memory_bytes", "torch_cuda_allocated_bytes")
OBS_PROFILE_STEPS = 16
# The request that decodes through the /profile window, the trip and the
# /drain (100 prompt tokens + these fill the 1024 positions but 24).
OBS_LONG_NEW = 900
OBS_COST_NEW = 256      # greedy tokens a request in the telemetry-cost leg


def http_get(url: str):
    """(status, body text) of a GET, HTTP errors included."""
    try:
        with urllib.request.urlopen(url, timeout=60) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def http_post(url: str, body: dict, timeout: float = 300):
    req = urllib.request.Request(url, data=json.dumps(body).encode())
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def scrape(base: str) -> dict:
    """/metrics parsed: {"types": {family: type}, "values": {sample line
    name with labels: value}}; every line must be a comment or a
    sample."""
    code, text = http_get(base + "/metrics")
    if code != 200:
        fail(f"/metrics answered {code}: {text[:300]}")
    types, values = {}, {}
    for ln in text.splitlines():
        if ln.startswith("# TYPE "):
            _, _, name, kind = ln.split(" ", 3)
            types[name] = kind
        elif ln.startswith("# HELP "):
            continue
        else:
            m = re.match(r'^([a-zA-Z_:][a-zA-Z0-9_:]*(?:\{.*\})?) (\S+)$',
                         ln)
            if m is None:
                fail(f"/metrics line not in the exposition format: {ln!r}")
            values[m.group(1)] = float(m.group(2))
    return {"types": types, "values": values}


def profile_kernels(path: str) -> dict:
    """Kernel events of a torch.profiler Chrome trace by name, with the
    ones launched by a CUDA graph replay counted apart (a kernel's
    'correlation' id matching a cudaGraphLaunch runtime event's)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    graph = {e["args"].get("correlation") for e in events
             if e.get("cat") == "cuda_runtime"
             and "GraphLaunch" in e.get("name", "")}
    out: dict = {"all": {}, "in_graph": {}}
    for e in events:
        if e.get("cat") != "kernel":
            continue
        name = e.get("name", "")[:70]
        out["all"][name] = out["all"].get(name, 0) + 1
        if e.get("args", {}).get("correlation") in graph:
            out["in_graph"][name] = out["in_graph"].get(name, 0) + 1
    return out


def named(counts: dict, part: str) -> int:
    return sum(n for k, n in counts.items() if part in k)


def wait_active(base: str, want: int, timeout: float = 60) -> None:
    """Until /debug/slots shows ``want`` active rows with a token each."""
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        slots = json.loads(http_get(base + "/debug/slots")[1])["slots"]
        if sum(s["state"] == "active" and s["tokens"] > 0
               for s in slots) >= want:
            return
        time.sleep(0.002)
    fail(f"no {want} decoding rows after {timeout} s")


def telemetry_cost(smi: str) -> dict:
    """The same bf16 124M engine, pipelined, with telemetry at its
    defaults and with the tracer, flight recorder and watchdogs off,
    each run twice (on, off, on, off) on 8 greedy requests: tokens,
    graph replays, counted launches and one traced decode step's kernels
    must be equal; each run's median step wall over its steady decode
    steps (every slot live) is printed."""
    from nanosandbox_tpu_torch.config import GPTConfig
    from nanosandbox_tpu_torch.models.gpt import GPT, cast_for_serving
    from nanosandbox_tpu_torch.obs import FlightRecorder, SpanTracer
    from nanosandbox_tpu_torch.ops import flash_decode as fd
    from nanosandbox_tpu_torch.serve.engine import Engine

    cfg = GPTConfig(**MODEL)
    model = GPT(cfg, device=DEVICE, generator=torch.Generator(
        device=DEVICE).manual_seed(SEED))
    cast_for_serving(model)
    rng = np.random.default_rng(SEED + 17)
    prompts = [[int(t) for t in rng.integers(0, prompt_vocab(cfg), n)]
               for n in (64, 100, 128, 200, 256, 300, 40, 500)]
    new = OBS_COST_NEW if DEVICE != "cpu" else 8
    engines = {
        "on": Engine(model, num_slots=8, max_len=1024, device=DEVICE),
        "off": Engine(model, num_slots=8, max_len=1024, device=DEVICE,
                      tracer=SpanTracer(enabled=False),
                      flight=FlightRecorder(enabled=False),
                      watchdogs=False)}
    runs: dict = {"on": [], "off": []}
    for name in ("on", "off", "on", "off"):
        engine = engines[name]
        fd.reset_counts()
        zero_replays(engine)
        rids = [engine.submit(p, new) for p in prompts]
        walls, done = [], {}
        while engine.sched.queued or any(not st.tokens for st in
                                         engine._active.values()):
            done.update((r.rid, r) for r in engine.step())
        sync()
        # Steady decode: every slot live, nothing to admit.
        while len(engine._active) == 8 and all(
                len(st.tokens) < new - 4 for st in engine._active.values()):
            t0 = time.perf_counter()
            done.update((r.rid, r) for r in engine.step())
            walls.append(time.perf_counter() - t0)
        traced = traced_kernels(lambda: engine.step())
        done.update((r.rid, r) for r in engine.drain())
        sync()
        # The next run of this engine starts as cold as this one did.
        engine.reset_prefix_cache()
        runs[name].append({
            "tokens": [done[r].tokens for r in rids],
            "replays": dict(engine.graph_replays),
            "launches": counted_launches(fd, engine),
            # The trace's preamble of spin kernels (traced_kernels) is no
            # kernel of the step: how many of it a trace loses varies.
            "step_kernels": {k: n for k, n in traced["all"].items()
                             if "spin_kernel" not in k},
            "wall_ms": 1e3 * float(np.median(walls)) if walls else None,
            "steps": len(walls)})
        engine.reset_latency_stats()
    on, off = runs["on"][0], runs["off"][0]
    for key in ("tokens", "replays", "launches", "step_kernels"):
        if any(r[key] != on[key] for r in runs["on"] + runs["off"]):
            seen = [r[key] for r in (on, off, runs["on"][1], runs["off"][1])]
            fail(f"telemetry changed the {key}: in the runs on, off, on, "
                 f"off {seen}")
    out = {name: [r["wall_ms"] for r in rs] for name, rs in runs.items()}
    print(f"  [{smi}] telemetry cost, bf16 124M engine pipelined, 8 rows x "
          f"{new} greedy tokens: median step wall on {out['on']} ms, off "
          f"{out['off']} ms (over {on['steps']} steady steps a run, runs "
          "in the order on, off, on, off); tokens, graph replays "
          f"{on['replays']}, counted launches and one traced step's "
          f"{sum(on['step_kernels'].values())} kernels equal")
    del engines, model
    if DEVICE != "cpu":
        torch.cuda.empty_cache()
    return out


def check_observability(fd, smi: str, tmp: str) -> dict:
    """Phase 17: the paged bf16 124M server (phase 5's flags, the CLI's
    defaults: --warmup=full, pipeline on) with --watchdog_dir, then
    /metrics against /stats over phase 5's rounds, /trace, a /profile
    window over a wave admitted while a request decodes, the /debug
    views, a forced watchdog trip and its dump, /drain while a request
    decodes; then the telemetry-cost leg (telemetry_cost). The server
    serves inside the CLI's --warmup=full freeze (frozen_programs): its
    serve_compile_traces_total must not move, and the rounds' host syncs
    by ledger name are printed a decode chunk. The launch check and the
    profile's kernels come last."""
    import os

    from nanosandbox_tpu_torch.checkpoint import save_for_serving
    from nanosandbox_tpu_torch.config import GPTConfig
    from nanosandbox_tpu_torch.models.gpt import GPT
    from nanosandbox_tpu_torch.ops import attention as at
    from nanosandbox_tpu_torch.serve.__main__ import (build_server,
                                                      frozen_programs)
    from nanosandbox_tpu_torch.utils import tracecheck

    t_phase = time.monotonic()
    cfg = GPTConfig(**MODEL)
    dumps = os.path.join(tmp, "watchdog")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_obs_") as out_dir:
        model = GPT(cfg, device=DEVICE, generator=torch.Generator(
            device=DEVICE).manual_seed(SEED))
        save_for_serving(out_dir, cfg, model.state_dict())
        del model
        server, loop, engine = build_server([
            f"--out_dir={out_dir}", "--host=127.0.0.1", "--port=0",
            "--num_slots=8", "--max_len=1024", "--kv_page_size=16",
            f"--device={DEVICE}", f"--watchdog_dir={dumps}"])
    fd.reset_counts()
    at.reset_counts()
    zero_replays(engine)

    def serve_frozen():
        with frozen_programs(engine, "full"):
            server.serve_forever()

    th = threading.Thread(target=serve_frozen, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    new = 64
    report: dict = {}
    programs = engine.program_counts()
    try:
        # /metrics against /stats over phase 5's rounds.
        before = scrape(base)
        sync_mark = tracecheck.sync_counts()
        rids, sent = [], 0
        for bodies in server_rounds(cfg):
            got = [None] * len(bodies)

            def one(i, body):
                got[i] = http_post(base + "/generate",
                                   dict(body, max_new_tokens=new))

            ths = [threading.Thread(target=one, args=(i, b))
                   for i, b in enumerate(bodies)]
            for t in ths:
                t.start()
            for t in ths:
                t.join(timeout=600)
            for g in got:
                if g is None or g[0] != 200 or len(g[1]["tokens"]) != new:
                    fail(f"a round request answered {g}")
                rids.append(g[1]["id"])
                sent += new
        syncs = tracecheck.sync_delta(sync_mark)
        after = scrape(base)
        stats = json.loads(http_get(base + "/stats")[1])
        v0, v1 = before["values"], after["values"]

        def delta(name):
            return v1.get(name, 0.0) - v0.get(name, 0.0)

        # The rounds' deliberate syncs a decode chunk, by ledger name:
        # one readback a chunk, and the admission waves' first tokens.
        chunks = delta('serve_host_dispatches_total{kind="decode"}')
        per_chunk = {k: round(n / max(chunks, 1), 4)
                     for k, n in sorted(syncs.items())}
        print(f"  [{smi}] host syncs over the rounds a decode chunk, by "
              f"name ({chunks:.0f} chunks): {per_chunk} ({syncs})")
        if not chunks or syncs.get("decode-readback") != chunks or set(
                syncs) - {"decode-readback", "admit-readback"}:
            fail(f"the rounds' host syncs {syncs} over {chunks} decode "
                 "chunks: one decode-readback a chunk, admit-readbacks, "
                 "nothing else")

        missing = [f for f in OBS_FAMILIES if f not in after["types"]
                   and not (DEVICE == "cpu" and f.startswith("torch_cuda"))]
        counters = {
            "submitted": delta("serve_requests_submitted_total"),
            "completed": delta('serve_requests_completed_total'
                               '{reason="length"}'),
            "tokens": delta("serve_tokens_generated_total"),
            "admitted": delta("serve_requests_admitted_total")}
        want = {"submitted": len(rids), "completed": len(rids),
                "tokens": sent, "admitted": len(rids)}
        print(f"  /metrics: {len(after['types'])} families; deltas over "
              f"phase 5's rounds {counters}; /stats tokens "
              f"{stats['tokens_generated']}, completed {stats['completed']}")
        if missing:
            fail(f"/metrics lacks {missing}")
        if counters != want:
            fail(f"/metrics deltas {counters}, sent {want}")
        if (v1["serve_tokens_generated_total"] != stats["tokens_generated"]
                or v1["serve_requests_admitted_total"] != stats["admitted"]
                or v1["serve_decode_steps_total"] != stats["decode_steps"]):
            fail(f"/metrics and /stats disagree: {v1}, {stats}")
        # /trace: a generate and a queued span a request, decode steps
        # overlapping by the pipeline's lag; an unknown rid is a 404.
        lagged = 0
        for rid in rids:
            code, body = http_get(base + f"/trace?rid={rid}")
            evs = [e for e in json.loads(body)["traceEvents"]
                   if e["ph"] == "X"]
            mine = sorted(e["name"] for e in evs
                          if e["args"].get("rid") == rid)
            steps = sorted((e for e in evs if e["name"] == "decode_step"),
                           key=lambda e: e["ts"])
            lagged += sum(b["ts"] < a["ts"] + a["dur"]
                          for a, b in zip(steps, steps[1:]))
            if code != 200 or mine != ["generate", "queued"] or not steps:
                fail(f"/trace?rid={rid}: {code}, request spans {mine}, "
                     f"{len(steps)} decode steps")
        code404 = http_get(base + "/trace?rid=987654")[0]
        print(f"  /trace: a generate and a queued span for each of "
              f"{len(rids)} requests, {lagged} decode-step pairs "
              f"overlapping (the pipeline's lag); unknown rid {code404}")
        if code404 != 404 or not lagged:
            fail(f"/trace: unknown rid answered {code404}, {lagged} "
                 "overlapping decode steps")
        # /debug views.
        evs = json.loads(http_get(base + f"/debug/requests?rid={rids[0]}")
                         [1])["events"]
        slots = json.loads(http_get(base + "/debug/slots")[1])
        kvpool = json.loads(http_get(base + "/debug/kvpool")[1])
        sched = json.loads(http_get(base + "/debug/scheduler")[1])
        names = [e["ev"] for e in evs]
        print(f"  /debug/requests?rid={rids[0]}: {names}; /debug/slots "
              f"{slots['num_slots']} slots; /debug/kvpool trie nodes "
              f"{kvpool['trie'].get('nodes')}, free {kvpool['free']}; "
              f"/debug/scheduler queued {sched['queued']}")
        if (names[:3] != ["submit", "queue", "block_reserve"]
                or "finish" not in names or names[-1] != "http"
                or slots["num_slots"] != 8 or len(slots["slots"]) != 8
                or kvpool["paged"] is not True
                or not kvpool["trie"]["enabled"]
                or sched["queue"] != [] or "brownout" not in sched):
            fail(f"/debug shapes: {names}, {slots}, {kvpool}, {sched}")
        # /profile: armed while a request decodes; a wave admitted inside
        # the window.
        long_req = {}
        lt = threading.Thread(target=lambda: long_req.update(r=http_post(
            base + "/generate", {"prompt_tokens": list(range(1, 101)),
                                 "max_new_tokens": OBS_LONG_NEW,
                                 "temperature": 0.0})))
        lt.start()
        wait_active(base, 1)
        code, armed = http_post(base + "/profile",
                                {"steps": OBS_PROFILE_STEPS})
        if code != 200:
            fail(f"/profile answered {code}: {armed}")
        wave = [None, None]

        def wave_one(i, n):
            wave[i] = http_post(base + "/generate", {
                "prompt_tokens": [int(t) for t in np.random.default_rng(
                    SEED + 170 + i).integers(0, prompt_vocab(cfg), n)],
                "max_new_tokens": 8, "temperature": 0.0})

        wts = [threading.Thread(target=wave_one, args=(i, n))
               for i, n in enumerate((40, 300))]
        for t in wts:
            t.start()
        for t in wts:
            t.join(timeout=600)
        t0 = time.monotonic()
        while json.loads(http_get(base + "/stats")[1])["profile"][
                "active"] and time.monotonic() - t0 < 120:
            time.sleep(0.01)
        prof = json.loads(http_get(base + "/stats")[1])["profile"]["last"]
        if any(w is None or w[0] != 200 for w in wave) or not prof \
                or prof.get("error") or not os.path.exists(
                    prof.get("trace", "")):
            fail(f"/profile: the window's wave {wave}, the window {prof}")
        in_window = prof.get("host_syncs_in_window", {})
        print(f"  /profile window's host_syncs_in_window {in_window}")
        if (in_window.get("profile-window-drain") != 1
                or not in_window.get("decode-readback")):
            fail(f"the /profile window's host syncs {in_window}: one "
                 "drain and its chunks' readbacks")
        report["profile"] = prof
        # A watchdog trip: a tight ttft_spike (any TTFT over the rolling
        # median of the TTFTs so far trips), fed at an admission of a
        # request through the server.
        wd = engine.watchdog
        wd.ttft_min_samples, wd.ttft_min_s = 1, 0.0
        wd.ttft_spike_factor = 1e-9
        tripped = http_post(base + "/generate", {"prompt_tokens": [1, 2, 3],
                                                 "max_new_tokens": 2})
        trips = dict(wd.trips)
        # The first trip of a kind dumps; later ones within cooldown_s
        # only count.
        found = (sorted(d for d in os.listdir(dumps)
                        if d.startswith("ttft_spike-"))
                 if os.path.isdir(dumps) else [])
        dump = os.path.join(dumps, found[0]) if found else ""
        files = sorted(os.listdir(dump)) if dump else []
        text = http_get(base + "/metrics")[1]
        print(f"  watchdog: a request {tripped[0]}; trips {trips}, the "
              f"last {wd.last_trip}; dump {dump}: {files}")
        if (not trips.get("ttft_spike") or files != [
                "flight-ttft_spike.jsonl", "meta-ttft_spike.json",
                "trace-ttft_spike.json"]
                or 'watchdog_trips_total{kind="ttft_spike"}' not in text):
            fail(f"the forced ttft_spike trip: trips {trips}, dump {files}")
        with open(os.path.join(dump, "flight-ttft_spike.jsonl")) as f:
            if not any(json.loads(ln)["ev"] == "finish" for ln in f):
                fail("the trip's flight dump holds no finish")
        if trips.get("post_freeze_retrace"):
            fail(f"a program was built while serving: {trips}")
        # /drain while the long request decodes.
        code, drained = http_post(base + "/drain", {})
        ready = http_get(base + "/healthz?ready=1")
        refused = http_post(base + "/generate", {"prompt_tokens": [1, 2],
                                                 "max_new_tokens": 4})
        lt.join(timeout=600)
        r = long_req.get("r")
        print(f"  /drain: {drained}; readiness then {ready[0]} "
              f"{json.loads(ready[1]).get('reason')}; a new request "
              f"{refused[0]}; the request in flight finished {r and r[0]} "
              f"with {r and len(r[1].get('tokens', []))} tokens")
        if (code != 200 or not drained["in_flight"] or ready[0] != 503
                or refused[0] != 503 or r is None or r[0] != 200
                or len(r[1]["tokens"]) != OBS_LONG_NEW):
            fail("/drain: readiness must go red at once, new requests "
                 "503, the request in flight must finish")
        sync()
        traces = {k: v for k, v in scrape(base)["values"].items()
                  if k.startswith("serve_compile_traces_total")}
        traces0 = {k: v for k, v in v0.items()
                   if k.startswith("serve_compile_traces_total")}
        print(f"  frozen (--warmup=full): serve_compile_traces_total "
              f"{traces} after the phase's requests, {traces0} before; "
              f"program_counts {engine.program_counts()}, {programs} "
              "before")
        if (not traces or traces != traces0
                or engine.program_counts() != programs):
            fail(f"a program was captured while serving frozen: "
                 f"{traces0} -> {traces}")
        launches = counted_launches(fd, engine)
        launches["flash_attention_fwd"] = at.launches["flash_attention_fwd"]
        plain = counted_plain(fd, at, engine)
    finally:
        server.shutdown()
        server.server_close()
        loop.stop()
        loop.join(timeout=60)
        th.join(timeout=60)
    del engine
    if DEVICE != "cpu":
        torch.cuda.empty_cache()
    report["cost"] = telemetry_cost(smi)
    # The launch checks, then the profile's kernels, come last.
    need_launches("the observed bf16 server", {
        "launches": launches, "plain_cuda_calls": plain},
        ("flash_decode_paged/bf16", "flash_prefill_paged/bf16"))
    kern = profile_kernels(report["profile"]["trace"])
    k2_all = named(kern["all"], "paged_decode_kernel")
    k2_graph = named(kern["in_graph"], "paged_decode_kernel")
    k1 = named(kern["all"], "paged_prefill_mma_kernel")
    print(f"  /profile window {report['profile']}: paged_decode_kernel "
          f"{k2_all} ({k2_graph} in graph replays), paged_prefill_mma_"
          f"kernel {k1}; launches {launches}")
    if not (k2_graph and k1):
        fail(f"the /profile trace lacks K2 in graph replays ({k2_graph}) "
             f"or K1 ({k1}): {kern}")
    report["kernels"] = {"K2": k2_all, "K2_in_graph": k2_graph, "K1": k1}
    print(f"  phase 17: {time.monotonic() - t_phase:.1f} s")
    return report


# ---------------------------------------------------------------------------
# phase 18: multi-replica serving
# ---------------------------------------------------------------------------

FLEET_KV_MODES = ("bf16", "int8", "int4")
FLEET_NEW = 64          # phase 5's budget


def bf16_model():
    """Phase 5's bf16 124M model (the weights its server loads), in
    process."""
    from nanosandbox_tpu_torch.config import GPTConfig
    from nanosandbox_tpu_torch.models.gpt import GPT, cast_for_serving

    return cast_for_serving(GPT(GPTConfig(**MODEL), device=DEVICE,
                                generator=torch.Generator(
                                    device=DEVICE).manual_seed(SEED)))


def phase5_requests(cfg) -> list:
    """Phase 5's six /generate bodies as (prompt, sampling keywords)."""
    out = []
    for bodies in server_rounds(cfg):
        for body in bodies:
            body = dict(body)
            out.append((body.pop("prompt_tokens"), body))
    return out


def serve_all(eng, reqs, new) -> list:
    """Submit every request at once and drain: each one's (tokens, finish
    reason), in order; fails unless every request ended exactly once."""
    rids = [eng.submit(p, new, **kw) for p, kw in reqs]
    out = eng.drain()
    sync()
    if sorted(str(r.rid) for r in out) != sorted(str(r) for r in rids):
        fail(f"{type(eng).__name__}: results {[r.rid for r in out]} for "
             f"requests {rids} (a request ended twice, or never)")
    got = {r.rid: (r.tokens, r.finish_reason) for r in out}
    return [got[r] for r in rids]


def engine_counts(fd, at, engines: dict) -> dict:
    """Wrap each engine's step so that the kernel wrappers' eager
    launches and plain-version calls made inside it are charged to that
    engine; zero the counts and the replays. Returns {name: {"launches":
    {}, "plain": {}}}, filled as the engines step; graph replays are
    added by engine_totals after the run."""
    fd.reset_counts()
    at.reset_counts()
    per = {name: {"launches": {}, "plain": {}} for name in engines}

    def snap():
        return (dict(fd.launches),
                {**fd.plain_cuda_calls, **at.plain_cuda_calls})

    for name, eng in engines.items():
        zero_replays(eng)
        step = eng.step

        def counted(_step=step, _name=name):
            l0, p0 = snap()
            try:
                return _step()
            finally:
                l1, p1 = snap()
                for key, d0, d1 in (("launches", l0, l1),
                                    ("plain", p0, p1)):
                    acc = per[_name][key]
                    for k, v in d1.items():
                        if v - d0[k]:
                            acc[k] = acc.get(k, 0) + v - d0[k]

        eng.step = counted
    return per


def engine_totals(per: dict, engines: dict) -> dict:
    """Each engine's launches and plain calls: its steps' eager counts
    plus its graph replays x their capture-time counts."""
    out = {}
    for name, eng in engines.items():
        launches = dict(per[name]["launches"])
        plain = dict(per[name]["plain"])
        for acc, graphs in ((launches, eng.graph_launches),
                            (plain, eng.graph_plain_calls)):
            for k, v in replay_counts(eng, graphs).items():
                acc[k] = acc.get(k, 0) + v
        out[name] = {"launches": launches, "plain": plain}
    return out


def bitwise_copies(pair) -> list:
    """Check every adoption's copy as it lands: the blocks read back from
    the decode tier's pool must be the source's bits, codes and scales
    alike. Returns the per-migration byte counts, filled as it runs."""
    sizes: list = []
    write = pair.decode.write_pool_blocks

    def checked(block_ids, values):
        n = write(block_ids, values)
        back = pair.decode.read_pool_blocks(block_ids)
        for got, want in zip(back, values):
            if not torch.equal(got.contiguous().view(torch.uint8),
                               want[:len(block_ids)].contiguous()
                               .view(torch.uint8)):
                fail(f"adopted blocks {list(block_ids)} are not the "
                     f"source's bits ({got.dtype} leaf)")
        sizes.append(n)
        return n

    pair.decode.write_pool_blocks = checked
    return sizes


def exactly_once(name: str, events: list) -> None:
    """Every namespaced rid that entered an engine (submit, adopt) ends
    there exactly once, or hands its request off (migrate) and ends
    nowhere there."""
    from nanosandbox_tpu_torch.obs.flight import TERMINAL_EVENTS

    terms: dict = {}
    entered, moved = set(), set()
    for e in events:
        if e["ev"] in ("submit", "adopt"):
            entered.add(e["rid"])
        elif e["ev"] == "migrate":
            moved.add(e["rid"])
        elif e["ev"] in TERMINAL_EVENTS:
            terms[e["rid"]] = terms.get(e["rid"], 0) + 1
    bad = {rid: terms.get(rid, 0) for rid in entered
           if terms.get(rid, 0) != (0 if rid in moved else 1)}
    if bad:
        fail(f"{name}: terminals per rid {bad} (want one each)")


def transfer_ms(pair, blocks: int) -> tuple:
    """Device time of one migration's copy of ``blocks`` chain blocks
    (read_pool_blocks on the prefill tier, write_pool_blocks on the
    decode tier, the same ids both sides; the engines are idle) and the
    bytes it moves."""
    ids = list(range(blocks))
    vals = pair.prefill.read_pool_blocks(ids)
    nbytes = sum(v.numel() * v.element_size() for v in vals)
    # The class's write, not bitwise_copies' checking wrapper.
    write = type(pair.decode).write_pool_blocks
    ms = time_ms(lambda: write(pair.decode, ids,
                               pair.prefill.read_pool_blocks(ids)))
    return ms, nbytes


def check_disagg_pairs(fd, at, smi: str, bf16, reqs) -> dict:
    """18a: per pool dtype, a DisaggPair against a colocated paged engine
    on phase 5's requests: tokens equal, every copy bit-identical, the
    decode tier's K1 launches 0 (eager and in its graphs) and no prefill
    dispatch, its K2 launches > 0, the prefill tier's K1 > 0; the
    migration's host wall p50 (export to adoption committed), its bytes a
    request and the device time of one request's copy."""
    from nanosandbox_tpu_torch.serve.disagg import DisaggPair
    from nanosandbox_tpu_torch.serve.engine import Engine

    kw = dict(num_slots=8, max_len=1024, device=DEVICE)
    out: dict = {}
    for mode in FLEET_KV_MODES:
        ref = serve_all(Engine(bf16, kv_dtype=mode, **kw), reqs, FLEET_NEW)
        pair = DisaggPair(bf16, kv_dtype=mode, **kw)
        sizes = bitwise_copies(pair)
        per = engine_counts(fd, at, pair.engines)
        got = serve_all(pair, reqs, FLEET_NEW)
        tot = engine_totals(per, pair.engines)
        st = pair.stats()
        bad = [i for i, (g, w) in enumerate(zip(got, ref)) if g != w]
        if bad:
            fail(f"18a {mode}: DisaggPair tokens differ from the colocated "
                 f"engine's for requests {bad}")
        if st["migrations"] != len(reqs) or not sizes:
            fail(f"18a {mode}: {st['migrations']} migrations of "
                 f"{len(reqs)} requests")
        exactly_once(f"18a {mode}", pair.merged_flight_events())
        dec = st["tiers"]["decode"]
        if dec["prefill_waves"] or dec["prefill_chunks"]:
            fail(f"18a {mode}: the decode tier dispatched prefills: {dec}")
        chain = max(len(p) for p, _ in reqs) // pair.prefill.kv_page_size
        ms, nbytes = (transfer_ms(pair, chain) if DEVICE != "cpu"
                      else (float("nan"), 0))
        out[mode] = {"tokens": got, "totals": tot, "stats": st,
                     "bytes_per_request": sum(sizes) / len(sizes),
                     "migration_s": st["migration_s"],
                     "copy_ms": ms, "copy_bytes": nbytes,
                     "copy_blocks": chain}
        print(f"  18a {mode}: {len(reqs)} requests x {FLEET_NEW} tokens equal "
              f"to the colocated engine's, {st['migrations']} migrations, "
              f"every copy bit-identical; launches prefill tier "
              f"{tot['prefill']['launches']}, decode tier "
              f"{tot['decode']['launches']}")
        del pair
        if DEVICE != "cpu":
            torch.cuda.empty_cache()
    print(f"  [{smi}] pool  bytes/request  migration p50 ms (host, export "
          "to adoption)  copy of one chain: blocks, MB, device ms, GB/s")
    for mode, r in out.items():
        p50 = r["migration_s"]["p50"]
        print(f"  {mode:<5} {r['bytes_per_request']:14.0f}  "
              f"{p50 * 1e3:10.3f}  {r['copy_blocks']:4d} "
              f"{r['copy_bytes'] / 1e6:8.3f} {r['copy_ms']:9.4f} "
              f"{r['copy_bytes'] / max(r['copy_ms'], 1e-9) / 1e6:8.1f}")
    return out


def check_pair_kill(fd, at, fp32, prompts) -> dict:
    """18a's replica_down leg, on phase 4's fp32 model (a restitched
    victim's salvaged tokens are prefilled where the colocated engine
    decoded them; in fp32 that cannot move a greedy token, in bf16 it
    can): phase 4's prompts migrate, then four more arrive four steps
    later and the kill fires in their migration window, with the first
    four decoding on the decode tier. Every request ends once, with the
    colocated engine's tokens."""
    from nanosandbox_tpu_torch.serve.disagg import DisaggPair
    from nanosandbox_tpu_torch.serve.engine import Engine
    from nanosandbox_tpu_torch.serve.faults import FaultPlan

    rng = np.random.default_rng(SEED + 18)
    late = [[int(t) for t in rng.integers(0, prompt_vocab(fp32.cfg), n)]
            for n in (33, 90, 140, 200)]
    reqs = [(p, {}) for p in prompts + late]
    kw = dict(num_slots=8, max_len=1024, device=DEVICE)
    ref = serve_all(Engine(fp32, **kw), reqs, ENGINE_NEW)
    pair = DisaggPair(fp32, faults=FaultPlan.parse("replica_down@4"), **kw)
    per = engine_counts(fd, at, pair.engines)
    rids = [pair.submit(p, ENGINE_NEW) for p in prompts]
    results = []
    for _ in range(4):
        results += pair.step()
    rids += [pair.submit(p, ENGINE_NEW) for p in late]
    results += pair.drain()
    sync()
    got = {r.rid: (r.tokens, r.finish_reason) for r in results}
    if sorted(got) != sorted(rids) or len(results) != len(rids):
        fail(f"18a kill: results {[r.rid for r in results]} for {rids}")
    bad = [i for i, r in enumerate(rids) if got[r] != ref[i]]
    if bad or not pair.decode.failed or pair.replica_downs != 1:
        fail(f"18a kill: tokens differ for requests {bad}; decode tier "
             f"failed {pair.decode.failed}, kills {pair.replica_downs}")
    exactly_once("18a kill", pair.merged_flight_events())
    st = pair.stats()
    restitched = sum(e["ev"] == "failover" for e in pair.flight.events())
    print(f"  18a kill: replica_down in the migration window at step "
          f"{[e['step'] for e in pair.flight.events() if e['ev'] == 'replica_down']}"
          f": {restitched} decoding requests restitched onto the prefill "
          f"tier, {st['fallbacks']} exports fell back colocated, "
          f"{len(rids)} requests ended once with the colocated engine's "
          f"tokens")
    return {"totals": engine_totals(per, pair.engines),
            "restitched": restitched, "fallbacks": st["fallbacks"]}


def check_fleet(fd, at, bf16, fp32, prompts) -> dict:
    """18b: a Fleet of two bf16 engines takes a request and then three
    sharing its 128-token prefix, one at a time: each follower routes
    to the warm replica by affinity and prefills only its suffix, and
    every answer equals a colocated bf16 engine's served the same way.
    Then a Fleet of two fp32 engines (phase 4's model: a failover
    prefills its victims' salvaged tokens, see check_pair_kill) under
    replica_down at step 6 with eight requests decoding: the victims
    fail over, each request ends once (one terminal a namespaced rid),
    and the tokens equal the colocated fp32 engine's."""
    from nanosandbox_tpu_torch.serve.engine import Engine
    from nanosandbox_tpu_torch.serve.faults import FaultPlan
    from nanosandbox_tpu_torch.serve.fleet import Fleet

    kw = dict(num_slots=8, max_len=1024, device=DEVICE)
    rng = np.random.default_rng(SEED + 19)
    vocab = prompt_vocab(bf16.cfg)
    shared = [int(t) for t in rng.integers(0, vocab, 128)]
    reqs = [(shared + [int(t) for t in rng.integers(0, vocab, n)],
             {"temperature": 0.8, "top_k": 40, "seed": i} if i % 2 else {})
            for i, n in enumerate((40, 25, 70, 9))]
    colo = Engine(bf16, **kw)
    ref = [serve_all(colo, [r], FLEET_NEW)[0] for r in reqs]
    fleet = Fleet(bf16, n_replicas=2, **kw)
    per = engine_counts(fd, at, fleet.replicas)
    got, homes = [], []
    for r in reqs:
        fid = fleet.submit(r[0], FLEET_NEW, **r[1])
        (res,) = fleet.drain()
        got.append((res.tokens, res.finish_reason))
        homes.append(fid.split(":")[0])
    sync()
    routes = [e for e in fleet.flight.events() if e["ev"] == "route"]
    hits = sum(e["reason"] == "affinity" for e in routes)
    if got != ref or hits < 3 or len(set(homes)) != 1:
        fail(f"18b affinity: tokens equal {got == ref}, routes "
             f"{[(e['replica'], e['reason'], e['est_hit_tokens']) for e in routes]}")
    warm = fleet.replicas[homes[0]].block_pool.stats()
    print(f"  18b affinity (bf16): {len(reqs)} requests, the followers "
          f"routed by affinity to {homes[0]} ({hits} affinity decisions, "
          f"est. hits {[e['est_hit_tokens'] for e in routes]}; prefix hit "
          f"tokens there {warm['prefix_hit_tokens']}), tokens equal to the "
          f"colocated engine's")
    aff = engine_totals(per, fleet.replicas)
    del fleet, colo
    late = [[int(t) for t in rng.integers(0, prompt_vocab(fp32.cfg), n)]
            for n in (50, 120, 64, 230)]
    reqs = [(p, {}) for p in prompts + late]
    ref = serve_all(Engine(fp32, **kw), reqs, ENGINE_NEW)
    fleet = Fleet(fp32, n_replicas=2,
                  faults=FaultPlan.parse("replica_down@6"), **kw)
    per = engine_counts(fd, at, fleet.replicas)
    got = serve_all(fleet, reqs, ENGINE_NEW)
    bad = [i for i, (g, w) in enumerate(zip(got, ref)) if g != w]
    events = fleet.merged_flight_events()
    fails = [e for e in events if e["ev"] == "failover"]
    if bad or fleet.replica_downs != 1 or not fails:
        fail(f"18b failover: tokens differ for requests {bad}; kills "
             f"{fleet.replica_downs}, failovers {len(fails)}")
    exactly_once("18b failover", events)
    print(f"  18b failover (fp32): replica_down at step 6 killed "
          f"{fails[0]['dead']} with {len(fails)} requests decoding; each "
          f"failed over with its salvaged tokens "
          f"{[e['tokens'] for e in fails]}, {len(reqs)} requests ended once "
          f"with the colocated engine's tokens")
    return {"affinity": aff, "failover": engine_totals(per, fleet.replicas),
            "failovers": len(fails)}


def check_http_tiers(fd, at, smi: str, want: list) -> dict:
    """18c: a --role=prefill and a --role=decode server (phase 5's model
    and flags; --warmup=buckets) behind an in-process RouterFrontend, all
    on loopback: phase 5's 60-token greedy request migrates (the answer
    names both replicas) with ``want``'s tokens; the prefill pod's
    serve_migrated_out_total and the decode pod's serve_adopted_in_total
    are >= 1, and the decode pod ran no prefill."""
    from nanosandbox_tpu_torch.checkpoint import save_for_serving
    from nanosandbox_tpu_torch.config import GPTConfig
    from nanosandbox_tpu_torch.models.gpt import GPT
    from nanosandbox_tpu_torch.serve.__main__ import build_server
    from nanosandbox_tpu_torch.serve.http import RouterFrontend

    cfg = GPTConfig(**MODEL)
    pods: dict = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fleet_") as out_dir:
        model = GPT(cfg, device=DEVICE, generator=torch.Generator(
            device=DEVICE).manual_seed(SEED))
        save_for_serving(out_dir, cfg, model.state_dict())
        del model
        for role in ("prefill", "decode"):
            server, loop, engine = build_server([
                f"--out_dir={out_dir}", "--host=127.0.0.1", "--port=0",
                "--num_slots=8", "--max_len=1024", "--kv_page_size=16",
                "--warmup=buckets", f"--device={DEVICE}", f"--role={role}"])
            th = threading.Thread(target=server.serve_forever, daemon=True)
            th.start()
            pods[role] = (server, loop, engine, th,
                          f"http://127.0.0.1:{server.server_address[1]}")
    engines = {role: pod[2] for role, pod in pods.items()}
    fe = None
    try:
        fe = RouterFrontend([pods["prefill"][4], pods["decode"][4]],
                            host="127.0.0.1", port=0, page=16,
                            health_interval_s=0.2).start()
        base = f"http://127.0.0.1:{fe.port}"
        deadline = time.monotonic() + 60
        while not fe._phase_tiering():
            if time.monotonic() > deadline:
                fail(f"18c: the router never saw both tiers ready: "
                     f"{fe.router.stats()}")
            time.sleep(0.05)
        per = engine_counts(fd, at, engines)
        prompt, kwargs = phase5_requests(cfg)[2]
        code, body = http_post(base + "/generate", dict(
            kwargs, prompt_tokens=prompt, max_new_tokens=FLEET_NEW))
        sync()
        out_m = scrape(pods["prefill"][4])["values"]
        in_m = scrape(pods["decode"][4])["values"]
        router = json.loads(http_get(base + "/debug/router")[1])
        fe_m = scrape(base)["values"]
    finally:
        if fe is not None:
            fe.stop()
        for server, loop, _, th, _ in pods.values():
            server.shutdown()
            server.server_close()
            loop.stop()
            loop.join(timeout=60)
            th.join(timeout=60)
    tot = engine_totals(per, engines)
    if code != 200 or body.get("migrated_from") != pods["prefill"][4] \
            or body.get("replica") != pods["decode"][4]:
        fail(f"18c: /generate through the router answered {code}: "
             f"{ {k: v for k, v in body.items() if k != 'tokens'} }")
    if body["tokens"] != want:
        fail("18c: the migrated request's tokens differ from phase 5's "
             "server's")
    migrated = out_m.get("serve_migrated_out_total", 0)
    adopted = in_m.get("serve_adopted_in_total", 0)
    if migrated < 1 or adopted < 1:
        fail(f"18c: serve_migrated_out_total {migrated} on the prefill "
             f"pod, serve_adopted_in_total {adopted} on the decode pod")
    dstats = engines["decode"].stats()
    if dstats["prefill_waves"] or dstats["prefill_chunks"]:
        fail(f"18c: the decode pod prefilled: {dstats['prefill_waves']} "
             "waves")
    print(f"  18c http: the router migrated phase 5's 60-token request "
          f"({len(want)} tokens, equal to the reference): prefill pod "
          f"serve_migrated_out_total {migrated:.0f}, decode pod "
          f"serve_adopted_in_total {adopted:.0f}; router decisions "
          f"{router['router']['decisions']}, serve_migrations_total "
          f"{ {k: v for k, v in fe_m.items() if 'serve_migrations_total' in k} }; "
          f"launches prefill pod {tot['prefill']['launches']}, decode pod "
          f"{tot['decode']['launches']}")
    return tot


def check_fleet_serving(fd, at, smi: str, served=None) -> dict:
    """Phase 18: 18a (check_disagg_pairs, check_pair_kill), 18b
    (check_fleet), 18c (check_http_tiers, its request's tokens held to
    phase 5's server's answer, or standalone to 18a's colocated bf16
    engine's, which phase 5's answer equals: the request prefills alone
    in a rung-1 wave and decodes in the 8-slot batch either way). The
    launch checks come last: K1 on every decode tier 0, K2 there > 0, K1
    on every prefill tier > 0, no plain version on the card."""
    t_phase = time.monotonic()
    bf16 = bf16_model()
    reqs = phase5_requests(bf16.cfg)
    pairs = check_disagg_pairs(fd, at, smi, bf16, reqs)
    fp32, prompts = fp32_model_and_prompts()
    kill = check_pair_kill(fd, at, fp32, prompts)
    fleet = check_fleet(fd, at, bf16, fp32, prompts)
    del bf16, fp32
    if DEVICE != "cpu":
        torch.cuda.empty_cache()
    colocated = pairs["bf16"]["tokens"][2][0]
    if served is not None and served[2] != colocated:
        fail("18a: the colocated bf16 engine's answer to phase 5's 60-token "
             "request differs from phase 5's server's")
    http = check_http_tiers(fd, at, smi, colocated if served is None
                            else served[2])
    # The launch checks.
    tiers = [(f"18a {mode}", r["totals"]) for mode, r in pairs.items()]
    tiers += [("18a kill", kill["totals"]), ("18c http", http)]
    for name, tot in tiers:
        k1 = {k: v for k, v in tot["decode"]["launches"].items()
              if k.startswith("flash_prefill_paged")}
        if any(k1.values()):
            fail(f"{name}: the decode tier launched K1: {k1}")
        for role, kernel in (("decode", "flash_decode_paged"),
                             ("prefill", "flash_prefill_paged")):
            if not any(v for k, v in tot[role]["launches"].items()
                       if k.startswith(kernel)):
                fail(f"{name} bypassed a kernel: the {role} tier never "
                     f"launched {kernel} ({tot[role]['launches']})")
    for name, tot in tiers + [("18b affinity", fleet["affinity"]),
                              ("18b failover", fleet["failover"])]:
        plain = {f"{eng}/{k}": v for eng, t in tot.items()
                 for k, v in t["plain"].items() if v}
        if plain:
            fail(f"{name}: plain versions ran on the card: {plain}")
        if not any(v for t in tot.values() for v in t["launches"].values()):
            fail(f"{name} bypassed a kernel: no launch at all")
    print(f"  phase 18: {time.monotonic() - t_phase:.1f} s")
    return {"pairs": pairs, "kill": kill, "fleet": fleet, "http": http}


# ---------------------------------------------------------------------------
# phase 21: the schedule fuzz over the serve host on the card
# ---------------------------------------------------------------------------

SCHED_SEEDS = (0, 1)
SCHED_NEW = 16
SCHED_KEYS = ("flash_prefill_paged/bf16", "flash_decode_paged/bf16")
# The fuzz's load: new tokens a request, the pool (16 blocks hold one
# slot's max_len of 256), requests per slot of the target, and the
# interactive requests' deadline.
SCHED_FUZZ_NEW = 32
SCHED_POOL_BLOCKS = 40
SCHED_FUZZ_PER_SLOT = 2
SCHED_DEADLINE_S = 0.1


def fuzz_requests(vocab: int, seed: int, n: int) -> list:
    """n (prompt, submit keywords): prompts of 60-200 tokens over the
    model's vocab; the even ones behind one shared 48-token prefix (the
    fleet's affinity, the prefix cache) and interactive with a deadline,
    the odd ones batch, the victims the deadline policy preempts."""
    rng = np.random.default_rng(SEED + 211 + seed)
    shared = rng.integers(0, vocab, 48).tolist()
    out = []
    for i in range(n):
        tail = rng.integers(0, vocab, int(rng.integers(60, 153))).tolist()
        out.append((shared + tail, {"slo_class": "interactive",
                                    "deadline_s": SCHED_DEADLINE_S})
                   if i % 2 == 0 else (tail, {"slo_class": "batch"}))
    return out


def sched_requests(vocab: int) -> list:
    """Six greedy requests, two of them sharing a 48-token prefix."""
    rng = np.random.default_rng(SEED + 210)
    shared = rng.integers(0, vocab, 48).tolist()
    out = []
    for i, n in enumerate((20, 60, 90, 130, 30, 70)):
        head = shared if i in (1, 2) else []
        out.append((head + rng.integers(0, vocab, n).tolist(),
                    {"temperature": 0.0}))
    return out


def group_run(fd, at, target, engines: list, reqs) -> dict:
    """Every engine's prefix cache flushed and counts zeroed, the
    requests served: tokens, K1/K2 launches (eager plus graph replays)
    and the sync ledger's growth by name."""
    from nanosandbox_tpu_torch.utils import tracecheck

    for eng in engines:
        eng.reset_prefix_cache()
        zero_replays(eng)
    if hasattr(target, "router"):
        for name in target.replicas:
            target.router.forget(name)
    fd.reset_counts()
    at.reset_counts()
    mark = tracecheck.sync_counts()
    tokens = serve_all(target, reqs, SCHED_NEW)
    launches = {k: n for k, n in fd.launches.items() if n}
    for eng in engines:
        for key, n in replay_counts(eng, eng.graph_launches).items():
            launches[key] = launches.get(key, 0) + n
    return {"tokens": tokens,
            "launches": {k: launches.get(k, 0) for k in SCHED_KEYS},
            "syncs": sorted(tracecheck.sync_delta(mark))}


def check_schedcheck(fd, at, smi: str) -> dict:
    """Phase 21 (the module docstring): the port's serve host under
    utils/schedcheck.py on the card."""
    from nanosandbox_tpu_torch.serve.disagg import DisaggPair
    from nanosandbox_tpu_torch.serve.engine import Engine
    from nanosandbox_tpu_torch.serve.fleet import Fleet
    from nanosandbox_tpu_torch.serve.http import EngineLoop
    from nanosandbox_tpu_torch.utils import schedcheck, tracecheck

    t_phase = time.monotonic()
    bf16 = bf16_model()
    kw = dict(num_slots=4, max_len=256, kv_pool_blocks=SCHED_POOL_BLOCKS,
              device=DEVICE)
    reqs = sched_requests(prompt_vocab(bf16.cfg))
    order = schedcheck.load_order()
    engine = Engine(bf16, **kw)
    fleet = Fleet(bf16, n_replicas=2, **kw)
    pair = DisaggPair(bf16, **kw)
    groups = (("engine loop", engine, [engine], schedcheck.instrument_engine),
              ("fleet", fleet, list(fleet.replicas.values()),
               schedcheck.instrument_fleet),
              ("disagg pair", pair, [pair.prefill, pair.decode],
               schedcheck.instrument_disagg))
    out: dict = {}
    for name, target, engines, instrument in groups:
        programs = [eng.program_counts() for eng in engines]
        ref = group_run(fd, at, target, engines, reqs)
        check = schedcheck.SchedCheck(seed=SCHED_SEEDS[0], order=order)
        instrument(target, check)
        got = group_run(fd, at, target, engines, reqs)
        print(f"  {name}: {len(reqs)} requests x {SCHED_NEW} tokens; "
              f"launches {ref['launches']} plain, {got['launches']} "
              f"instrumented; syncs by name {ref['syncs']}")
        bad = [i for i, (a, b) in enumerate(zip(ref["tokens"],
                                                 got["tokens"])) if a != b]
        if bad or got["launches"] != ref["launches"] or \
                got["syncs"] != ref["syncs"]:
            fail(f"phase 21 {name}: instrumentation changed tokens of "
                 f"requests {bad}, launches {ref['launches']} -> "
                 f"{got['launches']} or syncs {ref['syncs']} -> "
                 f"{got['syncs']}")
        # The fuzz, inside the frozen budgets: a capture would raise.
        loop = None
        if name == "engine loop":
            loop = EngineLoop(engine)
            loop.start()
        stats = []
        try:
            with contextlib.ExitStack() as frozen:
                for eng in engines:
                    frozen.enter_context(eng.tracecheck.frozen())
                frozen.enter_context(tracecheck.global_registry().frozen())
                for seed in SCHED_SEEDS:
                    load = dict(order=order, budget=SCHED_FUZZ_NEW,
                                requests=fuzz_requests(
                                    prompt_vocab(bf16.cfg), seed,
                                    SCHED_FUZZ_PER_SLOT * sum(
                                        e.num_slots for e in engines)))
                    pre = [sum(e.preemptions for e in engines),
                           sum(e.shed for e in engines)]
                    if loop is not None:
                        c = schedcheck.fuzz_engine_loop(loop, seed, **load)
                    elif name == "fleet":
                        c = schedcheck.fuzz_fleet(target, seed, **load)
                    else:
                        c = schedcheck.fuzz_disagg(target, seed, **load)
                    c.assert_clean()
                    stats.append((seed, len(load["requests"]), c.acquires,
                                  c.preemptions,
                                  sum(e.preemptions for e in engines) - pre[0],
                                  sum(e.shed for e in engines) - pre[1]))
        finally:
            if loop is not None:
                loop.stop()
                loop.join(60)
        after = [eng.program_counts() for eng in engines]
        print(f"  {name}: fuzz (seed, requests, instrumented acquires, "
              f"injected preemptions, engine preemptions, sheds) {stats}, "
              f"clean; program counts {after}")
        if after != programs:
            fail(f"phase 21 {name}: the fuzz built programs: {programs} "
                 f"-> {after}")
        out[name] = {"ref": ref, "fuzz": stats}
    del engine, fleet, pair
    if DEVICE != "cpu":
        torch.cuda.empty_cache()
    print(f"  [{smi}] phase 21: {time.monotonic() - t_phase:.1f} s")
    # The launch checks come last.
    for name, run in out.items():
        need_launches(f"phase 21 {name}", {
            "launches": run["ref"]["launches"], "plain_cuda_calls": {}},
            SCHED_KEYS)
    return out


# ---------------------------------------------------------------------------
# phase 20: tensor parallelism (the model mesh axis)
# ---------------------------------------------------------------------------

TP = 2
# (b) Phase 4's fp32 model at tp 2 over each pool and dispatch mode; each
# against the same engine at tp 1 (greedy tokens identical).
TP_MODES = (("paged fp32", {}), ("paged int8", dict(kv_dtype="int8")),
            ("paged int4", dict(kv_dtype="int4")),
            ("dense fp32", dict(paged=False)),
            ("paged scan_k 4", dict(scan_k=4)),
            ("paged NGram", dict(spec=True)))
# (f) The 124M multihost config at full width (12 heads, C 768, vocab
# 50304, block 1024) and 4 of its 12 layers, a global batch of 8 rows,
# 3 steps, warmup 1, at mesh_tp 2 over 2 ranks, in fp32 and bf16; (g) the
# same fp32 cut at mesh_fsdp 2 x mesh_tp 2 with shard_params; (g) the 8k
# dropout config at mesh_sp 2 x mesh_tp 2 (ring attention, dropout 0.1),
# fp32, 2 of its layers, 2 steps (phase 13's cut).
P20_CUTS = ["--batch_size=8", "--gradient_accumulation_steps=1",
            "--max_iters=3", "--lr_decay_iters=3", "--warmup_iters=1",
            "--n_layer=4"]
P20_FP32 = ["--compute_dtype=float32"]
P20_SP = ["--compute_dtype=float32", "--n_layer=2", "--max_iters=2",
          "--lr_decay_iters=2"]


def shard_kernel_cases(fd) -> dict:
    """(e): K2, K1 and K3 at a tp 2 shard's shape (H 6 of GPT-2 124M's
    12 heads, D 64), each against its plain version and timed beside its
    bound and its library call (phase 3's method): K2 at the serving
    steady state (8 rows x 512 positions) and K1 at a wave (8 x 512 from
    0) under bf16 and fp32 queries over a pool in the query's dtype, K3
    over fp32 slot rows (8 x 512) under an fp32 query."""
    import torch.nn.functional as F

    rng = np.random.default_rng(SEED + 20)
    H, D, T = 12 // TP, 64, 512
    lens = np.full(8, T, np.int32)
    sk, sv, stbl = make_case(rng, 8, lens, H=H)
    slen = torch.from_numpy(lens).to(DEVICE)
    start = np.zeros(8, np.int32)
    pstart = torch.from_numpy(start).to(DEVICE)
    pq = torch.from_numpy(rng.standard_normal((8, H, T, D),
                                              dtype=np.float32)).to(DEVICE)
    dq = torch.from_numpy(rng.standard_normal((8, H, D),
                                              dtype=np.float32)).to(DEVICE)
    ck, cv = (torch.from_numpy(rng.standard_normal(
        (8, H, T, D), dtype=np.float32)).to(DEVICE) for _ in range(2))
    mask = (torch.arange(T, device=DEVICE)[None, None, None, :]
            < slen[:, None, None, None])
    causal = torch.ones(T, T, dtype=torch.bool, device=DEVICE).tril()
    shape = f"B=8 H={H} D={D} lengths=8x{T} (tp {TP} shard)"
    tot = int(lens.sum())
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, qT = dq.to(dtype), pq.to(dtype)
        k, v = sk.to(dtype), sv.to(dtype)
        gk, gv = gathered(k, stbl, T), gathered(v, stbl, T)
        fp = "fp32" if dtype == torch.float32 else "bf16"
        runs = [
            ("K2", lambda: fd.flash_decode_paged(q, k, v, stbl, slen),
             lambda: fd.torch_decode_attention_paged(q, k, v, stbl, slen),
             lambda: F.scaled_dot_product_attention(q[:, :, None], gk, gv,
                                                    attn_mask=mask),
             decode_bytes(tot, H, D, fp, q.numel() * q.element_size()),
             4 * H * D * tot),
            ("K1", lambda: fd.flash_prefill_paged(qT, k, v, stbl, pstart),
             lambda: fd.torch_prefill_attention_paged(qT, k, v, stbl,
                                                      pstart),
             lambda: F.scaled_dot_product_attention(qT, gk, gv,
                                                    attn_mask=causal),
             decode_bytes(tot, H, D, fp, qT.numel() * qT.element_size()),
             int(8 * 4 * H * D * T * T / 2))]
        if dtype == torch.float32:
            runs.append((
                "K3", lambda: fd.flash_decode(q, ck, cv, slen),
                lambda: fd.torch_decode_attention(q, ck, cv, slen),
                lambda: F.scaled_dot_product_attention(q[:, :, None], ck, cv,
                                                       attn_mask=mask),
                decode_bytes(tot, H, D, "fp32", q.numel() * q.element_size()),
                4 * H * D * tot))
        for kind, fn, plain, library, nbytes, flops in runs:
            err = check_limits(f"phase 20 {kind} q {fp} {shape}", fn(),
                               plain(), dtype)
            out[(kind, fp)] = case(kind, dtype, shape, err,
                                   DECODE_TOL[dtype]["abs"], fn, plain,
                                   library, nbytes, flops)
    for (kind, fp), c in out.items():
        print(f"  {kind} q {fp:<4} {c['shape']}: max|err| "
              f"{c['max_abs_err']:.2e}, {c['ms']:.5f} ms (bound "
              f"{c['bound_ms']:.5f} ms [{c['bound_by']}], "
              f"{100 * c['bound_ms'] / c['ms']:.1f}%), plain "
              f"{c['plain_ms']:.5f} ms, library {c['library_ms']:.5f} ms")
    return out


def tp_serve(model, reqs, new, *, tp, **kw) -> dict:
    """One engine (8 slots x 1024) at ``tp`` drained over ``reqs``
    ((prompt, sampling keywords)), every count reset just before: tokens,
    launches (counted_launches), plain calls on the card, stats, and each
    graph replayed once under a trace (graph_trace: a decode step's K2 or
    K3 launches are rung x n_layer x tp)."""
    from nanosandbox_tpu_torch.ops import attention as at
    from nanosandbox_tpu_torch.ops import flash_decode as fd
    from nanosandbox_tpu_torch.serve.drafters import NGramDrafter
    from nanosandbox_tpu_torch.serve.engine import Engine

    spec = kw.pop("spec", False)
    engine = Engine(model, num_slots=8, max_len=1024, device=DEVICE, tp=tp,
                    spec=NGramDrafter(k=SPEC_K) if spec else None, **kw)
    fd.reset_counts()
    at.reset_counts()
    got = serve_all(engine, reqs, new)
    out = {"tokens": got, "launches": counted_launches(fd, engine),
           "plain_cuda_calls": counted_plain(fd, at, engine),
           "stats": engine.stats(), "engine": engine}
    if not spec:
        out["graph_trace"] = graph_trace(f"phase 20 tp {tp} {kw}", engine)
    return out


def need_k1_per_wave(name: str, run: dict, key: str) -> None:
    """K1's launches must be one a layer and shard for each prefill
    dispatch (waves and chunks; a verify's come on top under spec)."""
    st, e = run["stats"], run["engine"]
    want = e.cfg.n_layer * e.tp * (st["prefill_waves"] + st["prefill_chunks"])
    got = run["launches"].get(key, 0)
    if (got != want if "verify" not in st["host_dispatches"]
            else got < want):
        fail(f"phase 20 {name}: {key} launched {got}, want n_layer x tp x "
             f"prefill dispatches = {want}")


def tp_training_legs(tmp: str, smi: str) -> dict:
    """(f), (g) and (h): start the training ranks in two waves on the card
    and return a function that waits for them and checks them."""
    import os

    from nanosandbox_tpu_torch.config import load_config
    from nanosandbox_tpu_torch.data.prepare import prepare_bpe_dataset

    owt = os.path.join(tmp, "openwebtext")
    if not os.path.exists(os.path.join(owt, "train.bin")):
        prepare_bpe_dataset(owt, source_files=[CORPUS], tokenizer="bpe")
    base = [f"--data_dir={tmp}", f"--device={DEVICE}", *P19_RUN]
    sp_base = [f"--data_dir={tmp}", f"--device={DEVICE}", *SP_CUTS]
    runs: dict = {}
    live: list = []

    def start(name, n, config, flags, out_dir=None, b=base):
        if live and live[-1] is None:
            fail(f"phase 20: {name} not started, the phase failed")
        tag = os.path.join(tmp, "p20_" + name.replace(" ", "_"))
        out_dir = out_dir or tag
        handle = start_ranks(n, "fused", [config, *b, f"--out_dir={out_dir}",
                                          *flags], tag, digest=True)
        live.append(handle)
        return {"name": name, "n": n, "out_dir": out_dir, "handle": handle,
                "cfg": load_config([config, *b, *flags])}

    def stop() -> None:
        """Kill every rank still running (a check before them failed)."""
        live.append(None)               # the waves start nothing more
        for _, procs, _ in live[:-1]:
            for p, log in procs:
                p.kill()
                p.wait()
                log.close()

    def finish(*started):
        for run in started:
            handle = run.pop("handle")
            run["reports"] = wait_ranks(handle)
            run["wall_s"] = time.monotonic() - handle[2]
            run["note"] = "sharing the card"
            for rep_ in run["reports"]:
                if any(rep_["plain_cuda_calls"].values()):
                    fail(f"phase 20 {run['name']}: plain versions ran on "
                         f"the card on rank {rep_['rank']}")
            runs[run["name"]] = run

    tp = [f"--mesh_tp={TP}", "--mesh_dp=1"]
    fp32 = P20_CUTS + P20_FP32
    wave = [start(*leg) for leg in (
        ("tp fp32", TP, DP_CONFIG, fp32 + tp),
        ("tp bf16", TP, DP_CONFIG, P20_CUTS + tp),
        ("fp32 one", 1, DP_CONFIG, fp32),
        ("bf16 one", 1, DP_CONFIG, P20_CUTS),
        ("seq one", 1, SP_DROPOUT_CONFIG,
         P20_SP + ["--mesh_sp=1", "--remat=False"], None, sp_base))]

    def waves() -> None:
        """The first wave to its end, then the second (the resume reads
        the first's checkpoint), on a thread beside the serving checks."""
        try:
            finish(*wave)
            second = [start(*leg) for leg in (
                ("fsdp x tp", 4, DP_CONFIG,
                 fp32 + ["--shard_params=True", "--mesh_fsdp=2",
                         "--mesh_dp=1", f"--mesh_tp={TP}"]),
                ("seq x tp", 4, SP_DROPOUT_CONFIG,
                 P20_SP + ["--mesh_sp=2", f"--mesh_tp={TP}"], None,
                 sp_base),
                ("tp resume one", 1, DP_CONFIG,
                 fp32 + ["--init_from=resume", "--run_name=resume_one"],
                 runs["tp fp32"]["out_dir"]))]
            finish(*second)
        except BaseException as e:      # fail() raises SystemExit
            runs["error"] = e

    thread = threading.Thread(target=waves, daemon=True)
    thread.start()

    def check() -> dict:
        thread.join()
        if "error" in runs:
            raise runs["error"]
        print("    training runs' walls, s (sharing the card): " + ", ".join(
            f"{name} {run['wall_s']:.1f}" for name, run in runs.items()))
        for name, ref, lims in (
                ("tp fp32", "fp32 one", (DP_FP32_LOSS_REL, DP_FP32_NORM_REL)),
                ("tp bf16", "bf16 one", (DP_BF16_LOSS_REL, DP_BF16_NORM_REL)),
                ("fsdp x tp", "fp32 one",
                 (DP_FP32_LOSS_REL, DP_FP32_NORM_REL)),
                ("seq x tp", "seq one", (1e-5, 1e-4))):
            run = runs[name]
            compare_steps(name, run, runs[ref], *lims)
            c = run["cfg"]
            for rep_ in run["reports"]:
                if name == "seq x tp":
                    want = expected_launches(c.ring_layout, 2,
                                             (rep_["rank"] // TP) % 2,
                                             c.n_layer, c.max_iters, 2,
                                             "fused")
                else:
                    want = dp_expected(c.n_layer, c.max_iters)
                got = {k: v for k, v in rep_["launches"].items() if v}
                if (got != {k: v for k, v in want.items() if v}
                        and DEVICE != "cpu"):
                    fail(f"phase 20 {name}: rank {rep_['rank']} launched "
                         f"{got}, expected {want}")
            shas = {rep_["state"]["param_sha256"] for rep_ in run["reports"]}
            if name in ("tp fp32", "tp bf16") and len(shas) != TP:
                fail(f"phase 20 {name}: the model ranks hold "
                     f"{len(shas)} distinct shards, want {TP}")
            for rep_ in run["reports"]:
                x, st = rep_["exchanged"], rep_["state"]
                one = runs[ref]["reports"][0]["state"]
                mib = {k: x[f"{k}_bytes"] / c.max_iters / 2**20
                       for k in ("tp", "allreduce", "ring")}
                print(f"    [{smi}] {name} rank {rep_['rank']}: parameters "
                      f"{st['param_bytes']:,} B, moments "
                      f"{st['moment_bytes']:,} B (one process's x "
                      f"{st['param_bytes'] / one['param_bytes']:.4f} / "
                      f"{st['moment_bytes'] / one['moment_bytes']:.4f}); a "
                      f"step exchanges tp {mib['tp']:.1f} MiB in "
                      f"{x['tp_seconds'] / c.max_iters:.3f} s, all-reduce "
                      f"{mib['allreduce']:.1f} MiB, ring {mib['ring']:.1f} "
                      "MiB (host-staged gloo on one card; the end's eval "
                      f"included); peak {rep_['peak_memory_gb']:.2f} GiB")
                if not x["tp_bytes"]:
                    fail(f"phase 20 {name}: rank {rep_['rank']} exchanged "
                         "nothing over the model group")
                # A model rank holds 1/TP of every block's projections
                # (12 C^2 a layer, and the column-parallel biases) and the
                # embeddings and LayerNorms whole.
                C, item = c.n_embd, 4 if c.param_dtype == "float32" else 2
                split = c.n_layer * (12 * C * C + (7 * C if c.bias else 0))
                want_b = one["param_bytes"] - item * split * (TP - 1) // TP
                if name in ("tp fp32", "tp bf16") and (
                        st["param_bytes"] != want_b
                        or st["moment_bytes"] != 2 * want_b):
                    fail(f"phase 20 {name}: rank {rep_['rank']} holds "
                         f"{st['param_bytes']} parameter and "
                         f"{st['moment_bytes']} moment bytes, want {want_b} "
                         f"and {2 * want_b}")
        from nanosandbox_tpu_torch.checkpoint import TrainCheckpointer

        blob = TrainCheckpointer(runs["tp fp32"]["out_dir"]).restore()
        got = runs["tp resume one"]["reports"][0]["state"]["param_sha256"]
        if got != state_digest(blob["model"]):
            fail("phase 20 (h): the tp 2 checkpoint restored in one process "
                 "differs from it")
        print(f"  (h) the tp {TP} run's checkpoint (step {blob['iter_num']}, "
              "written by rank 0 from the gathered shards) restored bit for "
              "bit in one process")
        return runs

    check.stop = stop
    return check


def check_tp(fd, at, smi: str, tmp: str) -> dict:
    """Phase 20 (module docstring) in ``tmp`` (phase 19's, whose
    openwebtext it reuses); returns the runs whose launches the kernels
    line reads."""
    from nanosandbox_tpu_torch.models.gpt import shard_for_serving

    t_phase = time.monotonic()
    print("  (e) kernels at the shard shape")
    kern = shard_kernel_cases(fd)
    # (a) the bf16 124M paged engine at tp 1 and 2 on phase 5's requests.
    bf16 = bf16_model()
    reqs = phase5_requests(bf16.cfg)
    serve = {tp: tp_serve(bf16, reqs, FLEET_NEW, tp=tp) for tp in (1, TP)}
    same = sum(a == b for a, b in zip(serve[1]["tokens"], serve[TP]["tokens"]))
    x = torch.tensor([p[:256] for p, _ in reqs if len(p) >= 256][:2]
                     or [reqs[0][0]], device=DEVICE)
    with torch.no_grad():
        full = bf16(x)[:, -1]
        sharded = shard_for_serving(bf16, TP)(x)[:, -1]
    err = (full - sharded).abs().max().item()
    need_launches("phase 20 (a) bf16 tp 2", serve[TP],
                  ("flash_decode_paged/bf16", "flash_prefill_paged/bf16"))
    need_k1_per_wave("(a) bf16", serve[TP], "flash_prefill_paged/bf16")
    tpot = {tp: serve[tp]["stats"]["tpot_s"]["p50"] * 1e3 for tp in serve}
    print(f"  (a) bf16 124M paged engine, phase 5's {len(reqs)} requests x "
          f"{FLEET_NEW} tokens: tp {TP} answers equal to tp 1's: {same} of "
          f"{len(reqs)}; last-position logits of {tuple(x.shape)} prompts, "
          f"no-cache forward, tp {TP} vs tp 1: max |diff| {err:.3e}; launches "
          f"tp {TP} {serve[TP]['launches']}, graphs traced "
          f"{serve[TP]['graph_trace']}")
    print(f"    [{smi}] TPOT p50 tp 1 {tpot[1]:.3f} ms, tp {TP} "
          f"{tpot[TP]:.3f} ms (both shards on this one card: the layout's "
          f"cost, not a speed of TP); (e) and (a) took "
          f"{time.monotonic() - t_phase:.1f} s")
    if same < len(reqs) // 2 or err > 0.5:
        fail(f"phase 20 (a): tp {TP} bf16 answers equal to tp 1's {same} of "
             f"{len(reqs)}, logits max |diff| {err}")
    for tp in serve:
        serve[tp].pop("engine")
    del bf16
    release()
    # The training ranks run from here on, beside the serving checks.
    training = tp_training_legs(tmp, smi)
    try:
        t0 = time.monotonic()
        serving = tp_serving_checks()
        print(f"  (b) and (c) took {time.monotonic() - t0:.1f} s, beside "
              "the training ranks")
    except BaseException:
        training.stop()
        raise
    try:
        train = training()
    except BaseException:
        training.stop()
        raise
    print(f"  phase 20: {time.monotonic() - t_phase:.1f} s")
    return {"kernels": kern, "serve": serve, "train": train, **serving}


def release() -> None:
    """Free what dropped engines held on the card now: an engine's
    watchdog panel refers back to it, so only the cycle collector frees
    its pool and graphs (the training ranks share the card)."""
    import gc

    gc.collect()
    if DEVICE != "cpu":
        torch.cuda.empty_cache()


def tp_serving_checks() -> dict:
    """(b), (c) and (d) on phase 4's fp32 model: the tp 2 engine in
    every pool and dispatch mode against tp 1, recovery and preemption,
    the fleet and the mixed-tp pair; returns (b)'s runs."""
    from nanosandbox_tpu_torch.serve.disagg import DisaggPair
    from nanosandbox_tpu_torch.serve.engine import Engine
    from nanosandbox_tpu_torch.serve.faults import FaultPlan
    from nanosandbox_tpu_torch.serve.fleet import Fleet

    # (b) phase 4's fp32 model at tp 2 in every pool and dispatch mode.
    fp32, prompts = fp32_model_and_prompts()
    preqs = [(p, {}) for p in prompts]
    runs = {}
    for name, kw in TP_MODES:
        ref = tp_serve(fp32, preqs, ENGINE_NEW, tp=1, **dict(kw))
        run = tp_serve(fp32, preqs, ENGINE_NEW, tp=TP, **dict(kw))
        if run["tokens"] != ref["tokens"]:
            fail(f"phase 20 (b) {name}: tp {TP} greedy tokens differ from "
                 "tp 1's")
        # Under spec every step is a verify: K1 over the drafts.
        key = ("flash_decode" if kw.get("paged", True) is False
               else "flash_prefill_paged" if kw.get("spec")
               else "flash_decode_paged") + "/" + kw.get("kv_dtype", "fp32")
        need_launches(f"phase 20 (b) {name}", run, (key,))
        if kw.get("paged", True):
            need_k1_per_wave(f"(b) {name}", run, "flash_prefill_paged/" +
                             kw.get("kv_dtype", "fp32"))
        captured = [r["engine"].tracecheck.counts() for r in (run, ref)]
        if captured[0] != captured[1]:
            fail(f"phase 20 (b) {name}: graphs captured {captured[0]} vs "
                 f"tp 1's {captured[1]}")
        run.pop("engine")
        del ref
        release()
        runs[name] = run
        print(f"  (b) {name}: tp {TP} tokens identical to tp 1's; launches "
              f"{run['launches']}" + (f", graphs traced {run['graph_trace']}"
                                      if run.get("graph_trace") else ""))
    clean = spec_run(fp32, prompts, tp=TP)["tokens"]
    release()
    for name, plan in (("nan_logits@3", True), ("preempt_storm@4x2", False)):
        got = spec_run(fp32, prompts, tp=TP, supervised=plan,
                       faults=FaultPlan.parse(name))
        e = got.pop("engine")
        n = (e.recoveries, e.preemptions)
        del e, got["supervisor"]
        release()
        if got["tokens"] != clean or n[0 if plan else 1] < 1:
            fail(f"phase 20 (b) {name} at tp {TP}: tokens equal to a clean "
                 f"run {got['tokens'] == clean}, recoveries {n[0]}, "
                 f"preemptions {n[1]}")
        print(f"  (b) {name} at tp {TP}: recoveries {n[0]}, preemptions "
              f"{n[1]}; tokens equal to a clean tp {TP} run")
    # (c) a Fleet of two tp 2 replicas, and a pair with a tp 2 prefill tier
    # and a tp 1 decode tier, against the colocated tp 1 engine.
    kw = dict(num_slots=8, max_len=1024, device=DEVICE)
    want = serve_all(Engine(fp32, **kw), preqs, ENGINE_NEW)
    release()
    fleet = Fleet(fp32, n_replicas=2, tp=TP, **kw)
    got = serve_all(fleet, preqs, ENGINE_NEW)
    del fleet
    release()
    pair = DisaggPair(fp32, prefill_tp=TP, **kw)
    got_pair = serve_all(pair, preqs, ENGINE_NEW)
    if got != want or got_pair != want:
        fail(f"phase 20 (c): Fleet(tp={TP}) tokens equal {got == want}, "
             f"the tp {TP} / tp 1 pair's {got_pair == want}")
    print(f"  (c) Fleet(n_replicas=2, tp={TP}) and a DisaggPair with a tp "
          f"{TP} prefill tier and a tp 1 decode tier "
          f"({pair.stats()['migrations']} migrations): tokens equal to the "
          "colocated tp 1 engine's")
    del pair, fp32
    release()
    return {"runs": runs}


# Phases that stand alone, for a partial run (--phases=2,3,7,9,13,14,15,16,
# 17,18,19,20; 9 runs phase 12 after it).
STANDALONE_PHASES = (2, 3, 7, 9, 13, 14, 15, 16, 17, 18, 19, 20, 21)


def train_and_sample(at, fd, smi: str) -> None:
    """Phase 9, then phase 12 on its checkpoint, in a temporary dir."""
    from nanosandbox_tpu_torch.ops import _build

    _build.library()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        check_trainer(at, fd, smi, tmp)
        print("== phase 12: the sampler on phase 9's checkpoint")
        check_sampler(tmp)


def header(text: str) -> None:
    """A phase's header line, with the seconds since the script started."""
    print(f"{text} [at {time.monotonic() - T_START:.1f} s]", flush=True)


def main(argv: list[str] | None = None) -> int:
    args = sys.argv[1:] if argv is None else argv
    only = None
    for arg in args:
        name, _, value = arg.partition("=")
        if name != "--phases":
            raise SystemExit(f"chip_smoke: unknown argument {arg!r} (only "
                             "--phases=<comma list of "
                             f"{STANDALONE_PHASES}>)")
        only = {int(p) for p in value.split(",")}
        if not only <= set(STANDALONE_PHASES):
            raise SystemExit(f"chip_smoke: --phases takes phases of "
                             f"{STANDALONE_PHASES}, not {sorted(only)}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch; this script "
              "runs the port on a GPU only", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from nanosandbox_tpu_torch.ops import _build
    from nanosandbox_tpu_torch.ops import attention as at
    from nanosandbox_tpu_torch.ops import flash_decode as fd

    header("== phase 1: device")
    smi = nvidia_smi()
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    print(f"  nvidia-smi: {smi}")
    if only is not None:
        # Phases 2, 3 and 7 alone (the kernels' build, checks and times),
        # with no result line: the full run alone makes one.
        for phase, title, fn in (
                (2, "build", lambda: check_build(_build)),
                (3, "kernels vs plain versions (124M shapes)",
                 lambda: check_kernels(fd)),
                (7, "training kernels vs plain versions",
                 lambda: (check_train_kernels(at), check_ring_blocks(at))),
                (9, "the 124M bf16 trainer, then phase 12's sampler on "
                    "its checkpoint",
                 lambda: train_and_sample(at, fd, smi)),
                (13, "the sequence-parallel trainer (4 ranks, one card)",
                 lambda: (_build.library(), check_sp_trainer(
                     smi, tempfile.mkdtemp(prefix="chip_smoke_sp_")))),
                (14, "dispatch modes on the card",
                 lambda: check_dispatch(fd, smi)),
                (15, "scheduling (chunked prefill, preemption, deadlines)",
                 lambda: (_build.library(), check_scheduling(fd, at, smi))),
                (16, "speculative decoding and recovery",
                 lambda: (_build.library(),
                          check_spec_and_recovery(fd, at, smi))),
                (17, "observability on the live server",
                 lambda: (_build.library(), check_observability(
                     fd, smi, tempfile.mkdtemp(prefix="chip_smoke_obs_")))),
                (18, "multi-replica serving (disaggregated tiers, the "
                     "fleet, the router)",
                 lambda: (_build.library(),
                          check_fleet_serving(fd, at, smi))),
                (19, "data-parallel and FSDP training, the HF round trip",
                 lambda: (_build.library(), check_dp_fsdp(
                     smi, tempfile.mkdtemp(prefix="chip_smoke_dp_")))),
                (20, "tensor parallelism (the model mesh axis)",
                 lambda: (_build.library(), check_tp(
                     fd, at, smi,
                     tempfile.mkdtemp(prefix="chip_smoke_tp_")))),
                (21, "the schedule fuzz over the serve host",
                 lambda: (_build.library(), check_schedcheck(fd, at, smi)))):
            if phase in only:
                header(f"== phase {phase}: {title}")
                fn()
        print(f"chip_smoke: phases {sorted(only)} passed (a partial run "
              "prints no result line)")
        return 0

    header("== phase 2: build")
    check_build(_build)

    header("== phase 3: kernels vs plain versions (124M shapes)")
    kern = check_kernels(fd)

    header("== phase 4: fp32 124M engine vs no-cache recompute")
    model, prompts = fp32_model_and_prompts()
    ref = recompute(model, prompts)
    paged_fp32 = check_engine_fp32(model, prompts, ref)

    header("== phase 5: bf16 124M server")
    served = check_server(fd, smi)

    header("== phase 6: launch counts on the serving path")
    print(f"  kernels {served['launches']}; plain versions on CUDA "
          f"{served['plain_cuda_calls']}")

    header("== phase 7: training kernels vs plain versions")
    train_cases = check_train_kernels(at)
    ring_cases = check_ring_blocks(at)

    header("== phase 8: fp32 124M loss and gradients, kernels vs plain")
    parity_launches = check_train_parity(at)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        header("== phase 9: the 124M bf16 trainer")
        trained = check_trainer(at, fd, smi, tmp)

        header("== phase 10: fp32 124M engines, dense pool and int8/int4 "
              "pools")
        pools = check_pools_fp32(model, prompts, ref, paged_fp32)
        del model
        torch.cuda.empty_cache()

        header("== phase 11: bf16 124M servers, dense pool and int8/int4 "
              "pools")
        servers = {"paged bf16": served}
        for name, flags, need in (
                ("dense bf16", ["--paged=off"], (
                    "flash_decode/bf16", "flash_attention_fwd")),
                ("paged int8", ["--kv_dtype=int8"], (
                    "flash_decode_paged/int8", "flash_prefill_paged/int8")),
                ("paged int4", ["--kv_dtype=int4"], (
                    "flash_decode_paged/int4", "flash_prefill_paged/int4"))):
            servers[name] = check_server(fd, smi, flags, need)
        print(f"  [{smi}]\n  mode        decode tok/s  TTFT p50 ms  "
              "TPOT p50 ms")
        for name, sv in servers.items():
            st = sv["stats"]
            print(f"  {name:<11} {st['decode_tokens_per_sec']:12.1f}  "
                  f"{st['ttft_s']['p50'] * 1e3:11.2f}  "
                  f"{st['tpot_s']['p50'] * 1e3:11.3f}")

        header("== phase 12: the sampler on phase 9's checkpoint")
        check_sampler(tmp)

        header("== phase 13: the sequence-parallel trainer (4 ranks, one "
              "card)")
        sp = check_sp_trainer(smi, tmp)

    header("== phase 14: dispatch modes on the card")
    check_dispatch(fd, smi)

    header("== phase 15: scheduling (chunked prefill, preemption, deadlines)")
    check_scheduling(fd, at, smi, served["answers"])

    header("== phase 16: speculative decoding and recovery")
    spec = check_spec_and_recovery(fd, at, smi, paged_fp32["tokens"],
                                   pools["dense fp32"]["tokens"], served)

    header("== phase 17: observability on the live server")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_obs_") as tmp:
        check_observability(fd, smi, tmp)

    header("== phase 18: multi-replica serving (disaggregated tiers, the "
          "fleet, the router)")
    check_fleet_serving(fd, at, smi, served["answers"])

    header("== phase 19: data-parallel and FSDP training, the HF round trip")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_") as tmp:
        dp = check_dp_fsdp(smi, tmp)
        header("== phase 20: tensor parallelism (the model mesh axis)")
        p20 = check_tp(fd, at, smi, tmp)

    header("== phase 21: the schedule fuzz over the serve host")
    check_schedcheck(fd, at, smi)

    def entry(name, source, replaces, launches, case):
        return {"name": name, "route": "cuda",
                "source": f"nanosandbox_tpu_torch/csrc/{source}",
                "replaces": f"nanosandbox_tpu/ops/{replaces}",
                "launches": launches,
                "max_abs_err": case["max_abs_err"], "ms": case["ms"],
                "plain_ms": case["plain_ms"], "bound_ms": case["bound_ms"],
                "bound_by": case["bound_by"],
                "library_ms": case["library_ms"],
                "case": f"{case['dtype']} {case['shape']}"}

    def timed(kernel, dtype, shape=""):
        """The first phase-3 case of a kernel instance whose shape starts
        with ``shape``."""
        return next(c for c in kern["cases"] if c["kernel"] == kernel
                    and c["dtype"] == dtype and c["shape"].startswith(shape))

    paged, dense = "paged_attention.cu", "flash_decode.cu"
    flash = "flash_attention.cu"
    sl = {name: sv["launches"] for name, sv in servers.items()}
    tl = trained["launches"]
    kernels = []
    # K2 and K1 (the tensor-core instances, a bf16 query) with the paged
    # servers' launches; K1 at phase 3's B 2, T 256 case and at the
    # 8 x 512 admission wave.
    for mode in ("bf16", "int8", "int4"):
        tag = "" if mode == "bf16" else f"<{mode}>"
        k1 = f"paged_prefill_mma_kernel<{mode}>"
        n_k1 = sl[f"paged {mode}"][f"flash_prefill_paged/{mode}"]
        n_k2 = sl[f"paged {mode}"][f"flash_decode_paged/{mode}"]
        kernels += [
            entry(f"paged_decode_kernel{tag}", paged, "flash_decode.py:421",
                  n_k2, timed(f"paged_decode_kernel{tag}", "bfloat16")),
            entry(f"paged_decode_kernel{tag}[serve B=8 len=512]", paged,
                  "flash_decode.py:421", n_k2,
                  timed(f"paged_decode_kernel{tag}", "bfloat16",
                        "B=8 H=12 D=64 lengths=8x512")),
            entry(k1, paged, "flash_decode.py:585", n_k1,
                  timed(k1, "bfloat16", "B=2 H=12 T=256")),
            entry(f"{k1}[wave B=8 T=512]", paged, "flash_decode.py:585",
                  n_k1, timed(k1, "bfloat16", "B=8"))]
    # K2 and K1 under an fp32 query (K1 the f32 kernel), with the paged
    # fp32-compute engines' launches: phase 4's over the fp32 pool, phase
    # 10's over the int8 and int4 pools.
    for mode, run in (("fp32", paged_fp32), ("int8", pools["paged int8"]),
                      ("int4", pools["paged int4"])):
        tag = "" if mode == "fp32" else f"<{mode}>"
        k1 = f"paged_prefill_f32_kernel<{mode}>"
        n_k1 = run["launches"][f"flash_prefill_paged/{mode}"]
        n_k2 = run["launches"][f"flash_decode_paged/{mode}"]
        kernels += [
            entry(f"paged_decode_kernel{tag}[q fp32]", paged,
                  "flash_decode.py:421", n_k2,
                  timed(f"paged_decode_kernel{tag}", "float32")),
            entry(f"paged_decode_kernel{tag}[q fp32, serve B=8 len=512]",
                  paged, "flash_decode.py:421", n_k2,
                  timed(f"paged_decode_kernel{tag}", "float32",
                        "B=8 H=12 D=64 lengths=8x512")),
            entry(k1, paged, "flash_decode.py:585", n_k1,
                  timed(k1, "float32", "B=2 H=12 T=256")),
            entry(f"{k1}[wave B=8 T=512]", paged, "flash_decode.py:585",
                  n_k1, timed(k1, "float32", "B=8"))]
    # K1 at the verify shape (phase 16), with the launches of phase 16's
    # fp32 paged NGram engine (prefills and verifies) and of its bf16
    # --spec=ngram server.
    for mode, k1, n in (
            ("fp32", "paged_prefill_f32_kernel<fp32>",
             spec["runs"]["paged NGram"]["launches"][
                 "flash_prefill_paged/fp32"]),
            ("bf16", "paged_prefill_mma_kernel<bf16>",
             spec["server"]["launches"]["flash_prefill_paged/bf16"])):
        kernels.append(entry(f"{k1}[verify S=8 T=5]", paged,
                             "flash_decode.py:585", n, spec["k1"][mode]))
    # K3: the bf16 pool's launches are the dense bf16 server's; the fp32,
    # int8 and int4 pools' are phase 10's fp32-compute dense engines', so
    # their times are taken under an fp32 query. Each at phase 3's lengths,
    # at the dense server's steady state and at the sampler's single row.
    for mode, qdt, n in (
            ("bf16", "bfloat16", sl["dense bf16"]["flash_decode/bf16"]),
            *((mode, "float32",
               pools[f"dense {mode}"]["launches"][f"flash_decode/{mode}"])
              for mode in ("fp32", "int8", "int4"))):
        name = f"flash_decode_kernel<{mode}>"
        for suffix, shape in (("", "B=8 H=12 D=64 L=1024"),
                              ("[serve B=8 len=512]", "B=8 H=12 D=64 L=512"),
                              ("[sample B=1 len=1024]", "B=1 ")):
            kernels.append(entry(name + suffix, dense, "flash_decode.py:244",
                                 n, timed(name, qdt, shape)))
    kernels += [
        entry("flash_fwd_mma_kernel", flash, "attention.py:180",
              tl["flash_attention_fwd"], train_cases["fwd"]),
        entry("flash_bwd_mma_kernel", flash, "attention.py:556",
              tl["flash_attention_bwd_fused"], train_cases["fused"]),
        entry("flash_bwd_dq_mma_kernel", flash, "attention.py:475",
              tl["flash_attention_bwd_dq"], train_cases["dq"]),
        entry("flash_bwd_mma_kernel<with_dq=false>", flash,
              "attention.py:556", tl["flash_attention_bwd_dkv"],
              train_cases["dkv"]),
        # The fp32 instances, with the launches of phase 8's fp32 path.
        entry("flash_fwd_f32_kernel", flash, "attention.py:180",
              parity_launches["flash_attention_fwd"],
              train_cases["fwd_fp32"]),
        entry("flash_bwd_kv_kernel<float>", flash, "attention.py:556",
              parity_launches["flash_attention_bwd_fused"],
              train_cases["fused_fp32"]),
        entry("flash_bwd_dq_f32_kernel", flash, "attention.py:475",
              parity_launches["flash_attention_bwd_dq"],
              train_cases["dq_fp32"]),
        entry("flash_bwd_kv_kernel<float, with_dq=false>", flash,
              "attention.py:556", parity_launches["flash_attention_bwd_dkv"],
              train_cases["dkv_fp32"])]
    # The non-causal instances with an lse cotangent (ring attention's
    # off-diagonal blocks), timed at phase 7's ring block, with the
    # launches of phase 13's sequence-parallel runs (every rank): bf16 K5
    # in the first run, K6 + K7 in the resume; fp32 K5 in the zigzag and
    # dropout runs, K6 + K7 in the contiguous one.
    # The wgmma K4-K7 (csrc/flash_attention_sm90.cu) also at the 8k
    # config's committed batch 4, with the same launches.
    bf, zz, ct = "bf16", "fp32 zigzag", "fp32 contiguous"
    sm90 = "flash_attention_sm90.cu"
    n_k4 = sp_launches(sp, bf, "flash_attention_fwd/full")
    n_k5 = sp_launches(sp, bf, "flash_attention_bwd_fused/full/dlse")
    n_k6 = sp_launches(sp, bf, "flash_attention_bwd_dq/full/dlse")
    n_k7 = sp_launches(sp, bf, "flash_attention_bwd_dkv/full/dlse")
    for name, replaces, n, kind in (
            ("flash_fwd_wgmma_kernel", "attention.py:180", n_k4, "fwd"),
            ("flash_bwd_wgmma_kernel<dlse>", "attention.py:556", n_k5,
             "fused"),
            ("flash_bwd_dq_wgmma_kernel<dlse>", "attention.py:475", n_k6,
             "dq"),
            ("flash_bwd_wgmma_kernel<with_dq=false, dlse>",
             "attention.py:556", n_k7, "dkv")):
        kernels += [entry(name, sm90, replaces, n, ring_cases[kind]),
                    entry(f"{name}[B=4]", sm90, replaces, n,
                          ring_cases[f"{kind}_b4"])]
    # The non-causal fp32 K4-K7 (csrc/flash_ring_f32.cuh) also at the 8k
    # config's committed batch 4, with the same launches.
    ring = "flash_ring_f32.cuh"
    dr = "fp32 dropout"
    n_k4 = sum(sp_launches(sp, name, "flash_attention_fwd/full")
               for name in (zz, ct, dr))
    n_k5 = sum(sp_launches(sp, name, "flash_attention_bwd_fused/full/dlse")
               for name in (zz, dr))
    n_k6 = sp_launches(sp, ct, "flash_attention_bwd_dq/full/dlse")
    n_k7 = sp_launches(sp, ct, "flash_attention_bwd_dkv/full/dlse")
    for name, replaces, n, kind in (
            ("flash_fwd_ring_f32_kernel", "attention.py:180", n_k4,
             "fwd_fp32"),
            ("flash_bwd_ring_f32_kernel<dlse>", "attention.py:556", n_k5,
             "fused_fp32"),
            ("flash_bwd_dq_ring_f32_kernel<dlse>", "attention.py:475", n_k6,
             "dq_fp32"),
            ("flash_bwd_ring_f32_kernel<with_dq=false, dlse>",
             "attention.py:556", n_k7, "dkv_fp32")):
        kernels += [entry(name, ring, replaces, n, ring_cases[kind]),
                    entry(f"{name}[B=4]", ring, replaces, n,
                          ring_cases[f"{kind}_b4"])]
    # The causal K4 and K5 again with the launches of phase 19's ranks:
    # bf16 in the DP, FSDP and HF runs, fp32 in the DP fp32 run; and the
    # fp32 ring blocks with the data x seq ranks'.
    bf16_ranks = ("dp bf16", "dp bf16 accum 2", "fsdp", "hf")
    for name, source, replaces, key, runs_, case in (
            ("flash_fwd_mma_kernel[DP/FSDP ranks]", flash, "attention.py:180",
             "flash_attention_fwd", bf16_ranks, train_cases["fwd"]),
            ("flash_bwd_mma_kernel[DP/FSDP ranks]", flash, "attention.py:556",
             "flash_attention_bwd_fused", bf16_ranks, train_cases["fused"]),
            ("flash_fwd_f32_kernel[DP ranks]", flash, "attention.py:180",
             "flash_attention_fwd", ("dp fp32",), train_cases["fwd_fp32"]),
            ("flash_bwd_kv_kernel<float>[DP ranks]", flash, "attention.py:556",
             "flash_attention_bwd_fused", ("dp fp32",),
             train_cases["fused_fp32"]),
            ("flash_fwd_ring_f32_kernel[data x seq ranks]", ring,
             "attention.py:180", "flash_attention_fwd/full", ("data x seq",),
             ring_cases["fwd_fp32"]),
            ("flash_bwd_ring_f32_kernel<dlse>[data x seq ranks]", ring,
             "attention.py:556", "flash_attention_bwd_fused/full/dlse",
             ("data x seq",), ring_cases["fused_fp32"])):
        kernels.append(entry(name, source, replaces,
                             p19_launches(dp, runs_, key), case))
    # Phase 20: K2, K1 and K3 at a tp 2 shard's shape (H 6) with the
    # launches of its tp 2 engines (the bf16 124M engine's K2 and K1; the
    # fp32 paged and dense engines' K2, K1 and K3); the causal K4 and K5
    # and the fp32 ring blocks with the launches of its model-axis ranks.
    kc, sv, fr = p20["kernels"], p20["serve"][TP]["launches"], p20["runs"]
    shard = f"[tp {TP} shard H={12 // TP}]"
    pf, dn = fr["paged fp32"]["launches"], fr["dense fp32"]["launches"]
    kernels += [
        entry(f"paged_decode_kernel{shard}", paged, "flash_decode.py:421",
              sv["flash_decode_paged/bf16"], kc[("K2", "bf16")]),
        entry(f"paged_prefill_mma_kernel<bf16>{shard}", paged,
              "flash_decode.py:585", sv["flash_prefill_paged/bf16"],
              kc[("K1", "bf16")]),
        entry(f"paged_decode_kernel[q fp32]{shard}", paged,
              "flash_decode.py:421", pf["flash_decode_paged/fp32"],
              kc[("K2", "fp32")]),
        entry(f"paged_prefill_f32_kernel<fp32>{shard}", paged,
              "flash_decode.py:585", pf["flash_prefill_paged/fp32"],
              kc[("K1", "fp32")]),
        entry(f"flash_decode_kernel<fp32>{shard}", dense,
              "flash_decode.py:244", dn["flash_decode/fp32"],
              kc[("K3", "fp32")])]
    tr = p20["train"]
    for name, source, replaces, key, runs_, case in (
            ("flash_fwd_mma_kernel[model ranks]", flash, "attention.py:180",
             "flash_attention_fwd", ("tp bf16",), train_cases["fwd"]),
            ("flash_bwd_mma_kernel[model ranks]", flash, "attention.py:556",
             "flash_attention_bwd_fused", ("tp bf16",), train_cases["fused"]),
            ("flash_fwd_f32_kernel[model ranks]", flash, "attention.py:180",
             "flash_attention_fwd", ("tp fp32", "fsdp x tp"),
             train_cases["fwd_fp32"]),
            ("flash_bwd_kv_kernel<float>[model ranks]", flash,
             "attention.py:556", "flash_attention_bwd_fused",
             ("tp fp32", "fsdp x tp"), train_cases["fused_fp32"]),
            ("flash_fwd_ring_f32_kernel[seq x model ranks]", ring,
             "attention.py:180", "flash_attention_fwd/full", ("seq x tp",),
             ring_cases["fwd_fp32"]),
            ("flash_bwd_ring_f32_kernel<dlse>[seq x model ranks]", ring,
             "attention.py:556", "flash_attention_bwd_fused/full/dlse",
             ("seq x tp",), ring_cases["fused_fp32"])):
        kernels.append(entry(name, source, replaces,
                             p19_launches(tr, runs_, key), case))
    print(f"chip_smoke: every phase passed in "
          f"{time.monotonic() - T_START:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
