"""Iter-driven training loop: the nanoGPT train.py contract on one GPU.

    python -m nanosandbox_tpu_torch.train [configs/foo.py] --key=value ...

The port of nanosandbox_tpu/train.py, with the same CLI, config files
and loop semantics: iter-driven (max_iters), periodic evaluation on a
fixed set of batches (eval_interval, eval_iters; iteration 0 included),
logging every log_interval iterations, warmup + cosine learning rate,
AdamW with weight decay on >= 2-D parameters only, global-norm gradient
clipping, gradient accumulation, checkpoints under <out_dir>/ckpt with
best-val gating, and resume (--init_from=resume / auto).

One device, or one process a rank of the (data, fsdp, seq, model)
mesh. Causal attention goes through the flash kernels (ops/attention.py)
on a CUDA device and through their plain PyTorch versions with
--device=cpu; the dense projections stay cuBLAS GEMMs. The step runs
eagerly whatever ``compile`` says (torch.compile or CUDA graph capture
of the step is later work).

Several processes (mesh_dp, mesh_fsdp, mesh_sp, mesh_tp;
parallel/mesh.py, and make_hybrid_mesh under mesh_slices) are started
as the JAX package's are (coordinator_address, num_processes,
process_id, or
COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID;
parallel/distributed.py, which picks nccl or gloo). Every rank draws the
step's global batch and keeps its share (data/loader.py): its rows over
(data, fsdp), of each micro-batch; its columns over seq, in the ring
layout's order, with ring attention over its seq group
(ops/ring_attention.py). Each rank backprops its share of the summed
loss, tot_r / sum(cnt) over every rank's tokens, so that its gradients
summed over the step's ranks are the mean loss's. Without FSDP every
rank holds the whole model and the gradients are all-reduced over the
step's ranks, so every rank steps the same parameters. Under
shard_params at mesh_fsdp > 1 (ZeRO-3, parallel/sharding.py) each rank
holds its shard of every parameter and of both AdamW moments; a block's
weights are gathered just before it runs (forward, and the recompute
that serves its backward) and its gradients reduce-scattered as soon as
they exist, then summed over the data and seq ranks; clipping takes the
global norm over the shards and AdamW steps the shards. shard_params at
mesh_fsdp 1 is inert, as in JAX. Logging, event files and checkpoints
come from rank 0 (under FSDP after gathering the full parameters and
moments: the one-file format of one process); every rank loads a
checkpoint to resume, taking its shard, on any mesh.

Under mesh_tp > 1 (tensor parallelism, parallel/tensor.py) each rank of
a model group builds its shard of the model (models/gpt.py): its heads
and hidden units of every block, drawn as one process draws the full
parameters; the ranks of a group hold the same tokens, and the
row-parallel projections' partial products are summed over the group.
The data, fsdp and seq sums run per model rank, as above; clipping
takes the global norm (the model shards' squares summed over the group,
the replicated parameters' once), and checkpoints stay one file in one
process's layout, gathered from the shards before rank 0 writes.

``init_from='hf:<dir>'`` starts from a local HF GPT-2 directory
(models/convert.py load_hf_gpt2, read with torch and the standard
library): its config sets the architecture (n_layer, n_head, n_embd,
vocab, bias), block_size may crop wpe but not grow it, and 'hf:' with an
empty path is not pretrained; under FSDP each rank takes its shards of
the weights on arrival.

Numerics kept from the JAX package, because they decide the trajectory:
optax's schedule counts updates from 0, so with warmup the first update
has lr 0 and changes no parameter; clipping scales by max_norm / norm
only when norm >= max_norm (optax.clip_by_global_norm, no epsilon); the
reported grad_norm is the unclipped one; torch's AdamW over the two
weight-decay groups is optax.adamw (eps outside the square root,
decoupled decay).

Dropout masks come from a torch.Generator seeded from (seed + 7,
iter_num) at every step, so a resumed run draws the masks an
uninterrupted one would. Under sequence parallelism every rank holds
the same generator and draws the global masks (models/gpt.py), so a
rank's masks are one process's at its positions. JAX draws from
threefry: residual-dropout bits differ between the packages; the
attention mask is a pure function of the per-layer seed words and
matches the JAX kernels' bit for bit for the same words.

``profile_steps='a:b'`` traces iters [a, b) with torch.profiler (CPU and
CUDA activities) into a Chrome trace under <log_dir>/profile, on rank 0,
and prints the window's deliberate host syncs by ledger name
(utils/tracecheck.py: the loop reads back through ``host_sync`` only,
under JAX's names: one 'train-log-readback' a log step, one
'eval-readback' a split per eval, the window's 'profile-window-drain').
``memory_report`` prints and logs the JAX trainer's keys before iter 0
(``memory_report``): parameters, AdamW moments and batch computed from
their shapes, activations and workspace measured on the GPU over one
throwaway forward and backward of the first micro-batch. The port runs
eagerly, so there is no compiled program to analyse and no
``compile=True`` requirement.

Telemetry (obs/, as the JAX trainer's): ``trainer.metrics`` is a
MetricRegistry with the gauges train_loss, train_grad_norm, train_lr,
train_tokens_per_sec, train_mfu and eval_loss{split}, and the counters
train_iters_total and checkpoint_saves_total; ``trainer.tracer`` records
the eval windows ('eval'), checkpoint saves ('checkpoint_save') and the
profile window ('profiler_window') as spans. Both are updated at log and
eval points only, from values the loop already read back, never inside
the step.
"""

from __future__ import annotations

import math
import os
import sys
import time
from typing import Callable

import numpy as np
import torch

from nanosandbox_tpu_torch.config import (GPTConfig, TrainConfig,
                                          check_mesh, check_ported,
                                          load_config,
                                          resolve_device,
                                          resolve_loss_chunk_size)
from nanosandbox_tpu_torch.parallel import distributed
from nanosandbox_tpu_torch.utils import tracecheck

# Peak dense bf16 FLOP/s per device for MFU (data sheets): NVIDIA H100
# SXM 989 TFLOP/s. A CPU run reports MFU against a nominal 1 TFLOP/s.
PEAK_FLOPS = {"H100": 989e12, "cpu": 1e12}


def make_lr_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """lr as a function of the number of updates done so far: optax's
    join_schedules([linear_schedule(0, lr, warmup), cosine_decay_schedule
    (lr, decay, alpha=min_lr/lr)], [warmup]) -- 0 at update 0."""
    lr = cfg.learning_rate
    if not cfg.decay_lr:
        return lambda step: lr
    warmup = max(cfg.warmup_iters, 1)
    decay_steps = max(cfg.lr_decay_iters - cfg.warmup_iters, 1)
    alpha = cfg.min_lr / lr

    def schedule(step: int) -> float:
        if step < cfg.warmup_iters:
            return lr * min(step, warmup) / warmup
        t = min(step - cfg.warmup_iters, decay_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * t / decay_steps))
        return lr * ((1.0 - alpha) * cosine + alpha)

    return schedule


def make_optimizer(model, cfg: TrainConfig):
    """(AdamW over two groups -- weight decay on parameters with ndim >= 2,
    none on the rest -- and the lr schedule). ``model``: a module, or its
    parameters (FSDP's shards, which keep their full parameter's ndim)."""
    params = [p for p in (model.parameters() if isinstance(
        model, torch.nn.Module) else model) if p.requires_grad]
    groups = [
        {"params": [p for p in params if p.dim() >= 2],
         "weight_decay": cfg.weight_decay},
        {"params": [p for p in params if p.dim() < 2], "weight_decay": 0.0},
    ]
    opt = torch.optim.AdamW(groups, lr=0.0, betas=(cfg.beta1, cfg.beta2),
                            eps=1e-8)
    return opt, make_lr_schedule(cfg)


def global_norm(grads: list[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of every element's square (optax.global_norm)."""
    return torch.stack([g.float().square().sum() for g in grads]).sum().sqrt()


def clip_by_global_norm_(grads: list[torch.Tensor], norm: torch.Tensor,
                         max_norm: float) -> None:
    """optax.clip_by_global_norm in place: g * max_norm / norm when
    norm >= max_norm, untouched otherwise; decided on the device."""
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    for g in grads:
        g.mul_(scale.to(g.dtype))


def optimizer_step(optimizer: torch.optim.Optimizer,
                   schedule: Callable[[int], float], step: int,
                   grad_clip: float,
                   norm: torch.Tensor | None = None) -> torch.Tensor:
    """One update from the .grad of every parameter: optax's
    chain(clip_by_global_norm, adamw(schedule)) at update count ``step``.
    ``norm``: the global norm when the parameters are shards (FSDP
    grad_norm), else the norm of these gradients. Returns the unclipped
    global norm (a device scalar)."""
    grads = [p.grad for group in optimizer.param_groups
             for p in group["params"] if p.grad is not None]
    if norm is None:
        norm = global_norm(grads)
    if grad_clip > 0:
        clip_by_global_norm_(grads, norm, grad_clip)
    lr = schedule(step)
    for group in optimizer.param_groups:
        group["lr"] = lr
    optimizer.step()
    return norm


class Trainer:
    """Owns the model, optimizer, data and the train/eval steps."""

    def __init__(self, cfg: TrainConfig):
        from nanosandbox_tpu_torch.data.loader import BinDataset
        from nanosandbox_tpu_torch.models.convert import (load_hf_gpt2,
                                                          resolve_init_from)
        from nanosandbox_tpu_torch.models.gpt import GPT
        from nanosandbox_tpu_torch.ops.ring_attention import ring_positions
        from nanosandbox_tpu_torch.parallel.mesh import (make_hybrid_mesh,
                                                         make_mesh)
        from nanosandbox_tpu_torch.parallel.sharding import FSDP
        from nanosandbox_tpu_torch.parallel.tensor import full_shapes

        check_ported(cfg)
        if (cfg.init_from not in ("scratch", "resume", "auto")
                and not cfg.init_from.startswith("hf:")):
            raise ValueError(f"unknown init_from {cfg.init_from!r} (expected "
                             "scratch, resume, auto or hf:<dir>)")
        self.cfg = cfg
        self.process = distributed.initialize(
            cfg.coordinator_address, cfg.num_processes, cfg.process_id,
            resolve_device(cfg.device))
        world = self.process.world_size
        for axis, size, shard in (("mesh_sp", cfg.mesh_sp, "seq"),
                                  ("mesh_tp", cfg.mesh_tp, "model")):
            if size > 1 and world == 1:
                raise ValueError(
                    f"{axis}={size} runs one process per {shard} shard: start "
                    f"{size} processes with coordinator_address, "
                    "num_processes and process_id (or COORDINATOR_ADDRESS, "
                    "NUM_PROCESSES and PROCESS_ID)")
        self.device = self.process.device
        self.rank0 = self.process.rank == 0

        # Pretrained import: the HF config dictates the architecture;
        # block_size may crop wpe, not grow it ('hf:' alone is not one).
        hf_src = resolve_init_from(cfg.init_from)
        self._pretrained = bool(hf_src)
        hf_sd = None
        if hf_src:
            hf_cfg, hf_sd = load_hf_gpt2(hf_src)
            if cfg.block_size > hf_cfg.block_size:
                raise ValueError(
                    f"block_size {cfg.block_size} exceeds the pretrained "
                    f"context {hf_cfg.block_size} ({cfg.init_from})")
            hf_sd["wpe.weight"] = hf_sd["wpe.weight"][:cfg.block_size]
            self.cfg = cfg = cfg.replace(
                n_layer=hf_cfg.n_layer, n_head=hf_cfg.n_head,
                n_embd=hf_cfg.n_embd, vocab_size=hf_cfg.vocab_size,
                bias=True)
            if self.rank0:
                print(f"initializing from pretrained {cfg.init_from}: "
                      f"{hf_cfg.n_layer}L/{hf_cfg.n_head}H/"
                      f"{hf_cfg.n_embd}d, vocab {hf_cfg.vocab_size}")

        axes = (cfg.mesh_dp, cfg.mesh_fsdp, cfg.mesh_tp, cfg.mesh_sp)
        if cfg.mesh_slices:
            self.mesh = make_hybrid_mesh(*axes, num_slices=cfg.mesh_slices,
                                         world_size=world,
                                         rank=self.process.rank)
        else:
            self.mesh = make_mesh(*axes, world_size=world,
                                  rank=self.process.rank)
        check_mesh(cfg, self.mesh.shape)
        # This rank's share of each micro-batch: its row block over
        # (data, fsdp) (None: every row) and, under sequence parallelism,
        # its token columns in the ring layout's order (None: the row).
        m = self.mesh
        self.rows = ((m.batch_index, m.batch_shards)
                     if m.batch_shards > 1 else None)
        self.columns = (ring_positions(cfg.block_size, cfg.mesh_sp,
                                       m.seq_index, cfg.ring_layout)
                        if m.seq > 1 else None)
        self.dataset = BinDataset(cfg.data_dir, cfg.dataset)
        vocab = cfg.vocab_size or self.dataset.vocab_size
        self.model_cfg = GPTConfig.from_train_config(cfg, vocab)
        self.loss_chunk_size = resolve_loss_chunk_size(
            cfg.loss_chunk_size, cfg.batch_size // m.batch_shards,
            cfg.block_size, vocab, seq_shards=m.seq)
        # Every rank initializes from the same seed: the same parameters
        # (under FSDP, its shards of them, drawn as one process draws).
        gen = (None if hf_sd is not None else
               torch.Generator(device=self.device).manual_seed(cfg.seed))
        self.fsdp = None
        # The full model's count, whatever this rank holds of it.
        self.n_params = sum(math.prod(s) for s in full_shapes(
            self.model_cfg).values())
        if cfg.shard_params and m.fsdp > 1:
            self.model = GPT(self.model_cfg, device="meta", mesh=m)
            self.fsdp = FSDP(self.model, m, device=self.device,
                             generator=gen, state_dict=hf_sd)
            params = self.fsdp.parameters()
            if self.rank0:
                print(f"fsdp {m.fsdp}: a rank holds "
                      f"{self.fsdp.shard_bytes():,} of "
                      f"{self.fsdp.full_bytes():,} parameter bytes; "
                      f"replicated: {self.fsdp.replicated or 'none'}")
        else:
            self.model = GPT(self.model_cfg, device=self.device,
                             generator=gen, mesh=m)
            if hf_sd is not None:
                self.load_full(hf_sd)
            params = self.model.parameters()
        self.optimizer, self.lr_schedule = make_optimizer(params, cfg)
        self.step = 0  # optimizer updates done: the schedule's count
        self._init_telemetry()
        from nanosandbox_tpu_torch.utils.metrics import warn_once
        if cfg.compile:
            warn_once("compile", "[train] compile=True: the port runs the "
                      "step eagerly (torch.compile / CUDA graphs are not "
                      "ported yet)")
        if cfg.attention_impl not in ("auto", "pallas", "ring"):
            warn_once("attention_impl", f"[train] attention_impl="
                      f"{cfg.attention_impl!r} names a JAX implementation "
                      "and selects nothing here: causal attention runs the "
                      "flash kernels on CUDA, their plain versions on the "
                      "CPU")

    def _init_telemetry(self) -> None:
        """The registry and tracer of the module docstring."""
        from nanosandbox_tpu_torch.obs import MetricRegistry, SpanTracer

        self.metrics = MetricRegistry()
        self.tracer = SpanTracer(capacity=2048)
        # The profile window's host syncs by ledger name, once it closed.
        self.host_syncs_in_window: dict | None = None
        m = self.metrics
        self._m_loss = m.gauge("train_loss",
                               "Training loss at the last log step.")
        self._m_grad_norm = m.gauge("train_grad_norm",
                                    "Global grad norm at the last log step.")
        self._m_lr = m.gauge("train_lr", "Learning rate at the last "
                             "log step.")
        self._m_toks = m.gauge("train_tokens_per_sec",
                               "Window-averaged training tokens/sec.")
        self._m_mfu = m.gauge("train_mfu",
                              "Model FLOPs utilization (0..1).")
        self._m_iters = m.counter("train_iters_total",
                                  "Optimizer steps completed.")
        self._m_eval = m.gauge("eval_loss", "Last estimate_loss value, "
                               "by split.", labelnames=("split",))
        self._m_ckpt = m.counter("checkpoint_saves_total",
                                 "Checkpoints written.")

    # -- steps ---------------------------------------------------------------

    def loss(self, x: torch.Tensor, y: torch.Tensor,
             generator: torch.Generator | None = None):
        """(what this rank backprops, the mean cross entropy): chunked
        head + loss when loss_chunk_size > 0, full logits otherwise; one
        tensor twice on one process, and over several ranks this rank's
        share tot_r / sum(cnt) and the all-reduced mean."""
        from nanosandbox_tpu_torch.models.gpt import (chunked_nll_sums,
                                                      nll_sums, shared_mean)

        hidden = self.model.hidden(x, dropout_generator=generator)
        with self.model.gathered("wte."):
            if self.loss_chunk_size > 0:
                tot, cnt = chunked_nll_sums(
                    hidden, self.model.wte.weight, y,
                    chunk_size=self.loss_chunk_size,
                    compute_dtype=self.cfg.compute_dtype)
            else:
                tot, cnt = nll_sums(self.model.head(hidden), y)
        if self.mesh.size > 1:
            return shared_mean(tot, cnt, self.mesh.group)
        loss = tot / cnt.clamp(min=1)
        return loss, loss

    def dropout_generator(self, iter_num: int) -> torch.Generator | None:
        """The step's mask stream, keyed by (seed + 7, iter_num); None
        without dropout."""
        if self.cfg.dropout == 0.0:
            return None
        g = torch.Generator(device=self.device)
        g.manual_seed(((self.cfg.seed + 7) * 1_000_003 + iter_num)
                      & 0xFFFF_FFFF_FFFF)
        return g

    def grads(self, x: torch.Tensor, y: torch.Tensor,
              generator: torch.Generator | None = None) -> torch.Tensor:
        """Fill every parameter's .grad with the mean gradient over the
        batch's gradient_accumulation_steps micro-batches (summed over the
        step's ranks; under FSDP each rank's shards of it); returns the
        mean loss (a device scalar)."""
        accum = self.cfg.gradient_accumulation_steps
        self.optimizer.zero_grad(set_to_none=True)
        total = None
        for xm, ym in zip(x.chunk(accum), y.chunk(accum)):
            objective, loss = self.loss(xm, ym, generator)
            (objective / accum if accum > 1 else objective).backward()
            total = loss.detach() if total is None else total + loss.detach()
        if self.fsdp is not None:
            self.fsdp.reduce_grads()
        elif self.mesh.size > 1:
            distributed.all_reduce_grads_(self.model.parameters(),
                                          self.mesh.group)
        return total / accum

    def train_step(self, x: torch.Tensor, y: torch.Tensor,
                   generator: torch.Generator | None = None
                   ) -> dict[str, torch.Tensor]:
        """One optimizer update; {'loss', 'grad_norm' (unclipped)} as
        device scalars (no host sync)."""
        self.model.train()
        loss = self.grads(x, y, generator)
        norm = optimizer_step(self.optimizer, self.lr_schedule, self.step,
                              self.cfg.grad_clip, self.grad_norm())
        self.step += 1
        return {"loss": loss, "grad_norm": norm}

    def grad_norm(self) -> torch.Tensor | None:
        """The global norm of the full gradients when this rank holds
        shards (FSDP, or the model axis: every rank of the model group
        calls it); None: the optimizer's gradients are the full ones."""
        from nanosandbox_tpu_torch.parallel import tensor

        if self.fsdp is not None:
            return self.fsdp.grad_norm()
        if self.mesh.model > 1:
            return tensor.grad_norm(self.model.named_parameters(),
                                    self.mesh.model, self.mesh.model_group)
        return None

    @torch.no_grad()
    def eval_loss(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        self.model.eval()
        return self.loss(x, y)[1]

    # -- data ----------------------------------------------------------------

    def make_loader(self, split: str, start_step: int = 0, prefetch=True):
        from nanosandbox_tpu_torch.data.loader import BatchLoader

        return BatchLoader(self.dataset, split, self.cfg.sequences_per_iter,
                           self.cfg.block_size, seed=self.cfg.seed,
                           start_step=start_step, prefetch=prefetch,
                           columns=self.columns, rows=self.rows,
                           micro_batches=self.cfg.gradient_accumulation_steps)

    def to_device(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(a).long()
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    # -- evaluation (nanoGPT estimate_loss) ----------------------------------

    def estimate_loss(self, eval_iters: int | None = None) -> dict:
        """Mean loss over the same eval_iters batches of each split at
        every call (step index 1_000_000 + i, seed + 1): a low-variance,
        fixed sample; each rank takes its rows and columns of the global
        batch, and each batch's loss is the mean over every rank's
        tokens. One host read per split."""
        from nanosandbox_tpu_torch.data.loader import take_rows

        eval_iters = eval_iters or self.cfg.eval_iters
        cols = slice(None) if self.columns is None else self.columns

        def share(a):
            a = a if self.rows is None else take_rows(a, 1, *self.rows)
            return a[:, cols]

        sid = self.tracer.begin("eval", cat="train",
                                args={"eval_iters": eval_iters})
        out = {}
        for split in ("train", "val"):
            batches = [tuple(share(a) for a in self.dataset.sample_batch(
                split, 1_000_000 + i, self.cfg.batch_size,
                self.cfg.block_size, seed=self.cfg.seed + 1))
                for i in range(eval_iters)]
            losses = [self.eval_loss(self.to_device(xb), self.to_device(yb))
                      for xb, yb in batches]
            # One readback a split, through the ledger (JAX's name).
            out[split] = tracecheck.host_sync("eval-readback",
                                              torch.stack(losses).mean())
            self._m_eval.labels(split=split).set(out[split])
        self.tracer.end(sid, {f"{k}_loss": round(v, 6)
                              for k, v in out.items()})
        return out

    # -- memory --------------------------------------------------------------

    def memory_report(self, x: torch.Tensor, y: torch.Tensor) -> dict:
        """Bytes a device holds for one optimizer step, under the JAX
        trainer's keys: params_bytes and state_bytes (parameters, AdamW's
        two moments, the step's batch on the device) from their shapes,
        this rank's (its model shard, and under FSDP its shards of it);
        on a GPU also temp_bytes, the peak of torch.cuda's allocations
        over one forward and backward of the micro-batch x, y above what
        was allocated before it (activations, gradients, workspace), and
        total_bytes = state_bytes + temp_bytes. The pass changes nothing
        the run reads: its gradients are dropped and its dropout masks
        come from a generator of its own."""
        cfg = self.cfg
        itemsize = torch.empty((), dtype=self.model_cfg.torch_param_dtype
                               ).element_size()
        params = (itemsize * sum(p.numel() for p in self.model.parameters())
                  if self.fsdp is None else self.fsdp.shard_bytes())
        rows = cfg.sequences_per_iter // self.mesh.batch_shards
        cols = cfg.block_size if self.columns is None else len(self.columns)
        batch = 2 * rows * cols * torch.empty((), dtype=torch.long
                                              ).element_size()
        out = {"params_bytes": params, "state_bytes": 3 * params + batch}
        if self.device.type != "cuda":
            return out
        torch.cuda.synchronize(self.device)
        torch.cuda.reset_peak_memory_stats(self.device)
        before = torch.cuda.memory_allocated(self.device)
        gen = None
        if cfg.dropout > 0.0:
            gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self.model.train()
        self.loss(x, y, gen)[0].backward()
        torch.cuda.synchronize(self.device)
        out["temp_bytes"] = torch.cuda.max_memory_allocated(
            self.device) - before
        out["total_bytes"] = out["state_bytes"] + out["temp_bytes"]
        self.optimizer.zero_grad(set_to_none=True)
        return out

    def report_memory(self, writer, start_step: int) -> dict:
        """memory_report on the first micro-batch of step ``start_step``,
        printed (rank 0) in the JAX trainer's line and logged at step 0."""
        loader = self.make_loader("train", start_step=start_step,
                                  prefetch=False)
        xb, yb = next(loader)
        accum = self.cfg.gradient_accumulation_steps
        mem = self.memory_report(self.to_device(xb).chunk(accum)[0],
                                 self.to_device(yb).chunk(accum)[0])
        if self.rank0:
            gb = 1 << 30
            line = (f"memory report (per device): params "
                    f"{mem['params_bytes'] / gb:.2f} GB, state+batch "
                    f"{mem['state_bytes'] / gb:.2f} GB")
            if "temp_bytes" in mem:
                line += (f", activations/temp {mem['temp_bytes'] / gb:.2f} "
                         f"GB, total {mem['total_bytes'] / gb:.2f} GB")
            else:
                line += (" (activations are measured on a GPU only: not "
                         "measured on the CPU)")
            print(line)
        writer.log(0, {f"mem/{k}": float(v) for k, v in mem.items()})
        return mem

    # -- MFU -----------------------------------------------------------------

    def flops_per_iter(self) -> float:
        """nanoGPT's estimate: 6N + 12 L H Q T flops per token, N without
        the position embedding."""
        m, cfg = self.model_cfg, self.cfg
        n = self.n_params - m.block_size * m.n_embd
        L, H, Q, T = m.n_layer, m.n_head, m.head_dim, cfg.block_size
        return (6 * n + 12 * L * H * Q * T) * cfg.tokens_per_iter

    def peak_flops(self) -> float:
        """The peak of the cards the run occupies: one per rank under
        nccl, one shared by every rank under gloo (or the CPU)."""
        kind = (torch.cuda.get_device_name(self.device)
                if self.device.type == "cuda" else "cpu")
        cards = (self.process.world_size if self.process.backend == "nccl"
                 else 1)
        for k, v in PEAK_FLOPS.items():
            if k.lower() in kind.lower():
                return v * cards
        raise ValueError(f"no peak FLOP/s for {kind!r}: add it to "
                         "train.PEAK_FLOPS to report MFU")

    # -- checkpoints ---------------------------------------------------------

    def save(self, ckpt, iter_num: int, best_val_loss: float,
             final: bool = False) -> bool:
        """Rank 0 writes (a 'checkpoint_save' span) the full parameters
        and moments: under FSDP the ranks of its fsdp and model groups
        gather them first, over the model axis the ranks of its model
        group; otherwise every rank holds the same state."""
        m = self.mesh
        if self.fsdp is not None:
            if m.data_index or m.seq_index:
                return False
            model = self.fsdp.full_state_dict()
            optimizer = self.fsdp.full_optimizer_state(self.optimizer)
        elif m.model > 1:
            if m.data_index or m.fsdp_index or m.seq_index:
                return False
            model, optimizer = self._gather_state()
        if not self.rank0:
            return False
        if self.fsdp is None and m.model == 1:
            model = self.model.state_dict()
            optimizer = self.optimizer.state_dict()
        args = {"iter": iter_num, "final": True} if final else \
            {"iter": iter_num}
        sid = self.tracer.begin("checkpoint_save", cat="train", args=args)
        saved = ckpt.save(iter_num, model=model, optimizer=optimizer,
                          iter_num=iter_num, best_val_loss=best_val_loss,
                          config=self.cfg.to_dict(), opt_step=self.step)
        self.tracer.end(sid)
        self._m_ckpt.inc()
        return saved

    def restore(self, ckpt, step: int | None = None) -> dict:
        """Load a checkpoint written on any mesh: the whole state, or
        this rank's shards of it (the model axis, FSDP)."""
        blob = ckpt.restore(step)
        self.load_full(blob["model"])
        if self.fsdp is None:
            self.optimizer.load_state_dict(self._shard_optimizer(
                blob["optimizer"]))
        else:
            self.fsdp.load_optimizer(self.optimizer, blob["optimizer"])
        self.step = int(blob["step"])
        return blob

    def load_full(self, sd: dict) -> None:
        """Load full parameters (one process's state_dict): this rank's
        shards of them."""
        from nanosandbox_tpu_torch.parallel.tensor import shard_state_dict

        if self.fsdp is not None:
            self.fsdp.load_full(sd)
        elif self.mesh.model > 1:
            self.model.load_state_dict(shard_state_dict(
                sd, self.mesh.model, self.mesh.model_index))
        else:
            self.model.load_state_dict(sd)

    def _moments(self, osd: dict, fn) -> dict:
        """osd with fn(name, moment) for each AdamW moment (the model axis,
        no FSDP: the optimizer's parameters are the model's)."""
        by_id = {id(p): n for n, p in self.model.named_parameters()}
        names = [by_id[id(p)] for g in self.optimizer.param_groups
                 for p in g["params"]]
        state = {i: {k: (fn(names[int(i)], v) if k in (
            "exp_avg", "exp_avg_sq") else v) for k, v in st.items()}
            for i, st in osd["state"].items()}
        return {"state": state, "param_groups": osd["param_groups"]}

    def _gather_state(self) -> tuple:
        """(full parameters, full optimizer state) gathered over the model
        group; every rank of it must call."""
        from nanosandbox_tpu_torch.parallel.tensor import (gather_param,
                                                           gather_state_dict)

        m = self.mesh
        model = gather_state_dict(self.model.state_dict(), m.model,
                                  m.model_group)
        optimizer = self._moments(
            self.optimizer.state_dict(),
            lambda n, v: gather_param(n, v, m.model, m.model_group))
        return model, optimizer

    def _shard_optimizer(self, osd: dict) -> dict:
        """A full optimizer state_dict as this model rank's shards."""
        from nanosandbox_tpu_torch.parallel.tensor import shard_param

        m = self.mesh
        if m.model == 1:
            return osd
        return self._moments(osd, lambda n, v: shard_param(
            n, v, m.model, m.model_index).clone(
                memory_format=torch.contiguous_format))

    # -- main loop -----------------------------------------------------------

    def run(self) -> dict:
        from nanosandbox_tpu_torch.checkpoint import TrainCheckpointer
        from nanosandbox_tpu_torch.data.loader import OFFSET_SAMPLER
        from nanosandbox_tpu_torch.utils.metrics import MetricsWriter

        cfg = self.cfg
        say = print if self.rank0 else (lambda *a, **k: None)
        ckpt = TrainCheckpointer(cfg.out_dir, keep=cfg.keep_checkpoints)
        iter_num = 0
        best_val_loss = 1e9
        init_from = cfg.init_from
        if init_from == "auto":
            init_from = ("resume" if ckpt.latest_step() is not None
                         else "scratch")
        if init_from == "resume":
            blob = self.restore(ckpt)
            iter_num = int(blob["iter_num"])
            best_val_loss = float(blob["best_val_loss"])
            say(f"resumed from iter {iter_num} "
                f"(best val loss {best_val_loss:.4f})")

        # Rank 0 writes the metrics; the other ranks' writer is disabled.
        writer = MetricsWriter(cfg.resolved_log_dir, cfg.run_name,
                               enabled=self.rank0,
                               tensorboard=cfg.tensorboard)
        loader = self.make_loader("train", start_step=iter_num)
        writer.write_header({
            "eval_batch_policy": "fixed", "eval_seed": cfg.seed + 1,
            "eval_iters": cfg.eval_iters,
            "offset_sampler": OFFSET_SAMPLER,
            # A JAX PRNG name with no torch meaning: recorded, inert.
            "rng_impl": cfg.rng_impl,
            "device": str(self.device),
        })
        tokens_per_iter = cfg.tokens_per_iter
        flops_per_iter = self.flops_per_iter()
        peak = self.peak_flops()
        last_loss = float("nan")
        last_eval: tuple[int, dict] | None = None
        log: list[dict] = []
        mem = (self.report_memory(writer, iter_num) if cfg.memory_report
               else None)
        prof_range = cfg.profile_range() if self.rank0 else None
        profiler = None
        t0 = time.time()
        window_start_iter = iter_num - 1  # the sync precedes step iter_num
        try:
            while iter_num < cfg.max_iters:
                if (cfg.eval_interval > 0
                        and iter_num % cfg.eval_interval == 0):
                    losses = self.estimate_loss()
                    last_eval = (iter_num, losses)
                    say(f"step {iter_num}: train loss "
                          f"{losses['train']:.4f}, val loss "
                          f"{losses['val']:.4f}")
                    writer.log(iter_num, {"eval/train_loss": losses["train"],
                                          "eval/val_loss": losses["val"]})
                    # The iter-0 anchor never seeds best_val_loss: a run
                    # that cannot beat its scratch loss still saves.
                    if iter_num > 0 and (losses["val"] < best_val_loss
                                         or cfg.always_save_checkpoint):
                        best_val_loss = min(best_val_loss, losses["val"])
                        self.save(ckpt, iter_num, best_val_loss)
                    if cfg.eval_only:
                        break
                    # Eval and checkpoint time stay out of the next
                    # throughput window.
                    if self.device.type == "cuda":
                        # torchlint: disable=host-sync -- waits out the
                        # checkpoint's copies (the eval readback drained
                        # the rest), so they stay out of the next
                        # throughput window; JAX's loop has no such sync.
                        torch.cuda.synchronize(self.device)
                    t0, window_start_iter = time.time(), iter_num - 1

                if prof_range and iter_num == prof_range[0]:
                    profiler = self._start_profile(prof_range)
                xb, yb = next(loader)
                metrics = self.train_step(self.to_device(xb),
                                          self.to_device(yb),
                                          self.dropout_generator(iter_num))
                if profiler is not None and iter_num == prof_range[1] - 1:
                    self._stop_profile(profiler, prof_range)
                    profiler = None

                if cfg.log_interval > 0 and iter_num % cfg.log_interval == 0:
                    # The log-step sync: loss and grad norm in one
                    # readback, through the ledger (JAX's name).
                    loss, grad_norm = tracecheck.host_sync(
                        "train-log-readback",
                        torch.stack([metrics["loss"].float(),
                                     metrics["grad_norm"].float()])).tolist()
                    last_loss = loss
                    # Window-averaged: the host runs ahead of the device,
                    # and this read drains every step since the last one.
                    now = time.time()
                    n_iters = iter_num - window_start_iter
                    dt = (now - t0) / max(n_iters, 1)
                    t0, window_start_iter = now, iter_num
                    toks = tokens_per_iter / max(dt, 1e-9)
                    mfu = flops_per_iter / max(dt, 1e-9) / peak
                    say(f"iter {iter_num}: loss {loss:.4f}, "
                          f"time {dt * 1000:.2f}ms, "
                          f"tok/s {toks:,.0f}, mfu {mfu * 100:.2f}%")
                    lr = self.lr_schedule(iter_num)
                    writer.log(iter_num, {
                        "train/loss": loss, "train/grad_norm": grad_norm,
                        "train/lr": lr, "perf/tokens_per_sec": toks,
                        "perf/mfu": mfu})
                    log.append({"iter": iter_num, "loss": loss,
                                "grad_norm": grad_norm, "ms": dt * 1000,
                                "tok_s": toks, "mfu": mfu})
                    self._m_loss.set(loss)
                    self._m_grad_norm.set(grad_norm)
                    self._m_lr.set(lr)
                    self._m_toks.set(toks)
                    self._m_mfu.set(mfu)
                    self._m_iters._set_total(iter_num + 1)
                iter_num += 1
        finally:
            if profiler is not None:  # the run ended inside the window
                self._stop_profile(profiler, prof_range)
            loader.close()
            writer.close()

        if last_eval is not None and last_eval[0] == iter_num:
            losses = last_eval[1]  # already evaluated at this exact step
        else:
            losses = self.estimate_loss() if cfg.max_iters > 0 else {}
        if cfg.max_iters > 0 and not cfg.eval_only:
            self.save(ckpt, iter_num,
                      min(best_val_loss, losses.get("val", 1e9)), final=True)
        return {"iter_num": iter_num, "final_loss": last_loss, "log": log,
                "memory_report": mem,
                "host_syncs_in_window": self.host_syncs_in_window,
                **{f"final_{k}_loss": v for k, v in losses.items()}}

    # -- profiler window -----------------------------------------------------

    def _start_profile(self, prof_range):
        from nanosandbox_tpu_torch.utils import profiler as window

        self._profile_span = self.tracer.begin(
            "profiler_window", cat="train",
            args={"start": prof_range[0], "stop": prof_range[1]})
        # The window reports its own syncs, not the process's.
        self._profile_sync_mark = tracecheck.sync_counts()
        return window.start(self.device)

    def _stop_profile(self, profiler, prof_range) -> None:
        """Drain the device so the window holds its work, stop, and write
        the Chrome trace (utils/profiler.py)."""
        from nanosandbox_tpu_torch.utils import profiler as window

        out = os.path.join(self.cfg.resolved_log_dir, "profile")
        a, b = prof_range
        window.stop(profiler, self.device,
                    os.path.join(out, f"iters_{a}_{b}.trace.json"))
        by_kind = tracecheck.sync_delta(self._profile_sync_mark)
        self.host_syncs_in_window = by_kind
        self.tracer.end(self._profile_span,
                        {"host_syncs": sum(by_kind.values())})
        print(f"profiler trace for iters [{a}:{b}) -> {out} "
              f"({sum(by_kind.values())} logged host sync(s) in the "
              f"window; by kind: {by_kind})")


def main(argv: list[str] | None = None) -> dict:
    cfg = load_config(argv if argv is not None else sys.argv[1:])
    trainer = Trainer(cfg)
    try:
        if trainer.rank0:
            print(f"tokens per iteration: {cfg.tokens_per_iter:,}")
            print(f"device: {trainer.device}"
                  + (f" ({torch.cuda.get_device_name(trainer.device)})"
                     if trainer.device.type == "cuda" else ""))
        return trainer.run()
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    main()
