"""Iter-driven training loop: the nanoGPT train.py contract on one GPU.

    python -m nanosandbox_tpu_torch.train [configs/foo.py] --key=value ...

The port of nanosandbox_tpu/train.py, with the same CLI, config files
and loop semantics: iter-driven (max_iters), periodic evaluation on a
fixed set of batches (eval_interval, eval_iters; iteration 0 included),
logging every log_interval iterations, warmup + cosine learning rate,
AdamW with weight decay on >= 2-D parameters only, global-norm gradient
clipping, gradient accumulation, checkpoints under <out_dir>/ckpt with
best-val gating, and resume (--init_from=resume / auto).

One device, or one process per seq shard. Causal attention goes through
the flash kernels (ops/attention.py) on a CUDA device and through their
plain PyTorch versions with --device=cpu; the dense projections stay
cuBLAS GEMMs. The step runs eagerly whatever ``compile`` says
(torch.compile or CUDA graph capture of the step is later work).

Sequence parallelism (mesh_sp > 1, attention_impl='ring'): mesh_sp
processes, started as the JAX package's are (coordinator_address,
num_processes, process_id, or COORDINATOR_ADDRESS / NUM_PROCESSES /
PROCESS_ID; parallel/distributed.py, which picks nccl or gloo). Every
rank draws the same global batch and keeps its columns in the ring
layout's order; attention is ring attention over the ranks
(ops/ring_attention.py); each rank backprops its share of the summed
loss, tot_r / sum(cnt), and the parameter gradients are summed over the
ranks before clipping and AdamW, so every rank steps the same
parameters. Logging, event files and checkpoints come from rank 0;
every rank loads a checkpoint to resume. The data, fsdp and model axes
are not ported yet.

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
CUDA activities) into a Chrome trace under <log_dir>/profile, on rank 0.
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
                                          check_ported, load_config,
                                          resolve_device,
                                          resolve_loss_chunk_size)
from nanosandbox_tpu_torch.parallel import distributed

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


def make_optimizer(model: torch.nn.Module, cfg: TrainConfig):
    """(AdamW over two groups -- weight decay on parameters with ndim >= 2,
    none on the rest -- and the lr schedule)."""
    params = [p for p in model.parameters() if p.requires_grad]
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
                   grad_clip: float) -> torch.Tensor:
    """One update from the .grad of every parameter: optax's
    chain(clip_by_global_norm, adamw(schedule)) at update count ``step``.
    Returns the unclipped global norm (a device scalar)."""
    grads = [p.grad for group in optimizer.param_groups
             for p in group["params"] if p.grad is not None]
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
        from nanosandbox_tpu_torch.models.gpt import GPT
        from nanosandbox_tpu_torch.ops.ring_attention import ring_positions
        from nanosandbox_tpu_torch.parallel.mesh import make_mesh

        check_ported(cfg)
        if cfg.init_from not in ("scratch", "resume", "auto"):
            raise ValueError(f"unknown init_from {cfg.init_from!r} (expected "
                             "scratch, resume or auto)")
        self.cfg = cfg
        self.process = distributed.initialize(
            cfg.coordinator_address, cfg.num_processes, cfg.process_id,
            resolve_device(cfg.device))
        if cfg.mesh_sp > 1 and self.process.world_size == 1:
            raise ValueError(
                f"mesh_sp={cfg.mesh_sp} runs one process per seq shard: "
                f"start {cfg.mesh_sp} processes with coordinator_address, "
                "num_processes and process_id (or COORDINATOR_ADDRESS, "
                "NUM_PROCESSES and PROCESS_ID)")
        self.device = self.process.device
        self.rank0 = self.process.rank == 0
        self.mesh = make_mesh(cfg.mesh_dp, cfg.mesh_fsdp, cfg.mesh_tp,
                              cfg.mesh_sp,
                              world_size=self.process.world_size,
                              rank=self.process.rank)
        # Under sequence parallelism this rank's token columns, in the
        # ring layout's order; None: the whole row.
        self.columns = (ring_positions(cfg.block_size, cfg.mesh_sp,
                                       self.mesh.seq_index, cfg.ring_layout)
                        if self.mesh.seq > 1 else None)
        self.dataset = BinDataset(cfg.data_dir, cfg.dataset)
        vocab = cfg.vocab_size or self.dataset.vocab_size
        self.model_cfg = GPTConfig.from_train_config(cfg, vocab)
        self.loss_chunk_size = resolve_loss_chunk_size(
            cfg.loss_chunk_size, cfg.batch_size, cfg.block_size, vocab,
            seq_shards=self.mesh.seq)
        if self.mesh.seq > 1 and self.loss_chunk_size == 0:
            raise NotImplementedError(
                "full logits (loss_chunk_size=0) under mesh_sp > 1 are not "
                "ported yet: sequence parallelism takes the chunked loss")
        # Every rank initializes from the same seed: the same parameters.
        self.model = GPT(self.model_cfg, device=self.device,
                         generator=torch.Generator(
                             device=self.device).manual_seed(cfg.seed),
                         mesh=self.mesh)
        self.optimizer, self.lr_schedule = make_optimizer(self.model, cfg)
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
        tensor twice on one process, and under sequence parallelism this
        rank's share tot_r / sum(cnt) and the all-reduced mean."""
        from nanosandbox_tpu_torch.models.gpt import (
            chunked_cross_entropy_loss, cross_entropy_loss,
            sharded_chunked_cross_entropy_loss)

        kw = dict(chunk_size=self.loss_chunk_size,
                  compute_dtype=self.cfg.compute_dtype)
        if self.mesh.seq > 1:
            hidden = self.model.hidden(x, dropout_generator=generator)
            return sharded_chunked_cross_entropy_loss(
                hidden, self.model.wte.weight, y, group=self.mesh.seq_group,
                **kw)
        if self.loss_chunk_size > 0:
            hidden = self.model.hidden(x, dropout_generator=generator)
            loss = chunked_cross_entropy_loss(hidden, self.model.wte.weight,
                                              y, **kw)
        else:
            loss = cross_entropy_loss(self.model(
                x, dropout_generator=generator), y)
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
        seq ranks under sequence parallelism); returns the mean loss (a
        device scalar)."""
        accum = self.cfg.gradient_accumulation_steps
        self.optimizer.zero_grad(set_to_none=True)
        total = None
        for xm, ym in zip(x.chunk(accum), y.chunk(accum)):
            objective, loss = self.loss(xm, ym, generator)
            (objective / accum if accum > 1 else objective).backward()
            total = loss.detach() if total is None else total + loss.detach()
        if self.mesh.seq > 1:
            distributed.all_reduce_grads_(self.model.parameters(),
                                          self.mesh.seq_group)
        return total / accum

    def train_step(self, x: torch.Tensor, y: torch.Tensor,
                   generator: torch.Generator | None = None
                   ) -> dict[str, torch.Tensor]:
        """One optimizer update; {'loss', 'grad_norm' (unclipped)} as
        device scalars (no host sync)."""
        self.model.train()
        loss = self.grads(x, y, generator)
        norm = optimizer_step(self.optimizer, self.lr_schedule, self.step,
                              self.cfg.grad_clip)
        self.step += 1
        return {"loss": loss, "grad_norm": norm}

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
                           columns=self.columns)

    def to_device(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(a).long()
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    # -- evaluation (nanoGPT estimate_loss) ----------------------------------

    def estimate_loss(self, eval_iters: int | None = None) -> dict:
        """Mean loss over the same eval_iters batches of each split at
        every call (step index 1_000_000 + i, seed + 1): a low-variance,
        fixed sample. One host read per split."""
        eval_iters = eval_iters or self.cfg.eval_iters
        cols = slice(None) if self.columns is None else self.columns
        sid = self.tracer.begin("eval", cat="train",
                                args={"eval_iters": eval_iters})
        out = {}
        for split in ("train", "val"):
            batches = [tuple(a[:, cols] for a in self.dataset.sample_batch(
                split, 1_000_000 + i, self.cfg.batch_size,
                self.cfg.block_size, seed=self.cfg.seed + 1))
                for i in range(eval_iters)]
            losses = [self.eval_loss(self.to_device(xb), self.to_device(yb))
                      for xb, yb in batches]
            out[split] = float(torch.stack(losses).mean())
            self._m_eval.labels(split=split).set(out[split])
        self.tracer.end(sid, {f"{k}_loss": round(v, 6)
                              for k, v in out.items()})
        return out

    # -- memory --------------------------------------------------------------

    def memory_report(self, x: torch.Tensor, y: torch.Tensor) -> dict:
        """Bytes a device holds for one optimizer step, under the JAX
        trainer's keys: params_bytes and state_bytes (parameters, AdamW's
        two moments, the step's batch on the device) from their shapes;
        on a GPU also temp_bytes, the peak of torch.cuda's allocations
        over one forward and backward of the micro-batch x, y above what
        was allocated before it (activations, gradients, workspace), and
        total_bytes = state_bytes + temp_bytes. The pass changes nothing
        the run reads: its gradients are dropped and its dropout masks
        come from a generator of its own."""
        from nanosandbox_tpu_torch.models.gpt import count_params

        cfg = self.cfg
        itemsize = torch.empty((), dtype=self.model_cfg.torch_param_dtype
                               ).element_size()
        params = itemsize * count_params(self.model)
        rows = cfg.sequences_per_iter
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
        from nanosandbox_tpu_torch.models.gpt import count_params

        m, cfg = self.model_cfg, self.cfg
        n = count_params(self.model) - m.block_size * m.n_embd
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
        """Rank 0 writes (a 'checkpoint_save' span); every rank holds the
        same state."""
        if not self.rank0:
            return False
        args = {"iter": iter_num, "final": True} if final else \
            {"iter": iter_num}
        sid = self.tracer.begin("checkpoint_save", cat="train", args=args)
        saved = ckpt.save(iter_num, model=self.model.state_dict(),
                          optimizer=self.optimizer.state_dict(),
                          iter_num=iter_num, best_val_loss=best_val_loss,
                          config=self.cfg.to_dict(), opt_step=self.step)
        self.tracer.end(sid)
        self._m_ckpt.inc()
        return saved

    def restore(self, ckpt, step: int | None = None) -> dict:
        blob = ckpt.restore(step)
        self.model.load_state_dict(blob["model"])
        self.optimizer.load_state_dict(blob["optimizer"])
        self.step = int(blob["step"])
        return blob

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
                    loss = float(metrics["loss"])  # the log-step sync
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
                    grad_norm = float(metrics["grad_norm"])
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
                **{f"final_{k}_loss": v for k, v in losses.items()}}

    # -- profiler window -----------------------------------------------------

    def _start_profile(self, prof_range):
        from nanosandbox_tpu_torch.utils import profiler as window

        self._profile_span = self.tracer.begin(
            "profiler_window", cat="train",
            args={"start": prof_range[0], "stop": prof_range[1]})
        return window.start(self.device)

    def _stop_profile(self, profiler, prof_range) -> None:
        """Drain the device so the window holds its work, stop, and write
        the Chrome trace (utils/profiler.py)."""
        from nanosandbox_tpu_torch.utils import profiler as window

        out = os.path.join(self.cfg.resolved_log_dir, "profile")
        a, b = prof_range
        window.stop(profiler, self.device,
                    os.path.join(out, f"iters_{a}_{b}.trace.json"))
        self.tracer.end(self._profile_span)
        print(f"profiler trace for iters [{a}:{b}) -> {out}")


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
