"""Config system: TrainConfig, the nanoGPT-style configurator, GPTConfig,
and device selection.

``TrainConfig`` and ``load_config`` are this package's own copy of the
JAX package's ``config.py``: every field under the same name and
default, and the same CLI contract,

    python -m nanosandbox_tpu_torch.train [config_file.py] --key=value ...

so the files under ``configs/`` load unchanged. Fields that select
something this port does not have yet raise NotImplementedError when set
away from their default (``check_ported``); a few name TPU machinery
with no counterpart here and are accepted but select nothing (README
"PyTorch/CUDA port": ``attention_stat_layout``, ``rng_impl``,
``compile``, and the JAX-only values of ``attention_impl``).

``GPTConfig`` keeps the JAX model config's names and defaults (vocab
padded to 50304, no biases, f32 params, bf16 compute) for the fields the
port reads. Parameters are created in f32 and cast for serving by
models/gpt.py cast_for_serving.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import types
from dataclasses import dataclass, fields
from typing import Any

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
REMAT_POLICIES = ("save_attention", "full")


@dataclass
class TrainConfig:
    # -- I/O --
    out_dir: str = "out"
    data_dir: str = "data"  # root holding <dataset>/{train,val}.bin + meta.pkl
    dataset: str = "shakespeare_char"
    eval_interval: int = 2000
    log_interval: int = 1
    eval_iters: int = 200
    eval_only: bool = False
    always_save_checkpoint: bool = True
    # 'scratch' | 'resume' | 'auto' (resume if a checkpoint exists) |
    # 'hf:<path>' (a local HF GPT-2 directory) | 'gpt2*' (pretrained
    # OpenAI weights: a download, not ported yet)
    init_from: str = "scratch"
    keep_checkpoints: int = 3

    # -- model --
    n_layer: int = 12
    n_head: int = 12
    n_embd: int = 768
    block_size: int = 1024
    dropout: float = 0.0
    bias: bool = False
    vocab_size: int = 0  # 0 = take from dataset meta.pkl, else explicit

    # -- optimizer / schedule (cosine decay, AdamW, clip) --
    learning_rate: float = 6e-4
    max_iters: int = 600000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip: float = 1.0
    decay_lr: bool = True
    warmup_iters: int = 2000
    lr_decay_iters: int = 600000
    min_lr: float = 6e-5

    # -- batch --
    batch_size: int = 12  # micro-batch in sequences
    gradient_accumulation_steps: int = 1

    # -- system --
    device: str = "auto"  # 'auto' (the GPU, or raise) | 'cuda' | 'cpu'
    compile: bool = True  # a jax.jit switch in JAX; the port runs eager
    seed: int = 1337
    # Names a JAX PRNG for the dropout stream; torch has no counterpart.
    # Accepted and recorded in the metrics header, selects nothing.
    rng_impl: str = "threefry2x32"
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # One of ATTENTION_IMPLS. 'auto' and 'pallas' are the flash kernels;
    # 'ring' is ring attention under mesh_sp > 1 (the flash kernels at
    # mesh_sp 1); the other JAX names select nothing here.
    attention_impl: str = "auto"
    # A TPU operand layout of the flash backward; the port has one path.
    attention_stat_layout: str = "compact"
    remat: bool = False
    remat_policy: str = "save_attention"
    # Chunked LM-head + cross-entropy over this many positions; 0 = full
    # logits; -1 = resolve_loss_chunk_size() at Trainer construction.
    loss_chunk_size: int = -1

    # -- parallelism (data, fsdp, seq and slices are ported; model not) --
    mesh_dp: int = -1
    mesh_fsdp: int = 1
    mesh_tp: int = 1
    mesh_sp: int = 1
    ring_layout: str = "zigzag"
    ring_block_impl: str = "auto"
    shard_params: bool = False
    mesh_slices: int = 0

    # -- distributed bootstrap (parallel/distributed.py) --
    coordinator_address: str = ""
    num_processes: int = 0
    process_id: int = -1

    # Print and log the step's memory before iter 0 (train.py
    # memory_report): parameters, optimizer state and batch computed, the
    # activations measured over one forward+backward on a GPU.
    memory_report: bool = False

    # -- logging --
    tensorboard: bool = True
    run_name: str = ""
    log_dir: str = ""  # default: <out_dir>/runs
    # 'a:b': a torch.profiler trace (CPU and CUDA) of iters [a, b) to
    # <log_dir>/profile, rank 0 only.
    profile_steps: str = ""

    def __post_init__(self) -> None:
        if self.lr_decay_iters <= 0:
            self.lr_decay_iters = self.max_iters
        if self.profile_steps:  # fail fast, before any resources exist
            self.profile_range()

    def profile_range(self) -> tuple[int, int] | None:
        """Parsed --profile_steps=a:b, validated. None when unset."""
        if not self.profile_steps:
            return None
        parts = self.profile_steps.split(":")
        try:
            a, b = (int(p) for p in parts)
        except ValueError:
            raise ValueError(
                f"profile_steps expects 'a:b' integers, got "
                f"{self.profile_steps!r}") from None
        if len(parts) != 2 or a < 0 or b <= a:
            raise ValueError(
                f"profile_steps expects 'a:b' with 0 <= a < b, got "
                f"{self.profile_steps!r}")
        return a, b

    @property
    def resolved_log_dir(self) -> str:
        return self.log_dir or os.path.join(self.out_dir, "runs")

    @property
    def sequences_per_iter(self) -> int:
        """Sequences per optimizer step (batch_size is the micro-batch;
        accumulation multiplies the data)."""
        return self.gradient_accumulation_steps * self.batch_size

    @property
    def tokens_per_iter(self) -> int:
        return self.sequences_per_iter * self.block_size

    def replace(self, **kw: Any) -> "TrainConfig":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


# The JAX package's attention_impl values. The port runs causal attention
# one way (the flash kernels on CUDA, their plain versions on the CPU):
# 'auto' and 'pallas' name that; 'xla', 'pallas_interpret' and
# 'pallas_jax' name JAX implementations and are accepted but inert (the
# trainer says so once); 'ring' is ring attention over the seq axis.
ATTENTION_IMPLS = ("auto", "pallas", "xla", "pallas_interpret", "pallas_jax",
                   "ring")
RING_LAYOUTS = ("zigzag", "contiguous")
# The ring's block is the flash kernels' lse instance on CUDA and the
# plain block on the CPU, whatever this says: every JAX name is accepted
# and inert, as attention_impl is (ops/ring_attention.py).
RING_BLOCK_IMPLS = ("auto", "pallas", "xla", "pallas_interpret")


def check_ported(cfg: TrainConfig) -> None:
    """Raise NotImplementedError for every field set to something this
    port does not run yet (ROADMAP.md queue A lists them), and the JAX
    trainer's ValueErrors for a sequence-parallel config it refuses
    (check_mesh adds its batch checks once the Trainer has a mesh)."""
    if cfg.attention_impl not in ATTENTION_IMPLS:
        raise ValueError(f"unknown attention_impl {cfg.attention_impl!r} "
                         f"(expected one of {ATTENTION_IMPLS})")
    if cfg.ring_layout not in RING_LAYOUTS:
        raise ValueError(f"unknown ring layout: {cfg.ring_layout!r}")
    if cfg.ring_block_impl not in RING_BLOCK_IMPLS:
        raise ValueError(f"unknown ring block impl: {cfg.ring_block_impl!r}")
    if cfg.mesh_sp > 1 and cfg.attention_impl != "ring":
        raise ValueError(
            "mesh_sp > 1 requires attention_impl='ring' (other impls "
            "compute attention over the local sequence shard only)")
    if cfg.mesh_sp > 1 and cfg.block_size % cfg.mesh_sp:
        raise ValueError(
            f"block_size {cfg.block_size} must be divisible by the seq "
            f"mesh axis ({cfg.mesh_sp})")
    if cfg.mesh_tp > 1 and cfg.n_head % cfg.mesh_tp:
        # JAX checks this for the ring alone (its other impls let GSPMD
        # split a head); the port always splits the model axis by heads.
        raise ValueError(
            f"mesh_tp shards heads over model: n_head {cfg.n_head} must "
            f"be divisible by mesh_tp {cfg.mesh_tp}")
    unported = []
    if cfg.init_from.startswith("gpt2"):
        unported.append(f"init_from={cfg.init_from!r} (pretrained OpenAI "
                        "weights need a download)")
    if unported:
        raise NotImplementedError(
            "not ported yet to nanosandbox_tpu_torch: " + ", ".join(unported))


def check_mesh(cfg: TrainConfig, shape: dict) -> None:
    """The JAX trainer's batch and mesh ValueErrors
    (nanosandbox_tpu/train.py:240-267) for a resolved mesh ``shape``.
    JAX's two process-count checks (sequences_per_iter and batch_size
    divisible by jax.process_count()) exist because a JAX process loads
    its own rows; here every rank draws the global batch and keeps its
    rows over (data, fsdp), so the first check below is the whole
    condition (ROADMAP C5). The model axis takes no rows: its ranks hold
    the same tokens."""
    dp_shards = shape["data"] * shape["fsdp"]
    if cfg.batch_size % dp_shards:
        raise ValueError(
            f"batch_size {cfg.batch_size} must be divisible by "
            f"data*fsdp mesh shards ({dp_shards})")
    if cfg.block_size % shape["seq"]:
        raise ValueError(
            f"block_size {cfg.block_size} must be divisible by the "
            f"seq mesh axis ({shape['seq']})")


# Auto loss-chunk policy: full logits when the per-device (B, T, vocab) f32
# tensor fits this budget (3.3 GB at GPT-2 124M, batch 16), else chunks.
AUTO_FULL_LOGITS_BUDGET_BYTES = 4 << 30
AUTO_CHUNK = 512


def resolve_loss_chunk_size(loss_chunk_size: int, per_device_batch: int,
                            block_size: int, vocab_size: int,
                            seq_shards: int = 1) -> int:
    """Resolve the -1 (auto) sentinel to a concrete chunk size. Explicit
    values (>= 0) pass through; auto picks full logits (0) when the f32
    logits fit AUTO_FULL_LOGITS_BUDGET_BYTES, else AUTO_CHUNK, and always
    chunks under sequence parallelism."""
    if loss_chunk_size >= 0:
        return loss_chunk_size
    if seq_shards > 1:
        return AUTO_CHUNK
    logits_bytes = 4 * per_device_batch * block_size * vocab_size
    return 0 if logits_bytes <= AUTO_FULL_LOGITS_BUDGET_BYTES else AUTO_CHUNK


_FIELD_TYPES = {f.name: f.type for f in fields(TrainConfig)}


def _coerce(key: str, raw: str) -> Any:
    """A --key=value string as the field's type: literal_eval first, the
    raw string otherwise; bools must be spelled True/False."""
    try:
        val = ast.literal_eval(raw)
    except (ValueError, SyntaxError):
        val = raw
    want = _FIELD_TYPES.get(key, "")
    if want == "bool" and not isinstance(val, bool):
        raise ValueError(f"--{key} expects True/False, got {raw!r}")
    if want == "int" and isinstance(val, bool):
        raise ValueError(f"--{key} expects int, got {raw!r}")
    if want == "int" and isinstance(val, float) and val.is_integer():
        val = int(val)
    if want == "float" and isinstance(val, int) and not isinstance(val, bool):
        val = float(val)
    return val


def load_config(argv: list[str] | None = None,
                defaults: TrainConfig | None = None) -> TrainConfig:
    """Build a TrainConfig from [config_file.py] --key=value....

    The optional positional .py file is exec'd with the current config
    values as globals; names it (re)binds that match TrainConfig fields
    become overrides, and any other name it binds raises (a typo'd key
    must not train with the default). ``--key=value`` args are applied
    after, winning over the file; unknown keys raise.
    """
    argv = list(argv or [])
    cfg = defaults or TrainConfig()
    overrides: dict[str, Any] = {}

    positional = [a for a in argv if not a.startswith("--")]
    flags = [a for a in argv if a.startswith("--")]
    if len(positional) > 1:
        raise ValueError(f"at most one config file allowed, got {positional}")

    if positional:
        path = positional[0]
        if not path.endswith(".py"):
            raise ValueError(f"config file must be .py, got {path!r}")
        ns: dict[str, Any] = dict(cfg.to_dict())
        with open(path, "r", encoding="utf-8") as f:
            exec(compile(f.read(), path, "exec"), ns)
        # Underscore-prefixed names are deliberate locals; modules (from
        # imports) and callables (helpers) are allowed scaffolding.
        for k, v in ns.items():
            if (k in _FIELD_TYPES or k.startswith("_")
                    or isinstance(v, types.ModuleType) or callable(v)):
                continue
            raise ValueError(
                f"unknown config key {k!r} in {path} (prefix helper "
                "variables with '_' to keep them — for imported constants, "
                "alias at import: 'from math import pi as _pi')")
        for k in _FIELD_TYPES:
            if k in ns and ns[k] != getattr(cfg, k):
                overrides[k] = ns[k]

    for arg in flags:
        body = arg[2:]
        if "=" not in body:
            raise ValueError(f"flag {arg!r} must be --key=value")
        key, raw = body.split("=", 1)
        if key not in _FIELD_TYPES:
            raise ValueError(f"unknown config key: {key!r}")
        overrides[key] = _coerce(key, raw)

    return cfg.replace(**overrides)


@dataclass
class GPTConfig:
    """Model-only view of the config, passed to models.gpt.GPT."""

    n_layer: int = 12
    n_head: int = 12
    n_embd: int = 768
    block_size: int = 1024
    vocab_size: int = 50304  # GPT-2 50257 padded up to a multiple of 64
    dropout: float = 0.0
    bias: bool = False
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # Activation checkpointing of each training block (models/gpt.py):
    # 'save_attention' keeps each attention call's (o, lse), 'full' keeps
    # nothing.
    remat: bool = False
    remat_policy: str = "save_attention"
    # 'ring' runs ring attention when the model is given a mesh whose seq
    # axis is larger than 1 (models/gpt.py); every other value, and a
    # ring without such a mesh, is causal attention over the whole row.
    attention_impl: str = "auto"
    ring_layout: str = "zigzag"

    def __post_init__(self) -> None:
        for name in ("compute_dtype", "param_dtype"):
            if getattr(self, name) not in DTYPES:
                raise ValueError(f"{name} must be one of {sorted(DTYPES)}, "
                                 f"got {getattr(self, name)!r}")
        if self.n_embd % self.n_head:
            raise ValueError(f"n_embd {self.n_embd} is not divisible by "
                             f"n_head {self.n_head}")
        if self.remat and self.remat_policy not in REMAT_POLICIES:
            raise ValueError(
                f"unknown remat_policy: {self.remat_policy!r} "
                "(expected 'save_attention' or 'full')")

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head

    @property
    def torch_compute_dtype(self) -> torch.dtype:
        return DTYPES[self.compute_dtype]

    @property
    def torch_param_dtype(self) -> torch.dtype:
        return DTYPES[self.param_dtype]

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_train_config(cls, cfg: TrainConfig,
                          vocab_size: int) -> "GPTConfig":
        return cls(n_layer=cfg.n_layer, n_head=cfg.n_head, n_embd=cfg.n_embd,
                   block_size=cfg.block_size, vocab_size=vocab_size,
                   dropout=cfg.dropout, bias=cfg.bias,
                   param_dtype=cfg.param_dtype,
                   compute_dtype=cfg.compute_dtype, remat=cfg.remat,
                   remat_policy=cfg.remat_policy,
                   attention_impl=cfg.attention_impl,
                   ring_layout=cfg.ring_layout)


def resolve_device(device: str | torch.device = "auto") -> torch.device:
    """'auto' and 'cuda' mean the GPU and raise when there is none; only
    an explicit 'cpu' runs on the CPU. Nothing degrades quietly: a run
    that meant to measure the card must not end up timing the host."""
    name = str(device)
    if name == "cpu":
        return torch.device("cpu")
    if name in ("auto", "cuda") or name.startswith("cuda:"):
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={name!r} needs a CUDA GPU and torch sees none; "
                "pass --device=cpu (device='cpu') to run on the CPU")
        return torch.device("cuda" if name == "auto" else name)
    raise ValueError(f"unknown device {name!r} (expected auto, cuda or cpu)")
