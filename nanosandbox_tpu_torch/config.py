"""Model config for the serving path, and device selection.

``GPTConfig`` keeps the names and defaults of the JAX package's
``config.GPTConfig`` (vocab padded to 50304, no biases, bf16 compute)
for the fields the serving slice reads. Parameters are created in f32
(the JAX default param_dtype) and cast for serving by
models/gpt.py cast_for_serving. Training-only fields (dropout, remat,
ring attention, the attention/decode impl ladders) belong to later
slices of the port.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass
class GPTConfig:
    """Model-only view of the config, passed to models.gpt.GPT."""

    n_layer: int = 12
    n_head: int = 12
    n_embd: int = 768
    block_size: int = 1024
    vocab_size: int = 50304  # GPT-2 50257 padded up to a multiple of 64
    bias: bool = False
    compute_dtype: str = "bfloat16"

    def __post_init__(self) -> None:
        if self.compute_dtype not in DTYPES:
            raise ValueError(f"compute_dtype must be one of {sorted(DTYPES)}"
                             f", got {self.compute_dtype!r}")
        if self.n_embd % self.n_head:
            raise ValueError(f"n_embd {self.n_embd} is not divisible by "
                             f"n_head {self.n_head}")

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head

    @property
    def torch_compute_dtype(self) -> torch.dtype:
        return DTYPES[self.compute_dtype]

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


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
