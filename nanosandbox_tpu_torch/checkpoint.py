"""Serving checkpoints: a config and a state_dict in one torch file.

The counterpart of ``train.restore_for_inference`` for the serving
path. A JAX-trained checkpoint is converted once with
models/convert.py (reading Orbax needs JAX, which this package does not
import) and saved here; the server loads it with ``load_for_serving``.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import torch

from nanosandbox_tpu_torch.config import GPTConfig

FILENAME = "serving.pt"
FORMAT = 1


def save_for_serving(out_dir: str, cfg: GPTConfig,
                     state_dict: Dict[str, torch.Tensor]) -> str:
    """Write <out_dir>/serving.pt; returns its path. Tensors are saved
    from the CPU so the file loads on any device."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, FILENAME)
    blob = {"format": FORMAT, "config": cfg.to_dict(),
            "state_dict": {k: v.detach().cpu() for k, v in
                           state_dict.items()}}
    tmp = path + ".tmp"
    torch.save(blob, tmp)
    os.replace(tmp, path)
    return path


def load_for_serving(out_dir: str, map_location="cpu",
                     ) -> Tuple[GPTConfig, Dict[str, torch.Tensor]]:
    """(config, state_dict) from <out_dir>/serving.pt. weights_only
    loading: the file holds tensors and plain values, nothing to run."""
    path = os.path.join(out_dir, FILENAME)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"no serving checkpoint at {path} (write one with "
            "checkpoint.save_for_serving)")
    blob = torch.load(path, map_location=map_location, weights_only=True)
    if blob.get("format") != FORMAT:
        raise ValueError(f"{path}: format {blob.get('format')!r}, "
                         f"expected {FORMAT}")
    return GPTConfig(**blob["config"]), blob["state_dict"]
