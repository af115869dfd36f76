"""Checkpoints: training state under <out_dir>/ckpt/<step>/, and the
serving file <out_dir>/serving.pt.

Training (the counterpart of the JAX package's Orbax ``Checkpointer``,
same directory contract): ``TrainCheckpointer.save(step, ...)`` writes
model, optimizer, ``step``, ``iter_num``, ``best_val_loss`` and the
training config with torch.save into ``<out_dir>/ckpt/<step>/state.pt``,
keeps the newest ``keep`` steps, and skips a step that already exists
(a resumed run re-evaluates at its restored step). The directory is
written under a temporary name and renamed, so a crash never leaves a
half-written step behind.

Serving: a config and a state_dict in one torch file, loaded by the
server with ``load_for_serving``. A model this port trained becomes one
with ``serving_from_training``; a JAX-trained checkpoint is converted
once with models/convert.py (reading Orbax needs JAX, which this package
does not import) and saved with ``save_for_serving``.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict, Optional, Tuple

import torch

from nanosandbox_tpu_torch.config import GPTConfig
from nanosandbox_tpu_torch.utils.metrics import warn_once

FILENAME = "serving.pt"
FORMAT = 1
TRAIN_FILENAME = "state.pt"
TRAIN_FORMAT = 1


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


class TrainCheckpointer:
    """save(step, ...) / restore(step=None) under <out_dir>/ckpt."""

    def __init__(self, out_dir: str, keep: int = 3):
        self.out_dir = out_dir
        self.dir = os.path.join(out_dir, "ckpt")
        self.keep = keep

    def all_steps(self) -> list[int]:
        if not os.path.isdir(self.dir):
            return []
        return sorted(int(n) for n in os.listdir(self.dir) if n.isdigit()
                      and os.path.exists(os.path.join(self.dir, n,
                                                      TRAIN_FILENAME)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, *, model: Dict[str, torch.Tensor],
             optimizer: Dict[str, Any], iter_num: int, best_val_loss: float,
             config: Dict[str, Any], opt_step: int) -> bool:
        """Write step's state; False when the step exists already."""
        if step in self.all_steps():
            warn_once(f"ckpt-skip:{self.out_dir}",
                      f"[checkpoint] step {step} already exists under "
                      f"{self.dir}; skipping save (expected once right "
                      "after --init_from=resume)")
            return False
        os.makedirs(self.dir, exist_ok=True)
        final = os.path.join(self.dir, str(step))
        tmp = os.path.join(self.dir, f".{step}.tmp")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save({"format": TRAIN_FORMAT, "model": model,
                    "optimizer": optimizer, "step": opt_step,
                    "iter_num": iter_num, "best_val_loss": best_val_loss,
                    "config": config}, os.path.join(tmp, TRAIN_FILENAME))
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        for old in self.all_steps()[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.dir, str(old)))
        return True

    def restore(self, step: Optional[int] = None,
                map_location="cpu") -> Dict[str, Any]:
        """The saved dict of ``step`` (default the newest)."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        path = os.path.join(self.dir, str(step), TRAIN_FILENAME)
        blob = torch.load(path, map_location=map_location, weights_only=True)
        if blob.get("format") != TRAIN_FORMAT:
            raise ValueError(f"{path}: format {blob.get('format')!r}, "
                             f"expected {TRAIN_FORMAT}")
        return blob


def serving_from_training(out_dir: str, step: Optional[int] = None,
                          serve_dir: Optional[str] = None) -> str:
    """Turn a training checkpoint of this port into a serving one:
    <serve_dir or out_dir>/serving.pt with the trained weights and the
    model config. Returns its path."""
    from nanosandbox_tpu_torch.config import TrainConfig

    blob = TrainCheckpointer(out_dir).restore(step)
    cfg = TrainConfig(**blob["config"])
    vocab = blob["model"]["wte.weight"].shape[0]
    return save_for_serving(serve_dir or out_dir,
                            GPTConfig.from_train_config(cfg, vocab),
                            blob["model"])
