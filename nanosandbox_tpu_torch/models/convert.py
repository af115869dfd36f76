"""Weights from the JAX package's flax GPT into this package's GPT.

The flax param tree is a nested dict (``h_{i}/attn/c_attn/kernel`` ...)
of arrays; this module reads any array-like leaf through numpy, so it
needs no JAX import — a caller restores a checkpoint with the JAX
package (``train.restore_for_inference``) and hands the tree over:

    sd = state_dict_from_jax_params(jax.device_get(state["params"]), cfg)
    checkpoint.save_for_serving(out_dir, cfg, sd)

Mapping (flax -> torch): ``wte/embedding`` -> ``wte.weight`` (the tied
head), ``wpe/embedding`` -> ``wpe.weight``, LayerNorm ``scale`` ->
``weight``, Dense ``kernel`` -> ``weight`` TRANSPOSED (flax Dense stores
(in, out), nn.Linear (out, in)), ``bias`` -> ``bias``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from nanosandbox_tpu_torch.config import GPTConfig


def state_dict_from_jax_params(params: Dict[str, Any],
                               cfg: GPTConfig) -> Dict[str, torch.Tensor]:
    """flax GPT params -> this package's GPT state_dict (f32 CPU tensors;
    the caller moves and casts them)."""
    params = params.get("params", params)

    def t(x, transpose: bool = False) -> torch.Tensor:
        a = np.asarray(x, np.float32)
        return torch.from_numpy(np.array(a.T if transpose else a,
                                         order="C", copy=True))

    def ln(node, name):
        out = {f"{name}.weight": t(node["scale"])}
        if cfg.bias:
            out[f"{name}.bias"] = t(node["bias"])
        return out

    def dense(node, name):
        out = {f"{name}.weight": t(node["kernel"], transpose=True)}
        if cfg.bias:
            out[f"{name}.bias"] = t(node["bias"])
        return out

    sd = {"wte.weight": t(params["wte"]["embedding"]),
          "wpe.weight": t(params["wpe"]["embedding"]),
          **ln(params["ln_f"], "ln_f")}
    for i in range(cfg.n_layer):
        p, h = params[f"h_{i}"], f"h.{i}"
        sd.update(ln(p["ln_1"], f"{h}.ln_1"))
        sd.update(ln(p["ln_2"], f"{h}.ln_2"))
        sd.update(dense(p["attn"]["c_attn"], f"{h}.attn.c_attn"))
        sd.update(dense(p["attn"]["c_proj"], f"{h}.attn.c_proj"))
        sd.update(dense(p["mlp"]["c_fc"], f"{h}.mlp.c_fc"))
        sd.update(dense(p["mlp"]["c_proj"], f"{h}.mlp.c_proj"))
    want = (cfg.vocab_size, cfg.n_embd)
    if tuple(sd["wte.weight"].shape) != want:
        raise ValueError(f"wte {tuple(sd['wte.weight'].shape)} != {want}: "
                         "the params do not belong to this config")
    return sd
