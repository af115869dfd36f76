"""Weights in and out of this package's GPT: the JAX package's flax
params, and HF GPT-2 directories.

From JAX: the flax param tree is a nested dict (``h_{i}/attn/c_attn/
kernel`` ...) of arrays; ``state_dict_from_jax_params`` reads any
array-like leaf through numpy, so it needs no JAX import — a caller
restores a checkpoint with the JAX package (``train.restore_for_
inference``) and hands the tree over:

    sd = state_dict_from_jax_params(jax.device_get(state["params"]), cfg)
    checkpoint.save_for_serving(out_dir, cfg, sd)

Mapping (flax -> torch): ``wte/embedding`` -> ``wte.weight`` (the tied
head), ``wpe/embedding`` -> ``wpe.weight``, LayerNorm ``scale`` ->
``weight``, Dense ``kernel`` -> ``weight`` TRANSPOSED (flax Dense stores
(in, out), nn.Linear (out, in)), ``bias`` -> ``bias``.

HF GPT-2 (the port of nanosandbox_tpu/models/convert.py): import
(``load_hf_gpt2``, behind ``--init_from=hf:<dir>``) and export
(``export_hf_gpt2`` and this module's CLI) of a save_pretrained
directory, with torch and the standard library alone — no
``transformers`` or ``safetensors``:

  * ``config.json`` through ``json``; ``model.safetensors`` parsed by
    hand (an 8-byte little-endian header length, a JSON header of dtype,
    shape and ``data_offsets`` a tensor, then the raw bytes, read with
    torch.frombuffer), as are the shards a ``model.safetensors.index
    .json`` names; ``pytorch_model.bin`` through torch.load
    (weights_only);
  * keys with or without the ``transformer.`` prefix (hub GPT-2 files
    have none); the ``.attn.bias`` / ``.attn.masked_bias`` buffers
    skipped; ``lm_head.weight`` is the tied ``wte`` and need not exist;
  * HF's Conv1D stores (in, out), as flax does, and nn.Linear (out, in):
    transposed on import and back on export;
  * a model this GPT does not compute (an activation other than
    ``gelu_new``, a LayerNorm epsilon other than 1e-5) is refused with
    the JAX package's ValueErrors.

Export writes ``config.json`` (the JAX exporter's field values: dropouts
mirrored, the vocabulary cropped by ``vocab_size``) and
``model.safetensors`` (``__metadata__ {"format": "pt"}``, fp32), with
zero biases for a bias-free model (the format needs them; the forward
is the same) and ``wte`` once: save_pretrained drops the tied head too.

Pretrained OpenAI weights by name (``init_from='gpt2*'``) need a
download and are not ported: ``load_hf_gpt2`` reads local directories.

    python -m nanosandbox_tpu_torch.models.convert --out_dir=<run> \
        --to=<hf dir> [--vocab_size=50257] [--step=N]
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

import numpy as np
import torch

from nanosandbox_tpu_torch.config import GPTConfig

HF_GPT2_NAMES = ("gpt2", "gpt2-medium", "gpt2-large", "gpt2-xl")


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


# ---------------------------------------------------------------------------
# HF GPT-2 directories
# ---------------------------------------------------------------------------

_ST_DTYPES = {"F64": torch.float64, "F32": torch.float32,
              "F16": torch.float16, "BF16": torch.bfloat16,
              "I64": torch.int64, "I32": torch.int32, "I16": torch.int16,
              "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}
_ST_NAMES = {v: k for k, v in _ST_DTYPES.items()}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a .safetensors file, as CPU tensors over the file's
    bytes (module docstring)."""
    with open(path, "rb") as f:
        data = bytearray(f.read())
    n = int.from_bytes(data[:8], "little")
    header = json.loads(data[8:8 + n])
    base = 8 + n
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _ST_DTYPES[info["dtype"]]
        start, end = info["data_offsets"]
        count = (end - start) // torch.empty((), dtype=dtype).element_size()
        t = (torch.frombuffer(data, dtype=dtype, count=count,
                              offset=base + start)
             if count else torch.empty(0, dtype=dtype))
        out[name] = t.reshape(info["shape"])
    return out


def write_safetensors(path: str, tensors: Dict[str, torch.Tensor],
                      metadata: Dict[str, str] | None = None) -> None:
    """Write tensors as a .safetensors file: the header padded with
    spaces to 8 bytes, then each tensor's bytes in order."""
    header: Dict[str, Any] = {"__metadata__": metadata or {}}
    blobs, offset = [], 0
    for name, t in tensors.items():
        t = t.detach().cpu().contiguous()
        b = t.reshape(-1).view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(b)]}
        blobs.append(b)
        offset += len(b)
    hb = json.dumps(header, separators=(",", ":")).encode()
    hb += b" " * (-len(hb) % 8)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(len(hb).to_bytes(8, "little"))
        f.write(hb)
        for b in blobs:
            f.write(b)
    os.replace(tmp, path)


def read_hf_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The tensors of a local HF directory: model.safetensors, the
    shards of model.safetensors.index.json, or pytorch_model.bin."""
    single = os.path.join(path, "model.safetensors")
    index = single + ".index.json"
    if os.path.exists(single):
        return read_safetensors(single)
    if os.path.exists(index):
        with open(index, encoding="utf-8") as f:
            files = sorted(set(json.load(f)["weight_map"].values()))
        out: Dict[str, torch.Tensor] = {}
        for name in files:
            out.update(read_safetensors(os.path.join(path, name)))
        return out
    binary = os.path.join(path, "pytorch_model.bin")
    if os.path.exists(binary):
        return torch.load(binary, map_location="cpu", weights_only=True)
    raise FileNotFoundError(f"{path}: no model.safetensors, "
                            "model.safetensors.index.json or "
                            "pytorch_model.bin")


def gpt_config_from_hf(hf_config, *, compute_dtype: str = "bfloat16",
                       dropout: float = 0.0) -> GPTConfig:
    """The GPTConfig of an HF GPT-2 config (config.json's dict, or an
    object with those attributes); bias is always True in the family."""
    c = hf_config if isinstance(hf_config, dict) else vars(hf_config)
    act = c.get("activation_function", "gelu_new")
    if act != "gelu_new":
        raise ValueError(
            f"unsupported activation_function {act!r}: this model "
            "implements GPT-2's tanh-approx gelu ('gelu_new') only")
    eps = float(c.get("layer_norm_epsilon", 1e-5))
    if abs(eps - 1e-5) > 1e-7:
        raise ValueError(
            f"unsupported layer_norm_epsilon {eps}: this model hard-codes "
            "torch's 1e-5 (models/gpt.py _layer_norm)")
    return GPTConfig(n_layer=c["n_layer"], n_head=c["n_head"],
                     n_embd=c["n_embd"], block_size=c["n_positions"],
                     vocab_size=c["vocab_size"], dropout=dropout, bias=True,
                     compute_dtype=compute_dtype)


def params_from_hf_state_dict(state_dict: dict,
                              n_layer: int) -> Dict[str, torch.Tensor]:
    """An HF GPT2LMHeadModel state_dict (keys with or without the
    ``transformer.`` prefix) as this package's GPT state_dict: f32 CPU
    tensors of their own, the Conv1D weights transposed."""

    def take(name, transpose=False):
        for key in (f"transformer.{name}", name):
            if key in state_dict:
                t = state_dict[key].detach()
                t = t.t() if transpose else t
                return t.to(torch.float32, copy=True).contiguous()
        raise KeyError(f"{name} (or transformer.{name}) not in the "
                       "HF state_dict")

    sd = {"wte.weight": take("wte.weight"), "wpe.weight": take("wpe.weight")}
    for i in range(n_layer):
        h = f"h.{i}"
        for part, dense in (("ln_1", False), ("attn.c_attn", True),
                            ("attn.c_proj", True), ("ln_2", False),
                            ("mlp.c_fc", True), ("mlp.c_proj", True)):
            sd[f"{h}.{part}.weight"] = take(f"{h}.{part}.weight", dense)
            sd[f"{h}.{part}.bias"] = take(f"{h}.{part}.bias")
    sd["ln_f.weight"] = take("ln_f.weight")
    sd["ln_f.bias"] = take("ln_f.bias")
    return sd


def load_hf_gpt2(path: str):
    """(GPTConfig, GPT state_dict) of a local save_pretrained directory.
    Names on the hub need a download, which is not ported."""
    if not os.path.isdir(path):
        raise FileNotFoundError(
            f"{path!r} is not a local HF directory (downloading pretrained "
            "weights is not ported yet to nanosandbox_tpu_torch)")
    with open(os.path.join(path, "config.json"), encoding="utf-8") as f:
        cfg = gpt_config_from_hf(json.load(f))
    return cfg, params_from_hf_state_dict(read_hf_state_dict(path),
                                          cfg.n_layer)


def resolve_init_from(init_from: str) -> str | None:
    """'gpt2*' -> HF hub name; 'hf:<path>' -> local path; else None."""
    if init_from in HF_GPT2_NAMES:
        return init_from
    if init_from.startswith("hf:"):
        return init_from[3:]
    return None


def hf_config_from_gpt(cfg: GPTConfig, vocab_size: int | None = None
                       ) -> dict:
    """config.json of an HF GPT-2 mirroring cfg (the JAX exporter's
    GPT2Config values; vocab_size crops the export)."""
    v = vocab_size or cfg.vocab_size
    if v > cfg.vocab_size:
        raise ValueError(f"export vocab_size {v} exceeds model vocab "
                         f"{cfg.vocab_size}")
    return {"architectures": ["GPT2LMHeadModel"], "model_type": "gpt2",
            "vocab_size": v, "n_positions": cfg.block_size,
            "n_embd": cfg.n_embd, "n_layer": cfg.n_layer,
            "n_head": cfg.n_head, "n_inner": None,
            "activation_function": "gelu_new", "layer_norm_epsilon": 1e-5,
            "resid_pdrop": cfg.dropout, "embd_pdrop": cfg.dropout,
            "attn_pdrop": cfg.dropout, "initializer_range": 0.02,
            "bos_token_id": 50256, "eos_token_id": 50256,
            "scale_attn_weights": True,
            "scale_attn_by_inverse_layer_idx": False,
            "reorder_and_upcast_attn": False, "tie_word_embeddings": True,
            "use_cache": True, "torch_dtype": "float32"}


def hf_state_dict_from_params(state_dict: Dict[str, torch.Tensor],
                              n_layer: int, vocab_size: int) -> dict:
    """This package's GPT state_dict as an HF GPT2LMHeadModel state_dict
    (f32 CPU tensors, Conv1D weights transposed back, zero biases where
    the model has none, lm_head.weight the cropped wte)."""

    def t(name, transpose=False):
        x = state_dict[name].detach().cpu().to(torch.float32)
        return (x.t() if transpose else x).contiguous()

    wte = t("wte.weight")[:vocab_size].contiguous()
    C = wte.shape[1]
    widths = {"ln_1": C, "attn.c_attn": 3 * C, "attn.c_proj": C, "ln_2": C,
              "mlp.c_fc": 4 * C, "mlp.c_proj": C}
    sd = {"transformer.wte.weight": wte,
          "transformer.wpe.weight": t("wpe.weight")}
    for i in range(n_layer):
        for part, width in widths.items():
            name = f"h.{i}.{part}"
            sd[f"transformer.{name}.weight"] = t(
                f"{name}.weight", transpose=not part.startswith("ln_"))
            sd[f"transformer.{name}.bias"] = (
                t(f"{name}.bias") if f"{name}.bias" in state_dict
                else torch.zeros(width))
    sd["transformer.ln_f.weight"] = t("ln_f.weight")
    sd["transformer.ln_f.bias"] = (t("ln_f.bias") if "ln_f.bias" in
                                   state_dict else torch.zeros(C))
    sd["lm_head.weight"] = wte  # weight-tied, same as training
    return sd


def export_hf_gpt2(state_dict: Dict[str, torch.Tensor], cfg: GPTConfig,
                   out_dir: str, vocab_size: int | None = None) -> str:
    """Write an HF save_pretrained directory (config.json,
    model.safetensors) that GPT2LMHeadModel.from_pretrained and this
    package's ``--init_from=hf:<dir>`` load."""
    hf_cfg = hf_config_from_gpt(cfg, vocab_size)
    sd = hf_state_dict_from_params(state_dict, cfg.n_layer,
                                   hf_cfg["vocab_size"])
    del sd["lm_head.weight"]  # tied: save_pretrained writes wte once
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "config.json"), "w",
              encoding="utf-8") as f:
        json.dump(hf_cfg, f, indent=2)
    write_safetensors(os.path.join(out_dir, "model.safetensors"), sd,
                      {"format": "pt"})
    return out_dir


def main(argv: list[str] | None = None) -> str:
    """CLI: export a training checkpoint of this package to an HF
    directory, on the CPU.

        python -m nanosandbox_tpu_torch.models.convert \\
            --out_dir=runs/gpt2_124m --to=exports/gpt2_124m_hf \\
            [--vocab_size=50257] [--step=N]
    """
    import argparse
    import sys

    from nanosandbox_tpu_torch.checkpoint import TrainCheckpointer
    from nanosandbox_tpu_torch.config import TrainConfig

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--out_dir", required=True,
                    help="training out_dir holding ckpt/")
    ap.add_argument("--to", required=True, help="destination HF directory")
    ap.add_argument("--vocab_size", type=int, default=None,
                    help="crop the exported vocab (e.g. 50257 from a "
                         "50304-padded table)")
    ap.add_argument("--step", type=int, default=None)
    args = ap.parse_args(argv if argv is not None else sys.argv[1:])

    ckpt = TrainCheckpointer(args.out_dir)
    step = args.step if args.step is not None else ckpt.latest_step()
    blob = ckpt.restore(step)
    cfg = TrainConfig(**blob["config"])
    model_cfg = GPTConfig.from_train_config(
        cfg, blob["model"]["wte.weight"].shape[0])
    dest = export_hf_gpt2(blob["model"], model_cfg, args.to,
                          vocab_size=args.vocab_size)
    print(f"exported step {step} -> {dest}")
    return dest


if __name__ == "__main__":
    main()
