"""HF GPT-2 import and export of the port (models/convert.py), on the CPU.

The cases of tests/test_convert.py, on the port's types: a randomly
initialized tiny HF GPT2LMHeadModel saved locally (as safetensors, as a
sharded safetensors index, as pytorch_model.bin; with the
``transformer.`` prefix and, saved from its GPT2Model, without) loads
through the port's own readers (torch and the standard library) into a
GPT whose fp32 logits match transformers' within 2e-4 (the JAX test's
limit), and into the same weights as the JAX package's
params_from_hf_state_dict passed through state_dict_from_jax_params,
bit for bit. The export (bias or none, vocabulary cropped) loads in
transformers and in the JAX package's load_hf_gpt2 with the port's
logits; variants this GPT does not compute are refused with JAX's
ValueErrors; --init_from=hf: forces the architecture, crops block_size
and refuses to grow it, and 'hf:' alone is not pretrained; the export
CLI turns a port training checkpoint into a directory that re-imports
to the trained weights.
"""

import json
import os

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

import jax.numpy as jnp  # noqa: E402

from nanosandbox_tpu.models import convert as jconvert  # noqa: E402
from nanosandbox_tpu.models.gpt import GPT as JGPT  # noqa: E402
from nanosandbox_tpu_torch import train as ttrain  # noqa: E402
from nanosandbox_tpu_torch.config import GPTConfig, TrainConfig  # noqa: E402
from nanosandbox_tpu_torch.models import convert  # noqa: E402
from nanosandbox_tpu_torch.models.gpt import GPT  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _hf_model(n_layer=2, n_head=2, n_embd=64, vocab=128, n_positions=64,
              seed=0):
    torch.manual_seed(seed)
    cfg = transformers.GPT2Config(
        n_layer=n_layer, n_head=n_head, n_embd=n_embd, vocab_size=vocab,
        n_positions=n_positions, resid_pdrop=0.0, embd_pdrop=0.0,
        attn_pdrop=0.0)
    return transformers.GPT2LMHeadModel(cfg).eval()


def _port(cfg: GPTConfig, sd) -> GPT:
    model = GPT(cfg.__class__(**{**cfg.to_dict(),
                                 "compute_dtype": "float32"}))
    model.load_state_dict(sd)
    return model.eval()


def _logits(model, x) -> np.ndarray:
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    return (out.logits if hasattr(out, "logits") else out).numpy()


@pytest.mark.parametrize("fmt", ["safetensors", "sharded", "bin",
                                 "unprefixed"])
def test_logits_match_hf_forward(tmp_path, fmt):
    hf = _hf_model()
    path = str(tmp_path / "hf")
    if fmt == "unprefixed":      # hub GPT-2 files: GPT2Model's keys
        hf.transformer.save_pretrained(path)
    else:
        hf.save_pretrained(path, safe_serialization=fmt != "bin",
                           **({"max_shard_size": "60KB"}
                              if fmt == "sharded" else {}))
    files = set(os.listdir(path))
    assert {"safetensors": "model.safetensors",
            "sharded": "model.safetensors.index.json",
            "bin": "pytorch_model.bin",
            "unprefixed": "model.safetensors"}[fmt] in files
    cfg, sd = convert.load_hf_gpt2(path)
    assert (cfg.n_layer, cfg.n_embd, cfg.vocab_size, cfg.block_size,
            cfg.bias) == (2, 64, 128, 64, True)
    x = np.random.default_rng(0).integers(0, 128, size=(2, 48))
    np.testing.assert_allclose(_logits(_port(cfg, sd), x), _logits(hf, x),
                               atol=2e-4, rtol=2e-4)


def test_import_equals_the_jax_conversion():
    hf = _hf_model()
    sd = hf.state_dict()
    ours = convert.params_from_hf_state_dict(sd, 2)
    jparams = jconvert.params_from_hf_state_dict(sd, 2)
    cfg = convert.gpt_config_from_hf(hf.config.to_dict())
    want = convert.state_dict_from_jax_params(jparams, cfg)
    assert list(ours) == list(GPT(cfg, device="meta").state_dict())
    for name, t in want.items():
        assert torch.equal(ours[name], t), name
    assert convert.resolve_init_from("hf:/a/b") == "/a/b"
    for name in ("gpt2", "gpt2-xl", "scratch", "resume", "auto", "hf:"):
        assert (convert.resolve_init_from(name)
                == jconvert.resolve_init_from(name))


@pytest.mark.parametrize("bias,vocab", [(True, 120), (False, None)])
def test_export_loads_in_transformers_and_jax(tmp_path, bias, vocab):
    """The port's export (bias or zero biases; the vocab cropped to 120)
    loads in transformers and in the JAX package's load_hf_gpt2, both
    with the port's logits; wte is written once."""
    cfg = GPTConfig(n_layer=2, n_head=2, n_embd=64, block_size=64,
                    vocab_size=128, bias=bias, compute_dtype="float32")
    model = GPT(cfg, generator=torch.Generator().manual_seed(1)).eval()
    if bias:
        with torch.no_grad():
            for name, p in model.named_parameters():
                if name.endswith("bias"):
                    p.normal_(0, 0.02, generator=torch.Generator()
                              .manual_seed(len(name)))
    dest = convert.export_hf_gpt2(model.state_dict(), cfg,
                                  str(tmp_path / "hf"), vocab_size=vocab)
    with open(os.path.join(dest, "model.safetensors"), "rb") as f:
        header = json.loads(f.read(int.from_bytes(f.read(8), "little")))
    assert header["__metadata__"] == {"format": "pt"}
    assert "lm_head.weight" not in header
    v = vocab or 128
    back = transformers.GPT2LMHeadModel.from_pretrained(dest).eval()
    assert back.config.vocab_size == v
    x = np.random.default_rng(3).integers(0, v, size=(2, 32))
    ours = _logits(model, x)[..., :v]
    np.testing.assert_allclose(ours, _logits(back, x), atol=2e-4, rtol=2e-4)
    jcfg, jparams = jconvert.load_hf_gpt2(dest)
    jcfg.compute_dtype = "float32"
    theirs = JGPT(jcfg).apply({"params": jparams}, jnp.asarray(x, jnp.int32))
    np.testing.assert_allclose(ours, np.asarray(theirs), atol=2e-4,
                               rtol=2e-4)


@pytest.mark.parametrize("key,value,match", [
    ("activation_function", "gelu", "gelu_new"),
    ("layer_norm_epsilon", 1e-6, "layer_norm_epsilon")])
def test_variant_configs_rejected(key, value, match):
    cfg = transformers.GPT2Config(n_layer=1, n_head=1, n_embd=32,
                                  **{key: value})
    with pytest.raises(ValueError, match=match) as ours:
        convert.gpt_config_from_hf(cfg.to_dict())
    with pytest.raises(ValueError) as theirs:
        jconvert.gpt_config_from_hf(cfg)
    assert str(ours.value) == str(theirs.value)


def _hf_dir(tmp_path) -> str:
    hf = _hf_model(vocab=128)
    path = str(tmp_path / "hf_gpt2")
    hf.save_pretrained(path)
    return path


@pytest.mark.parametrize("block,error", [(32, None), (128, "pretrained "
                                                            "context")])
def test_trainer_takes_the_hf_architecture(char_dataset, tmp_path, block,
                                           error):
    """init_from=hf:<dir> forces the HF architecture (the config's dims
    deliberately differ), crops wpe to block_size and refuses to grow
    it; the model starts from the directory's weights and trains."""
    path = _hf_dir(tmp_path)
    cfg = TrainConfig(
        data_dir=char_dataset, dataset="shakespeare_char",
        out_dir=str(tmp_path / "out"), init_from=f"hf:{path}",
        n_layer=5, n_head=3, n_embd=48, block_size=block, batch_size=4,
        max_iters=4, lr_decay_iters=4, warmup_iters=1, eval_interval=0,
        eval_iters=1, log_interval=1, learning_rate=3e-4,
        compute_dtype="float32", device="cpu", tensorboard=False)
    if error:
        with pytest.raises(ValueError, match=error):
            ttrain.Trainer(cfg)
        return
    trainer = ttrain.Trainer(cfg)
    m = trainer.model_cfg
    assert (m.n_layer, m.n_head, m.n_embd, m.vocab_size, m.bias,
            m.block_size) == (2, 2, 64, 128, True, 32)
    hf = transformers.GPT2LMHeadModel.from_pretrained(path)
    sd = trainer.model.state_dict()
    assert torch.equal(sd["wte.weight"],
                       hf.state_dict()["transformer.wte.weight"])
    assert torch.equal(sd["wpe.weight"],
                       hf.state_dict()["transformer.wpe.weight"][:32])
    out = trainer.run()
    assert np.isfinite([r["loss"] for r in out["log"]]).all()


def test_empty_hf_path_is_not_pretrained(char_dataset, tmp_path):
    cfg = TrainConfig(data_dir=char_dataset, dataset="shakespeare_char",
                      out_dir=str(tmp_path / "out"), init_from="hf:",
                      n_layer=1, n_head=2, n_embd=32, block_size=16,
                      batch_size=8, device="cpu", tensorboard=False)
    trainer = ttrain.Trainer(cfg)
    assert trainer._pretrained is False
    assert trainer.model_cfg.n_layer == 1  # user dims kept


def test_export_cli_from_checkpoint(char_dataset, tmp_path):
    """Train 2 iters, export with the module CLI (vocab cropped to 36),
    re-import through load_hf_gpt2: the trained weights, the trained
    model's logits in transformers too."""
    out = str(tmp_path / "run")
    trainer = ttrain.Trainer(TrainConfig(
        out_dir=out, data_dir=char_dataset, dataset="shakespeare_char",
        n_layer=2, n_head=2, n_embd=64, block_size=64, batch_size=8,
        max_iters=2, eval_interval=0, eval_iters=1, log_interval=1,
        warmup_iters=1, lr_decay_iters=2, compute_dtype="float32",
        tensorboard=False, device="cpu"))
    trainer.run()
    dest = convert.main(["--out_dir", out, "--to",
                         str(tmp_path / "hf_export"), "--vocab_size=36"])
    cfg, sd = convert.load_hf_gpt2(dest)
    assert (cfg.n_layer, cfg.n_embd, cfg.vocab_size) == (2, 64, 36)
    trained = trainer.model.state_dict()
    for name, t in sd.items():
        want = trained.get(name)
        if want is None:             # bias-free model: zero biases
            assert not t.any(), name
            continue
        assert torch.equal(t, want[:36] if name == "wte.weight" else want)
    x = np.random.default_rng(5).integers(0, 36, size=(2, 40))
    back = transformers.GPT2LMHeadModel.from_pretrained(dest).eval()
    np.testing.assert_allclose(_logits(_port(cfg, sd), x), _logits(back, x),
                               atol=2e-4, rtol=2e-4)
