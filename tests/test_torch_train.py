"""The port's training slice against the JAX package, on the CPU.

* every config file loads to the same TrainConfig in both packages, and
  the fields this slice does not port raise NotImplementedError;
* the GPT's loss and every parameter gradient match jax.value_and_grad
  of the flax GPT (attention_impl='pallas_interpret') with one set of
  weights carried over by state_dict_from_jax_params: 1e-5 on the loss,
  1e-4 on gradients (fp32, tests/conftest.py tiny_cfg dimensions); the
  chunked loss matches the full one;
* 4 AdamW updates with warmup 2 and active clipping match optax on
  identical gradients to 1e-6, and lr(0) = 0;
* gradient accumulation over 2 micro-batches equals one step on the
  whole batch (loss 1e-6, gradients 1e-5);
* BinDataset.sample_batch draws the JAX loader's batches, both through
  their native xorshift128+ sampler and gather;
* the CLI trains on the CPU, checkpoints, resumes at the saved
  iteration, and the checkpoint converts into a serving one; its host
  syncs by ledger name are JAX's loop's at the same flags.
"""

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nanosandbox_tpu import config as jconfig
from nanosandbox_tpu.data import loader as jloader
from nanosandbox_tpu.models import gpt as jgpt
from nanosandbox_tpu.train import make_optimizer as jax_make_optimizer
from nanosandbox_tpu.utils import native
from nanosandbox_tpu_torch import config as tconfig
from nanosandbox_tpu_torch import train as ttrain
from nanosandbox_tpu_torch.checkpoint import (load_for_serving,
                                              serving_from_training)
from nanosandbox_tpu_torch.data.loader import BatchLoader, BinDataset
from nanosandbox_tpu_torch.models.convert import state_dict_from_jax_params
from nanosandbox_tpu_torch.models.gpt import (GPT, chunked_cross_entropy_loss,
                                              cross_entropy_loss)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIMS = dict(n_layer=2, n_head=2, n_embd=64, block_size=64, vocab_size=65)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _port_cfg(jax_cfg, **kw) -> tconfig.TrainConfig:
    return tconfig.TrainConfig(**{**jax_cfg.to_dict(), "device": "cpu",
                                  **kw})


def test_config_files_load_like_the_jax_package():
    paths = sorted(glob.glob(os.path.join(REPO, "configs", "*.py")))
    assert len(paths) >= 10
    for path in paths:
        got = tconfig.load_config([path, "--seed=3"]).to_dict()
        assert got == jconfig.load_config([path, "--seed=3"]).to_dict(), path
    assert set(tconfig.TrainConfig().to_dict()) == jconfig.field_names()
    for args in ((-1, 16, 1024, 50304), (-1, 64, 1024, 50304),
                 (-1, 4, 64, 65, 2), (128, 16, 1024, 50304)):
        assert (tconfig.resolve_loss_chunk_size(*args)
                == jconfig.resolve_loss_chunk_size(*args))
    with pytest.raises(ValueError, match="unknown config key"):
        tconfig.load_config(["--learning_rte=1"])


# The committed config the port does not run: a download of pretrained
# GPT-2 weights.
UNPORTED_CONFIGS = {"finetune_gpt2_owt.py": "init_from"}


@pytest.mark.parametrize("name", sorted(
    os.path.basename(p) for p in glob.glob(os.path.join(REPO, "configs",
                                                        "*.py"))))
def test_committed_configs_run_unmodified(name):
    """Every committed config but UNPORTED_CONFIGS passes check_ported as
    written (remat, profile_steps, memory_report and dropout under
    mesh_sp > 1 included) and builds its GPT (on the meta device: no
    memory, no init); the other still raises."""
    cfg = tconfig.load_config([os.path.join(REPO, "configs", name)])
    if name in UNPORTED_CONFIGS:
        with pytest.raises(NotImplementedError,
                           match=UNPORTED_CONFIGS[name]):
            tconfig.check_ported(cfg)
        return
    tconfig.check_ported(cfg)
    mcfg = tconfig.GPTConfig.from_train_config(cfg, cfg.vocab_size or 65)
    model = GPT(mcfg, device="meta")
    assert mcfg.remat == cfg.remat and mcfg.dropout == cfg.dropout
    n = sum(p.numel() for p in model.parameters())
    C, L, V = cfg.n_embd, cfg.n_layer, mcfg.vocab_size
    assert n == (V + cfg.block_size) * C + L * 12 * C * C + (2 * L + 1) * C


# The data, fsdp, seq and model axes, mesh_slices, shard_params and hf:
# init are ported; pretrained OpenAI weights are not, and with them
# beside anything ported the config still raises.
@pytest.mark.parametrize("override", [
    dict(init_from="gpt2"),
    dict(profile_steps="1:3", init_from="gpt2-medium"),
    dict(coordinator_address="h:1", mesh_sp=2, attention_impl="ring",
         dropout=0.1, mesh_tp=2, init_from="gpt2"),
    dict(num_processes=2, mesh_sp=2, mesh_tp=2, attention_impl="ring",
         init_from="gpt2-large")])
def test_unported_keys_raise(override):
    with pytest.raises(NotImplementedError, match="not ported yet"):
        tconfig.check_ported(tconfig.TrainConfig(**override))


@pytest.mark.parametrize("override", [
    dict(mesh_fsdp=2), dict(mesh_sp=2, mesh_dp=2, attention_impl="ring"),
    dict(mesh_dp=4), dict(mesh_slices=-1), dict(shard_params=True),
    dict(attention_impl="ring", mesh_fsdp=2), dict(init_from="hf:/x"),
    dict(memory_report=True, mesh_dp=2), dict(mesh_tp=2),
    dict(coordinator_address="h:1", mesh_sp=2, attention_impl="ring",
         dropout=0.1, mesh_tp=2),
    dict(num_processes=2, mesh_sp=2, mesh_tp=2, attention_impl="ring"),
    dict(mesh_tp=2, mesh_fsdp=2, shard_params=True)])
def test_ported_mesh_keys_accepted(override):
    """What used to raise as unported passes check_ported now; the batch
    checks against the mesh are the Trainer's (check_mesh). The model
    axis splits heads, under every attention impl: n_head must divide
    by it."""
    tconfig.check_ported(tconfig.TrainConfig(**override))
    if override.get("mesh_tp", 1) > 1:
        with pytest.raises(ValueError, match="n_head 6 must be divisible"):
            tconfig.check_ported(tconfig.TrainConfig(**{
                **override, "n_head": 6, "n_embd": 384, "mesh_tp": 4}))


def test_accepted_inert_keys_and_device(monkeypatch, tiny_cfg):
    cfg = _port_cfg(tiny_cfg, rng_impl="rbg", attention_stat_layout=
                    "replicated", compile=True, mesh_dp=1)
    tconfig.check_ported(cfg)
    for impl in ("pallas", "xla", "pallas_interpret", "pallas_jax"):
        tconfig.check_ported(cfg.replace(attention_impl=impl))
    with pytest.raises(ValueError, match="unknown attention_impl"):
        tconfig.check_ported(cfg.replace(attention_impl="flash"))
    assert tconfig.GPTConfig(remat=True).remat_policy == "save_attention"
    tconfig.GPTConfig(remat=True, remat_policy="full")
    with pytest.raises(ValueError, match="unknown remat_policy"):
        tconfig.GPTConfig(remat=True, remat_policy="dots")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device=cpu"):
        ttrain.Trainer(cfg.replace(device="auto"))


@pytest.fixture(scope="module")
def twin():
    """(flax model, params, port model) with one set of fp32 weights."""
    jcfg = jconfig.GPTConfig(**DIMS, compute_dtype="float32",
                             attention_impl="pallas_interpret")
    jmodel = jgpt.GPT(jcfg)
    params = jax.jit(jmodel.init)(                  # compiled: faster
        jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]
    cfg = tconfig.GPTConfig(**DIMS, compute_dtype="float32")
    model = GPT(cfg)
    model.load_state_dict(state_dict_from_jax_params(
        jax.device_get(params), cfg))
    return jmodel, params, model


def test_loss_and_gradients_match_jax(twin):
    jmodel, params, model = twin
    rng = np.random.default_rng(0)
    x, y = (rng.integers(0, DIMS["vocab_size"], (2, 64)) for _ in range(2))
    y[0, :5] = -1                                # ignore_index positions

    def jloss(p):
        logits = jmodel.apply({"params": p}, jnp.asarray(x, jnp.int32))
        return jgpt.cross_entropy_loss(logits, jnp.asarray(y, jnp.int32))

    jl, jg = jax.value_and_grad(jloss)(params)
    ref = state_dict_from_jax_params(jax.device_get(jg), model.cfg)
    model.zero_grad()
    loss = cross_entropy_loss(model(torch.from_numpy(x)), torch.from_numpy(y))
    loss.backward()
    assert abs(loss.item() - float(jl)) <= 1e-5
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(),
                                   atol=1e-4, err_msg=name)

    full = {n: p.grad.clone() for n, p in model.named_parameters()}
    model.zero_grad()
    hidden = model.hidden(torch.from_numpy(x))
    chunked = chunked_cross_entropy_loss(hidden, model.wte.weight,
                                         torch.from_numpy(y), chunk_size=24,
                                         compute_dtype="float32")
    chunked.backward()
    assert abs(chunked.item() - loss.item()) <= 1e-6
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), full[name].numpy(),
                                   atol=1e-6, err_msg=name)


def test_convert_carries_biased_training_params():
    """state_dict_from_jax_params maps every f32 training parameter of a
    biased model too (strict load), and the logits agree."""
    dims = dict(DIMS, n_layer=1, bias=True)
    jmodel = jgpt.GPT(jconfig.GPTConfig(**dims, compute_dtype="float32",
                                        attention_impl="xla"))
    params = jax.jit(jmodel.init)(jax.random.key(1),
                                  jnp.zeros((1, 8), jnp.int32))["params"]
    params = jax.tree.map(lambda p: p + 0.01, params)   # nonzero biases
    cfg = tconfig.GPTConfig(**dims, compute_dtype="float32")
    model = GPT(cfg)
    model.load_state_dict(state_dict_from_jax_params(
        jax.device_get(params), cfg))
    idx = np.random.default_rng(2).integers(0, 65, (2, 16))
    ref = jmodel.apply({"params": params}, jnp.asarray(idx, jnp.int32))
    with torch.no_grad():
        out = model(torch.from_numpy(idx))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


def test_dropout_forward_is_keyed_by_the_generator(twin):
    _, _, model = twin
    cfg = tconfig.GPTConfig(**DIMS, compute_dtype="float32", dropout=0.2)
    drop = GPT(cfg)
    drop.load_state_dict(model.state_dict())
    x = torch.from_numpy(np.random.default_rng(1).integers(0, 65, (2, 32)))

    def run(seed, **kw):
        g = torch.Generator().manual_seed(seed)
        return drop(x, dropout_generator=g, **kw)

    assert torch.equal(run(3), run(3))
    assert torch.equal(run(3), run(3, plain_attention=True))
    assert not torch.equal(run(3), run(4))
    assert torch.allclose(drop(x), model(x))     # no generator: no dropout


def test_optimizer_matches_optax():
    jcfg = jconfig.TrainConfig(learning_rate=1e-2, min_lr=1e-3,
                               warmup_iters=2, max_iters=10,
                               lr_decay_iters=10, grad_clip=0.5,
                               weight_decay=0.1)
    cfg = tconfig.TrainConfig(**jcfg.to_dict())
    rng = np.random.default_rng(0)
    init = {"w": rng.standard_normal((4, 3), dtype=np.float32),
            "b": rng.standard_normal((3,), dtype=np.float32)}
    tx, jsched = jax_make_optimizer(jcfg)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(jparams)

    module = torch.nn.Module()
    for k, v in init.items():
        module.register_parameter(k, torch.nn.Parameter(torch.tensor(v)))
    opt, sched = ttrain.make_optimizer(module, cfg)
    assert sched(0) == 0.0 == float(jsched(0))
    for step in range(4):
        grads = {k: 3 * rng.standard_normal(v.shape, dtype=np.float32)
                 for k, v in init.items()}
        updates, state = tx.update({k: jnp.asarray(g) for k, g in
                                    grads.items()}, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in module.named_parameters():
            p.grad = torch.tensor(grads[k])
        norm = ttrain.optimizer_step(opt, sched, step, cfg.grad_clip)
        assert float(norm) > cfg.grad_clip      # clipping is active
        np.testing.assert_allclose(float(norm),
                                   float(optax.global_norm(grads)),
                                   rtol=1e-6)
        assert abs(sched(step) - float(jsched(step))) <= 1e-9
        for k, p in module.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(jparams[k]), atol=1e-6)
        if step == 0:                            # lr 0: nothing moved
            for k, p in module.named_parameters():
                np.testing.assert_array_equal(p.detach().numpy(), init[k])


def test_gradient_accumulation_equals_whole_batch(tiny_cfg):
    whole = ttrain.Trainer(_port_cfg(tiny_cfg, batch_size=8))
    accum = ttrain.Trainer(_port_cfg(tiny_cfg, batch_size=4,
                                     gradient_accumulation_steps=2))
    xb, yb = next(whole.make_loader("train", prefetch=False))
    x, y = torch.from_numpy(xb).long(), torch.from_numpy(yb).long()
    l1, l2 = whole.grads(x, y), accum.grads(x, y)
    assert abs(float(l1) - float(l2)) <= 1e-6
    for (name, a), b in zip(whole.model.named_parameters(),
                            accum.model.parameters()):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(),
                                   atol=1e-5, err_msg=name)


def test_sample_batch_matches_the_jax_loader(char_dataset):
    assert native.get_lib() is not None     # xorshift on both sides
    jds = jloader.BinDataset(char_dataset, "shakespeare_char")
    tds = BinDataset(char_dataset, "shakespeare_char")
    assert tds.vocab_size == jds.vocab_size
    for split, step in (("train", 0), ("train", 7), ("val", 1_000_003)):
        for got, ref in zip(tds.sample_batch(split, step, 4, 32, seed=5),
                            jds.sample_batch(split, step, 4, 32, seed=5)):
            np.testing.assert_array_equal(got, ref)
    jl = jloader.BatchLoader(jds, "train", 4, 32, seed=9, start_step=2,
                             prefetch=False)
    tl = BatchLoader(tds, "train", 4, 32, seed=9, start_step=2)
    try:
        for _ in range(3):
            for got, ref in zip(next(tl), next(jl)):
                np.testing.assert_array_equal(got, ref)
    finally:
        tl.close()


def test_cli_trains_checkpoints_and_resumes(char_dataset, tmp_path):
    from nanosandbox_tpu_torch.utils import tracecheck

    out = str(tmp_path / "out")
    flags = [os.path.join(REPO, "configs", "smoke_cpu.py"),
             f"--data_dir={char_dataset}", f"--out_dir={out}",
             "--device=cpu", "--block_size=64", "--batch_size=8",
             "--eval_interval=10", "--eval_iters=2", "--log_interval=5",
             "--tensorboard=False", "--run_name=r"]
    mark = tracecheck.sync_counts()
    first = ttrain.main(flags + ["--max_iters=20", "--lr_decay_iters=20"])
    # JAX's loop at these flags: one log readback a log step (0, 5, 10,
    # 15), one eval readback a split per eval (iters 0 and 10, the end).
    assert tracecheck.sync_delta(mark) == {"train-log-readback": 4,
                                           "eval-readback": 6}
    log = first["log"]
    assert first["iter_num"] == 20 and [r["iter"] for r in log] == [
        0, 5, 10, 15]
    assert log[-1]["loss"] < log[0]["loss"] - 0.3
    assert np.isfinite(first["final_val_loss"])
    assert sorted(os.listdir(os.path.join(out, "ckpt"))) == ["10", "20"]
    resumed = ttrain.main(flags + ["--max_iters=25", "--lr_decay_iters=20",
                                   "--init_from=resume"])
    assert resumed["iter_num"] == 25 and resumed["log"][0]["iter"] == 20
    with open(os.path.join(out, "runs", "r", "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    header = recs[0]["header"]
    assert header["offset_sampler"] == "native-xorshift128+"
    assert header["rng_impl"] == "threefry2x32"
    assert any(r.get("step") == 20 and "train/loss" in r for r in recs)

    serving_from_training(out)
    cfg, sd = load_for_serving(out)
    model = GPT(cfg)
    model.load_state_dict(sd)
    with torch.no_grad():
        logits = model(torch.zeros((1, 8), dtype=torch.long))
    assert logits.shape == (1, 8, cfg.vocab_size)
    assert torch.isfinite(logits).all()
