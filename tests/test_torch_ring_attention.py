"""Ring attention and sequence-parallel training of the port against the
JAX package, on the CPU.

* The lse block: flash_attention_lse / flash_attention_lse_dropout (the
  plain versions the CPU takes, and the autograd.Function the CUDA path
  uses, wired to the same plain versions), causal and not, against JAX's
  Pallas kernels in interpret mode: o and lse within 2e-5, dq, dk, dv of
  sum(o dO) + sum(lse dlse) with a random dlse within 2e-4 (the limits
  of test_torch_attention.py: f32 sums in another order); the dropout
  mask with global offsets bit-equal.
* The ring op over 2 and 4 gloo processes (this file run as a script,
  one process a rank), zigzag and contiguous, without and with dropout,
  and a T with T % 2P != 0 (the contiguous layout, as JAX takes it),
  against JAX's ring_attention_sharded(block_impl='xla') on a CPU mesh
  with mesh_sp = P: forward and dq, dk, dv within 1e-5.
* The SP trainer: one optimizer step of a tiny fp32 GPT at mesh_sp 2 and
  4 (gloo), weights from JAX, the batch JAX's loader draws: the loss
  within 1e-5 and every gradient (the summed gradients on rank 0) within
  1e-4 of the JAX ring model's on the CPU mesh (the limits of
  test_loss_and_gradients_match_jax), the updated parameters within 1e-4
  of optax's update of JAX's gradients (AdamW's first update is
  lr g / (|g| + eps), which magnifies f32 gradient differences where
  |g| is tiny; a flipped sign would move a parameter 2 lr = 2e-3), and
  all of them of the port's own single-process step at the same limits;
  every rank holds the same parameters bit for bit; then a two-step
  CLI run at mesh_sp 2 writes one checkpoint from rank 0 and resumes.
* The JAX trainer's ring validations (tests/test_ring_attention.py),
  and mesh_dp > 1 with ring in one process, which raises the process
  count's ValueError.

Each multi-process case starts its ranks with this file's worker mode,
at B 2, H 2, T 64-68, D 16, or a 2-layer, 64-wide GPT over 64 positions.
"""

import contextlib
import json
import os
import socket
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, H, T, D = 2, 2, 64, 16
# (T, requested layout, dropout rate) of every ring case; T 66 / 68 are
# not multiples of 2P at P 2 / 4, so zigzag falls back to contiguous.
RING_CASES = [(T, layout, rate) for layout in ("zigzag", "contiguous")
              for rate in (0.0, 0.1)]
FALLBACK_T = {2: 66, 4: 68}
DIMS = dict(n_layer=2, n_head=2, n_embd=64, block_size=64)
TRAIN = dict(vocab_size=65, batch_size=2, learning_rate=1e-3, warmup_iters=0,
             max_iters=10, lr_decay_iters=10, min_lr=1e-4,
             loss_chunk_size=16, compute_dtype="float32", grad_clip=1.0,
             weight_decay=0.1, seed=3, dropout=0.0)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _qkv(T_, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, H, T_, D), dtype=np.float32)
            for _ in range(4)]                      # q, k, v, dO


def _start_ranks(P, argv, env=None):
    """Start P processes of ``argv`` as the ranks of one group (the
    COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID contract), each
    writing to a temporary file; returns them for _wait_ranks."""
    port = _free_port()
    procs = []
    for rank in range(P):
        e = {**os.environ, **(env or {}),
             "COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
             "NUM_PROCESSES": str(P), "PROCESS_ID": str(rank),
             "OMP_NUM_THREADS": "1", "PYTHONPATH": REPO}
        log = tempfile.TemporaryFile("w+")
        procs.append((subprocess.Popen(argv, cwd=REPO, env=e, text=True,
                                       stdout=log, stderr=subprocess.STDOUT),
                      log))
    return procs


def _wait_ranks(procs, timeout=120):
    """Wait for the ranks _start_ranks started; returns their outputs. A
    rank that fails fails the test."""
    outs = []
    try:
        for p, log in procs:
            p.wait(timeout=timeout)
            log.seek(0)
            outs.append(log.read())
    finally:
        for p, log in procs:
            p.kill()
            log.close()
    for rank, ((p, _), out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank}:\n{out[-4000:]}"
    return outs


def _run_ranks(P, argv, timeout=120, env=None):
    """_start_ranks, then _wait_ranks."""
    return _wait_ranks(_start_ranks(P, argv, env), timeout)


# ---------------------------------------------------------------------------
# Workers (this file run as a script: one process a rank)
# ---------------------------------------------------------------------------

def _worker(out_dir: str) -> None:
    """Every ring case, then the SP trainer's step at each config of
    <out_dir>/legs.json; this rank's results under out_dir."""
    from nanosandbox_tpu_torch import train as ttrain
    from nanosandbox_tpu_torch.config import TrainConfig
    from nanosandbox_tpu_torch.ops import ring_attention as ra
    from nanosandbox_tpu_torch.parallel import distributed

    proc = distributed.initialize("", 0, -1, torch.device("cpu"))
    P, rank = proc.world_size, proc.rank
    group = torch.distributed.group.WORLD
    cases = RING_CASES + [(FALLBACK_T[P], "zigzag", 0.0)]
    for i, (T_, layout, rate) in enumerate(cases):
        q, k, v, do = (torch.from_numpy(x) for x in _qkv(T_))
        pos = ra.ring_positions(T_, P, rank, layout)
        ql, kl, vl = (x[:, :, pos].clone().requires_grad_()
                      for x in (q, k, v))
        seed = torch.tensor([7]) if rate else None
        out = ra.ring_attention_sharded(
            ql, kl, vl, group=group, rank=rank, size=P, layout=layout,
            dropout_rate=rate, dropout_seed=seed)
        out.backward(do[:, :, pos])
        np.savez(os.path.join(out_dir, f"ring{i}_rank{rank}.npz"), pos=pos,
                 o=out.detach().numpy(), dq=ql.grad.numpy(),
                 dk=kl.grad.numpy(), dv=vl.grad.numpy())
    with open(os.path.join(out_dir, "legs.json")) as f:
        legs = json.load(f)
    for leg in legs:
        cfg = TrainConfig(**leg)
        trainer = ttrain.Trainer(cfg)
        trainer.model.load_state_dict(torch.load(os.path.join(out_dir,
                                                              "init.pt")))
        xb, yb = next(trainer.make_loader("train", prefetch=False))
        loss = trainer.grads(torch.from_numpy(xb).long(),
                             torch.from_numpy(yb).long())
        grads = {n: p.grad.clone()
                 for n, p in trainer.model.named_parameters()}
        ttrain.optimizer_step(trainer.optimizer, trainer.lr_schedule, 0,
                              cfg.grad_clip)
        torch.save({"loss": float(loss), "grads": grads,
                    "params": trainer.model.state_dict()},
                   os.path.join(out_dir,
                                f"step_{cfg.ring_layout}_rank{rank}.pt"))
    distributed.shutdown()


if __name__ == "__main__":
    torch.set_num_threads(1)
    _worker(sys.argv[1])
    sys.exit(0)


import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from nanosandbox_tpu import config as jconfig  # noqa: E402
from nanosandbox_tpu.models import gpt as jgpt  # noqa: E402
from nanosandbox_tpu.ops import attention as jattn  # noqa: E402
from nanosandbox_tpu.ops.ring_attention import (  # noqa: E402
    ring_attention_sharded as jax_ring)
from nanosandbox_tpu.parallel.mesh import make_mesh  # noqa: E402
from nanosandbox_tpu.train import (  # noqa: E402
    make_optimizer as jax_make_optimizer)
from nanosandbox_tpu_torch import config as tconfig  # noqa: E402
from nanosandbox_tpu_torch import train as ttrain  # noqa: E402
from nanosandbox_tpu_torch.models.convert import (  # noqa: E402
    state_dict_from_jax_params)
from nanosandbox_tpu_torch.ops import attention as tattn  # noqa: E402

TOL_O, TOL_G = 2e-5, 2e-4


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# 1. The lse block
# ---------------------------------------------------------------------------

def _lse_grads(fn, q, k, v, do, dlse):
    """(o, lse, dq, dk, dv) of sum(o dO) + sum(lse dlse) of a torch
    function of (q, k, v) returning (o, lse)."""
    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    o, lse = fn(qt, kt, vt)
    ((o * torch.from_numpy(do)).sum()
     + (lse * torch.from_numpy(dlse)).sum()).backward()
    return (o.detach().numpy(), lse.detach().numpy(), qt.grad.numpy(),
            kt.grad.numpy(), vt.grad.numpy())


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("causal", [True, False])
def test_lse_block_matches_jax(causal, rate):
    T_ = 128                     # JAX's non-causal blocks take no padding
    q, k, v, do = _qkv(T_, seed=4)
    dlse = np.random.default_rng(5).standard_normal(
        (B, H, T_), dtype=np.float32)
    words = [9, 0, 0, 256, 128]              # a ring block's global offsets
    hash_len = 512

    def jfn(q, k, v):
        if rate:
            return jattn.flash_attention_lse_dropout(
                q, k, v, jnp.asarray(words, jnp.uint32), causal, None, rate,
                True, "replicated", H, hash_len)
        return jattn.flash_attention_lse(q, k, v, causal, None, True)

    (jo, jlse), vjp = jax.vjp(jfn, *(jnp.asarray(x) for x in (q, k, v)))
    jg = vjp((jnp.asarray(do), jnp.asarray(dlse)))
    refs = (np.asarray(jo), np.asarray(jlse), *(np.asarray(g) for g in jg))
    wkw = dict(hash_heads=H, hash_seq_len=hash_len)
    runs = {
        "entry point": lambda q, k, v: tattn.flash_attention_lse_dropout(
            q, k, v, words, causal, None, rate, **wkw),
        # The Function the CUDA path applies, on the CPU entry points.
        "autograd.Function": lambda q, k, v: tattn.FlashAttention.apply(
            q, k, v, tattn.seed_words(words), causal, None, rate,
            hash_len)}
    if not rate:
        runs["no-dropout entry point"] = (
            lambda q, k, v: tattn.flash_attention_lse(q, k, v, causal))
    for name, fn in runs.items():
        got = _lse_grads(fn, q, k, v, do, dlse)
        for g, r, tol, what in zip(got, refs, (TOL_O, TOL_O) + (TOL_G,) * 3,
                                   ("o", "lse", "dq", "dk", "dv")):
            np.testing.assert_allclose(g, r, atol=tol,
                                       err_msg=f"{name}: {what}")
    if rate:
        ref = jattn.hash_dropout_keep_mask(
            jnp.asarray(words, jnp.uint32), B, H, T_, T_, hash_heads=H,
            hash_seq_len=hash_len, rate=rate)
        got = tattn.hash_dropout_keep_mask(words, B, H, T_, T_,
                                           hash_heads=H,
                                           hash_seq_len=hash_len, rate=rate)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# ---------------------------------------------------------------------------
# 2. The ring op over gloo processes
# ---------------------------------------------------------------------------

# The SP trainer's step at each P: the layouts one spawn of P ranks runs
# after the ring cases.
SP_LEGS = {2: ("zigzag",), 4: ("zigzag", "contiguous")}


@pytest.fixture(scope="module")
def ring_runs(sp_setup):
    """{P: (cases, per-case global (o, dq, dk, dv), {layout: every rank's
    trainer step})}: one spawn a P, whose ranks run every ring case once,
    then the SP trainer's step at each of SP_LEGS[P]'s layouts."""
    _, sd, _, cfg = sp_setup
    runs, started = {}, {}
    with contextlib.ExitStack() as stack:
        for P in (4, 2):                 # both spawns run at once
            tmp = stack.enter_context(tempfile.TemporaryDirectory())
            torch.save(sd, os.path.join(tmp, "init.pt"))
            with open(os.path.join(tmp, "legs.json"), "w") as f:
                json.dump([cfg.replace(mesh_sp=P, ring_layout=layout)
                           .to_dict() for layout in SP_LEGS[P]], f)
            started[P] = (tmp, _start_ranks(P, [sys.executable, __file__,
                                                tmp]))
        for P, (tmp, procs) in sorted(started.items()):
            _wait_ranks(procs)
            cases = RING_CASES + [(FALLBACK_T[P], "zigzag", 0.0)]
            results = []
            for i, (T_, _, _) in enumerate(cases):
                full = {n: np.zeros((B, H, T_, D), np.float32)
                        for n in ("o", "dq", "dk", "dv")}
                for rank in range(P):
                    z = np.load(os.path.join(tmp, f"ring{i}_rank{rank}.npz"))
                    for n in full:
                        full[n][:, :, z["pos"]] = z[n]
                results.append(full)
            steps = {layout: [torch.load(os.path.join(
                tmp, f"step_{layout}_rank{r}.pt")) for r in range(P)]
                for layout in SP_LEGS[P]}
            runs[P] = (cases, results, steps)
    return runs


def _jax_ring(P, T_, layout, rate):
    mesh = make_mesh(mesh_dp=1, mesh_sp=P, devices=jax.devices()[:P])
    q, k, v, do = _qkv(T_)

    def fn(q, k, v):
        return jax_ring(q, k, v, mesh=mesh, layout=layout, block_impl="xla",
                        dropout_rate=rate,
                        dropout_seed=(jnp.asarray([7], jnp.uint32)
                                      if rate else None))

    @jax.jit
    def fwd_bwd(q, k, v, do):
        o, vjp = jax.vjp(fn, q, k, v)
        return (o, *vjp(do))

    out = fwd_bwd(*(jnp.asarray(x) for x in (q, k, v, do)))
    return dict(zip(("o", "dq", "dk", "dv"), (np.asarray(x) for x in out)))


@pytest.mark.parametrize("case", range(len(RING_CASES) + 1))
@pytest.mark.parametrize("P", [2, 4])
def test_ring_attention_matches_jax(ring_runs, P, case):
    cases, results, _ = ring_runs[P]
    T_, layout, rate = cases[case]
    ref = _jax_ring(P, T_, layout, rate)
    for name, got in results[case].items():
        np.testing.assert_allclose(
            got, ref[name], atol=1e-5,
            err_msg=f"P={P} T={T_} {layout} dropout {rate}: {name}")


# ---------------------------------------------------------------------------
# 3. The SP trainer
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sp_setup(tmp_path_factory, char_dataset):
    """(jax params, port state_dict, the step's global batch, config)."""
    jcfg = jconfig.GPTConfig(**DIMS, vocab_size=65, compute_dtype="float32",
                             attention_impl="xla")
    params = jax.jit(jgpt.GPT(jcfg).init)(       # compiled: faster
        jax.random.key(2), jnp.zeros((1, 8), jnp.int32))["params"]
    params = jax.device_get(params)
    cfg = tconfig.TrainConfig(**DIMS, **TRAIN, data_dir=char_dataset,
                              dataset="shakespeare_char", device="cpu",
                              attention_impl="ring", tensorboard=False)
    sd = state_dict_from_jax_params(params, tconfig.GPTConfig(
        **DIMS, vocab_size=65, compute_dtype="float32"))
    from nanosandbox_tpu_torch.data.loader import BinDataset

    x, y = BinDataset(char_dataset, "shakespeare_char").sample_batch(
        "train", 0, cfg.batch_size, cfg.block_size, seed=cfg.seed)
    return params, sd, (x, y), cfg


def _jax_step(params, x, y, P, layout, cfg):
    """(loss, grads, updated params) of the JAX ring model on a CPU mesh
    with mesh_sp = P (P = 1: the plain model), optax's AdamW."""
    mesh = make_mesh(mesh_dp=1, mesh_sp=P, devices=jax.devices()[:P])
    jcfg = jconfig.GPTConfig(**DIMS, vocab_size=65, compute_dtype="float32",
                             attention_impl="ring", ring_layout=layout,
                             ring_block_impl="xla")
    model = jgpt.GPT(jcfg, mesh=mesh)

    def loss(p):
        hidden = model.apply({"params": p}, jnp.asarray(x),
                             return_hidden=True)
        return jgpt.sharded_chunked_cross_entropy_loss(
            hidden, p["wte"]["embedding"], jnp.asarray(y), mesh=mesh,
            chunk_size=cfg.loss_chunk_size, compute_dtype="float32")

    jl, jg = jax.jit(jax.value_and_grad(loss))(params)
    tx, _ = jax_make_optimizer(jconfig.TrainConfig(**{
        k: v for k, v in cfg.to_dict().items()}))
    updates, _ = tx.update(jg, tx.init(params), params)
    return float(jl), jax.device_get(jg), jax.device_get(
        optax.apply_updates(params, updates))


def _single_process_step(sd, x, y, cfg):
    trainer = ttrain.Trainer(cfg.replace(mesh_sp=1))
    trainer.model.load_state_dict(sd)
    loss = trainer.grads(torch.from_numpy(x).long(),
                         torch.from_numpy(y).long())
    grads = {n: p.grad.clone() for n, p in trainer.model.named_parameters()}
    ttrain.optimizer_step(trainer.optimizer, trainer.lr_schedule, 0,
                          cfg.grad_clip)
    return float(loss), grads, trainer.model.state_dict()


@pytest.mark.parametrize("P,layout", [(2, "zigzag"), (4, "zigzag"),
                                      (4, "contiguous")])
def test_sp_trainer_step_matches_jax(sp_setup, ring_runs, P, layout):
    params, sd, (x, y), cfg = sp_setup
    cfg = cfg.replace(mesh_sp=P, ring_layout=layout)
    ranks = ring_runs[P][2][layout]
    got = ranks[0]
    for other in ranks[1:]:                 # every rank steps the same
        assert other["loss"] == got["loss"]
        for n, t in got["params"].items():
            assert torch.equal(other["params"][n], t), n

    mcfg = tconfig.GPTConfig(**DIMS, vocab_size=65, compute_dtype="float32")
    jl, jg, jnew = _jax_step(params, x, y, P, layout, cfg)
    refs = {"JAX ring model": (jl, state_dict_from_jax_params(jg, mcfg),
                               state_dict_from_jax_params(jnew, mcfg)),
            "single-process port": _single_process_step(sd, x, y, cfg)}
    for ref_name, (rl, rg, rp) in refs.items():
        assert abs(got["loss"] - rl) <= 1e-5, (ref_name, got["loss"], rl)
        for n, g in got["grads"].items():
            np.testing.assert_allclose(g.numpy(), rg[n].numpy(), atol=1e-4,
                                       err_msg=f"{ref_name}: grad {n}")
        for n, p in got["params"].items():
            np.testing.assert_allclose(p.numpy(), rp[n].numpy(), atol=1e-4,
                                       err_msg=f"{ref_name}: param {n}")


def test_sp_cli_checkpoints_from_rank0_and_resumes(char_dataset, tmp_path):
    out = str(tmp_path / "out")
    flags = [sys.executable, "-m", "nanosandbox_tpu_torch.train",
             f"--data_dir={char_dataset}", f"--out_dir={out}",
             "--device=cpu", "--n_layer=2", "--n_head=2", "--n_embd=64",
             "--block_size=64", "--batch_size=2", "--compute_dtype=float32",
             "--mesh_sp=2", "--attention_impl=ring", "--loss_chunk_size=16",
             "--eval_interval=0", "--eval_iters=1", "--log_interval=1",
             "--tensorboard=False", "--run_name=r", "--warmup_iters=0"]
    first = _run_ranks(2, flags + ["--max_iters=2", "--lr_decay_iters=3"])
    assert sorted(os.listdir(os.path.join(out, "ckpt"))) == ["2"]
    assert "iter 1: loss" in first[0] and "iter 1: loss" not in first[1]
    for rank, text in enumerate(first):
        assert f"[rank {rank}/2] backend gloo" in text
    resumed = _run_ranks(2, flags + ["--max_iters=3", "--lr_decay_iters=3",
                                     "--init_from=resume"])
    assert "resumed from iter 2" in resumed[0]
    assert "iter 2: loss" in resumed[0]
    assert sorted(os.listdir(os.path.join(out, "ckpt"))) == ["2", "3"]
    with open(os.path.join(out, "runs", "r", "metrics.jsonl")) as f:
        steps = [json.loads(line).get("step") for line in f]
    assert [s for s in steps if s is not None] == [0, 1, 2]


# ---------------------------------------------------------------------------
# 4. Validation (the JAX trainer's ring checks)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("override,error,match", [
    (dict(mesh_sp=2), ValueError, "requires attention_impl='ring'"),
    (dict(mesh_sp=8, block_size=60, attention_impl="ring"), ValueError,
     "block_size"),
    (dict(mesh_sp=2, mesh_dp=4, attention_impl="ring"),
     ValueError, "processes"),
    (dict(mesh_sp=2, attention_impl="ring"), ValueError,
     "one process per seq shard")])
def test_trainer_validates_ring_config(tiny_cfg, override, error, match):
    cfg = tconfig.TrainConfig(**{**tiny_cfg.to_dict(), "device": "cpu",
                                 **override})
    with pytest.raises(error, match=match):
        ttrain.Trainer(cfg)


@pytest.mark.parametrize("what", ["plain_attention", "hash_heads"])
def test_ring_refuses_what_it_does_not_run(what):
    """The ring's block picks the kernels or the plain block by the
    tensors' device alone, so a ring forward refuses plain_attention; and
    a call holds at most the heads the mask hash runs over, so the lse
    block refuses a hash head count below the call's (a larger one is a
    head-sharded call, tests/test_torch_tp.py)."""
    if what == "plain_attention":
        from nanosandbox_tpu_torch.models.gpt import GPT
        from nanosandbox_tpu_torch.parallel.mesh import Mesh

        mesh = Mesh({"data": 1, "fsdp": 1, "seq": 2, "model": 1})
        model = GPT(tconfig.GPTConfig(**DIMS, vocab_size=65,
                                      compute_dtype="float32",
                                      attention_impl="ring"),
                    mesh=mesh, generator=torch.Generator().manual_seed(0))
        with pytest.raises(ValueError, match="plain_attention"):
            model(torch.zeros(1, 32, dtype=torch.long), plain_attention=True)
    else:
        q = torch.zeros(B, H, T, D)
        with pytest.raises(ValueError, match="hash_heads"):
            tattn.flash_attention_lse_dropout(q, q, q, [1], False, None, 0.1,
                                              hash_heads=H - 1)
