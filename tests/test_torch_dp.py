"""Data-parallel and FSDP training of the port against the JAX package,
on the CPU.

* One optimizer step of a tiny fp32 GPT (2 layers, C 64, vocab 65,
  global batch 4 x 64) in gloo ranks (this file run as a script, one
  process a rank; one spawn per rank count runs several legs):
  mesh_dp 2 (mesh_slices -1); mesh_fsdp 2 with shard_params, alone and
  x mesh_sp 2; mesh_dp 2 x mesh_sp 2 (4 ranks, ring attention, full
  logits); mesh_dp 2 with dropout 0.1 (mesh_slices 2). Weights from JAX,
  the global batch JAX's loader draws. The loss within 1e-5, every
  gradient (summed; under FSDP the gathered shards) and every updated
  parameter within 1e-4 of jax.value_and_grad of the flax GPT and
  optax's AdamW on the global batch, and of the port's own one-process
  step; the dropout leg against the one-process port only (the packages'
  residual-dropout bits differ, tests/test_torch_train.py). DP ranks end
  with the same parameters bit for bit; an FSDP rank holds only its
  shards (of the parameters and of both moments), each the elements of
  JAX's param_shardings slice of the same leaf (wte, whose 65 rows the
  fsdp size does not divide, replicated, as JAX replicates it), and the
  gathered shards are the full parameters.
* A CLI run at mesh_fsdp 2 writes one checkpoint from rank 0 in one
  process's format, which loads bit for bit into one process, mesh_dp 2
  and mesh_fsdp 2 (each rank its shards), and resumes at mesh_dp 2 and
  at one process (the CLI's loop, Trainer.run) with the same next step.
* The hybrid mesh (mesh_slices): the rank layout and the ValueErrors of
  JAX's make_hybrid_mesh on virtual devices, and make_mesh's layout.
"""

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

DIMS = dict(n_layer=2, n_head=2, n_embd=64, block_size=64)
TRAIN = dict(vocab_size=65, batch_size=4, learning_rate=1e-3,
             warmup_iters=0, max_iters=10, lr_decay_iters=10, min_lr=1e-4,
             loss_chunk_size=16, compute_dtype="float32", grad_clip=1.0,
             weight_decay=0.1, seed=3, dropout=0.0, device="cpu",
             tensorboard=False, eval_interval=0, eval_iters=1,
             **DIMS)
# (name, ranks, overrides) of each leg.
# The dp legs also lay the data axis over slices: by host name (one
# host: one slice) and as two contiguous groups of one rank.
# The model axis (tensor parallelism) alone and beside each other axis;
# its ring leg drops (dropout 0.1) at T 128, where one process's
# attention-dropout hash length is the ring's (tests/
# test_torch_sp_dropout.py), from weights of its own (SP_TP).
LEGS = [("dp", 2, dict(mesh_dp=2, mesh_slices=-1)),
        ("fsdp", 2, dict(mesh_fsdp=2, mesh_dp=1, shard_params=True)),
        ("dropout", 2, dict(mesh_dp=2, dropout=0.1, mesh_slices=2)),
        ("tp", 2, dict(mesh_tp=2, mesh_dp=1)),
        ("dp_sp", 4, dict(mesh_dp=2, mesh_sp=2, attention_impl="ring",
                          loss_chunk_size=0)),
        ("fsdp_sp", 4, dict(mesh_fsdp=2, mesh_dp=1, mesh_sp=2,
                            shard_params=True, attention_impl="ring")),
        ("dp_tp", 4, dict(mesh_dp=2, mesh_tp=2)),
        ("fsdp_tp", 4, dict(mesh_fsdp=2, mesh_dp=1, mesh_tp=2,
                            shard_params=True)),
        ("sp_tp", 4, dict(mesh_sp=2, mesh_dp=1, mesh_tp=2,
                          attention_impl="ring", dropout=0.1,
                          block_size=128))]
SP_TP = dict(dropout=0.1, block_size=128)


# ---------------------------------------------------------------------------
# The rank worker (this file run as a script)
# ---------------------------------------------------------------------------

def _worker(plan_path: str) -> None:
    """Each leg of the plan in turn: one step, a checkpoint restore, or a
    training run (the CLI's loop, ``Trainer.run``); writes
    <out>/<leg>_rank<r>.pt."""
    from nanosandbox_tpu_torch import train as ttrain
    from nanosandbox_tpu_torch.checkpoint import TrainCheckpointer
    from nanosandbox_tpu_torch.config import TrainConfig
    from nanosandbox_tpu_torch.parallel import distributed
    from nanosandbox_tpu_torch.parallel.tensor import gather_param

    with open(plan_path) as f:
        plan = json.load(f)
    for leg in plan["legs"]:
        trainer = ttrain.Trainer(TrainConfig(**leg["cfg"]))
        rank, fsdp, m = trainer.process.rank, trainer.fsdp, trainer.mesh
        named = (fsdp.named_parameters() if fsdp
                 else list(trainer.model.named_parameters()))
        out = {"held": sorted(n for n, _ in trainer.model.named_parameters())}

        def full(tensors):
            """Every rank's pieces gathered: {name: full tensor}."""
            if fsdp:
                return {n: fsdp._full(n, t) for n, t in tensors.items()}
            return {n: gather_param(n, t, m.model, m.model_group)
                    for n, t in tensors.items()}

        if leg.get("run"):
            trainer.run()
            if m.model > 1:
                out["full"] = trainer._gather_state()[0]
        elif leg.get("restore"):
            trainer.restore(TrainCheckpointer(leg["restore"]))
            out["params"] = {n: p.detach().clone() for n, p in named}
        else:
            trainer.load_full(torch.load(leg.get("init", plan["init"])))
            xb, yb = next(trainer.make_loader("train", prefetch=False))
            loss = trainer.grads(torch.from_numpy(xb).long(),
                                 torch.from_numpy(yb).long(),
                                 trainer.dropout_generator(0))
            out["loss"] = float(loss)
            out["grads"] = {n: p.grad.clone() for n, p in named}
            if fsdp or m.model > 1:
                out["full_grads"] = full(out["grads"])
            ttrain.optimizer_step(trainer.optimizer, trainer.lr_schedule, 0,
                                  trainer.cfg.grad_clip, trainer.grad_norm())
            out["params"] = {n: p.detach().clone() for n, p in named}
            out["moments"] = sum(
                v.numel() for st in trainer.optimizer.state.values()
                for k, v in st.items() if k in ("exp_avg", "exp_avg_sq"))
            if fsdp or m.model > 1:
                out["full"] = full(out["params"])
        torch.save(out, os.path.join(plan["out"],
                                     f"{leg['name']}_rank{rank}.pt"))
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
from nanosandbox_tpu.parallel import mesh as jmesh  # noqa: E402
from nanosandbox_tpu.parallel.sharding import param_shardings  # noqa: E402
from nanosandbox_tpu.train import (  # noqa: E402
    make_optimizer as jax_make_optimizer)
from nanosandbox_tpu_torch import config as tconfig  # noqa: E402
from nanosandbox_tpu_torch import train as ttrain  # noqa: E402
from nanosandbox_tpu_torch.checkpoint import TrainCheckpointer  # noqa: E402
from nanosandbox_tpu_torch.data.loader import BinDataset  # noqa: E402
from nanosandbox_tpu_torch.models.convert import (  # noqa: E402
    state_dict_from_jax_params)
from nanosandbox_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from nanosandbox_tpu_torch.parallel.sharding import fsdp_dim  # noqa: E402


def _start_ranks(P, argv):
    """Start P processes of ``argv`` as the ranks of one group (the
    COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID contract; P = 1: one
    process, no group), each writing to a temporary file; returns them
    for _wait_ranks."""
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    procs = []
    for rank in range(P):
        env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": REPO}
        if P > 1:
            env.update(COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                       NUM_PROCESSES=str(P), PROCESS_ID=str(rank))
        log = tempfile.TemporaryFile("w+")
        procs.append((subprocess.Popen(argv, cwd=REPO, env=env, text=True,
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


def _run_ranks(P, argv, timeout=120):
    """_start_ranks, then _wait_ranks."""
    return _wait_ranks(_start_ranks(P, argv), timeout)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def flax_path(name: str) -> str:
    """The flax leaf path of a port parameter name:
    ``h.0.attn.c_attn.weight`` -> ``h_0/attn/c_attn/kernel``."""
    parts = name.split(".")
    if parts[0] == "h":
        parts = [f"h_{parts[1]}", *parts[2:]]
    owner, leaf = parts[-2], parts[-1]
    if owner in ("wte", "wpe"):
        leaf = "embedding"
    elif owner.startswith("ln_"):
        leaf = "scale" if leaf == "weight" else leaf
    elif leaf == "weight":
        leaf = "kernel"
    return "/".join([*parts[:-1], leaf])


def _leaf(tree, path: str):
    for k in path.split("/"):
        tree = tree[k]
    return tree


@pytest.fixture(scope="module")
def dp_runs(char_dataset, tmp_path_factory):
    """JAX's weights and step on the global batch, the one-process port's
    steps, and every leg's rank outputs (two spawns)."""
    tmp = tmp_path_factory.mktemp("dp")
    base = tconfig.TrainConfig(data_dir=char_dataset,
                               out_dir=str(tmp / "out"), **TRAIN)
    jcfg = jconfig.GPTConfig(**DIMS, vocab_size=65, compute_dtype="float32",
                             attention_impl="xla")
    model = jgpt.GPT(jcfg)
    params = jax.device_get(jax.jit(model.init)(      # compiled: faster
        jax.random.key(5), jnp.zeros((1, 8), jnp.int32))["params"])
    mcfg = tconfig.GPTConfig(**DIMS, vocab_size=65, compute_dtype="float32")
    sd = state_dict_from_jax_params(params, mcfg)
    torch.save(sd, tmp / "init.pt")
    x, y = BinDataset(char_dataset, "shakespeare_char").sample_batch(
        "train", 0, base.batch_size, base.block_size, seed=base.seed)

    def jloss(p):
        hidden = model.apply({"params": p}, jnp.asarray(x),
                             return_hidden=True)
        return jgpt.chunked_cross_entropy_loss(
            hidden, p["wte"]["embedding"], jnp.asarray(y), chunk_size=16,
            compute_dtype="float32")

    jl, jg = jax.jit(jax.value_and_grad(jloss))(params)
    tx, _ = jax_make_optimizer(jconfig.TrainConfig(**{
        k: v for k, v in base.to_dict().items() if k != "device"}))
    updates, _ = tx.update(jg, tx.init(params), params)
    jax_ref = (float(jl), state_dict_from_jax_params(jax.device_get(jg),
                                                     mcfg),
               state_dict_from_jax_params(jax.device_get(
                   optax.apply_updates(params, updates)), mcfg))

    # The sp_tp leg's weights: the port's initialization at T 128.
    sd128 = ttrain.Trainer(base.replace(**SP_TP)).model.state_dict()
    torch.save(sd128, tmp / "init128.pt")

    def single(init=sd, **kw):
        trainer = ttrain.Trainer(base.replace(**kw))
        trainer.model.load_state_dict(init)
        xb, yb = trainer.dataset.sample_batch(
            "train", 0, base.batch_size, trainer.cfg.block_size,
            seed=base.seed)
        loss = trainer.grads(torch.from_numpy(xb).long(),
                             torch.from_numpy(yb).long(),
                             trainer.dropout_generator(0))
        grads = {n: p.grad.clone()
                 for n, p in trainer.model.named_parameters()}
        ttrain.optimizer_step(trainer.optimizer, trainer.lr_schedule, 0,
                              base.grad_clip)
        return float(loss), grads, trainer.model.state_dict()

    # The 4-rank spawn runs beside the CLI leg and then the 2-rank spawn,
    # which restores the CLI leg's checkpoint.
    ckpt_dir = str(tmp / "cli_fsdp")
    runs, started = {}, {}
    for n in (4, 2):
        legs = [{"name": name, "cfg": base.replace(**kw).to_dict()}
                for name, ranks, kw in LEGS if ranks == n]
        for leg in legs:
            if leg["name"] == "sp_tp":
                leg["init"] = str(tmp / "init128.pt")
        if n == 2:
            legs += [{"name": f"restore_{name}", "restore": ckpt_dir,
                      "cfg": base.replace(out_dir=ckpt_dir, **kw).to_dict()}
                     for name, kw in (("dp", dict(mesh_dp=2)),
                                      ("fsdp", dict(mesh_fsdp=2, mesh_dp=1,
                                                    shard_params=True)),
                                      ("tp", dict(mesh_tp=2, mesh_dp=1)))]
            legs.append({"name": "resume_dp2", "run": True, "cfg": _resume(
                base, ckpt_dir, str(tmp / "resume_dp2"), mesh_dp=2)})
            # The CLI's loop (Trainer.run) at mesh_tp 2: its checkpoint.
            legs.append({"name": "tp_run", "run": True, "cfg": base.replace(
                out_dir=str(tmp / "tp_run"), mesh_tp=2, mesh_dp=1,
                max_iters=2, run_name="r").to_dict()})
        with open(tmp / f"plan{n}.json", "w") as f:
            json.dump({"legs": legs, "init": str(tmp / "init.pt"),
                       "out": str(tmp)}, f)
        if n == 2:
            cli = _cli_run(char_dataset, ckpt_dir, 2, [
                "--mesh_fsdp=2", "--shard_params=True", "--max_iters=2"])
        started[n] = (legs, _start_ranks(
            n, [sys.executable, __file__, str(tmp / f"plan{n}.json")]))
    # The one-process references while the spawns run.
    singles = {"single": single(), "single_dropout": single(dropout=0.1),
               "single_sp_tp": single(sd128, **SP_TP)}
    for n, (legs, procs) in started.items():
        _wait_ranks(procs)
        for leg in legs:
            runs[leg["name"]] = [torch.load(tmp / f"{leg['name']}_rank{r}.pt")
                                 for r in range(n)]
    return {"params": params, "sd": sd, "jax": jax_ref, **singles,
            "runs": runs, "cli": cli, "ckpt_dir": ckpt_dir,
            "resume_dp2": str(tmp / "resume_dp2"), "base": base,
            "tp_run": str(tmp / "tp_run")}


def _resume(base, ckpt_dir: str, out: str, **kw) -> dict:
    """The config of a run that resumes the CLI run's checkpoint in its
    own out_dir (the checkpoint linked in) and takes one more step."""
    os.makedirs(os.path.join(out, "ckpt"))
    os.symlink(os.path.join(ckpt_dir, "ckpt", "2"),
               os.path.join(out, "ckpt", "2"))
    return base.replace(out_dir=out, init_from="resume", max_iters=3,
                        run_name="r", **kw).to_dict()


def _resumed_losses(out: str) -> list:
    with open(os.path.join(out, "runs", "r", "metrics.jsonl")) as f:
        return [json.loads(line)["train/loss"] for line in f
                if "train/loss" in line]


def _cli_run(data_dir, out, n, flags):
    argv = [sys.executable, "-m", "nanosandbox_tpu_torch.train",
            f"--data_dir={data_dir}", f"--out_dir={out}", "--device=cpu",
            "--n_layer=2", "--n_head=2", "--n_embd=64", "--block_size=64",
            "--batch_size=4", "--compute_dtype=float32", "--vocab_size=65",
            "--eval_interval=0", "--eval_iters=1", "--log_interval=1",
            "--tensorboard=False", "--run_name=r", "--warmup_iters=0",
            "--lr_decay_iters=3", *flags]
    return _run_ranks(n, argv)


def _check(got, ref, name, params=True):
    rl, rg, rp = ref
    assert abs(got["loss"] - rl) <= 1e-5, (name, got["loss"], rl)
    for n, g in got["grads"].items():
        np.testing.assert_allclose(g.numpy(), rg[n].numpy(), atol=1e-4,
                                   err_msg=f"{name}: grad {n}")
    if params:
        for n, p in got["params"].items():
            np.testing.assert_allclose(p.numpy(), rp[n].numpy(), atol=1e-4,
                                       err_msg=f"{name}: param {n}")


@pytest.mark.parametrize("leg", ["dp", "dp_sp", "dropout"])
def test_dp_step_matches_jax_and_one_process(dp_runs, leg):
    ranks = dp_runs["runs"][leg]
    for other in ranks[1:]:               # every rank steps the same
        assert other["loss"] == ranks[0]["loss"]
        for n, t in ranks[0]["params"].items():
            assert torch.equal(other["params"][n], t), (leg, n)
    refs = {"one-process port": dp_runs["single_dropout" if leg == "dropout"
                                        else "single"]}
    if leg != "dropout":
        refs["JAX"] = dp_runs["jax"]
    for name, ref in refs.items():
        _check(ranks[0], ref, f"{leg} vs {name}")


# (leg, the ranks at fsdp index 0 and 1 with seq index 0): rank r sits
# at (data, fsdp, seq) row-major.
@pytest.mark.parametrize("leg,at", [("fsdp", (0, 1)), ("fsdp_sp", (0, 2))])
def test_fsdp_step_holds_shards_equal_to_jax(dp_runs, leg, at):
    ranks = [dp_runs["runs"][leg][r] for r in at]
    sd, params = dp_runs["sd"], dp_runs["params"]
    jax_mesh = jmesh.make_mesh(mesh_dp=1, mesh_fsdp=2,
                               devices=jax.devices()[:2])
    shardings = param_shardings(jax_mesh, params, shard_params=True)
    total = sum(t.numel() for t in sd.values())
    for r, got in enumerate(ranks):
        assert got["held"] == []          # the modules hold no parameter
        held = sum(p.numel() for p in got["params"].values())
        replicated = [n for n in sd if fsdp_dim(n, tuple(sd[n].shape), 2)
                      is None]
        assert replicated == ["wte.weight"]      # 65 rows: ragged
        assert held == (total + sd["wte.weight"].numel()) // 2
        assert got["moments"] == 2 * held
        device = jax_mesh.devices[0, r, 0, 0]
        for n, full in sd.items():
            path = flax_path(n)
            leaf = np.asarray(_leaf(params, path))
            idx = _leaf(shardings, path).devices_indices_map(
                leaf.shape)[device]
            want = leaf[idx]
            if full.dim() == 2 and n not in ("wte.weight", "wpe.weight"):
                want = want.T
            # The initial shard is JAX's slice, element for element.
            dim = fsdp_dim(n, tuple(full.shape), 2)
            shard0 = (full if dim is None else full.narrow(
                dim, r * full.shape[dim] // 2, full.shape[dim] // 2))
            np.testing.assert_array_equal(shard0.numpy(), want, err_msg=n)
            assert got["params"][n].shape == shard0.shape, n
            # The gathered shards are the full parameter.
            if dim is not None:
                np.testing.assert_array_equal(
                    torch.cat([ranks[k]["params"][n] for k in range(2)],
                              dim).numpy(), got["full"][n].numpy())
    got = dict(ranks[0], grads=ranks[0]["full_grads"],
               params=ranks[0]["full"])
    for name in ("single", "jax"):
        _check(got, dp_runs[name], f"{leg} vs {name}")


def test_fsdp_cli_checkpoint_resumes_anywhere(dp_runs, tmp_path):
    """The mesh_fsdp 2 CLI run's one checkpoint (rank 0, one process's
    format) loads bit for bit into one process, mesh_dp 2 and mesh_fsdp 2,
    and resumes at mesh_dp 2 and at one process with the same step."""
    ckpt_dir, base = dp_runs["ckpt_dir"], dp_runs["base"]
    assert sorted(os.listdir(os.path.join(ckpt_dir, "ckpt"))) == ["2"]
    assert "iter 1: loss" in dp_runs["cli"][0]
    assert "iter 1: loss" not in dp_runs["cli"][1]
    blob = TrainCheckpointer(ckpt_dir).restore()
    one = ttrain.Trainer(base.replace(out_dir=ckpt_dir))
    assert list(blob["model"]) == list(one.model.state_dict())
    one.restore(TrainCheckpointer(ckpt_dir))
    for n, t in one.model.state_dict().items():
        assert torch.equal(t, blob["model"][n]), n
    state = one.optimizer.state_dict()["state"]
    for i, st in blob["optimizer"]["state"].items():
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(state[i][k], st[k]), (i, k)
    for r, got in enumerate(dp_runs["runs"]["restore_dp"]):
        for n, t in got["params"].items():
            assert torch.equal(t, blob["model"][n]), (r, n)
    for r, got in enumerate(dp_runs["runs"]["restore_fsdp"]):
        for n, t in got["params"].items():
            full = blob["model"][n]
            dim = fsdp_dim(n, tuple(full.shape), 2)
            want = (full if dim is None else full.narrow(
                dim, r * full.shape[dim] // 2, full.shape[dim] // 2))
            assert torch.equal(t, want), (r, n)

    # The next step, resumed at mesh_dp 2 (in the 2-rank spawn) and at
    # one process, through the CLI's loop.
    one = str(tmp_path / "resume_one")
    ttrain.Trainer(tconfig.TrainConfig(**_resume(base, ckpt_dir,
                                                 one))).run()
    resumed = {"dp2": _resumed_losses(dp_runs["resume_dp2"]),
               "one": _resumed_losses(one)}
    assert len(resumed["one"]) == 1 == len(resumed["dp2"]), resumed
    assert abs(resumed["dp2"][0] - resumed["one"][0]) <= 1e-5, resumed
    assert sorted(os.listdir(os.path.join(one, "ckpt"))) == ["2", "3"]


@pytest.mark.parametrize("leg", ["tp", "dp_tp", "fsdp_tp", "sp_tp"])
def test_tp_step_matches_jax_and_one_process(dp_runs, leg):
    """The model axis, alone and beside each other axis: every rank's
    loss the same, and the shards gathered (gradients and updated
    parameters) within the file's limits of JAX's step and of the
    one-process port's; the dropout leg of the one-process port's."""
    ranks = dp_runs["runs"][leg]
    for other in ranks[1:]:
        assert other["loss"] == ranks[0]["loss"]
    got = dict(ranks[0], grads=ranks[0]["full_grads"],
               params=ranks[0]["full"])
    refs = {"one-process port": dp_runs["single_sp_tp" if leg == "sp_tp"
                                        else "single"]}
    if leg != "sp_tp":
        refs["JAX"] = dp_runs["jax"]
    for name, ref in refs.items():
        _check(got, ref, f"{leg} vs {name}")


def test_tp_shards_are_megatron_slices(dp_runs):
    """At mesh_tp 2 rank r holds model shard r: c_fc and c_proj are the
    elements of JAX's param_shardings slice over model, c_attn the rows
    of heads [r H/2, (r+1) H/2) of each of q, k and v (ROADMAP C5), the
    rest whole; the shards gathered are the full parameters, and so are
    a CLI checkpoint's restored at mesh_tp 2."""
    from nanosandbox_tpu_torch.parallel.tensor import unshard_param

    sd, params = dp_runs["sd"], dp_runs["params"]
    ranks = dp_runs["runs"]["tp"]
    jax_mesh = jmesh.make_mesh(mesh_dp=1, mesh_tp=2,
                               devices=jax.devices()[:2])
    shardings = param_shardings(jax_mesh, params, tp=True)
    C = DIMS["n_embd"]
    blob = TrainCheckpointer(dp_runs["ckpt_dir"]).restore()["model"]
    for r in range(2):
        restored = dp_runs["runs"]["restore_tp"][r]["params"]
        for n, full in sd.items():
            if n.endswith("c_attn.weight"):
                want = torch.cat([full[j * C + r * C // 2:
                                       j * C + (r + 1) * C // 2]
                                  for j in range(3)])
            elif n.endswith(("c_fc.weight", "c_proj.weight")):
                path = flax_path(n)
                leaf = np.asarray(_leaf(params, path))
                idx = _leaf(shardings, path).devices_indices_map(
                    leaf.shape)[jax_mesh.devices[0, 0, 0, r]]
                want = torch.from_numpy(np.ascontiguousarray(leaf[idx].T))
            elif n.endswith(("c_attn.bias", "c_fc.bias")):
                k = full.shape[0] // (3 if "c_attn" in n else 1)
                want = torch.cat([full[j * k + r * k // 2:
                                       j * k + (r + 1) * k // 2]
                                  for j in range(full.shape[0] // k)])
            else:
                want = full
            assert ranks[r]["params"][n].shape == want.shape, n
            torch.testing.assert_close(
                tshard(n, full, r), want, rtol=0, atol=0, msg=n)
            torch.testing.assert_close(
                restored[n], tshard(n, blob[n], r), rtol=0, atol=0, msg=n)
    for n, t in ranks[0]["full"].items():
        assert torch.equal(unshard_param(
            n, [ranks[r]["params"][n] for r in range(2)]), t), n
    assert ranks[0]["moments"] == 2 * sum(
        p.numel() for p in ranks[0]["params"].values())


def tshard(name, full, r):
    from nanosandbox_tpu_torch.parallel.tensor import shard_param

    return shard_param(name, full, 2, r)


def test_tp_checkpoint_loads_in_one_process(dp_runs):
    """The mesh_tp 2 run's one checkpoint (rank 0, one process's format)
    holds the ranks' shards gathered, and loads bit for bit into one
    process, parameters and moments."""
    out, base = dp_runs["tp_run"], dp_runs["base"]
    assert sorted(os.listdir(os.path.join(out, "ckpt"))) == ["2"]
    blob = TrainCheckpointer(out).restore()
    for n, t in dp_runs["runs"]["tp_run"][0]["full"].items():
        assert torch.equal(blob["model"][n], t), n
    one = ttrain.Trainer(base.replace(out_dir=out))
    assert list(blob["model"]) == list(one.model.state_dict())
    one.restore(TrainCheckpointer(out))
    for n, t in one.model.state_dict().items():
        assert torch.equal(t, blob["model"][n]), n
    state = one.optimizer.state_dict()["state"]
    for i, st in blob["optimizer"]["state"].items():
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(state[i][k], st[k]), (i, k)
    assert blob["config"]["mesh_tp"] == 2


@pytest.mark.parametrize("args,n", [
    ((-1, 1, 1, 1), 8), ((-1, 2, 1, 1), 8), ((-1, 1, 1, 2), 8),
    ((2, 2, 1, 2), 8), ((-1, 2, 1, 2), 8), ((-1, 1, 1, 1), 6)])
@pytest.mark.parametrize("slices", [2, -1])
def test_hybrid_mesh_layout_matches_jax(args, n, slices):
    devices = jax.devices()[:n]
    ids = np.vectorize(lambda d: d.id)
    jax_layout = ids(jmesh.make_hybrid_mesh(*args, num_slices=slices,
                                            devices=devices).devices)
    np.testing.assert_array_equal(
        tmesh.hybrid_layout(*args, num_slices=slices, world_size=n),
        jax_layout)
    np.testing.assert_array_equal(
        tmesh.mesh_layout(*args, world_size=n),
        ids(jmesh.make_mesh(*args, devices=devices).devices))


@pytest.mark.parametrize("args,kw", [
    ((-1, 0, 1, 1), dict(num_slices=2)),
    ((-1, 1, 1, 1), dict(num_slices=3)),
    ((-1, 4, 1, 1), dict(num_slices=4)),
    ((3, 1, 1, 1), dict(num_slices=2)),
    ((-1, 1, 1, 1), dict(num_slices=-1, ids=[0, 0, 1, 1, 1, 2, 2, 2]))])
def test_hybrid_mesh_errors_match_jax(args, kw):
    """The ValueErrors of make_hybrid_mesh, message for message; slice
    ids stand in for the devices' slice_index."""
    ids = kw.pop("ids", None)

    class Dev:
        def __init__(self, i, s):
            self.id, self.slice_index = i, s

    devices = (jax.devices()[:8] if ids is None
               else [Dev(i, s) for i, s in enumerate(ids)])
    with pytest.raises(ValueError) as want:
        jmesh.make_hybrid_mesh(*args, devices=devices, **kw)
    with pytest.raises(ValueError) as got:
        tmesh.hybrid_layout(*args, world_size=8, slice_ids=ids, **kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("override,shape,match", [
    (dict(batch_size=6), dict(data=4, fsdp=1, seq=1), "data\\*fsdp"),
    (dict(batch_size=4), dict(data=2, fsdp=4, seq=1), "data\\*fsdp"),
    (dict(batch_size=4, block_size=60), dict(data=1, fsdp=1, seq=8),
     "seq mesh axis")])
def test_batch_checks_against_the_mesh(override, shape, match):
    """The JAX trainer's batch ValueErrors for a resolved mesh."""
    with pytest.raises(ValueError, match=match):
        tconfig.check_mesh(tconfig.TrainConfig(**override),
                           {**shape, "model": 1})
    tconfig.check_mesh(tconfig.TrainConfig(batch_size=8),
                       {**shape, "model": 1, "seq": 1})
