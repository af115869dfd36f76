"""Dropout under sequence parallelism, with and without remat, on the CPU.

Two gloo processes (this file run as a script, one process a rank) take
one gradient step of a tiny fp32 GPT at mesh_sp 2, in the zigzag and in
the contiguous layout, with dropout 0.1: without remat, and with remat
under 'save_attention' and 'full'. Every rank draws the step's global
(B, T, C) residual masks from the shared (seed + 7, iter) generator and
keeps its own positions' rows, so its masks are one process's and the
per-layer attention seeds stay shared. The loss must be within 1e-5 and
every gradient (summed over the ranks) within 1e-4 of the same step by
one process (the limits of tests/test_torch_ring_attention.py), and both
ranks must hold the same gradients bit for bit. Under 'full' the ring's
K/V rotation runs again inside the backward, on every rank in the same
order. T is 128, where one process's attention-dropout hash length (T
padded to 128) is the ring's (the global T).
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# T a multiple of 128: one process's attention-dropout hash runs over T
# padded to 128 and the ring's over the global T, as in the JAX package,
# so only there do both drop the same scores.
DIMS = dict(n_layer=2, n_head=2, n_embd=64, block_size=128)
TRAIN = dict(vocab_size=65, batch_size=2, learning_rate=1e-3, warmup_iters=0,
             max_iters=10, lr_decay_iters=10, min_lr=1e-4,
             loss_chunk_size=16, compute_dtype="float32", seed=5,
             dropout=0.1, tensorboard=False)
# (remat, policy) of each variant a rank runs, in order.
VARIANTS = ((False, "save_attention"), (True, "save_attention"),
            (True, "full"))
LAYOUTS = ("zigzag", "contiguous")


def _step(cfg):
    """(loss, {name: grad}) of step 0 of ``cfg``'s trainer: its first
    batch, its step-0 dropout generator."""
    from nanosandbox_tpu_torch import train as ttrain

    trainer = ttrain.Trainer(cfg)
    xb, yb = next(trainer.make_loader("train", prefetch=False))
    loss = trainer.grads(torch.from_numpy(xb).long(),
                         torch.from_numpy(yb).long(),
                         trainer.dropout_generator(0))
    return float(loss), {n: p.grad.clone()
                         for n, p in trainer.model.named_parameters()}


def _worker(cfg_path: str, out_dir: str) -> None:
    from nanosandbox_tpu_torch.config import TrainConfig
    from nanosandbox_tpu_torch.parallel import distributed

    with open(cfg_path) as f:
        cfg = TrainConfig(**json.load(f))
    out = {}
    for remat, policy in VARIANTS:
        out[f"{remat}-{policy}"] = _step(cfg.replace(remat=remat,
                                                     remat_policy=policy))
    rank = int(os.environ["PROCESS_ID"])
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    distributed.shutdown()


if __name__ == "__main__":
    torch.set_num_threads(1)
    _worker(*sys.argv[1:])
    sys.exit(0)


from nanosandbox_tpu_torch.config import TrainConfig  # noqa: E402


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_groups(P, argvs, timeout=180):
    """Run P ranks of each argv, every group at once, each on a port of
    its own."""
    procs = []
    for argv in argvs:
        port = _free_port()
        for rank in range(P):
            env = {**os.environ, "COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
                   "NUM_PROCESSES": str(P), "PROCESS_ID": str(rank),
                   "OMP_NUM_THREADS": "1", "PYTHONPATH": REPO}
            procs.append(subprocess.Popen(argv, cwd=REPO, env=env, text=True,
                                          stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT))
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, (f"rank {i % P} of {argvs[i // P]}:\n"
                                   f"{out[-4000:]}")


@pytest.fixture(scope="module")
def runs(char_dataset, tmp_path_factory):
    """{layout: (rank 0's results, rank 1's)} and one process's step."""
    base = TrainConfig(**DIMS, **TRAIN, data_dir=char_dataset,
                       dataset="shakespeare_char", device="cpu",
                       attention_impl="ring")
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        single = _step(base.replace(mesh_sp=1))
    finally:
        torch.set_num_threads(n)
    tmps = {}
    for layout in LAYOUTS:
        tmps[layout] = tmp = tmp_path_factory.mktemp(f"sp_{layout}")
        with open(tmp / "cfg.json", "w") as f:
            json.dump(base.replace(mesh_sp=2, ring_layout=layout).to_dict(),
                      f)
    _run_groups(2, [[sys.executable, __file__, str(tmp / "cfg.json"),
                     str(tmp)] for tmp in tmps.values()])
    out = {layout: [torch.load(tmp / f"rank{r}.pt") for r in range(2)]
           for layout, tmp in tmps.items()}
    return out, single


@pytest.mark.parametrize("variant", [f"{r}-{p}" for r, p in VARIANTS])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_sp_dropout_matches_one_process(runs, layout, variant):
    ranks, (ref_loss, ref) = runs
    (loss, grads), (loss1, grads1) = (r[variant] for r in ranks[layout])
    assert loss == loss1
    assert abs(loss - ref_loss) <= 1e-5, (loss, ref_loss)
    for name, g in ref.items():
        assert torch.equal(grads[name], grads1[name]), name
        np.testing.assert_allclose(grads[name].numpy(), g.numpy(),
                                   atol=1e-4, err_msg=name)
