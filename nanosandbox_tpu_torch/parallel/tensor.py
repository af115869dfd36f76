"""Tensor parallelism over the mesh's model axis (Megatron).

The JAX package places the weights on the ``model`` axis
(parallel/sharding.py _tp_dim) and lets GSPMD insert the collectives;
the port has no partitioner, so the model runs at local width on each
rank (models/gpt.py) and this module holds what GSPMD would add:

  * ``copy_to_model``: identity forward, all-reduce backward, at the
    input of a column-parallel projection (c_attn, c_fc): every rank
    reads the whole replicated activation, and the gradient that flows
    back into it is the sum of every rank's heads' or hidden units';
  * ``reduce_from_model``: all-reduce forward, identity backward, at the
    output of a row-parallel projection (c_proj): each rank's partial
    product over its heads or hidden units is summed, and the bias is
    added once, after the sum (models/gpt.py).

Both exchange over ``mesh.model_group`` and count in
parallel/distributed.py ``exchanged`` under "tp".

The layout of a rank's shard (``shard_param``): c_fc and c_proj are
JAX's slices over model exactly (c_fc's rows, the outputs, and c_proj's
columns, the inputs, contiguous). c_attn is not: JAX's
P(None, "model") splits its 3C outputs contiguously, so at tp 2 its
shard 0 holds all of q and half of k, and XLA reshards that to heads.
Here shard i holds the rows of heads [i H/tp, (i+1) H/tp) of each of q,
k and v, so that its q, k and v are its own heads' (a divergence by
design, ROADMAP C5). The column-parallel biases split with their
columns; c_proj's bias, the embeddings and the LayerNorms are whole on
every rank. ``shard_state_dict`` and ``gather_state_dict`` carry full
weights (models/convert.py, a checkpoint, HF GPT-2) to a shard and back.
"""

from __future__ import annotations

import torch

from nanosandbox_tpu_torch.parallel import distributed
from nanosandbox_tpu_torch.parallel.sharding import tp_dim


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        distributed.all_reduce_sum_(g, ctx.group, kind="tp")
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        distributed.all_reduce_sum_(x, group, kind="tp")
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """x forward; its gradient summed over the model group backward."""
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """x summed over the model group forward; the gradient as it is
    backward."""
    return _ReduceFromModel.apply(x, group)


# ---------------------------------------------------------------------------
# Full weights <-> a rank's shard
# ---------------------------------------------------------------------------

def full_shapes(cfg) -> dict:
    """{name: full shape} of a GPT of ``cfg`` (no memory is allocated)."""
    from nanosandbox_tpu_torch.models.gpt import GPT

    return {n: tuple(p.shape)
            for n, p in GPT(cfg, device="meta").named_parameters()}


def _heads_aligned(name: str) -> bool:
    return name.endswith(("c_attn.weight", "c_attn.bias"))


def shard_param(name: str, full: torch.Tensor, tp: int,
                index: int) -> torch.Tensor:
    """Shard ``index`` of ``tp`` of the full parameter ``name`` (module
    docstring): a view where the layout allows, c_attn's a copy."""
    dim = tp_dim(name, tuple(full.shape), tp)
    if dim is None:
        return full
    if _heads_aligned(name):
        return full.unflatten(0, (3, tp, -1))[:, index].flatten(0, 1)
    n = full.shape[dim] // tp
    return full.narrow(dim, index * n, n)


def unshard_param(name: str, shards: list) -> torch.Tensor:
    """The full parameter ``name`` from its shards in model order (the
    inverse of shard_param)."""
    tp = len(shards)
    dim = tp_dim(name, tuple(shards[0].shape), tp)
    if dim is None:
        return shards[0]
    if _heads_aligned(name):
        return torch.stack([s.unflatten(0, (3, -1)) for s in shards],
                           dim=1).flatten(0, 2)
    return torch.cat(shards, dim=dim)


def shard_state_dict(sd: dict, tp: int, index: int) -> dict:
    """{name: shard ``index`` of ``tp``} of a full state_dict (views and
    copies of its tensors: clone before writing into one)."""
    return {n: shard_param(n, t, tp, index) for n, t in sd.items()}


def gather_param(name: str, t: torch.Tensor, tp: int,
                 group) -> torch.Tensor:
    """The full parameter from every model rank's shard ``t`` (every rank
    of the model group must call it); t itself when replicated."""
    if tp_dim(name, tuple(t.shape), tp) is None:
        return t.detach().clone()
    flat = distributed.all_gather(t.detach().reshape(-1), group)
    return unshard_param(name, [s.view(t.shape)
                                for s in flat.view(tp, -1)])


def gather_state_dict(sd: dict, tp: int, group) -> dict:
    """{name: full tensor} from this rank's shard state_dict; every rank
    of the model group must call it, in one order."""
    return {n: gather_param(n, t, tp, group) for n, t in sd.items()}


def grad_norm(named_params, tp: int, group) -> torch.Tensor:
    """The global L2 norm of the full gradients from a rank's shards: the
    model shards' squared sums summed over the model group, the
    parameters whole on every model rank (equal gradients there) counted
    once. Every rank of the model group must call it."""
    split, whole = [], []
    for n, p in named_params:
        if p.grad is not None:
            (split if tp_dim(n, tuple(p.shape), tp) is not None
             else whole).append(p.grad.float().square().sum())
    total = torch.stack(split).sum()
    distributed.all_reduce_sum_(total.view(1), group, kind="tp")
    return (total + torch.stack(whole).sum()).sqrt()
