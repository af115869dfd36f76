"""Parameter placement over the model and fsdp axes, and the FSDP wrapper.

The placements are nanosandbox_tpu/parallel/sharding.py spec_for_param's,
model axis first. ``tp_dim`` is its Megatron rule (_tp_dim):
column-parallel c_attn and c_fc split their outputs, row-parallel c_proj
its inputs, wte (the tied head) and everything else stay whole. The
model axis always splits by heads here (parallel/tensor.py), so the
column-parallel biases split with their columns, where JAX keeps them
replicated over model and lets GSPMD slice them. ``fsdp_dim`` is the
fsdp rule: shard the largest dim that the fsdp size divides and the
model axis did not take, the embedding tables (wte, wpe) only along
their row dim, and replicate a parameter with no such dim (tiny models).
The rules run on the flax leaf's full shape: nn.Linear stores (out, in)
where flax Dense stores (in, out), so both map the dim through the
transpose, and the rank at fsdp index j holds the elements of JAX's j-th
shard of that leaf (of its model shard, under tensor parallelism).

``FSDP`` holds a GPT's parameters as such shards, and the model runs on
them (models/gpt.py ``gathered``):

  * each rank keeps its shard of every parameter (replicated ones whole)
    as the optimizer's parameters, so AdamW's two moments are shards too;
  * each part of the forward gathers its full weights over the fsdp
    group just before it runs and drops them after: the embeddings, each
    block, the final LayerNorm, the tied head. A training block runs
    under remat (models/gpt.py _RematBlock), so its backward gathers the
    block's weights again in the recompute instead of keeping them;
  * the gather is an autograd Function whose backward reduce-scatters
    the full weights' gradients over the fsdp group as soon as the
    block's backward has made them, so each rank receives its shard's
    sum over the fsdp ranks (``_Gather``);
  * ``reduce_grads`` then sums the shards' gradients over the ranks that
    hold the same shard (data x seq) and the replicated parameters' over
    every rank of the step; ``grad_norm`` is the global norm over all
    shards.

Between blocks a rank holds its shards and, while the loss runs, the
full tied embedding and final LayerNorm. Checkpoints hold full tensors
(``full_state_dict``, ``full_optimizer_state``), the one-file format of
one process, and load back into any mesh (``load_full``,
``load_optimizer``).
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn

from nanosandbox_tpu_torch.parallel import distributed

EMBEDDINGS = ("wte.weight", "wpe.weight")
# Column-parallel parameters: split along their output dim (dim 0 here).
TP_COLUMNS = ("c_attn.weight", "c_attn.bias", "c_fc.weight", "c_fc.bias")


def tp_dim(name: str, shape: tuple, tp: int) -> int | None:
    """The dim of parameter ``name`` (the port's orientation, full shape)
    that a model axis of ``tp`` ranks splits, or None: replicated over
    model (module docstring)."""
    if tp <= 1:
        return None
    if name.endswith(TP_COLUMNS):
        return 0
    if name.endswith("c_proj.weight") and len(shape) == 2:
        return 1
    return None


def fsdp_dim(name: str, shape: tuple, fsdp: int, tp: int = 1) -> int | None:
    """The dim of parameter ``name`` (the port's orientation, full shape)
    that an fsdp axis of ``fsdp`` ranks shards, or None: replicated. Under
    a model axis of ``tp`` ranks the dim tp_dim took is not a candidate,
    and the shard is taken of the rank's model shard along this dim."""
    if fsdp <= 1:
        return None
    embedding = name in EMBEDDINGS
    transposed = len(shape) == 2 and not embedding
    flax_shape = tuple(reversed(shape)) if transposed else tuple(shape)
    taken = tp_dim(name, shape, tp)
    if taken is not None and transposed:
        taken = len(shape) - 1 - taken
    allowed = (0,) if embedding else range(len(flax_shape))
    candidates = sorted(
        (i for i in allowed if i != taken
         and flax_shape[i] % fsdp == 0 and flax_shape[i] >= fsdp),
        key=lambda i: flax_shape[i], reverse=True)
    if not candidates:
        return None
    return len(shape) - 1 - candidates[0] if transposed else candidates[0]


class _Gather(torch.autograd.Function):
    """Shards in, full tensors out (an all-gather over the fsdp group);
    the backward reduce-scatters the full tensors' gradients into the
    shards' (module docstring)."""

    @staticmethod
    def forward(ctx, fsdp, names, *shards):
        ctx.fsdp, ctx.names = fsdp, names
        return fsdp._all_gather(names, shards)

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, *ctx.fsdp._reduce_scatter(ctx.names, grads))


class FSDP:
    """A GPT's parameters as fsdp shards (module docstring). The model's
    parameters leave its modules: ``parameters()`` are the shards, and
    ``gathered`` installs full tensors for the span of a context. The
    full parameters come from ``state_dict`` (CPU tensors, each rank
    slicing its shard: sharded on arrival), else from GPT-2's
    initialization drawn from ``generator`` one full parameter at a time,
    in the order one process draws them."""

    def __init__(self, model: nn.Module, mesh, *, device,
                 generator: torch.Generator | None = None,
                 state_dict: dict | None = None):
        from nanosandbox_tpu_torch.models.gpt import init_param
        from nanosandbox_tpu_torch.parallel.tensor import full_shapes

        if generator is None and state_dict is None:
            raise ValueError("FSDP needs a generator or a state_dict")
        self.mesh = mesh
        self.size, self.index = mesh.fsdp, mesh.fsdp_index
        self.tp = mesh.model
        self.names: list[str] = []
        self.dims: dict[str, int | None] = {}
        self.shapes: dict[str, tuple] = {}
        self.shards: dict[str, nn.Parameter] = {}
        self._slots = {}
        modules = dict(model.named_modules())
        fulls = full_shapes(model.cfg)
        for name, p in list(model.named_parameters()):
            if state_dict is not None:
                full = state_dict[name]
            else:
                full = torch.empty(fulls[name], dtype=p.dtype, device=device)
                init_param(name, full, generator, model.cfg.n_layer)
            dim = fsdp_dim(name, fulls[name], self.size, self.tp)
            self.names.append(name)
            self.dims[name], self.shapes[name] = dim, tuple(p.shape)
            shard = self._shard(name, full).to(device=device, dtype=p.dtype)
            self.shards[name] = nn.Parameter(shard.clone().contiguous())
            owner, _, leaf = name.rpartition(".")
            module = modules[owner]
            del module._parameters[leaf]
            module.__dict__[leaf] = None
            self._slots[name] = (module, leaf)
        model.fsdp = self

    # -- layout -------------------------------------------------------------

    def _shard(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's shard of the full tensor of parameter ``name``: of
        its model shard (parallel/tensor.py), the fsdp slice (the model
        shard itself when replicated over fsdp)."""
        from nanosandbox_tpu_torch.parallel.tensor import shard_param

        local = shard_param(name, full, self.tp, self.mesh.model_index)
        dim = self.dims[name]
        if dim is None:
            return local
        n = local.shape[dim] // self.size
        return local.narrow(dim, self.index * n, n)

    def parameters(self) -> list[nn.Parameter]:
        return [self.shards[n] for n in self.names]

    def named_parameters(self):
        return [(n, self.shards[n]) for n in self.names]

    @property
    def replicated(self) -> list[str]:
        """The parameters no dim of which the fsdp size divides."""
        return [n for n in self.names if self.dims[n] is None]

    def shard_bytes(self) -> int:
        return sum(p.numel() * p.element_size() for p in self.parameters())

    def full_bytes(self) -> int:
        return sum(p.element_size() * int(torch.Size(self.shapes[n]).numel())
                   for n, p in self.named_parameters())

    # -- the gather and its backward ----------------------------------------

    def _all_gather(self, names, shards) -> tuple:
        flat = torch.cat([s.detach().reshape(-1) for s in shards])
        out = distributed.all_gather(flat, self.mesh.fsdp_group).view(
            self.size, -1)
        fulls, off = [], 0
        for name, s in zip(names, shards):
            k = s.numel()
            fulls.append(torch.cat([out[j, off:off + k].view(s.shape)
                                    for j in range(self.size)],
                                   dim=self.dims[name]))
            off += k
        return tuple(fulls)

    def _reduce_scatter(self, names, grads) -> tuple:
        pieces = []
        for j in range(self.size):
            for name, g in zip(names, grads):
                if g is None:
                    g = self.shards[name].new_zeros(self.shapes[name])
                n = self.shapes[name][self.dims[name]] // self.size
                pieces.append(g.narrow(self.dims[name], j * n, n)
                              .reshape(-1))
        out = distributed.reduce_scatter(torch.cat(pieces),
                                         self.mesh.fsdp_group)
        grads, off = [], 0
        for name in names:
            s = self.shards[name]
            grads.append(out[off:off + s.numel()].view(s.shape))
            off += s.numel()
        return tuple(grads)

    def _install(self, name: str, t) -> None:
        module, leaf = self._slots[name]
        module.__dict__[leaf] = t

    @contextlib.contextmanager
    def gathered(self, *prefixes: str):
        """The parameters named from ``prefixes`` whole on their modules
        for the span of the context: gathered (differentiably) when
        sharded, the replicated Parameter itself otherwise."""
        names = [n for n in self.names if n.startswith(prefixes)]
        sharded = tuple(n for n in names if self.dims[n] is not None)
        full = {}
        if sharded:
            full = dict(zip(sharded, _Gather.apply(
                self, sharded, *(self.shards[n] for n in sharded))))
        for n in names:
            self._install(n, full.get(n, self.shards[n]))
        try:
            yield
        finally:
            for n in names:
                self._install(n, None)

    # -- after the backward -------------------------------------------------

    def reduce_grads(self) -> None:
        """Sum the shards' gradients over the ranks that hold the same
        shards (data x seq), the replicated parameters' over every rank
        of the step (module docstring)."""
        m = self.mesh
        sharded = [self.shards[n] for n in self.names
                   if self.dims[n] is not None]
        if m.shape["data"] * m.seq > 1:
            distributed.all_reduce_grads_(sharded, m.replica_group)
        replicated = [self.shards[n] for n in self.replicated]
        if replicated:
            distributed.all_reduce_grads_(replicated, m.group)

    def grad_norm(self) -> torch.Tensor:
        """The global L2 norm of the full gradients: each parameter's
        squared sum summed over the ranks that hold its other elements,
        the fsdp group for an fsdp shard, then the model group for a
        model shard; a parameter whole on both axes counted once."""
        def sq(keep):
            g = [self.shards[n].grad.float().square().sum()
                 for n in self.names if keep(n)
                 and self.shards[n].grad is not None]
            return torch.stack(g).sum() if g else torch.zeros(
                (), device=self.shards[self.names[0]].device)

        def split(n):
            return tp_dim(n, self.shapes[n], self.tp) is not None

        fsdp = torch.stack([
            sq(lambda n: self.dims[n] is not None and not split(n)),
            sq(lambda n: self.dims[n] is not None and split(n))])
        distributed.all_reduce_sum_(fsdp, self.mesh.fsdp_group)
        model = fsdp[1] + sq(lambda n: self.dims[n] is None and split(n))
        if self.tp > 1:
            distributed.all_reduce_sum_(model.view(1), self.mesh.model_group,
                                        kind="tp")
        whole = sq(lambda n: self.dims[n] is None and not split(n))
        return (fsdp[0] + whole + model).sqrt()

    # -- checkpoints --------------------------------------------------------

    def _full(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The full tensor of a shard-shaped tensor of parameter name:
        gathered over the fsdp group, then over the model group."""
        from nanosandbox_tpu_torch.parallel.tensor import gather_param

        local = (t.detach().clone() if self.dims[name] is None
                 else self._all_gather((name,), (t,))[0])
        if self.tp == 1:
            return local
        return gather_param(name, local, self.tp, self.mesh.model_group)

    @torch.no_grad()
    def full_state_dict(self) -> dict:
        """{name: full parameter}, in the model's state_dict order; every
        rank of the fsdp group and of the model group must call it."""
        return {n: self._full(n, self.shards[n]) for n in self.names}

    @torch.no_grad()
    def full_optimizer_state(self, optimizer) -> dict:
        """The optimizer's state_dict with every moment made full: what
        one process's optimizer over the full parameters holds. Every
        rank of the fsdp group and of the model group must call it."""
        osd = optimizer.state_dict()
        order = self._optimizer_names(optimizer)
        state = {}
        for i, st in osd["state"].items():
            state[i] = {k: (self._full(order[i], v) if k in (
                "exp_avg", "exp_avg_sq") else v) for k, v in st.items()}
        return {"state": state, "param_groups": osd["param_groups"]}

    @torch.no_grad()
    def load_full(self, state_dict: dict) -> None:
        """Copy each full parameter's shard into this rank's shard."""
        for n in self.names:
            self.shards[n].copy_(self._shard(n, state_dict[n]))

    def load_optimizer(self, optimizer, osd: dict) -> None:
        """Load a full optimizer state_dict (full_optimizer_state's, or
        one process's) as this rank's shards of it."""
        order = self._optimizer_names(optimizer)
        state = {}
        for i, st in osd["state"].items():
            name = order[int(i)]
            state[i] = {k: (self._shard(name, v).clone() if k in (
                "exp_avg", "exp_avg_sq") else v) for k, v in st.items()}
        optimizer.load_state_dict({"state": state,
                                   "param_groups": osd["param_groups"]})

    def _optimizer_names(self, optimizer) -> list[str]:
        """Parameter names in the optimizer's state index order."""
        by_id = {id(p): n for n, p in self.named_parameters()}
        return [by_id[id(p)] for g in optimizer.param_groups
                for p in g["params"]]
