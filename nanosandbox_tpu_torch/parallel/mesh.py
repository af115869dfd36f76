"""The (data, fsdp, seq, model) mesh over processes: one process a rank.

The counterpart of nanosandbox_tpu/parallel/mesh.py's make_mesh and
make_hybrid_mesh: the same axes, the same mesh_dp = -1 rule (every
process no other axis claims) and the same layout. Rank r sits at
(data, fsdp, seq, model) in row-major order over AXES, ``model``
innermost, as JAX's ``np.reshape`` of its device list places device r.

A Mesh carries this rank's index on each axis and a process group for
each reduction the training step runs:

  * ``seq_group``: the ranks that share (data, fsdp): ring attention's
    ring (ops/ring_attention.py);
  * ``fsdp_group``: the ranks that share (data, seq): FSDP's gathers of
    parameter shards and reduce-scatters of their gradients
    (parallel/sharding.py);
  * ``replica_group``: the ranks that share fsdp, over (data, seq): those
    that hold the same parameter shard, whose gradients FSDP sums;
  * ``group``: every rank of the step at this model index, over (data,
    fsdp, seq): the loss sums and, without FSDP, the gradients are summed
    over it. The batch's rows are split over (data, fsdp) (``batch_index``,
    the loader's ``rows``), but no sum runs over those axes alone: a seq
    rank holds other tokens of the same rows;
  * ``model_group``: the ranks that share (data, fsdp, seq), over model:
    tensor parallelism's (parallel/tensor.py). They hold the same tokens
    and other heads and hidden units of every block, and sum the
    row-parallel projections' partial outputs (and, in the backward, the
    column-parallel inputs' gradients) over it.

Every rank creates every group, in one order (``dist.new_group`` is
collective over the world). A group that is the whole world is the
default group; one of a single rank is None, and its size 1 says that
nothing is exchanged over it.

``mesh_slices`` (make_hybrid_mesh) lays the data axis over slices: each
(fsdp, seq, model) block lies inside one slice, and the data axis runs
slice-major. An explicit count splits the ranks into contiguous groups;
-1 groups them by host name (``socket.gethostname()``, gathered from
every rank), which stands in for a TPU device's ``slice_index``.
"""

from __future__ import annotations

import socket
from dataclasses import dataclass

import numpy as np
import torch.distributed as dist

AXES = ("data", "fsdp", "seq", "model")


@dataclass(frozen=True)
class Mesh:
    """Axis sizes, this rank's index on each axis, and the groups of the
    module docstring (None for one process, or a group of one rank)."""
    shape: dict
    seq_index: int = 0
    seq_group: object = None
    data_index: int = 0
    fsdp_index: int = 0
    fsdp_group: object = None
    replica_group: object = None
    group: object = None
    model_index: int = 0
    model_group: object = None

    @property
    def seq(self) -> int:
        return self.shape["seq"]

    @property
    def model(self) -> int:
        """The tensor-parallel degree: the ranks a block's heads and
        hidden units are split over."""
        return self.shape["model"]

    @property
    def fsdp(self) -> int:
        return self.shape["fsdp"]

    @property
    def batch_shards(self) -> int:
        """The ranks a micro-batch's rows are split over: data x fsdp."""
        return self.shape["data"] * self.shape["fsdp"]

    @property
    def batch_index(self) -> int:
        """This rank's row block: its index over (data, fsdp)."""
        return self.data_index * self.shape["fsdp"] + self.fsdp_index

    @property
    def size(self) -> int:
        """The ranks of one step at one model index: data x fsdp x
        seq."""
        return self.batch_shards * self.seq


def _resolve(mesh_dp: int, mesh_fsdp: int, mesh_tp: int, mesh_sp: int,
             n: int) -> int:
    """mesh_dp with -1 resolved over ``n`` ranks (JAX's checks and
    messages, in processes)."""
    if mesh_fsdp <= 0 or mesh_tp <= 0 or mesh_sp <= 0:
        raise ValueError("mesh_fsdp, mesh_tp, and mesh_sp must be positive")
    claimed = mesh_fsdp * mesh_tp * mesh_sp
    if mesh_dp == -1:
        if n % claimed:
            raise ValueError(f"{n} processes not divisible by "
                             f"fsdp*sp*tp={claimed}")
        mesh_dp = n // claimed
    if mesh_dp * claimed != n:
        raise ValueError(f"mesh {mesh_dp}x{mesh_fsdp}x{mesh_sp}x{mesh_tp} "
                         f"!= {n} processes")
    return mesh_dp


def mesh_layout(mesh_dp: int = -1, mesh_fsdp: int = 1, mesh_tp: int = 1,
                mesh_sp: int = 1, *, world_size: int = 1) -> np.ndarray:
    """The (data, fsdp, seq, model) array of ranks: make_mesh's layout."""
    dp = _resolve(mesh_dp, mesh_fsdp, mesh_tp, mesh_sp, world_size)
    return np.arange(world_size).reshape(dp, mesh_fsdp, mesh_sp, mesh_tp)


def hybrid_layout(mesh_dp: int = -1, mesh_fsdp: int = 1, mesh_tp: int = 1,
                  mesh_sp: int = 1, *, num_slices: int = -1,
                  world_size: int = 1,
                  slice_ids: list | None = None) -> np.ndarray:
    """make_hybrid_mesh's layout over ranks 0..world_size-1, with JAX's
    ValueErrors. num_slices = -1 groups ranks by ``slice_ids`` (one
    hashable a rank; slices ordered by their first rank); an explicit
    count splits the ranks into contiguous groups."""
    if mesh_fsdp <= 0 or mesh_tp <= 0 or mesh_sp <= 0:
        raise ValueError("mesh_fsdp, mesh_tp, and mesh_sp must be positive")
    ranks = list(range(world_size))
    n = world_size
    if num_slices == -1:
        ids = slice_ids if slice_ids is not None else [0] * n
        order = list(dict.fromkeys(ids))
        num_slices = len(order)
        groups = [[r for r in ranks if ids[r] == s] for s in order]
    else:
        if num_slices <= 0 or n % num_slices:
            raise ValueError(
                f"{n} devices cannot split into {num_slices} slices")
        per = n // num_slices
        groups = [ranks[i * per:(i + 1) * per] for i in range(num_slices)]
    per_slice = len(groups[0])
    if any(len(g) != per_slice for g in groups):
        raise ValueError(
            f"unequal slice sizes {[len(g) for g in groups]}: a mesh "
            "needs homogeneous slices")
    claimed = mesh_fsdp * mesh_tp * mesh_sp
    if per_slice % claimed:
        raise ValueError(
            f"fsdp*sp*tp={claimed} must divide the per-slice device count "
            f"{per_slice}: those axes' collectives must stay on ICI — "
            "only the data axis may span slices (DCN)")
    dp_per_slice = per_slice // claimed
    dp = num_slices * dp_per_slice
    if mesh_dp not in (-1, dp):
        raise ValueError(
            f"mesh_dp={mesh_dp} inconsistent with {num_slices} slices x "
            f"{dp_per_slice} in-slice dp (= {dp})")
    return np.stack([
        np.asarray(g).reshape(dp_per_slice, mesh_fsdp, mesh_sp, mesh_tp)
        for g in groups]).reshape(dp, mesh_fsdp, mesh_sp, mesh_tp)


def _group(layout: np.ndarray, rank: int, keep: tuple, world_size: int):
    """Create, on every rank and in one order, the groups of ranks that
    share the axes not in ``keep`` (each group varies the ``keep`` axes);
    return this rank's (None for one member, the world group for all)."""
    varied = [AXES.index(a) for a in keep]
    fixed = [i for i in range(len(AXES)) if i not in varied]
    arr = layout.transpose(fixed + varied).reshape(
        -1, int(np.prod([layout.shape[i] for i in varied])))
    mine = None
    for members in arr:
        members = sorted(int(r) for r in members)
        if len(members) == 1:
            group = None
        elif len(members) == world_size:
            group = dist.group.WORLD
        else:
            group = dist.new_group(members)
        if rank in members:
            mine = group
    return mine


def _build(layout: np.ndarray, rank: int) -> Mesh:
    shape = dict(zip(AXES, (int(s) for s in layout.shape)))
    world = layout.size
    d, f, s, m = (int(i[0]) for i in np.nonzero(layout == rank))
    if world == 1:
        return Mesh(shape)
    return Mesh(shape, seq_index=s,
                seq_group=_group(layout, rank, ("seq",), world),
                data_index=d, fsdp_index=f,
                fsdp_group=_group(layout, rank, ("fsdp",), world),
                replica_group=_group(layout, rank, ("data", "seq"), world),
                group=_group(layout, rank, ("data", "fsdp", "seq"), world),
                model_index=m,
                model_group=_group(layout, rank, ("model",), world))


def make_mesh(mesh_dp: int = -1, mesh_fsdp: int = 1, mesh_tp: int = 1,
              mesh_sp: int = 1, *, world_size: int = 1,
              rank: int = 0) -> Mesh:
    """The mesh over ``world_size`` processes (module docstring); every
    rank must call it, with the same arguments."""
    return _build(mesh_layout(mesh_dp, mesh_fsdp, mesh_tp, mesh_sp,
                              world_size=world_size), rank)


def make_hybrid_mesh(mesh_dp: int = -1, mesh_fsdp: int = 1,
                     mesh_tp: int = 1, mesh_sp: int = 1, *,
                     num_slices: int = -1, world_size: int = 1,
                     rank: int = 0) -> Mesh:
    """The multi-slice mesh (module docstring); num_slices = -1 gathers
    every rank's host name, which needs the process group."""
    ids = None
    if num_slices == -1:
        ids = [socket.gethostname()]
        if world_size > 1:
            ids = [None] * world_size
            dist.all_gather_object(ids, socket.gethostname())
    return _build(hybrid_layout(mesh_dp, mesh_fsdp, mesh_tp, mesh_sp,
                                num_slices=num_slices, world_size=world_size,
                                slice_ids=ids), rank)
