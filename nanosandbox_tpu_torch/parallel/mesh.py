"""The (data, fsdp, seq, model) mesh, as far as the port runs it.

The counterpart of nanosandbox_tpu/parallel/mesh.py's make_mesh: the
same axes and the same mesh_dp = -1 rule (every process no other axis
claims). This slice runs the ``seq`` axis only: sequence parallelism,
one process per seq shard, K/V chunks rotating around the ring
(ops/ring_attention.py). A data, fsdp or model axis larger than 1 raises
NotImplementedError.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch.distributed as dist

AXES = ("data", "fsdp", "seq", "model")


@dataclass(frozen=True)
class Mesh:
    """Axis sizes, this process's index on the seq axis, and the process
    group of the seq ranks (None for one process)."""
    shape: dict
    seq_index: int = 0
    seq_group: object = None

    @property
    def seq(self) -> int:
        return self.shape["seq"]


def make_mesh(mesh_dp: int = -1, mesh_fsdp: int = 1, mesh_tp: int = 1,
              mesh_sp: int = 1, *, world_size: int = 1,
              rank: int = 0) -> Mesh:
    """The mesh over ``world_size`` processes; mesh_dp = -1 takes what
    fsdp, seq and model leave. The seq ranks are the whole world (the
    only axis with more than one member): rank is the seq index, and the
    seq group the default (world) group."""
    if mesh_fsdp <= 0 or mesh_tp <= 0 or mesh_sp <= 0:
        raise ValueError("mesh_fsdp, mesh_tp, and mesh_sp must be positive")
    claimed = mesh_fsdp * mesh_tp * mesh_sp
    if mesh_dp == -1:
        if world_size % claimed:
            raise ValueError(f"{world_size} processes not divisible by "
                             f"fsdp*sp*tp={claimed}")
        mesh_dp = world_size // claimed
    if mesh_dp * claimed != world_size:
        raise ValueError(f"mesh {mesh_dp}x{mesh_fsdp}x{mesh_sp}x{mesh_tp} "
                         f"!= {world_size} processes")
    shape = dict(zip(AXES, (mesh_dp, mesh_fsdp, mesh_sp, mesh_tp)))
    others = {k: v for k, v in shape.items() if k != "seq" and v > 1}
    if others:
        raise NotImplementedError(
            f"mesh axes {others} are not ported yet to nanosandbox_tpu_torch "
            "(only the seq axis: sequence parallelism)")
    if mesh_sp == 1:
        return Mesh(shape)
    return Mesh(shape, rank, dist.group.WORLD)
