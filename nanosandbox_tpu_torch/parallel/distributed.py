"""Multi-process bootstrap and the collectives the port runs.

The counterpart of nanosandbox_tpu/parallel/distributed.py, with the
same contract: every process runs the same program, and it learns its
place from, per field, an explicit argument (the ``coordinator_address``,
``num_processes`` and ``process_id`` config fields), else the environment
(``COORDINATOR_ADDRESS``, ``NUM_PROCESSES``, ``PROCESS_ID``), else, for
the process id, the ordinal of a StatefulSet pod's hostname
(``<name>-<ordinal>``). ``torch.distributed.init_process_group`` then
meets the others at ``tcp://<coordinator_address>``.

The backend is chosen once, from counts, and printed; nothing falls back
from one to the other:

  * nccl when every rank has a card of its own (world size <= the cards
    torch sees; rank i runs on cuda:i);
  * gloo when ranks share a card (world size > the card count) or run on
    the CPU. NCCL refuses two ranks on one card, so ranks that share it
    exchange through host memory: a CUDA tensor is copied to the host,
    sent, and copied back (``host_staged``), while the compute stays on
    the card.

``exchanged`` counts the bytes a process sent through these helpers and,
when they were host-staged, the host seconds the exchanges took (copies
included): on one shared card that is host-staged gloo, not an
interconnect's time.
"""

from __future__ import annotations

import os
import re
import time
from dataclasses import dataclass

import torch
import torch.distributed as dist

# Bytes sent and, for host-staged exchanges, their host seconds, keyed by
# kind ("ring": K/V rotations and their gradients, "allreduce": loss sums
# and gradients; "recompute": the share of "ring" sent while
# ``recomputing`` is set; "gather" and "scatter": FSDP's all-gathers of
# parameter shards and reduce-scatters of their gradients, counted as
# the full buffer's bytes, as an all-reduce is; "tp": tensor
# parallelism's all-reduces over the model group, parallel/tensor.py).
exchanged = {"ring_bytes": 0, "ring_seconds": 0.0,
             "allreduce_bytes": 0, "allreduce_seconds": 0.0,
             "recompute_bytes": 0, "recompute_seconds": 0.0,
             "gather_bytes": 0, "gather_seconds": 0.0,
             "scatter_bytes": 0, "scatter_seconds": 0.0,
             "tp_bytes": 0, "tp_seconds": 0.0}

# Set by remat's recompute of a block (models/gpt.py _RematBlock) while it
# runs the block again, so that the rotations it repeats count as
# "recompute" too.
recomputing = False


def derive_process_id_from_hostname(hostname: str | None = None) -> int | None:
    """StatefulSet pods are named <name>-<ordinal>."""
    hostname = hostname if hostname is not None else os.environ.get(
        "HOSTNAME", "")
    m = re.search(r"-(\d+)$", hostname)
    return int(m.group(1)) if m else None


def resolve_process(coordinator_address: str = "", num_processes: int = 0,
                    process_id: int = -1) -> tuple[str, int, int]:
    """(coordinator address, number of processes, this process's id):
    explicit argument > environment > hostname ordinal (the id only)."""
    coord = coordinator_address or os.environ.get("COORDINATOR_ADDRESS", "")
    nproc = num_processes if num_processes > 0 else int(
        os.environ.get("NUM_PROCESSES", "0"))
    pid = process_id
    if pid < 0:
        pid = int(os.environ.get("PROCESS_ID", "-1"))
    if pid < 0:
        derived = derive_process_id_from_hostname()
        pid = derived if derived is not None else 0
    return coord, nproc, pid


def choose_backend(world_size: int, device: torch.device) -> str:
    """nccl when each rank has a card of its own, gloo otherwise (ranks
    sharing a card, or the CPU). A rule on counts, not a recovery."""
    if device.type == "cuda" and world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


@dataclass(frozen=True)
class Process:
    """This process's place: rank, world size, backend and device."""
    rank: int = 0
    world_size: int = 1
    backend: str = ""
    device: torch.device = torch.device("cpu")


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, device: torch.device,
               timeout_s: int = 300) -> Process:
    """Join the process group when more than one process is configured
    (see the module docstring), choose the backend and, under nccl, the
    rank's card; a single process joins nothing. Prints the choice."""
    coord, nproc, pid = resolve_process(coordinator_address, num_processes,
                                        process_id)
    if nproc <= 1:
        return Process(device=device)
    if not coord:
        raise ValueError(f"{nproc} processes need a coordinator_address "
                         "(or COORDINATOR_ADDRESS) host:port to meet at")
    if not 0 <= pid < nproc:
        raise ValueError(f"process_id {pid} outside [0, {nproc})")
    backend = choose_backend(nproc, device)
    if backend == "nccl":
        device = torch.device("cuda", pid)
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        import datetime

        dist.init_process_group(
            backend, init_method=f"tcp://{coord}", world_size=nproc,
            rank=pid, timeout=datetime.timedelta(seconds=timeout_s))
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    print(f"[rank {pid}/{nproc}] backend {backend} ({cards} card(s) "
          f"visible), device {device}"
          + (", exchanges host-staged" if backend == "gloo"
             and device.type == "cuda" else ""), flush=True)
    return Process(pid, nproc, backend, device)


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def host_staged(t: torch.Tensor, group=None) -> bool:
    """Whether an exchange of t goes through host memory (gloo, CUDA)."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def shift(t: torch.Tensor, offset: int, group=None) -> torch.Tensor:
    """Send t to the rank ``offset`` places on in the group's ring and
    return what the rank ``offset`` places back sent: one step of a ring
    rotation. Every rank of the group must call it with the same offset."""
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    group = group if group is not None else dist.group.WORLD
    dst = dist.get_global_rank(group, (rank + offset) % size)
    src = dist.get_global_rank(group, (rank - offset) % size)
    staged = host_staged(t, group)
    t0 = time.perf_counter()
    send = t.detach().contiguous()
    if staged:
        send = send.cpu()
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, dst, group),
           dist.P2POp(dist.irecv, recv, src, group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    kinds = ("ring", "recompute") if recomputing else ("ring",)
    if staged:
        recv = recv.to(t.device)
        secs = time.perf_counter() - t0
        for kind in kinds:
            exchanged[kind + "_seconds"] += secs
    for kind in kinds:
        exchanged[kind + "_bytes"] += send.numel() * send.element_size()
    return recv


def all_reduce_sum_(t: torch.Tensor, group=None,
                    kind: str = "allreduce") -> torch.Tensor:
    """Sum t over the group's ranks, in place (through host memory when
    host_staged), counted in ``exchanged`` under ``kind``; returns t."""
    staged = host_staged(t, group)
    t0 = time.perf_counter()
    buf = t.cpu() if staged else t
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    if staged:
        t.copy_(buf)
        exchanged[kind + "_seconds"] += time.perf_counter() - t0
    exchanged[kind + "_bytes"] += t.numel() * t.element_size()
    return t


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """The group's ranks' 1-D tensors t concatenated in rank order (through
    host memory when host_staged), on t's device."""
    size = dist.get_world_size(group)
    staged = host_staged(t, group)
    t0 = time.perf_counter()
    src = t.detach().contiguous()
    if staged:
        src = src.cpu()
    out = src.new_empty(size * src.numel())
    _all_gather(out, src, group=group)
    if staged:
        out = out.to(t.device)
        exchanged["gather_seconds"] += time.perf_counter() - t0
    exchanged["gather_bytes"] += out.numel() * out.element_size()
    return out


def reduce_scatter(t: torch.Tensor, group) -> torch.Tensor:
    """Sum the 1-D t over the group's ranks and return this rank's equal
    piece of the sum, the rank-th (through host memory when host_staged),
    on t's device."""
    size = dist.get_world_size(group)
    staged = host_staged(t, group)
    t0 = time.perf_counter()
    src = t.detach().contiguous()
    if staged:
        src = src.cpu()
    out = src.new_empty(src.numel() // size)
    _reduce_scatter(out, src, group=group)
    if staged:
        out = out.to(t.device)
        exchanged["scatter_seconds"] += time.perf_counter() - t0
    exchanged["scatter_bytes"] += src.numel() * src.element_size()
    return out


# torch renamed all_gather_into_tensor and reduce_scatter_tensor to
# all_gather_single and reduce_scatter_single (same arguments); the card's
# torch and this one need not agree on the names.
_all_gather = getattr(dist, "all_gather_single", None) or getattr(
    dist, "all_gather_into_tensor", None)
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or getattr(
    dist, "reduce_scatter_tensor", None)


def all_reduce_grads_(params, group=None) -> None:
    """Sum every parameter's .grad over the group's ranks: one flat
    buffer, one all-reduce."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    all_reduce_sum_(flat, group)
    offset = 0
    for g in grads:
        n = g.numel()
        g.copy_(flat[offset:offset + n].view_as(g))
        offset += n
