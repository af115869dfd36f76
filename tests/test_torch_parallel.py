"""The port's multi-process start-up and mesh, on the CPU, in one process.

* parallel/distributed.py resolves (coordinator, processes, process id)
  as the JAX package's maybe_initialize_distributed does: an explicit
  field, else the environment, else (the id) the StatefulSet hostname
  ordinal; it picks nccl only when every rank has a card of its own,
  gloo otherwise; one process joins no group, and several need a
  coordinator address.
* parallel/mesh.py applies the JAX mesh's mesh_dp = -1 rule over the
  processes, places rank r as JAX places device r, and raises
  NotImplementedError for a model axis.
* ops/ring_attention.py's layouts: zigzag_permutation equals the JAX
  package's, ring_positions gives each rank its rows (zigzag only when
  causal, cp > 1 and T % 2cp == 0), and the rows of all ranks cover the
  sequence once.
"""

import numpy as np
import pytest
import torch

from nanosandbox_tpu.ops import ring_attention as jring
from nanosandbox_tpu.parallel import distributed as jdist
from nanosandbox_tpu_torch.ops import ring_attention as ra
from nanosandbox_tpu_torch.parallel import distributed, mesh

ENV = ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID", "HOSTNAME")


@pytest.mark.parametrize("args,env,want", [
    (("h:1", 4, 2), {"COORDINATOR_ADDRESS": "e:2", "NUM_PROCESSES": "8",
                     "PROCESS_ID": "5"}, ("h:1", 4, 2)),
    (("", 0, -1), {"COORDINATOR_ADDRESS": "e:2", "NUM_PROCESSES": "8",
                   "PROCESS_ID": "5"}, ("e:2", 8, 5)),
    (("", 0, -1), {"COORDINATOR_ADDRESS": "e:2", "NUM_PROCESSES": "3",
                   "HOSTNAME": "train-multipod-2"}, ("e:2", 3, 2)),
    (("", 0, -1), {}, ("", 0, 0))])
def test_resolve_process_precedence(monkeypatch, args, env, want):
    for key in ENV:
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    assert distributed.resolve_process(*args) == want
    # The process id follows the JAX package's resolution order.
    assert (jdist.derive_process_id_from_hostname(env.get("HOSTNAME", ""))
            == distributed.derive_process_id_from_hostname(
                env.get("HOSTNAME", "")))


@pytest.mark.parametrize("world,cards,device,want", [
    (4, 4, "cuda", "nccl"), (2, 8, "cuda", "nccl"),
    (4, 1, "cuda", "gloo"), (4, 0, "cpu", "gloo")])
def test_backend_is_a_rule_on_counts(monkeypatch, world, cards, device,
                                     want):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert distributed.choose_backend(world, torch.device(device)) == want


def test_one_process_joins_no_group(monkeypatch):
    for key in ENV:
        monkeypatch.delenv(key, raising=False)
    proc = distributed.initialize("", 0, -1, torch.device("cpu"))
    assert (proc.rank, proc.world_size, proc.backend) == (0, 1, "")
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="coordinator_address"):
        distributed.initialize("", 2, 0, torch.device("cpu"))
    with pytest.raises(ValueError, match="process_id"):
        distributed.initialize("h:1", 2, 2, torch.device("cpu"))


def test_mesh_takes_the_seq_axis_only():
    """A mesh with one axis larger than 1 forms no group of its own (its
    groups are the world), so it builds without a process group; the
    data, fsdp and model axes are ported too (the model axis innermost:
    a model group is consecutive ranks)."""
    m = mesh.make_mesh(-1, 1, 1, 4, world_size=4, rank=3)
    assert m.shape == {"data": 1, "fsdp": 1, "seq": 4, "model": 1}
    assert (m.seq, m.seq_index) == (4, 3)
    assert m.seq_group is torch.distributed.group.WORLD
    assert m.group is torch.distributed.group.WORLD
    assert (m.batch_shards, m.fsdp_group, m.replica_group) == (1, None,
                                                               None)
    one = mesh.make_mesh(-1, 1, 1, 1, world_size=1)
    assert (one.seq, one.seq_index, one.seq_group, one.size) == (1, 0, None,
                                                                 1)
    d = mesh.make_mesh(-1, 1, 1, 1, world_size=4, rank=2)
    assert (d.shape["data"], d.data_index, d.batch_index) == (4, 2, 2)
    assert d.replica_group is torch.distributed.group.WORLD
    f = mesh.make_mesh(1, 4, 1, 1, world_size=4, rank=1)
    assert (f.fsdp, f.fsdp_index, f.batch_index) == (4, 1, 1)
    assert f.fsdp_group is torch.distributed.group.WORLD
    assert f.replica_group is None
    # Rank r at (data, fsdp, seq, model) row-major, model innermost.
    np.testing.assert_array_equal(
        mesh.mesh_layout(-1, 2, 1, 2, world_size=8),
        np.arange(8).reshape(2, 2, 2, 1))
    t = mesh.make_mesh(1, 1, 4, 1, world_size=4, rank=2)   # model axis 4
    assert (t.model, t.model_index, t.size) == (4, 2, 1)
    assert t.model_group is torch.distributed.group.WORLD
    assert (t.group, t.seq_group, t.fsdp_group) == (None, None, None)
    np.testing.assert_array_equal(mesh.mesh_layout(1, 2, 2, 1, world_size=4),
                                  np.arange(4).reshape(1, 2, 1, 2))
    with pytest.raises(ValueError, match="processes"):
        mesh.make_mesh(1, 1, 1, 4, world_size=2)


@pytest.mark.parametrize("T,cp,layout,causal,zigzag", [
    (64, 4, "zigzag", True, True), (68, 4, "zigzag", True, False),
    (64, 4, "contiguous", True, False), (64, 2, "zigzag", False, False),
    (64, 1, "zigzag", True, False)])
def test_ring_layouts(T, cp, layout, causal, zigzag):
    assert ra.use_zigzag(layout, causal, cp, T) == zigzag
    rows = [ra.ring_positions(T, cp, r, layout, causal) for r in range(cp)]
    np.testing.assert_array_equal(np.sort(np.concatenate(rows)),
                                  np.arange(T))
    if zigzag:
        idx, inv = ra.zigzag_permutation(T, cp)
        jidx, jinv = jring.zigzag_permutation(T, cp)
        np.testing.assert_array_equal(idx, jidx)
        np.testing.assert_array_equal(inv, jinv)
        np.testing.assert_array_equal(np.concatenate(rows), idx)
    else:
        np.testing.assert_array_equal(np.concatenate(rows), np.arange(T))
    with pytest.raises(ValueError, match="ring layout"):
        ra.use_zigzag("spiral", causal, cp, T)
