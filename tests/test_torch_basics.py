"""The port's process and topology state against the JAX package's."""

import pytest
import torch
import torch.distributed as dist

from horovod_tpu import basics as jbasics
import horovod_tpu_torch as thvd
from horovod_tpu_torch import basics as tbasics
from horovod_tpu_torch.topology import build_mesh, data_axis, mesh_size


@pytest.mark.parametrize("rank,size,local_size", [
    (0, 1, 1), (3, 4, 2), (4, 5, 2), (2, 8, 4), (0, 3, 3)])
def test_topology_matches_jax(monkeypatch, rank, size, local_size):
    """With no launcher host map exported, both synthesize the same
    uniform host blocks from the LOCAL/CROSS contract."""
    monkeypatch.delenv("HOROVOD_TOPOLOGY", raising=False)
    monkeypatch.delenv("HOROVOD_HOSTNAME", raising=False)
    args = (rank, size, rank % local_size, local_size, rank // local_size,
            -(-size // local_size))
    want = jbasics._build_topology(*args)
    got = tbasics._build_topology(*args)
    assert tuple(got) == tuple(want)
    assert (got.num_hosts, got.leader, got.is_leader) == (
        want.num_hosts, want.leader, want.is_leader)


def test_accessors_need_init():
    thvd.shutdown()
    with pytest.raises(ValueError, match="init"):
        thvd.rank()


def test_cpu_world_of_one(monkeypatch):
    for var in ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_LOCAL_RANK",
                "HOROVOD_LOCAL_SIZE", "HOROVOD_COORDINATOR_ADDR"):
        monkeypatch.delenv(var, raising=False)
    thvd.init(device="cpu")
    try:
        assert (thvd.rank(), thvd.size(), thvd.local_rank(),
                thvd.local_size(), thvd.cross_rank(), thvd.cross_size()) \
            == (0, 1, 0, 1, 0, 1)
        assert thvd.device() == torch.device("cpu")
        mesh = thvd.mesh()
        assert mesh_size(mesh) == 1 and data_axis(mesh) is None
        assert mesh.backend == "gloo"
        t = torch.ones(3)
        dist.all_reduce(t)
        assert torch.equal(t, torch.ones(3))
        assert thvd.topology().hosts == (("", 1),)
        assert build_mesh(device="cpu").device == torch.device("cpu")
    finally:
        thvd.shutdown()
    assert not dist.is_initialized()


def test_larger_world_needs_a_rendezvous_address(monkeypatch):
    monkeypatch.setenv("HOROVOD_SIZE", "2")
    monkeypatch.setenv("HOROVOD_RANK", "0")
    monkeypatch.delenv("HOROVOD_COORDINATOR_ADDR", raising=False)
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    monkeypatch.delenv("MASTER_PORT", raising=False)
    thvd.shutdown()
    with pytest.raises(RuntimeError, match="rendezvous"):
        thvd.init(device="cpu")
    assert not thvd.is_initialized()
