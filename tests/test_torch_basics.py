"""The port's process and topology state against the JAX package's."""

import pytest
import torch
import torch.distributed as dist

from horovod_tpu import basics as jbasics
import horovod_tpu_torch as thvd
from horovod_tpu_torch import basics as tbasics
from horovod_tpu_torch.topology import build_mesh, data_axis, mesh_size

from torch_support import run_job


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


@pytest.mark.parametrize("spec,rank,size,local_size", [
    ("hostA:2,hostB:1", 0, 3, 2), ("hostA:2,hostB:1", 2, 3, 2),
    ("a:1,b:3", 2, 4, 1), ("a,b", 1, 2, 1),
    # Slots that do not add up to the world size: uniform synthesis.
    ("hostA:2", 1, 3, 3), ("", 3, 4, 2)])
def test_topology_from_launcher_map_matches_jax(monkeypatch, spec, rank,
                                                size, local_size):
    """HOROVOD_TOPOLOGY (uneven hosts too) and HOROVOD_HOSTNAME resolve
    to the same Topology in both packages."""
    monkeypatch.setenv("HOROVOD_TOPOLOGY", spec)
    monkeypatch.setenv("HOROVOD_HOSTNAME", "node7")
    args = (rank, size, rank % local_size, local_size, rank // local_size,
            -(-size // local_size))
    want = jbasics._build_topology(*args)
    got = tbasics._build_topology(*args)
    assert tuple(got) == tuple(want)
    assert (got.num_hosts, got.leader, got.is_leader) == (
        want.num_hosts, want.leader, want.is_leader)


@pytest.fixture()
def no_world(monkeypatch):
    for var in ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_LOCAL_RANK",
                "HOROVOD_LOCAL_SIZE", "HOROVOD_COORDINATOR_ADDR",
                "HOROVOD_TOPOLOGY", "HOROVOD_HOSTNAME"):
        monkeypatch.delenv(var, raising=False)
    thvd.shutdown()
    yield thvd
    thvd.shutdown()


def test_build_queries_answer_for_the_port(no_world):
    """The reference's queries (``basics.py:478-515``), answered for a
    torch.distributed port: no MPI, DDL, MLSL or TPU; gloo and NCCL as
    torch was built; gloo enabled in a CPU world."""
    thvd.init(device="cpu")
    assert not any(f() for f in (
        thvd.mpi_threads_supported, thvd.mpi_built, thvd.mpi_enabled,
        thvd.ddl_built, thvd.mlsl_built, thvd.tpu_built, thvd.tpu_enabled))
    assert thvd.gloo_built() and thvd.gloo_enabled()
    assert thvd.nccl_built() == dist.is_nccl_available()
    assert thvd.num_devices() == 1
    assert thvd.local_devices() == [torch.device("cpu")]


def test_rank_subset_init_in_a_world_of_one(no_world):
    thvd.init(device="cpu", ranks=[0])
    assert (thvd.rank(), thvd.size()) == (0, 1)
    assert torch.equal(thvd.allreduce(torch.ones(2), op=thvd.Sum),
                       torch.ones(2))
    thvd.shutdown()
    with pytest.raises(ValueError, match="ranks must be in"):
        thvd.init(device="cpu", ranks=[1])
    assert not thvd.is_initialized()


LAUNCH_JOB = r'''
import os
import sys

import numpy as np
import torch

from horovod_tpu import basics as jbasics
import horovod_tpu_torch as thvd

out_dir = sys.argv[1]
thvd.init(device="cpu")   # rendezvous at HOROVOD_COORDINATOR_ADDR
out = {}
env = jbasics._topology_unchecked()
out["rank_size"] = np.array([[thvd.rank(), thvd.size(), thvd.local_rank(),
                              thvd.local_size(), thvd.cross_rank(),
                              thvd.cross_size()],
                             [env.rank, env.size, env.local_rank,
                              env.local_size, env.cross_rank,
                              env.cross_size]])
args = (thvd.rank(), thvd.size(), thvd.local_rank(), thvd.local_size(),
        thvd.cross_rank(), thvd.cross_size())
out["launcher"] = np.array([repr(tuple(thvd.topology())),
                            repr(tuple(jbasics._build_topology(*args)))])
os.environ["HOROVOD_TOPOLOGY"] = "hostA:2,hostB:1"
out["uneven"] = np.array([repr(tuple(thvd.topology())),
                          repr(tuple(jbasics._build_topology(*args)))])
x = thvd.allreduce(torch.tensor([thvd.rank() + 1.0]), op=thvd.Sum)
out["sum"] = x.numpy()
thvd.shutdown()

# Rank-subset init: ranks 0 and 2 form the job, rank 1 a world of one.
os.environ.pop("HOROVOD_COORDINATOR_ADDR")
thvd.init(device="cpu", ranks=[0, 2])
out["subset"] = np.array([thvd.rank(), thvd.size(), thvd.allreduce(
    torch.tensor([float(jbasics._topology_unchecked().rank + 1)]),
    op=thvd.Sum).item()])
thvd.shutdown()
np.savez(f"{out_dir}/rank{args[0]}.npz", **out)
'''


def test_port_under_launcher_matches_jax(tmp_path):
    """The port started by ``hvdrun -np 3 --jax-distributed`` (which
    exports HOROVOD_COORDINATOR_ADDR and HOROVOD_TOPOLOGY): rank, size,
    local and cross ranks and the Topology equal the JAX package's, with
    the launcher's host map and with an uneven one; then a rank-subset
    init over ranks 0 and 2 (rank 1 becomes a world of one, as the
    reference's ``init(ranks=...)`` makes it)."""
    job = run_job(LAUNCH_JOB, str(tmp_path), np_=3,
                  args=("--jax-distributed",))
    for r, res in enumerate(job):
        got, want = res["rank_size"]
        assert list(got) == list(want) and got[:2].tolist() == [r, 3]
        for key in ("launcher", "uneven"):
            assert res[key][0] == res[key][1], (key, res[key])
        assert "'localhost', 3" in str(res["launcher"][0])
        assert res["sum"].tolist() == [6.0]
    assert [tuple(res["subset"]) for res in job] == [
        (0, 2, 4.0), (0, 1, 2.0), (1, 2, 4.0)]


# The reference's public top-level names that only the JAX package has:
# none (warm_restore was the last one).
JAX_ONLY = frozenset()
# The port's own additions: the mesh helpers, the SPMD fused ops, the
# callbacks (a module of their own in the reference), the step guard's
# functional form and the device accessors.
PORT_ONLY = frozenset({
    "BroadcastGlobalVariablesCallback", "Callback",
    "LearningRateScheduleCallback", "LearningRateWarmupCallback", "Mesh",
    "MetricAverageCallback", "apply_step_guard", "build_mesh", "data_axis",
    "device", "fused_psum", "fused_pytree_mean", "grouped_allreduce_async",
    "mesh_size", "resolve_device", "scaled_lr", "warmup_schedule"})


def test_the_public_names_are_the_references():
    """Functions, classes and constants; submodules appear as attributes
    once anything imports them, so they are held by the reference's
    ``__all__`` alone."""
    import types

    import horovod_tpu as jhvd

    def public(mod):
        return {n for n in dir(mod) if not n.startswith("_")
                and not isinstance(getattr(mod, n), types.ModuleType)}

    ref, port = public(jhvd), public(thvd)
    assert ref - port == JAX_ONLY
    assert port - ref == PORT_ONLY
    assert set(jhvd.__all__) <= set(dir(thvd))
    from horovod_tpu_torch import resilience
    assert thvd.warm_restore is resilience.warm_restore
