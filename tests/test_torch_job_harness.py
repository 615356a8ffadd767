"""The job harness of the port's tests (``tests/torch_support.py``).

A job that an xdist worker starts must compute the same whatever the
worker ran before it, and must meet at a rendezvous that no other job can
take: a world-shape variable left in the worker's environment does not
reach the job's ranks, and ``free_port`` hands out ports of the worker's
own window, outside the kernel's ephemeral range, where no ``bind(0)``
of another process lands.
"""

import numpy as np
import pytest

import torch_support
from torch_support import PORT_LAUNCHER, REF_LAUNCHER, free_port, run_job

LEAKS = {"HOROVOD_TOPOLOGY": "hostA:1,hostB:1",
         "HOROVOD_LOCAL_SIZE": "1", "HOROVOD_LOCAL_RANK": "0",
         "HOROVOD_HIERARCHICAL_ALLREDUCE": "1",
         "HOROVOD_HIERARCHICAL_ALLGATHER": "1",
         "HOROVOD_COORD_TREE": "1", "HOROVOD_HOSTNAME": "stale-node"}

JOB = r'''
import os
import sys

import numpy as np
import torch

import horovod_tpu_torch as hvd

hvd.init(device="cpu")
seen = [os.environ.get(k, "") for k in sorted(%r)]
got = hvd.allgather(torch.tensor([hvd.rank(), hvd.local_rank(),
                                  hvd.local_size()]))
np.savez(f"{sys.argv[1]}/rank{hvd.rank()}.npz", seen=np.array(seen),
         got=got.numpy(), tree=np.array(hvd.basics.runtime()
                                        .coord_tree_enabled()))
hvd.shutdown()
''' % (sorted(LEAKS),)


@pytest.mark.parametrize("launcher", [PORT_LAUNCHER, REF_LAUNCHER])
def test_a_leaked_world_shape_does_not_reach_the_job(launcher, tmp_path,
                                                    monkeypatch):
    for k, v in LEAKS.items():
        monkeypatch.setenv(k, v)
    out = run_job(JOB, str(tmp_path), np_=2, launcher=launcher,
                  env={"OMP_NUM_THREADS": "1"})
    for r in range(2):
        seen = dict(zip(sorted(LEAKS), out[r]["seen"].tolist()))
        for k in ("HOROVOD_HIERARCHICAL_ALLREDUCE",
                  "HOROVOD_HIERARCHICAL_ALLGATHER", "HOROVOD_COORD_TREE"):
            assert seen[k] == "", (k, seen[k])
        assert seen["HOROVOD_TOPOLOGY"] != LEAKS["HOROVOD_TOPOLOGY"]
        assert seen["HOROVOD_HOSTNAME"] != "stale-node"
        # One host of two ranks, as launched.
        np.testing.assert_array_equal(out[r]["got"], [0, 0, 2, 1, 1, 2])
        assert not out[r]["tree"]


def test_free_port_keeps_to_its_workers_window(monkeypatch):
    low = torch_support._ephemeral_low()
    for worker, base in (("gw0", 10000), ("gw3", 16000), ("gw5", 20000)):
        monkeypatch.setenv("PYTEST_XDIST_WORKER", worker)
        ports = {free_port() for _ in range(50)}
        assert len(ports) == 50
        if base + torch_support.PORT_WINDOW <= low:
            assert all(base <= p < base + torch_support.PORT_WINDOW
                       for p in ports), (worker, sorted(ports)[:5])
