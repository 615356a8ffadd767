"""Process sets inside a rank-subset job, against the reference's eager
plane, on the CPU.

One ``python -m horovod_tpu.runner -np 4`` job: both packages
``init(ranks=[0, 1, 2])``, so launched process 3 is an inactive world of
one that never takes part in a group of the job.  The three members
register the sets ``[0, 1]`` and then ``[1, 2]`` (the reference's
``add_process_set``, ``native/runtime.py:1163-1183``; in the port only a
set's members create its group), and each set's members run
``allreduce`` (Sum and Average), ``allgather`` (uneven first dimensions)
and ``broadcast`` on it.  Every result equals the reference's bit for
bit.  The second set overlaps the first on rank 1 alone: its group is
named after how many groups each member holds, which the port keeps
equal across ranks.
"""

import numpy as np
import pytest

from torch_support import run_job

JOB = r'''
import sys

import numpy as np
import torch

import horovod_tpu as jhvd
import horovod_tpu.torch as jt
import horovod_tpu_torch as thvd

out_dir = sys.argv[1]
jhvd.init(ranks=[0, 1, 2])
thvd.init(device="cpu", ranks=[0, 1, 2])
r, n = thvd.rank(), thvd.size()
out = {"world": np.array([r, n, jhvd.rank(), jhvd.size()])}
if n == 3:
    sets = {}
    for pkg, mod in (("ref", jhvd), ("port", thvd)):
        sets[pkg] = [mod.add_process_set([0, 1]), mod.add_process_set([1, 2])]
    out["ids"] = np.array([ps.id for ps in sets["ref"] + sets["port"]])
    for k, members in enumerate(([0, 1], [1, 2])):
        if r not in members:
            continue
        me = members.index(r)
        x = torch.arange(6, dtype=torch.float32).reshape(2, 3) * (r + 1) + k
        rows = torch.full((me + 1, 2), float(10 * r + k))
        for pkg, mod in (("ref", jt), ("port", thvd)):
            ps = sets[pkg][k]
            tag = f"{pkg}/set{k}"
            out[f"{tag}/sum"] = mod.allreduce(
                x, op=mod.Sum, name=f"s{k}.sum", process_set=ps).numpy()
            out[f"{tag}/avg"] = mod.allreduce(
                x, name=f"s{k}.avg", process_set=ps).numpy()
            out[f"{tag}/gather"] = mod.allgather(
                rows, name=f"s{k}.ag", process_set=ps).numpy()
            out[f"{tag}/bcast"] = mod.broadcast(
                x, members[1], name=f"s{k}.bc", process_set=ps).numpy()
            out[f"{tag}/size_rank"] = np.array([ps.size(), ps.rank()])
    out["after"] = thvd.allreduce(torch.ones(2), op=thvd.Sum,
                                  name="after").numpy()
np.savez(f"{out_dir}/rank{thvd.basics.global_rank(r) if n == 3 else 3}.npz",
         **out)
thvd.shutdown()
jhvd.shutdown()
print("subset job done", flush=True)
'''


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    return run_job(JOB, str(tmp_path_factory.mktemp("subset_sets")), np_=4,
                   env={"OMP_NUM_THREADS": "1"})


def test_the_processes_outside_the_subset_stay_worlds_of_one(job):
    for r in range(3):
        np.testing.assert_array_equal(job[r]["world"], [r, 3, r, 3])
        np.testing.assert_array_equal(job[r]["after"], [3.0, 3.0])
    np.testing.assert_array_equal(job[3]["world"], [0, 1, 0, 1])
    # Both packages number the two sets alike.
    ids = job[0]["ids"]
    assert list(ids[:2]) == list(ids[2:]) == [1, 2]


@pytest.mark.parametrize("k,members", [(0, [0, 1]), (1, [1, 2])])
@pytest.mark.parametrize("kind", ["sum", "avg", "gather", "bcast",
                                  "size_rank"])
def test_a_set_inside_a_subset_job_matches_the_reference(job, k, members,
                                                         kind):
    for r in members:
        want = job[r][f"ref/set{k}/{kind}"]
        got = job[r][f"port/set{k}/{kind}"]
        assert got.dtype == want.dtype, (r, got, want)
        np.testing.assert_array_equal(got, want, err_msg=f"rank {r}")
    for r in set(range(3)) - set(members):
        assert f"port/set{k}/{kind}" not in job[r]
