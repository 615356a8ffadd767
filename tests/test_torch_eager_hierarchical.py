"""The eager plane's two-level collectives
(``HOROVOD_HIERARCHICAL_ALLREDUCE``/``_ALLGATHER``) on the CPU, in one
4-rank gloo job under the port's launcher over two hosts of two
(``-H localhost:2,127.0.1.1:2``; 127.0.1.1 is not local, so its ranks
ride ``ci/fake_ssh.sh``), the launcher's own block topology.  The job
re-initializes its world once a phase, each at a fresh rendezvous:

* ``flat``: no flag; then ``hier``: both flags at a 4 KiB threshold.  Sum
  and Average allreduces (alone and fused), and allgathers with uneven
  first dimensions, in f32, bf16 and int32, at sizes on both sides of
  the threshold, on integer-valued data: every result of ``hier`` equals
  ``flat``'s bit for bit.  ``hierarchical_enabled()`` is true, and the
  reference's oracle of ``tests/distributed/hier_check_np4.py`` holds
  (the sum against the allgathered inputs at odd sizes, bf16 ones times
  ``rank + 1``, the uneven allgather of ``full(base + 17 r, r)``).
* The counters: the cross bytes of the payloads above the threshold,
  summed over the ranks, are exactly the flat bytes over ``local_size``;
  the ``hvd_hier_*`` and ``hvd_collective_bytes_total`` series carry the
  same counts.
* The agreement's negative cases stay flat on every rank: the flag on
  rank 0 only, a mapping that is not a block one; and with thresholds
  that differ across ranks the smallest wins, so a payload between them
  takes the two-level plane on every rank.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from torch_support import PORT_LAUNCHER, REPO

JOB = r'''
import os
import sys

import numpy as np
import torch

torch.set_num_threads(1)

import horovod_tpu_torch as hvd
from horovod_tpu_torch import telemetry

out_dir, phases = sys.argv[1], sys.argv[2].split(",")
rank, size = int(os.environ["HOROVOD_RANK"]), int(os.environ["HOROVOD_SIZE"])
launched_local_rank = os.environ["HOROVOD_LOCAL_RANK"]
THRESHOLD = 4096
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "i32": torch.int32}
out = {}


def ints(shape, seed, dtype):
    g = np.random.default_rng(seed)
    return torch.from_numpy(g.integers(-8, 8, shape).astype(np.float32)).to(
        DTYPES[dtype])


def save(key, t):
    out[key] = (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def series(name, **labels):
    fam = telemetry.metrics_snapshot().get(name, {"values": []})
    return sum(v["value"] for v in fam["values"]
               if all(v["labels"].get(k) == w for k, w in labels.items()))


def start(phase):
    for k in ("HOROVOD_HIERARCHICAL_ALLREDUCE",
              "HOROVOD_HIERARCHICAL_ALLGATHER",
              "HOROVOD_HIERARCHICAL_ALLREDUCE_THRESHOLD"):
        os.environ.pop(k, None)
    os.environ["HOROVOD_LOCAL_RANK"] = launched_local_rank
    flags = {"HOROVOD_HIERARCHICAL_ALLREDUCE": "1",
             "HOROVOD_HIERARCHICAL_ALLGATHER": "1",
             "HOROVOD_HIERARCHICAL_ALLREDUCE_THRESHOLD": str(THRESHOLD)}
    if phase == "hier":
        os.environ.update(flags)
    elif phase == "one_rank_flag":
        if rank == 0:
            os.environ.update(flags)
    elif phase == "not_block":
        # The first host's two ranks swap their local ranks.
        os.environ.update(flags)
        if rank < 2:
            os.environ["HOROVOD_LOCAL_RANK"] = str(1 - rank)
    elif phase == "thresholds":
        os.environ.update(flags)
        os.environ["HOROVOD_HIERARCHICAL_ALLREDUCE_THRESHOLD"] = str(
            1000 * (rank + 1))
    hvd.init(device="cpu")
    return hvd.basics.runtime()


def workload(p, rt):
    """Every case of the phase's comparison, and the counters around the
    payloads above the threshold."""
    for dtype in DTYPES:
        for n in (1, 7, 3001):          # bytes below and above 4 KiB
            for op, tag in ((hvd.Sum, "sum"), (hvd.Average, "avg")):
                x = ints((n, 3), 100 * rank + n, dtype)
                save(f"{p}/ar/{dtype}/{n}/{tag}",
                     hvd.allreduce(x, op=op, name=f"ar.{dtype}.{n}.{tag}"))
        fused = [ints((k, 5), 7 * rank + k, dtype) for k in (3, 211, 1000)]
        for i, r in enumerate(hvd.grouped_allreduce(
                fused, op=hvd.Sum, name=f"fused.{dtype}")):
            save(f"{p}/fused/{dtype}/{i}", r)
        for base in (3, 5000):
            x = ints((base + 17 * rank, 2), 31 * rank + base, dtype)
            save(f"{p}/ag/{dtype}/{base}",
                 hvd.allgather(x, name=f"ag.{dtype}.{base}"))
    # The reference's oracle (hier_check_np4.py), on integer values.
    g = np.random.default_rng(rank)
    for n in (1, 7, 100_003, 1_000_003):
        x = torch.from_numpy(g.integers(-50, 50, n).astype(np.float32))
        got = hvd.allreduce(x, op=hvd.Sum, name=f"chk.{n}")
        allx = hvd.allgather(x[None], name=f"gin.{n}")
        out[f"{p}/oracle/{n}"] = np.array(torch.equal(got, allx.sum(0)))
    x16 = torch.ones(4097, dtype=torch.bfloat16) * (rank + 1)
    got = hvd.allreduce(x16, op=hvd.Sum, name="chk.bf16")
    out[f"{p}/oracle/bf16"] = np.array(torch.equal(
        got.float(), torch.full((4097,), size * (size + 1) / 2)))
    for base in (3, 5000, 200_000):
        x = torch.full((base + rank * 17,), float(rank))
        got = hvd.allgather(x, name=f"hag.{base}")
        want = torch.cat([torch.full((base + r * 17,), float(r))
                          for r in range(size)])
        out[f"{p}/oracle/ag/{base}"] = np.array(torch.equal(got, want))
    # Payloads above the threshold alone: the cross bytes against the
    # flat bytes.
    before = dict(rt.hier_counters)
    for n in (1025, 100_003):
        hvd.allreduce(ints((n,), rank, "f32"), op=hvd.Sum, name=f"big.{n}")
    c = rt.hier_counters
    out[f"{p}/big"] = np.array([c[k] - before[k] for k in (
        "flat_allreduce_bytes", "hier_cross_bytes", "hier_local_bytes",
        "hier_allreduce_ops", "flat_allreduce_ops")])


def probe(p, rt, nbytes):
    """One f32 allreduce of ``nbytes``: which path it took here."""
    before = dict(rt.hier_counters)
    x = torch.ones(nbytes // 4)
    got = hvd.allreduce(x, op=hvd.Sum, name=f"probe.{p}.{nbytes}")
    assert torch.equal(got, torch.full_like(x, float(size)))
    c = rt.hier_counters
    return [c["hier_allreduce_ops"] - before["hier_allreduce_ops"],
            c["flat_allreduce_ops"] - before["flat_allreduce_ops"]]


for i, p in enumerate(phases):
    if i:
        # A fresh rendezvous for the next world, picked by rank 0.
        port = hvd.broadcast_object(
            hvd.basics._free_localhost_port() if rank == 0 else None, 0)
        host = os.environ["HOROVOD_COORDINATOR_ADDR"].rpartition(":")[0]
        hvd.shutdown()
        os.environ["HOROVOD_COORDINATOR_ADDR"] = f"{host}:{port}"
    rt = start(p)
    cfg = rt.tuned_config()
    out[f"{p}/state"] = np.array([
        rt.hierarchical_enabled(), rt.hierarchical_allgather_enabled(),
        cfg["hier_allreduce"], cfg["hier_available"],
        rt.hier.threshold if rt.hier is not None else -1])
    if p in ("flat", "hier"):
        workload(p, rt)
        out[f"{p}/flat_ops"] = np.array(rt.hier_counters["flat_allreduce_ops"])
    if p == "hier":
        c = rt.hier_counters
        out["hier/series"] = np.array([
            series("hvd_hier_bytes_total", level="cross", op="allreduce"),
            c["hier_cross_bytes"],
            series("hvd_hier_bytes_total", level="local", op="allreduce"),
            c["hier_local_bytes"],
            series("hvd_hier_allreduce_ops_total"), c["hier_allreduce_ops"],
            series("hvd_hier_allgather_ops_total"), c["hier_ag_ops"],
            series("hvd_hier_bytes_total", level="cross", op="allgather"),
            c["hier_ag_cross_bytes"],
            series("hvd_collective_bytes_total", plane="eager",
                   kind="allreduce", level="cross"),
            series("hvd_flat_allreduce_ops_total"), c["flat_allreduce_ops"]])
        out["hier/synced"] = np.array(list(
            rt.sync_tuned_config().values())[1:])
    if p == "thresholds":
        out[f"{p}/paths"] = np.array(
            [probe(p, rt, 400), probe(p, rt, 2400), probe(p, rt, 8000)])
    elif p in ("one_rank_flag", "not_block"):
        out[f"{p}/paths"] = np.array([probe(p, rt, 400000)])
hvd.shutdown()
np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
print(f"HIER_JOB_OK rank={rank}", flush=True)
'''

PHASES = ("flat", "hier", "one_rank_flag", "not_block", "thresholds")


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("eager_hier")
    path = tmp / "job.py"
    path.write_text(JOB)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HOROVOD_", "MASTER_"))}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1", HOME=str(tmp),
               HOROVOD_SSH_CMD="ci/fake_ssh.sh", HOROVOD_METRICS="1",
               HOROVOD_TERMINATE_GRACE_SECONDS="3")
    p = subprocess.run(
        [sys.executable, "-m", PORT_LAUNCHER, "-np", "4",
         "-H", "localhost:2,127.0.1.1:2", sys.executable, str(path),
         str(tmp), ",".join(PHASES)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    log = p.stdout + p.stderr
    assert p.returncode == 0, log[-6000:]
    assert log.count("HIER_JOB_OK") == 4, log[-4000:]
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(4)], log


def test_two_level_results_equal_the_flat_planes_bit_for_bit(job):
    ranks, _ = job
    for r, res in enumerate(ranks):
        keys = [k[len("flat/"):] for k in res
                if k.startswith(("flat/ar/", "flat/fused/", "flat/ag/"))]
        assert len(keys) == 3 * (3 * 2 + 3 + 2)
        for k in keys:
            want, got = res["flat/" + k], res["hier/" + k]
            assert got.dtype == want.dtype and got.shape == want.shape, k
            np.testing.assert_array_equal(got, want, err_msg=f"{r} {k}")
        # The same on every rank.
        for k in keys:
            np.testing.assert_array_equal(res["hier/" + k],
                                          ranks[0]["hier/" + k])


def test_the_references_oracle_holds_on_both_planes(job):
    ranks, _ = job
    for res in ranks:
        oracle = {k: bool(v) for k, v in res.items() if "/oracle/" in k}
        assert len(oracle) == 2 * 8 and all(oracle.values()), oracle


def test_the_plane_is_enabled_only_where_asked(job):
    ranks, _ = job
    for res in ranks:
        assert res["flat/state"].tolist() == [0, 0, 0, 1, 262144]
        assert res["hier/state"].tolist() == [1, 1, 1, 1, 4096]
        assert res["hier/synced"].tolist() == [1, 1]


def test_cross_bytes_are_the_flat_bytes_over_local_size(job):
    ranks, _ = job
    flat = sum(res["flat/big"] for res in ranks)
    hier = sum(res["hier/big"] for res in ranks)
    payload = 4 * (1025 + 100_003)
    # flat: every rank's payload on the one ring; two-level: each host's
    # payload crosses once, a 1/local_size slice from each of its ranks.
    assert flat.tolist() == [4 * payload, 0, 0, 0, 4 * 2]
    assert hier.tolist() == [0, 4 * payload // 2, 4 * payload, 4 * 2, 0]
    assert hier[1] * 2 == flat[0]


def test_the_series_carry_the_counters(job):
    ranks, _ = job
    for res in ranks:
        s = res["hier/series"]
        assert s[0] == s[1] > 0 and s[2] == s[3] > 0
        assert s[4] == s[5] > 0 and s[6] == s[7] > 0 and s[8] == s[9] > 0
        assert s[10] == s[1]       # hvd_collective_bytes_total{level=cross}
        # The small payloads stayed flat (the series counts both phases).
        assert s[12] == res["hier/flat_ops"] > 0
        assert s[11] == s[12] + res["flat/flat_ops"]


@pytest.mark.parametrize("case,available", [("one_rank_flag", 1),
                                            ("not_block", 0)])
def test_a_disagreement_stays_flat_everywhere(job, case, available):
    ranks, log = job
    for res in ranks:
        assert res[f"{case}/state"].tolist()[:4] == [0, 0, 0, available]
        assert res[f"{case}/paths"].tolist() == [[0, 1]]
    # Rank 0's warning, once for each case.
    assert log.count("HOROVOD_HIERARCHICAL_ALLREDUCE requested but the "
                     "topology is not a homogeneous block mapping or the "
                     "flag is not set on every rank") == 2


def test_differing_thresholds_agree_on_the_smallest(job):
    ranks, log = job
    for res in ranks:
        assert res["thresholds/state"].tolist() == [1, 1, 1, 1, 1000]
        # 400 bytes flat, 2400 (between rank 1's and rank 2's thresholds)
        # and 8000 two-level, on every rank.
        assert res["thresholds/paths"].tolist() == [[0, 1], [1, 0], [1, 0]]
    assert ("HOROVOD_HIERARCHICAL_ALLREDUCE_THRESHOLD differs across ranks "
            "(min/max 1000/4000); using the agreed min 1000") in log
