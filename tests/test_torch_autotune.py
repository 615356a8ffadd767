"""The port's autotuner (``horovod_tpu_torch/native/autotune.py``) against
the reference's C++ (``horovod_tpu/native/cc``), on the CPU.

* A small oracle program is built with g++ against the reference's
  ``autotune.h`` and its sources, as ``make unittest`` builds
  ``test_bayes_oracle``.  For the same observations the port's GP/EI
  proposals equal the reference's: the discrete values (the rounded
  cache bit, which trial pins) are equal, and every coordinate of every
  proposal agrees to 1e-12 (in practice bit for bit: the port follows the
  C++ loop for loop with the C library's ``exp``, ``log`` and ``erfc``).
  Fed the same bytes, the port's ``ParameterManager`` writes the
  reference's trial log line for line, pin and re-open included.
* The reference's gates, on the port: the convergence gate of
  ``native/cc/tests/test_bayes_oracle.cc`` (two-peak objectives, 20 and
  40 trials, 95 % of the grid maximum in 3-D, 90 % in 5-D, 97 % at 40)
  and the drift-monitor gate of ``test_param_monitor.cc``.
* Under the reference's launcher (``--autotune --autotune-log-file``,
  2 gloo ranks), the counterparts of ``tests/test_autotune.py``'s
  ``test_autotune_tunes_and_pins`` and ``test_autotune_off_by_default``:
  the log has at least 5 rows, a parameter varies, the last row is
  pinned, and every sum is exact while thresholds, cycle times and the
  cache change mid-stream.  Trials, pinning and rows follow from counts
  of samples: the workload runs more busy cycles than the schedule needs
  to pin, and the drift windows are set beyond the run, so no timing can
  re-open the search.
"""

import csv
import math
import os
import subprocess

import numpy as np
import pytest

from horovod_tpu_torch.native import autotune
from torch_support import REPO, run_job

CC = os.path.join(REPO, "horovod_tpu", "native", "cc")

ORACLE = r'''
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#include "autotune.h"

namespace {

double Peak(const std::vector<double>& x, const std::vector<double>& c,
            double width) {
  double d2 = 0;
  for (size_t i = 0; i < x.size(); ++i)
    d2 += (x[i] - c[i]) * (x[i] - c[i]);
  return std::exp(-d2 / width);
}

// test_bayes_oracle.cc's objective, and a rough one with many ties.
double Objective(const std::vector<double>& x, int kind) {
  static const std::vector<double> kMain = {0.7, 0.2, 0.5, 0.35, 0.8};
  static const std::vector<double> kDecoy = {0.15, 0.85, 0.1, 0.9, 0.2};
  std::vector<double> m(kMain.begin(), kMain.begin() + x.size());
  std::vector<double> d(kDecoy.begin(), kDecoy.begin() + x.size());
  double v = Peak(x, m, 0.15) + 0.45 * Peak(x, d, 0.03);
  if (kind == 1) v = std::floor(v * 8.0) + 0.5 * x[0];
  return v;
}

}  // namespace

int main(int argc, char** argv) {
  if (std::strcmp(argv[1], "bo") == 0) {
    const int dims = std::atoi(argv[2]), trials = std::atoi(argv[3]);
    const int kind = std::atoi(argv[4]);
    hvd::BayesianOptimizer bo(dims);
    for (int t = 0; t < trials; ++t) {
      std::vector<double> x = bo.NextSample();
      double y = Objective(x, kind);
      for (double v : x) std::printf("%.17g ", v);
      std::printf("%.17g\n", y);
      bo.Observe(x, y);
    }
    return 0;
  }
  // "pm": one Update per byte count on stdin, the log under the env.
  hvd::ParameterManager pm;
  pm.Initialize(0, 1.0, 64 * 1024 * 1024, true);
  long long b;
  while (std::scanf("%lld", &b) == 1) pm.Update(b);
  return 0;
}
'''


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    d = tmp_path_factory.mktemp("autotune_oracle")
    src = d / "oracle.cc"
    src.write_text(ORACLE)
    exe = d / "oracle"
    srcs = [os.path.join(CC, "src", f) for f in (
        "gaussian_process.cc", "bayesian_optimization.cc",
        "parameter_manager.cc", "logging.cc")]
    subprocess.run(["g++", "-O2", "-std=c++17", "-pthread",
                    f"-I{CC}/include", "-o", str(exe), str(src), *srcs],
                   check=True, capture_output=True, timeout=240)
    return str(exe)


def _objective(x, kind):
    main = [0.7, 0.2, 0.5, 0.35, 0.8][:len(x)]
    decoy = [0.15, 0.85, 0.1, 0.9, 0.2][:len(x)]

    def peak(c, width):
        return math.exp(-sum((a - b) * (a - b) for a, b in zip(x, c))
                        / width)

    v = peak(main, 0.15) + 0.45 * peak(decoy, 0.03)
    return math.floor(v * 8.0) + 0.5 * x[0] if kind == 1 else v


@pytest.mark.parametrize("dims,trials,kind", [
    (3, 20, 0), (3, 40, 0), (5, 20, 0), (3, 30, 1)])
def test_proposals_are_the_references(oracle, dims, trials, kind):
    out = subprocess.run([oracle, "bo", str(dims), str(trials), str(kind)],
                         check=True, capture_output=True, text=True,
                         timeout=60).stdout.split("\n")
    bo = autotune.BayesianOptimizer(dims)
    for t in range(trials):
        row = [float(v) for v in out[t].split()]
        want, score = row[:dims], row[dims]
        got = bo.next_sample()
        assert [v >= 0.5 for v in got] == [v >= 0.5 for v in want], t
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12,
                                   err_msg=f"trial {t}")
        # The reference's observation, fed as it was observed.
        bo.observe(want, score)
    assert bo.best_score == max(float(r.split()[dims])
                                for r in out[:trials])


def _bytes_sequence():
    """Scores (bytes, at 1 us a sample) that explore, pin, hold in the
    band, drift out of it for two windows, and explore again."""
    g = np.random.default_rng(13)
    explore = g.integers(100_000, 1_000_000, size=80).tolist()
    steady = [500_000] * 12
    drop = [100_000] * 12
    return explore + steady + drop + g.integers(
        100_000, 1_000_000, size=40).tolist()


SCHEDULE = {"HOROVOD_AUTOTUNE": "1",
            "HOROVOD_AUTOTUNE_WARMUP_SAMPLES": "2",
            "HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE": "1",
            "HOROVOD_AUTOTUNE_SAMPLES": "3",
            "HOROVOD_AUTOTUNE_BAYES_TRIALS": "12",
            "HOROVOD_AUTOTUNE_DRIFT_RATIO": "0.5",
            "HOROVOD_AUTOTUNE_DRIFT_WINDOWS": "2"}


def test_the_trial_log_is_the_references(oracle, tmp_path, monkeypatch):
    """One sample a busy cycle: the C++ sample opens and closes at one
    clock reading (1 us), so its score is the bytes, with no timing."""
    seq = _bytes_sequence()
    ref_log = tmp_path / "ref.csv"
    subprocess.run([oracle, "pm"], input=" ".join(map(str, seq)),
                   check=True, capture_output=True, text=True, timeout=120,
                   env=dict(os.environ, HOROVOD_AUTOTUNE_LOG=str(ref_log),
                            **SCHEDULE))
    port_log = tmp_path / "port.csv"
    for k, v in dict(SCHEDULE, HOROVOD_AUTOTUNE_LOG=str(port_log)).items():
        monkeypatch.setenv(k, v)
    pm = autotune.ParameterManager(0, 1.0, 64 * 1024 * 1024, True)
    for b in seq:
        pm.update(b, 0.0)
    pm.close()
    want = ref_log.read_text().splitlines()
    got = port_log.read_text().splitlines()
    assert got == want
    phases = [row.split(",")[-1] for row in want]
    assert "pinned" in phases and "reopen" in phases, phases
    assert pm.reopens == phases.count("reopen")


def _grid_max(dims, steps):
    axes = np.meshgrid(*[np.linspace(0.0, 1.0, steps)] * dims,
                       indexing="ij")
    pts = np.stack([a.ravel() for a in axes], axis=1)
    main = np.array([0.7, 0.2, 0.5, 0.35, 0.8][:dims])
    decoy = np.array([0.15, 0.85, 0.1, 0.9, 0.2][:dims])
    v = (np.exp(-((pts - main) ** 2).sum(1) / 0.15)
         + 0.45 * np.exp(-((pts - decoy) ** 2).sum(1) / 0.03))
    return float(v.max())


@pytest.mark.parametrize("dims,trials,frac,steps", [
    (3, 20, 0.95, 21), (5, 20, 0.90, 13), (3, 40, 0.97, 21)])
def test_the_convergence_gate(dims, trials, frac, steps):
    """``test_bayes_oracle.cc``: the best observed value against the dense
    grid's maximum of the two-peak objective."""
    bo = autotune.BayesianOptimizer(dims)
    for _ in range(trials):
        x = bo.next_sample()
        bo.observe(x, _objective(x, 0))
    assert bo.best_score / _grid_max(dims, steps) >= frac


def _pinned(monkeypatch, steady):
    for k, v in {"HOROVOD_AUTOTUNE": "1",
                 "HOROVOD_AUTOTUNE_WARMUP_SAMPLES": "0",
                 "HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE": "1",
                 "HOROVOD_AUTOTUNE_SAMPLES": "1",
                 "HOROVOD_AUTOTUNE_BAYES_TRIALS": "3",
                 "HOROVOD_AUTOTUNE_DRIFT_RATIO": "0.5",
                 "HOROVOD_AUTOTUNE_DRIFT_WINDOWS": "2"}.items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("HOROVOD_AUTOTUNE_LOG", raising=False)
    pm = autotune.ParameterManager(0, 1.0, 64 * 1024 * 1024, True)
    assert pm.active
    for _ in range(3):
        pm.update(steady, 0.0)
    assert not pm.active and pm.monitoring
    pm.update(steady, 0.0)   # the first window calibrates the anchor
    return pm


@pytest.mark.parametrize("case", ["benign", "gradual"])
def test_the_drift_monitor_gate(monkeypatch, case):
    """``test_param_monitor.cc``: +/-8 % around the anchor never re-opens;
    -5 % a window, in band against a walking baseline for ever, crosses
    the anchor-clamped floor and re-opens."""
    steady = 1_000_000
    pm = _pinned(monkeypatch, steady)
    if case == "benign":
        for i in range(40):
            pm.update(steady * 92 // 100 if i % 2 else steady * 108 // 100,
                      0.0)
        assert pm.monitoring and pm.reopens == 0
        return
    score = float(steady)
    for _ in range(80):
        score *= 0.95
        pm.update(int(score), 0.0)
        if pm.reopens:
            break
    assert pm.reopens == 1 and pm.active and not pm.monitoring


TUNE_JOB = r'''
import sys

import numpy as np
import torch

torch.set_num_threads(1)

import horovod_tpu_torch as hvd

out_dir = sys.argv[1]
hvd.init(device="cpu")
r, s = hvd.rank(), hvd.size()
exact = []
# tests/test_autotune.py's workload: many small allreduces, each checked.
for step in range(600):
    x = torch.full((64,), float(step % 7))
    got = hvd.allreduce(x, op=hvd.Sum, name=f"g.{step % 8}")
    exact.append(torch.equal(got, torch.full((64,), float(step % 7) * s)))
# Fused names of 0.25-1.2 MB, so that the tuned threshold (1-64 MB) cuts
# the buckets differently from trial to trial.
sizes = (64, 300_000, 200_000, 64)
for step in range(60):
    hs = [hvd.allreduce_async(torch.full((n,), float(step % 5 + r + i)),
                              op=hvd.Sum, name=f"f.{i}")
          for i, n in enumerate(sizes)]
    for i, (h, n) in enumerate(zip(hs, sizes)):
        want = float(s * (step % 5 + i) + s * (s - 1) // 2)
        exact.append(torch.equal(hvd.synchronize(h),
                                 torch.full((n,), want)))
rt = hvd.basics.runtime()
cfg = rt.tuned_config()
agreed = rt.sync_tuned_config()
from horovod_tpu_torch.ops import fusion
np.savez(f"{out_dir}/rank{r}.npz", exact=np.array(exact),
         live=np.array(fusion.fusion_threshold_bytes()),
         agreed=np.array(agreed["fusion_threshold_bytes"]),
         local=np.array(cfg["fusion_threshold_bytes"]),
         exploring=np.array(cfg["exploring"]))
hvd.shutdown()
print(f"rank {r}: autotune workload done", flush=True)
'''


def test_autotune_tunes_and_pins_under_the_launcher(tmp_path):
    log = tmp_path / "autotune.csv"
    ranks = run_job(TUNE_JOB, str(tmp_path), np_=2,
                    args=["--autotune", "--autotune-log-file", str(log)],
                    env={"HOROVOD_AUTOTUNE_WARMUP_SAMPLES": "1",
                         "HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE": "3",
                         "HOROVOD_AUTOTUNE_SAMPLES": "3",
                         "HOROVOD_AUTOTUNE_BAYES_TRIALS": "10",
                         "HOROVOD_AUTOTUNE_DRIFT_WINDOWS": "1000000"})
    for res in ranks:
        assert res["exact"].all() and res["exact"].size == 840
        assert not bool(res["exploring"])
    with open(log) as f:
        rows = list(csv.DictReader(f))
    assert list(rows[0]) == autotune.LOG_HEADER.split(",")
    assert len(rows) >= 5, rows
    assert (len({row["cycle_time_ms"] for row in rows}) > 1
            or len({row["fusion_threshold_mb"] for row in rows}) > 1), rows
    assert rows[-1]["pinned"] == "1" and rows[-1]["phase"] == "pinned"
    assert sum(row["pinned"] == "1" for row in rows) == 1
    assert all(float(row["score_bytes_per_usec"]) > 0 for row in rows)
    # The pinned threshold, agreed by both ranks, is what bucketing uses.
    pinned = int(float(rows[-1]["fusion_threshold_mb"]) * 2 ** 20)
    for res in ranks:
        assert int(res["agreed"]) == int(res["live"]) == int(res["local"])
        assert abs(int(res["agreed"]) - pinned) <= 1e-5 * pinned


OFF_JOB = r'''
import sys

import numpy as np
import torch

import horovod_tpu_torch as hvd

hvd.init(device="cpu")
out = hvd.allreduce(torch.ones(4), op=hvd.Sum, name="t")
cfg = hvd.basics.runtime().tuned_config()
np.savez(f"{sys.argv[1]}/rank{hvd.rank()}.npz", out=out.numpy(),
         exploring=np.array(cfg["exploring"]))
hvd.shutdown()
'''


def test_autotune_off_by_default_under_the_launcher(tmp_path):
    """Without ``--autotune`` nothing is tuned and no log appears, even
    with ``HOROVOD_AUTOTUNE_LOG`` set."""
    log = tmp_path / "autotune.csv"
    ranks = run_job(OFF_JOB, str(tmp_path), np_=2,
                    env={"HOROVOD_AUTOTUNE_LOG": str(log)})
    for res in ranks:
        np.testing.assert_array_equal(res["out"], np.full(4, 2.0))
        assert not bool(res["exploring"])
    assert not log.exists()
