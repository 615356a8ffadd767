"""The autotuner: Bayesian optimization of the control plane's knobs.

Counterpart of ``horovod_tpu/native/cc/include/autotune.h`` and its
sources ``gaussian_process.cc``, ``bayesian_optimization.cc`` and
``parameter_manager.cc``.  Only rank 0 tunes.  It scores the payload
bytes each busy cycle moved over the time to the completion of the
cycle's collectives, takes the median of ``HOROVOD_AUTOTUNE_SAMPLES``
samples as a trial's score, proposes the next configuration with a
Gaussian process and expected improvement, and pins the best after
``HOROVOD_AUTOTUNE_BAYES_TRIALS`` trials (or 8 trials and 5 without a
gain).  Once pinned it keeps scoring and re-opens the search when the
score leaves the drift band for ``HOROVOD_AUTOTUNE_DRIFT_WINDOWS``
windows in a row.  The runtime attaches :meth:`ParameterManager.current`
to every response list, so every rank applies a change at the same
point of the response stream.

The search space is the knobs the port's plane has: the cycle time (log
scale over 0.1–20 ms), the fusion threshold (1–64 MB), the response
cache on or off and, where the two-level plane is available (every rank
agreed on a block topology at ``init``), the hierarchical allreduce and
allgather booleans as two categorical dimensions
(``parameter_manager.cc:31``, ``:105-123``): 5-D there, 3-D elsewhere.
The reference leaves out a dimension that is not available; by that
rule the port has no chunk size, stripes or shm granule (its wire is
NCCL or gloo).  The arithmetic follows the C++ loop for loop in float64, with the C
library's ``exp``, ``log`` and ``erfc``, and the same xorshift64*
stream, so the same observations give the same proposals bit for bit.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np

from horovod_tpu_torch import config
from horovod_tpu_torch.native.message import TunedParams
from horovod_tpu_torch.utils.logging import get_logger

log = get_logger("horovod_tpu_torch.autotune")

_MASK = (1 << 64) - 1
SEED = 0x9E3779B97F4A7C15

# The search space: cycle time, fusion threshold, response cache, then
# the two hierarchical booleans where they are available.
DIMS = 3
HIER_DIMS = 2
CYCLE_MIN_MS, CYCLE_MAX_MS = 0.1, 20.0
FUSION_MIN_MB, FUSION_MAX_MB = 1.0, 64.0

LOG_HEADER = ("trial,cycle_time_ms,fusion_threshold_mb,cache_enabled,"
              "hier_allreduce,hier_allgather,score_bytes_per_usec,"
              "best_score,pinned,chunk_kb,transport_stripes,"
              "shm_granule_kb,phase")


def _exp(values: np.ndarray) -> np.ndarray:
    """The C library's ``exp`` element by element (numpy's may round
    another way in the last bit)."""
    return np.array([math.exp(v) for v in values.tolist()], np.float64)


class GaussianProcess:
    """RBF kernel plus observation noise, zero prior mean on standardized
    targets, a dense Cholesky factor (``gaussian_process.cc``)."""

    def __init__(self):
        self.n = 0
        self.length = 0.25
        self.y_mean, self.y_std = 0.0, 1.0

    def fit(self, xs: Sequence[Sequence[float]], ys: Sequence[float],
            length_scale: float = 0.25, noise: float = 1e-4) -> None:
        n = self.n = len(xs)
        self.xs = np.array(xs, np.float64).reshape(n, -1)
        self.length = length_scale
        if n == 0:
            return
        y_mean = 0.0
        for y in ys:
            y_mean += y
        y_mean /= n
        y_std = 0.0
        for y in ys:
            y_std += (y - y_mean) * (y - y_mean)
        y_std = math.sqrt(y_std / n)
        if y_std < 1e-12:
            y_std = 1.0
        self.y_mean, self.y_std = y_mean, y_std
        rows = [list(map(float, x)) for x in xs]
        chol = [[0.0] * n for _ in range(n)]
        for i in range(n):
            for j in range(i + 1):
                chol[i][j] = self._kernel(rows[i], rows[j]) + (
                    noise if i == j else 0.0)
        for j in range(n):
            d = chol[j][j]
            for k in range(j):
                d -= chol[j][k] * chol[j][k]
            d = math.sqrt(d if d > 1e-12 else 1e-12)
            chol[j][j] = d
            for i in range(j + 1, n):
                s = chol[i][j]
                for k in range(j):
                    s -= chol[i][k] * chol[j][k]
                chol[i][j] = s / d
        z = [0.0] * n
        for i in range(n):
            s = (ys[i] - y_mean) / y_std
            for k in range(i):
                s -= chol[i][k] * z[k]
            z[i] = s / chol[i][i]
        alpha = [0.0] * n
        for i in range(n - 1, -1, -1):
            s = z[i]
            for k in range(i + 1, n):
                s -= chol[k][i] * alpha[k]
            alpha[i] = s / chol[i][i]
        self.chol, self.alpha = chol, alpha

    def _kernel(self, a: Sequence[float], b: Sequence[float]) -> float:
        d2 = 0.0
        for u, v in zip(a, b):
            d = u - v
            d2 += d * d
        return math.exp(-0.5 * d2 / (self.length * self.length))

    def predict(self, xs: np.ndarray):
        """Mean and standard deviation at each row of ``xs`` [m, d], each
        row computed as ``GaussianProcess::Predict`` computes one."""
        m = xs.shape[0]
        if self.n == 0:
            return np.zeros(m), np.ones(m)
        n, ll = self.n, self.length * self.length
        k = np.empty((n, m))
        for i in range(n):
            d2 = np.zeros(m)
            for dim in range(xs.shape[1]):
                d = xs[:, dim] - self.xs[i, dim]
                d2 = d2 + d * d
            k[i] = _exp(-0.5 * d2 / ll)
        mu = np.zeros(m)
        for i in range(n):
            mu = mu + k[i] * self.alpha[i]
        v = np.empty((n, m))
        for i in range(n):
            s = k[i].copy()
            for j in range(i):
                s = s - self.chol[i][j] * v[j]
            v[i] = s / self.chol[i][i]
        var = np.ones(m)
        for i in range(n):
            var = var - v[i] * v[i]
        var = np.where(var < 1e-12, 1e-12, var)
        return (self.y_mean + self.y_std * mu,
                self.y_std * np.sqrt(var))


class BayesianOptimizer:
    """Expected improvement over the unit box, maximized over 256 uniform
    candidates and 96 perturbations of the incumbent
    (``bayesian_optimization.cc``)."""

    def __init__(self, dims: int, n_init: int = 5):
        self.dims, self.n_init = dims, n_init
        self.state = SEED
        self.xs: List[List[float]] = []
        self.ys: List[float] = []
        self.best_x: List[float] = []
        self.best_score = -1e300
        self.gp = GaussianProcess()

    def rand01(self) -> float:
        """xorshift64*: the reference's stream, seed for seed."""
        x = self.state
        x ^= x >> 12
        x ^= (x << 25) & _MASK
        x ^= x >> 27
        self.state = x
        return float(((x * 0x2545F4914F6CDD1D) & _MASK) >> 11) / float(
            1 << 53)

    def num_observations(self) -> int:
        return len(self.ys)

    def next_sample(self) -> List[float]:
        if self.num_observations() < self.n_init:
            return [self.rand01() for _ in range(self.dims)]
        self.gp.fit(self.xs, self.ys)
        cands = [[self.rand01() for _ in range(self.dims)]
                 for _ in range(256 + 128 * max(self.dims - 3, 0))]
        if self.best_x:
            for scale in (0.2, 0.07, 0.02):
                for _ in range(32):
                    x = []
                    for d in range(self.dims):
                        v = self.best_x[d] + scale * (2.0 * self.rand01()
                                                      - 1.0)
                        x.append(0.0 if v < 0.0 else (1.0 if v > 1.0
                                                      else v))
                    cands.append(x)
        pts = np.array(cands, np.float64)
        mu, sigma = self.gp.predict(pts)
        xi = 0.01 * abs(self.best_score)
        imp = mu - self.best_score - xi
        z = imp / sigma
        big_phi = np.array([0.5 * math.erfc(-v / math.sqrt(2.0))
                            for v in z.tolist()])
        small_phi = _exp(-0.5 * z * z) / math.sqrt(2.0 * math.pi)
        ei = imp * big_phi + sigma * small_phi
        # The first candidate whose EI beats every earlier one and -1.
        ok = ei > -1.0
        if not ok.any():
            return [0.5] * self.dims
        return cands[int(np.argmax(np.where(ok, ei, -np.inf)))]

    def observe(self, x: Sequence[float], score: float) -> None:
        self.xs.append(list(x))
        self.ys.append(float(score))
        if score > self.best_score:
            self.best_score = float(score)
            self.best_x = list(x)


def _g(v: float) -> str:
    """A number as a C++ stream writes a double by default."""
    return f"{v:g}"


class ParameterManager:
    """Rank 0's tuner (``parameter_manager.cc``): warm-up, samples of
    bytes/us with a median per trial, GP/EI proposals, pin, monitor."""

    def __init__(self, rank: int, cycle_ms: float, fusion_bytes: int,
                 cache_enabled: bool, hier_allreduce: bool = False,
                 hier_allgather: bool = False,
                 hier_available: bool = False):
        self.rank = rank
        self.cycle_time_ms = float(cycle_ms)
        self.fusion_threshold = int(fusion_bytes)
        self.cache_enabled = bool(cache_enabled)
        self.cache_available = bool(cache_enabled)
        self.hier_allreduce = bool(hier_allreduce)
        self.hier_allgather = bool(hier_allgather)
        self.hier_available = bool(hier_available)
        self.dims = DIMS + (HIER_DIMS if self.hier_available else 0)
        self.active = config.env_bool("HOROVOD_AUTOTUNE")
        self.monitoring = False
        self.reopens = 0
        self.trials = 0
        self.no_improve_streak = 0
        self.best_seen = -1e300
        self.steps_in_sample = 0
        self.bytes_in_sample = 0
        self.sample_start = 0.0
        self.scores: List[float] = []
        self.baseline_score = 0.0
        self.anchor_score = 0.0
        self.drifted_windows = 0
        self.optimizer = BayesianOptimizer(self.dims)
        self._log = None
        if not self.active:
            return
        self.warmup_remaining = config.env_int(
            "HOROVOD_AUTOTUNE_WARMUP_SAMPLES")
        self.steps_per_sample = config.env_int(
            "HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE")
        self.samples_per_trial = config.env_int("HOROVOD_AUTOTUNE_SAMPLES")
        self.max_trials = config.env_int("HOROVOD_AUTOTUNE_BAYES_TRIALS")
        self.drift_ratio = config.env_float("HOROVOD_AUTOTUNE_DRIFT_RATIO")
        if not 0.0 < self.drift_ratio < 1.0:
            self.drift_ratio = 0.5
        self.drift_windows_needed = config.env_int(
            "HOROVOD_AUTOTUNE_DRIFT_WINDOWS")
        if rank == 0:
            path = config.env_str("HOROVOD_AUTOTUNE_LOG")
            if path:
                self._log = open(path, "w")
                self._log.write(LOG_HEADER + "\n")
                self._log.flush()
            log.info("autotuner: enabled (warm-up %d samples, %d samples a "
                     "trial, %d trials at most, drift band [%gx, %gx])",
                     self.warmup_remaining, self.samples_per_trial,
                     self.max_trials, self.drift_ratio,
                     1.0 / self.drift_ratio)

    def current_point(self) -> List[float]:
        x0 = ((math.log(self.cycle_time_ms) - math.log(CYCLE_MIN_MS))
              / (math.log(CYCLE_MAX_MS) - math.log(CYCLE_MIN_MS)))
        x1 = ((self.fusion_threshold / (1024 * 1024) - FUSION_MIN_MB)
              / (FUSION_MAX_MB - FUSION_MIN_MB))
        x = [min(max(x0, 0.0), 1.0), min(max(x1, 0.0), 1.0),
             1.0 if self.cache_enabled else 0.0]
        if self.hier_available:
            x += [1.0 if self.hier_allreduce else 0.0,
                  1.0 if self.hier_allgather else 0.0]
        return x

    def apply_point(self, x: Sequence[float]) -> None:
        self.cycle_time_ms = math.exp(
            math.log(CYCLE_MIN_MS)
            + x[0] * (math.log(CYCLE_MAX_MS) - math.log(CYCLE_MIN_MS)))
        mb = FUSION_MIN_MB + x[1] * (FUSION_MAX_MB - FUSION_MIN_MB)
        self.fusion_threshold = int(mb * 1024 * 1024)
        self.cache_enabled = self.cache_available and x[2] >= 0.5
        # Off an available topology the booleans stay at their bootstrap
        # state.
        if self.hier_available and len(x) > DIMS + 1:
            self.hier_allreduce = x[DIMS] >= 0.5
            self.hier_allgather = x[DIMS + 1] >= 0.5

    def update(self, nbytes: int, now: float) -> bool:
        """One busy cycle that moved ``nbytes`` and whose collectives
        completed at ``now`` (seconds).  A sample runs from its first busy
        cycle's completion to its last's; True when the parameters
        changed."""
        if (not self.active and not self.monitoring) or nbytes <= 0:
            return False
        if self.steps_in_sample == 0:
            self.sample_start = now
        self.bytes_in_sample += nbytes
        self.steps_in_sample += 1
        if self.steps_in_sample < self.steps_per_sample:
            return False
        usec = float(int((now - self.sample_start) * 1e6))
        if usec < 1.0:
            usec = 1.0
        self.steps_in_sample = 0
        score = self.bytes_in_sample / usec
        self.bytes_in_sample = 0
        if self.warmup_remaining > 0:
            self.warmup_remaining -= 1
            return False
        self.scores.append(score)
        if len(self.scores) < self.samples_per_trial:
            return False
        self.scores.sort()
        median = self.scores[len(self.scores) // 2]
        self.scores = []
        return self._monitor(median) if self.monitoring else self._tune(
            median)

    def _tune(self, median: float) -> bool:
        self.optimizer.observe(self.current_point(), median)
        self.trials += 1
        if median > self.best_seen:
            self.best_seen = median
            self.no_improve_streak = 0
        else:
            self.no_improve_streak += 1
        pin = (self.trials >= self.max_trials
               or (self.trials >= 8 and self.no_improve_streak >= 5))
        self._log_trial(median, False, "explore")
        if pin:
            self.apply_point(self.optimizer.best_x)
            self._log_trial(self.optimizer.best_score, True, "pinned")
            self.active = False
            self.monitoring = True
            self.baseline_score = 0.0
            self.drifted_windows = 0
            log.info("autotuner: converged after %d trials; pinned "
                     "cycle_time_ms=%g fusion_threshold=%d cache=%d "
                     "hier_allreduce=%d hier_allgather=%d (best %g "
                     "bytes/usec); monitoring for drift", self.trials,
                     self.cycle_time_ms, self.fusion_threshold,
                     int(self.cache_enabled), int(self.hier_allreduce),
                     int(self.hier_allgather), self.optimizer.best_score)
            return True
        self.apply_point(self.optimizer.next_sample())
        return True

    def _monitor(self, median: float) -> bool:
        if self.baseline_score <= 0.0:
            self.baseline_score = self.anchor_score = median
            return False
        ratio = self.drift_ratio
        drifted = (median < self.baseline_score * ratio
                   or median > self.baseline_score / ratio)
        if not drifted:
            self.drifted_windows = 0
            # A slow EMA re-centres the band, clamped to the anchor's band
            # so that a regression in small steps still trips.
            b = 0.9 * self.baseline_score + 0.1 * median
            self.baseline_score = min(max(b, self.anchor_score * ratio),
                                      self.anchor_score / ratio)
            return False
        self.drifted_windows += 1
        if self.drifted_windows < self.drift_windows_needed:
            return False
        self._log_trial(median, False, "reopen")
        self.optimizer = BayesianOptimizer(self.dims)
        self.trials = 0
        self.no_improve_streak = 0
        self.best_seen = -1e300
        self.warmup_remaining = 1
        self.monitoring = False
        self.active = True
        self.drifted_windows = 0
        self.reopens += 1
        log.info("autotuner: drift detected (window %g bytes/usec against "
                 "baseline %g); re-opening the search (reopen #%d)", median,
                 self.baseline_score, self.reopens)
        return False

    def _log_trial(self, score: float, pinned: bool, phase: str) -> None:
        if self._log is None:
            return
        # The dimensions the port does not have at their fixed values:
        # no chunking, stripes or shm granule.
        self._log.write(",".join([
            str(self.trials), _g(self.cycle_time_ms),
            _g(self.fusion_threshold / (1024 * 1024)),
            str(int(self.cache_enabled)), str(int(self.hier_allreduce)),
            str(int(self.hier_allgather)), _g(score),
            _g(self.optimizer.best_score), str(int(pinned)), "0", "0", "0",
            phase]) + "\n")
        self._log.flush()

    def current(self) -> TunedParams:
        return TunedParams(tuning=self.active,
                           cycle_time_ms=self.cycle_time_ms,
                           fusion_threshold=self.fusion_threshold,
                           cache_enabled=self.cache_enabled,
                           hier_allreduce=self.hier_allreduce,
                           hier_allgather=self.hier_allgather)

    def close(self) -> None:
        if self._log is not None:
            self._log.close()
            self._log = None
