"""Shared pieces of the port's ``hvd.*`` tests.

* :func:`run_job` runs a script under the JAX package's launcher.  The
  script gets the output directory as its one argument and writes
  ``rank<r>.npz`` there; the reference's ranks meet through the launcher,
  the port's gloo world through ``MASTER_ADDR``/``MASTER_PORT``.
  :func:`run_port_job` runs a script of the port alone the same way,
  without the launcher, and returns each rank's output too;
  :func:`start_port_job` starts one and returns what waits for it.
* ``world1``: the port's gloo world of one, shut down after the test.
* ``jax_world``: the JAX package initialised at size 1 for the test.  It
  leaves an initialisation it finds in place (unlike ``tests/conftest.py``'s
  ``hvd``, which shuts it down), so a session-wide init of the files under
  ``tests/distributed/`` that share an xdist worker survives these tests.
* ``caplog``: pytest's, whose handler also hangs on the port's root
  logger: that logger does not propagate (``utils/logging.py``, as the
  reference's does not), so pytest's root handler never sees its records.

Test modules import the fixtures by name.
"""

import logging
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import horovod_tpu_torch as thvd

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_job(script: str, out_dir: str, np_: int = 3, args=(), env=None,
            timeout: int = 300):
    """Run ``script`` with ``np_`` ranks (launcher options ``args``, extra
    environment ``env``); returns every rank's ``.npz`` as a dict."""
    path = os.path.join(out_dir, "job.py")
    with open(path, "w") as f:
        f.write(script)
    full = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
                MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()))
    full.pop("XLA_FLAGS", None)   # the ranks need no fake devices
    full.update(env or {})
    res = subprocess.run(
        [sys.executable, "-m", "horovod_tpu.runner", "-np", str(np_),
         *args, sys.executable, path, out_dir],
        capture_output=True, text=True, timeout=timeout, env=full, cwd=REPO)
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-4000:]
    return [dict(np.load(os.path.join(out_dir, f"rank{r}.npz")))
            for r in range(np_)]


def start_port_job(script: str, out_dir: str, np_: int = 2, env=None,
                   timeout: int = 120):
    """Start ``script`` as ``np_`` ranks of the port alone, without the
    launcher: each process gets ``HOROVOD_RANK``/``HOROVOD_SIZE`` and one
    rendezvous address.  Returns ``finish()``, which waits for the ranks
    and returns every rank's ``.npz`` and its output, so the caller can
    compute its oracle meanwhile."""
    path = os.path.join(out_dir, "job.py")
    with open(path, "w") as f:
        f.write(script)
    base = dict(os.environ, PYTHONPATH=REPO, MASTER_ADDR="127.0.0.1",
                MASTER_PORT=str(free_port()), HOROVOD_SIZE=str(np_))
    base.update(env or {})
    procs = [subprocess.Popen(
        [sys.executable, path, out_dir], cwd=REPO, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        env=dict(base, HOROVOD_RANK=str(r))) for r in range(np_)]

    def finish():
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=timeout)[0])
        finally:
            for p in procs:
                p.kill()
        for p, log in zip(procs, logs):
            assert p.returncode == 0, log[-4000:]
        return ([dict(np.load(os.path.join(out_dir, f"rank{r}.npz")))
                 for r in range(np_)], logs)

    return finish


def run_port_job(script: str, out_dir: str, np_: int = 2, env=None,
                 timeout: int = 120):
    """:func:`start_port_job`, waited for."""
    return start_port_job(script, out_dir, np_, env, timeout)()


@pytest.fixture()
def world1(monkeypatch):
    for var in ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_LOCAL_RANK",
                "HOROVOD_LOCAL_SIZE", "HOROVOD_COORDINATOR_ADDR",
                "HOROVOD_TOPOLOGY", "HOROVOD_HOSTNAME"):
        monkeypatch.delenv(var, raising=False)
    thvd.shutdown()
    thvd.init(device="cpu")
    yield thvd
    thvd.shutdown()


@pytest.fixture()
def caplog(caplog):
    port_root = logging.getLogger("horovod_tpu_torch")
    port_root.addHandler(caplog.handler)
    yield caplog
    port_root.removeHandler(caplog.handler)


@pytest.fixture()
def jax_world(world1):
    import horovod_tpu as jhvd
    found = jhvd.is_initialized()
    if not found:
        jhvd.init()
    assert jhvd.size() == 1
    yield jhvd
    if not found:
        jhvd.shutdown()


def randomize_variables(variables, seed=0):
    """A flax model's variables with every leaf random (numpy seed), so no
    branch hides behind a zero init: kernels at 1/sqrt(fan_in), BN scales
    near 1, biases and means near 0, variances > 0.  numpy leaves."""
    import jax

    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name, shape = path[-1].key, x.shape
        if name == "kernel":
            return rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        if name == "scale":
            return 1.0 + 0.2 * rng.standard_normal(shape)
        if name == "var":
            return 1.0 + 0.5 * rng.random(shape)
        return 0.1 * rng.standard_normal(shape)

    return jax.tree_util.tree_map_with_path(
        lambda p, x: np.asarray(leaf(p, x), np.float32), variables)


def flat(tree) -> dict:
    """``{"['a']['b']": leaf}`` of a pytree, leaves as numpy arrays."""
    import jax

    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def assert_trees_close(got, want, atol, rtol, what=""):
    got, want = flat(got), flat(want)
    assert got.keys() == want.keys(), what
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=atol, rtol=rtol,
                                   err_msg=what + k)


def assert_rounds_like_reference(got, ref, truth, floor, what=""):
    """``got`` (the port) and ``ref`` (the JAX package) computed at a low
    precision, ``truth`` the same model at f64: the port's error is at most
    twice the reference's own, or ``floor``.  For deep models in train
    mode, where BatchNorm over a few samples amplifies every rounding, so
    that the reference's own error exceeds any fixed limit."""
    err = float(np.abs(np.asarray(got, np.float64) - truth).max())
    ref_err = float(np.abs(np.asarray(ref, np.float64) - truth).max())
    assert err <= max(2 * ref_err, floor), (
        f"{what}: the port's error {err:.4g} against f64 exceeds twice the "
        f"reference's {ref_err:.4g} (and {floor})")
