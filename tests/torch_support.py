"""Shared pieces of the port's ``hvd.*`` tests.

* :func:`run_job` runs a script under the JAX package's launcher.  The
  script gets the output directory as its one argument and writes
  ``rank<r>.npz`` there; the reference's ranks meet through the launcher,
  the port's gloo world through ``MASTER_ADDR``/``MASTER_PORT``.
  :func:`run_port_job` runs a script of the port alone the same way,
  without the launcher, and returns each rank's output too.
* ``world1``: the port's gloo world of one, shut down after the test.
* ``jax_world``: the JAX package initialised at size 1 for the test.  It
  leaves an initialisation it finds in place (unlike ``tests/conftest.py``'s
  ``hvd``, which shuts it down), so a session-wide init of the files under
  ``tests/distributed/`` that share an xdist worker survives these tests.

Test modules import the fixtures by name.
"""

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


def run_port_job(script: str, out_dir: str, np_: int = 2, env=None,
                 timeout: int = 120):
    """Run ``script`` as ``np_`` ranks of the port alone, without the
    launcher: each process gets ``HOROVOD_RANK``/``HOROVOD_SIZE`` and one
    rendezvous address.  Returns every rank's ``.npz`` and its output."""
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
def jax_world(world1):
    import horovod_tpu as jhvd
    found = jhvd.is_initialized()
    if not found:
        jhvd.init()
    assert jhvd.size() == 1
    yield jhvd
    if not found:
        jhvd.shutdown()
