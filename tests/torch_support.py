"""Shared pieces of the port's ``hvd.*`` tests.

* :func:`run_job` runs a script under a launcher: the port's
  (:data:`PORT_LAUNCHER`, ``python -m horovod_tpu_torch.runner``) for a
  job whose ranks run only the port, the JAX package's
  (:data:`REF_LAUNCHER`) for one in which the reference's ranks run too.
  The script gets the output directory as its one argument and writes
  ``rank<r>.npz`` there.  A job inherits this process's environment but
  for :data:`JOB_SHAPE_VARS` (the world's shape and routing, which an
  earlier test in the same xdist worker may have left behind), and its
  rendezvous port comes from :func:`free_port`.  Under the port's launcher the port's gloo world
  meets at the launcher's ``HOROVOD_COORDINATOR_ADDR``; under the
  reference's the reference's ranks meet through the launcher and the
  port's world through ``MASTER_ADDR``/``MASTER_PORT``.
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
* :func:`flash_kernels_as_plain` runs the flash wrappers as on the card,
  with each kernel call computed by the plain version.

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
PORT_LAUNCHER = "horovod_tpu_torch.runner"
REF_LAUNCHER = "horovod_tpu.runner"


# What a job's ranks would take from the test process's environment
# that sets the world's shape or routing: the launchers set the ranks'
# own, so a value left in this process by an earlier test would only
# change what the job computes.  A caller that wants one passes it in
# ``env``.
JOB_SHAPE_VARS = (
    "HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_LOCAL_RANK",
    "HOROVOD_LOCAL_SIZE", "HOROVOD_CROSS_RANK", "HOROVOD_CROSS_SIZE",
    "HOROVOD_TOPOLOGY", "HOROVOD_HOSTNAME", "HOROVOD_COORDINATOR_ADDR",
    "HOROVOD_HIERARCHICAL_ALLREDUCE", "HOROVOD_HIERARCHICAL_ALLGATHER",
    "HOROVOD_HIERARCHICAL_ALLREDUCE_THRESHOLD", "HOROVOD_COORD_TREE",
    "HOROVOD_SCHEDULE_CHECK", "HOROVOD_WORLD_EPOCH", "HOROVOD_COORD_EPOCH",
    "HOROVOD_COORD_RANK", "MASTER_ADDR", "MASTER_PORT")

PORT_WINDOW = 2000
_next_port = iter(range(os.getpid() % PORT_WINDOW, 1 << 30))


def _ephemeral_low() -> int:
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            return int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return 32768


def free_port() -> int:
    """A free localhost port for a job's rendezvous.

    A port the kernel hands out for ``bind(0)`` is free only until the
    job binds it; meanwhile any other process's ``bind(0)`` (another
    job's store or launcher, in this or another xdist worker) may take
    it.  So the port comes from a window below the kernel's ephemeral
    range that belongs to this xdist worker alone (``gwN``: ``10000 +
    2000 N`` onward), cycling through it, and only a port free now is
    returned.  Where the window would reach the ephemeral range the
    kernel picks."""
    worker = os.environ.get("PYTEST_XDIST_WORKER", "gw0")
    n = int(worker[2:]) if worker[2:].isdigit() else 0
    base = 10000 + PORT_WINDOW * n
    if base + PORT_WINDOW <= _ephemeral_low():
        for _ in range(PORT_WINDOW):
            port = base + next(_next_port) % PORT_WINDOW
            with socket.socket() as s:
                try:
                    s.bind(("127.0.0.1", port))
                except OSError:
                    continue
                return port
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def job_environ(**extra) -> dict:
    """This process's environment without :data:`JOB_SHAPE_VARS`, with
    ``extra`` on top."""
    env = {k: v for k, v in os.environ.items() if k not in JOB_SHAPE_VARS}
    env.update(extra)
    return env


def run_job(script: str, out_dir: str, np_: int = 3, args=(), env=None,
            timeout: int = 300, launcher: str = REF_LAUNCHER):
    """Run ``script`` with ``np_`` ranks under ``launcher`` (a module run
    with ``python -m``; its options ``args``, extra environment ``env``);
    returns every rank's ``.npz`` as a dict."""
    path = os.path.join(out_dir, "job.py")
    with open(path, "w") as f:
        f.write(script)
    full = job_environ(JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()))
    full.pop("XLA_FLAGS", None)   # the ranks need no fake devices
    full.update(env or {})
    res = subprocess.run(
        [sys.executable, "-m", launcher, "-np", str(np_),
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
    base = job_environ(PYTHONPATH=REPO, MASTER_ADDR="127.0.0.1",
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


def flash_kernels_as_plain(monkeypatch) -> list:
    """The flash attention wrappers as if the tensors lay on the card: the
    route says "cuda", and each kernel call (``_run_fwd``, ``_run_dq``,
    ``_run_dkv``, reached after the plan, the padding and the layout
    checks) computes with the plain version on the operands it was handed.
    Returns the list of ``(kernel, instance, operand shape)`` the calls
    saw, in order."""
    from horovod_tpu_torch.ops import flash_attention as fa

    plain_fwd, plain_dq, plain_dkv = (fa._fwd_parts_plain, fa._bwd_dq_plain,
                                      fa._bwd_dkv_plain)
    seen = []

    def fold(x):
        return fa._fold(x) if x.dim() == 4 else x

    def unfold(y, like):
        return fa._unfold(y, like.shape[0], like.shape[2]) \
            if like.dim() == 4 else y

    def run_fwd(inst, q, k, v, qseg, kseg, causal, scale):
        seen.append(("fwd", inst, tuple(q.shape)))
        o, m, l = plain_fwd(fold(q), fold(k), fold(v), qseg, kseg, causal,
                            scale)
        return unfold(o, q), m[:, 0], l[:, 0]

    def run_dq(inst, q, k, v, o, do, m, l, qseg, kseg, causal, scale):
        seen.append(("bwd_dq", inst, tuple(q.shape)))
        return unfold(plain_dq(*map(fold, (q, k, v, o, do)), m, l, qseg,
                               kseg, causal, scale), q)

    def run_dkv(inst, q, k, v, o, do, m, l, qseg, kseg, causal, scale):
        seen.append(("bwd_dkv", inst, tuple(q.shape)))
        dk, dv = plain_dkv(*map(fold, (q, k, v, o, do)), m, l, qseg, kseg,
                           causal, scale)
        return unfold(dk, q), unfold(dv, q)

    monkeypatch.setattr(fa, "_route", lambda x: "cuda")
    monkeypatch.setattr(fa, "_run_fwd", run_fwd)
    monkeypatch.setattr(fa, "_run_dq", run_dq)
    monkeypatch.setattr(fa, "_run_dkv", run_dkv)
    return seen
