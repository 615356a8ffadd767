"""The port's chaos plane against the reference's ``horovod_tpu/faults.py``.

The grammar (every ported kind, site and key) parses to the same rules
and refuses the same bad specs with the same error class; ``inject``
fires at the same passages of each site and rank (``delay:0`` and
``error`` in process; ``crash``, ``exit:N`` and ``hang`` in subprocesses);
``fleet_chaos`` and ``control_chaos`` return the same lists poll by
poll; and ``drop_residual`` zeroes the residuals the reference's step
zeroes.
"""

import os
import re
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from horovod_tpu import faults as jfaults
from horovod_tpu_torch import faults

from torch_support import REPO, world1  # noqa: F401

GOOD = [
    "rank=1,site=allreduce,after=3,kind=crash",
    "rank=*,site=rpc,kind=delay:0.5,count=2",
    "rank=1,site=allreduce,kind=hang,attempt=0",
    "site=spawn,kind=exit:7",
    "site=barrier,kind=error",
    "site=native_submit,kind=error:boom there",
    "site=native_wait,after=2,kind=delay:0",
    "site=allgather,kind=nan,count=1",
    "site=broadcast,kind=corrupt:4",
    "site=heartbeat,kind=heartbeat_drop:3",
    "site=spill,kind=spill_corrupt:0",
    "rank=*,site=compression,kind=residual_drop,after=3",
    "site=compression,kind=residual_drop:2",
    "site=fleet,kind=preempt_storm",
    "site=fleet,after=20,kind=preempt_storm:1",
    "site=fleet,kind=host_flap",
    "site=fleet,kind=host_flap:3,count=5",
    "site=fleet,kind=rank_kill",
    "site=fleet,kind=rank_kill:2",
    "site=serving,kind=replica_crash:2",
    "site=serving,kind=request_storm:16,count=3",
    "site=control,kind=msg_drop",
    "site=control,kind=msg_dup:3",
    "site=control,kind=msg_delay:250",
    "site=control,kind=msg_delay",
    "site=control,kind=partition:2.5",
    "site=control,kind=coord_crash",
    "site=alltoall,kind=error;site=reducescatter,after=1,kind=delay:0",
    " rank = 2 , site = * , kind = crash ; ",
]

BAD = [
    "site=allreduce,kind=krash",
    "rank=1,site=allreduce",
    "site=allreduce,kind=crash,color=red",
    "site=allreduce,kind",
    "site=nowhere,kind=crash",
    "rank=one,kind=crash",
    "site=allreduce,kind=exit",
    "site=allreduce,kind=delay:soon",
    "site=allreduce,kind=crash:1",
    "site=allreduce,kind=corrupt:0",
    "site=heartbeat,kind=heartbeat_drop:0",
    "site=spill,kind=spill_corrupt:-1",
    "site=compression,kind=residual_drop:0",
    "site=fleet,kind=preempt_storm:0",
    "site=fleet,kind=host_flap:0",
    "site=serving,kind=replica_crash:0",
    "site=serving,kind=request_storm:0",
    "site=control,kind=msg_drop:0",
    "site=control,kind=msg_delay:-1",
    "site=control,kind=partition:0",
    "site=control,kind=coord_crash:1",
    "site=fleet,kind=rank_kill:0",
]

TRANSPORT = [
    "site=transport,kind=frame_corrupt",
    "site=transport,kind=stripe_kill:2",
    "site=transport,kind=shm_stall:5",
    "site=transport,kind=link_reset",
    "site=transport,kind=rank_kill",
    "kind=rank_kill",
]


def _unlisted(err) -> str:
    return re.sub(r"(valid kinds: |\(one of ).*", "", str(err))


def _fields(rule):
    return (rule.rank, rule.site, rule.after, rule.kind, rule.arg,
            rule.count, rule.attempt)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in (faults.ENV_VAR, "HOROVOD_RANK", "HOROVOD_RESTART_ATTEMPT"):
        monkeypatch.delenv(var, raising=False)
    faults.reset()
    jfaults.reset()
    yield
    faults.reset()
    jfaults.reset()


def _arm(monkeypatch, spec):
    monkeypatch.setenv(faults.ENV_VAR, spec)
    faults.reset()
    jfaults.reset()


@pytest.mark.parametrize("spec", GOOD)
def test_a_spec_parses_to_the_references_rules(spec):
    got = [_fields(r) for r in faults.parse_spec(spec)]
    want = [_fields(r) for r in jfaults.parse_spec(spec)]
    assert got == want
    assert [repr(r) for r in faults.parse_spec(spec)] == \
        [repr(r) for r in jfaults.parse_spec(spec)]


@pytest.mark.parametrize("spec", BAD)
def test_a_bad_spec_is_refused_as_the_reference_refuses_it(spec):
    with pytest.raises(jfaults.FaultSpecError) as want:
        jfaults.parse_spec(spec)
    with pytest.raises(faults.FaultSpecError) as got:
        faults.parse_spec(spec)
    assert isinstance(got.value, ValueError)
    assert type(got.value).__name__ == type(want.value).__name__
    # Word for word, but for the list of kinds (the port's lacks the
    # transport kinds).
    assert _unlisted(got.value) == _unlisted(want.value)


@pytest.mark.parametrize("spec", TRANSPORT)
def test_the_transport_kinds_are_refused_by_name(spec):
    jfaults.parse_spec(spec)            # the reference's native plane
    kind = spec.split("kind=")[1].split(":")[0]
    with pytest.raises(faults.FaultSpecError,
                       match=f"fault kind '{kind}' acts on the reference's "
                             f"native transports"):
        faults.parse_spec(spec)


SITES = ("allreduce", "allgather", "broadcast", "alltoall", "reducescatter",
         "barrier", "native_submit", "native_wait", "rpc", "spawn")


def _inject_trace(mod, polls):
    """Per poll: did ``inject`` raise, and every rule's firing count."""
    out = []
    for site, rank in polls:
        try:
            mod.inject(site, f"t.{site}", rank=rank)
            raised = None
        except mod.FaultInjected as e:
            raised = str(e)
        out.append((raised, [r._fired for r in mod.load()]))
    return out


@pytest.mark.parametrize("spec", [
    "rank=1,site=allreduce,after=3,kind=error",
    "site=*,after=5,kind=error,count=2",
    "rank=*,site=barrier,kind=error:custom words",
    "rank=0,site=native_submit,after=1,kind=delay:0,count=3;"
    "rank=1,site=native_wait,kind=error,count=1",
    "site=rpc,kind=delay:0;site=spawn,after=2,kind=error",
    "site=allgather,kind=error,attempt=1",
    "site=allgather,kind=error,attempt=0",
    # Kinds that never fire at inject().
    "site=allreduce,kind=nan;site=fleet,kind=preempt_storm;"
    "site=control,kind=msg_drop;site=compression,kind=residual_drop;"
    "site=serving,kind=replica_crash;site=heartbeat,kind=heartbeat_drop",
])
def test_inject_fires_at_the_references_passages(spec, monkeypatch):
    monkeypatch.setenv("HOROVOD_RESTART_ATTEMPT", "1")
    _arm(monkeypatch, spec)
    rng = np.random.default_rng(7)
    polls = [(SITES[int(i)], int(r) if r < 2 else None)
             for i, r in zip(rng.integers(0, len(SITES), 120),
                             rng.integers(0, 3, 120))]
    assert _inject_trace(faults, polls) == _inject_trace(jfaults, polls)


def test_the_context_rank_is_the_launchers(monkeypatch):
    monkeypatch.setenv("HOROVOD_RANK", "1")
    _arm(monkeypatch, "rank=1,site=allreduce,after=1,kind=error")
    polls = [("allreduce", None)] * 3
    got, want = _inject_trace(faults, polls), _inject_trace(jfaults, polls)
    assert got == want and [g[0] is not None for g in got] == \
        [False, True, True]


def test_no_spec_costs_one_load():
    assert not faults.active() and faults._plan is None
    faults.inject("allreduce", "x")
    assert faults.fleet_chaos() == [] and faults.control_chaos() == []
    assert not faults.drop_residual()


PROC = r'''
import sys
from horovod_tpu_torch import faults
faults.inject("allreduce", "t.0")
print("PASSED", flush=True)
faults.inject("allreduce", "t.1")
print("NOT_REACHED", flush=True)
'''


@pytest.mark.parametrize("kind,rc", [("crash", -9), ("exit:7", 7),
                                     ("hang", None)])
def test_the_terminal_kinds_end_the_process(kind, rc):
    env = dict(os.environ, PYTHONPATH=REPO,
               HOROVOD_FAULT_SPEC=f"rank=*,site=allreduce,after=1,"
                                  f"kind={kind}")
    p = subprocess.Popen([sys.executable, "-c", PROC], env=env, text=True,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    guard = threading.Timer(120, p.kill)    # bounds a wedged import too
    guard.start()
    try:
        first = p.stdout.readline()     # after the imports, the first pass
        try:
            p.wait(timeout=60 if rc is not None else 3)
            hung = False
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
            hung = True
        out, err = first + p.stdout.read(), p.stderr.read()
    finally:
        guard.cancel()
        p.stdout.close()
        p.stderr.close()
    assert hung == (rc is None), err
    if rc is not None:
        assert p.returncode == rc, err
    assert "PASSED" in out and "NOT_REACHED" not in out
    assert (f"horovod_tpu_torch.faults: firing kind={kind.split(':')[0]} "
            f"at site=allreduce (t.1) [launcher, hit 2]") in err


@pytest.mark.parametrize("spec", [
    "site=fleet,kind=preempt_storm:2",
    "site=fleet,after=4,kind=preempt_storm:1",
    "site=fleet,kind=host_flap",
    "site=fleet,kind=host_flap:3;site=fleet,after=1,kind=rank_kill",
    "site=*,kind=preempt_storm,count=3",
    "rank=0,site=fleet,kind=preempt_storm",
])
def test_fleet_chaos_returns_the_references_lists(spec, monkeypatch):
    _arm(monkeypatch, spec)
    assert [faults.fleet_chaos() for _ in range(12)] == \
        [jfaults.fleet_chaos() for _ in range(12)]


@pytest.mark.parametrize("spec", [
    "site=control,kind=msg_drop:2",
    "site=control,after=2,kind=msg_dup",
    "site=control,kind=msg_delay:40,count=3",
    "site=control,kind=partition:1.5;site=control,after=3,kind=coord_crash",
    "rank=1,site=control,kind=msg_drop,count=4",
    "site=*,kind=msg_delay",
])
def test_control_chaos_returns_the_references_lists(spec, monkeypatch):
    _arm(monkeypatch, spec)
    for rank in (None, 1, 0):
        assert [faults.control_chaos(rank) for _ in range(8)] == \
            [jfaults.control_chaos(rank) for _ in range(8)]


@pytest.mark.parametrize("spec", [
    "rank=*,site=compression,kind=residual_drop,after=3",
    "site=compression,kind=residual_drop:2,after=1",
    "rank=1,site=compression,kind=residual_drop,count=3",
])
def test_drop_residual_fires_at_the_references_steps(spec, monkeypatch):
    _arm(monkeypatch, spec)
    for rank in (1, 0):
        assert [faults.drop_residual(rank) for _ in range(8)] == \
            [jfaults.drop_residual(rank) for _ in range(8)]


def test_drop_residuals_zeroes_what_the_reference_zeroes():
    import jax.numpy as jnp

    from horovod_tpu.ops import compression as jcomp
    from horovod_tpu.parallel import data as jdata
    from horovod_tpu_torch.ops import compression as tcomp
    from horovod_tpu_torch.parallel import data as tdata

    rng = np.random.default_rng(3)
    rs = [rng.standard_normal(8).astype(np.float32), None,
          rng.standard_normal(4).astype(np.float32)]
    ag = [None, rng.standard_normal(6).astype(np.float32),
          rng.standard_normal(2).astype(np.float32)]
    fac = [rng.standard_normal((3, 2)).astype(np.float32), None, None]

    def j(xs):
        return [None if x is None else jnp.asarray(x) for x in xs]

    def t(xs):
        return [None if x is None else torch.from_numpy(x.copy())
                for x in xs]

    want, _ = jdata._drop_residuals(
        (jcomp.CodecState(j(rs), j(ag), j(fac)), ()))
    got = tdata._drop_residuals(tcomp.CodecState(t(rs), t(ag), t(fac)))
    for name in ("rs", "ag", "factors"):
        for a, b in zip(getattr(got, name), getattr(want, name)):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_the_compressed_step_drops_its_residuals_when_armed(
        world1, monkeypatch):
    """The replicated int8 step under ``residual_drop,after=1``: step 1's
    wire gets step 0's state with its residuals zeroed, and no other step
    is touched."""
    from horovod_tpu_torch.ops import compression as tcomp

    _arm(monkeypatch, "rank=*,site=compression,kind=residual_drop,after=1")
    torch.manual_seed(0)
    model = torch.nn.Linear(6, 3)
    events = []
    real_wire, real_zero = tcomp.compressed_allreduce, tcomp.zero_residuals

    def wire(grads, group, codec, plan, state, mean):
        events.append(("in", id(state)))
        out = real_wire(grads, group, codec, plan=plan, state=state,
                        mean=mean)
        events.append(("out", id(out[1])))
        return out

    def zero(state):
        out = real_zero(state)
        events.append(("zero", id(state), id(out)))
        return out

    monkeypatch.setattr(tcomp, "compressed_allreduce", wire)
    monkeypatch.setattr(tcomp, "zero_residuals", zero)
    step = world1.make_training_step(
        lambda m, b: ((m(b[0]) - b[1]) ** 2).mean(), model,
        torch.optim.SGD(model.parameters(), lr=0.1), compression="int8")
    step.init()
    x, y = torch.randn(4, 6), torch.randn(4, 3)
    for _ in range(3):
        step((x, y))
    kinds = [e[0] for e in events]
    assert kinds == ["in", "out", "zero", "in", "out", "in", "out"]
    assert events[2][1] == events[1][1]          # the drop: step 0's state
    assert events[3][1] == events[2][2]          # step 1: the zeroed one
    assert events[5][1] == events[4][1]          # step 2: step 1's state
    (rule,) = faults.load()
    assert rule._fired == 1
