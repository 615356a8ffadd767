"""The eager-op deadline (``HOROVOD_EAGER_OP_TIMEOUT``) and its watchdog
(``HOROVOD_EAGER_OP_WARN_SECONDS``), on the CPU.

* One ``python -m horovod_tpu.runner -np 2`` job under a 3 s deadline:
  rank 1 submits nothing until rank 0 has given up, so rank 0's wait on
  ``stalled`` raises ``EagerStallError`` in both packages (the
  reference's native plane, as ``tests/test_chaos.py:114-140`` drives
  it, then the port), within the deadline plus a margin of 2 s.  The port's message is the
  reference's word for word, less the notes of the parts the port does
  not have (the eager chunk size, the transport, the schedule check).
  Rank 0 gave ``stalled`` to ``allreduce_`` in place: when rank 1
  finally submits it, the collective completes on both ranks and rank
  0's tensor is left as it was, and a later op works.
* A 2-rank job of the port alone without the deadline and with a 1 s
  warning: rank 0 waits 3.5 s for its peer without an error, and the
  watchdog warns about the op while it waits, again each interval,
  naming it and the missing rank.
"""

import re

import numpy as np
import pytest

from torch_support import run_job, run_port_job

DEADLINE = 3.0
MARGIN = 2.0

STALL = r'''
import os
import sys
import time

import numpy as np
import torch

import horovod_tpu as jhvd
import horovod_tpu_torch as thvd
from horovod_tpu.native.runtime import EagerStallError as JStall
from horovod_tpu_torch.native.runtime import EagerStallError

out_dir = sys.argv[1]
jhvd.init()
thvd.init(device="cpu")
r = thvd.rank()
out = {}
thvd.allreduce(torch.ones(1), name="start")
if r == 0:
    for pkg, run in (
            ("ref", lambda: jhvd.allreduce(np.ones(2, np.float32),
                                           op=jhvd.Sum, name="stalled")),
            ("port", lambda: thvd.allreduce_(x, op=thvd.Sum,
                                             name="stalled"))):
        x = torch.full((2,), 5.0)
        t0 = time.monotonic()
        try:
            run()
            out[f"{pkg}/msg"] = np.array("no error")
        except (JStall, EagerStallError) as e:
            out[f"{pkg}/msg"] = np.array(str(e))
            out[f"{pkg}/type"] = np.array(type(e).__name__)
        out[f"{pkg}/seconds"] = np.array(time.monotonic() - t0)
    # Waits without a bound from here on, so the peer may be late.
    thvd.basics.runtime().op_timeout = None
    jhvd.basics._state.runtime._op_timeout = None
    out["port/x_before"] = x.numpy().copy()
    open(f"{out_dir}/raised", "w").close()
else:
    # Late on purpose: until rank 0 has given up on both packages' waits.
    end = time.monotonic() + 60
    while not os.path.exists(f"{out_dir}/raised") and time.monotonic() < end:
        time.sleep(0.05)
    jhvd.allreduce(np.ones(2, np.float32), op=jhvd.Sum, name="stalled")
    x = torch.full((2,), 1.0)
    out["port/late"] = thvd.allreduce_(x, op=thvd.Sum,
                                       name="stalled").numpy()
out["sync"] = thvd.allreduce(torch.ones(2), op=thvd.Sum,
                             name="sync").numpy()
jhvd.allreduce(np.ones(1, np.float32), name="sync")
if r == 0:
    out["port/x_after"] = x.numpy()
    out["port/pending"] = np.array(thvd.basics.runtime().queue.num_pending())
np.savez(f"{out_dir}/rank{r}.npz", **out)
thvd.shutdown()
jhvd.shutdown()
'''


@pytest.fixture(scope="module")
def stall(tmp_path_factory):
    return run_job(STALL, str(tmp_path_factory.mktemp("deadline")), np_=2,
                   env={"HOROVOD_EAGER_OP_TIMEOUT": str(DEADLINE)})


def _without_missing_parts(msg: str) -> str:
    """The reference's report less its chunk-size, transport and
    schedule-check notes, and with the seconds blanked."""
    msg = re.sub(r", chunk_bytes=-?\d+", "", msg)
    msg = re.sub(r" Active transport backends: .*?(?= If a divergent|$)",
                 "", msg)
    msg = re.sub(r" If a divergent submission order is suspected.*$", "",
                 msg)
    return re.sub(r"after \d+\.\ds", "after _s", msg)


def test_a_missing_rank_trips_the_deadline_as_in_the_reference(stall):
    r0 = stall[0]
    for pkg in ("ref", "port"):
        assert str(r0[f"{pkg}/type"]) == "EagerStallError", r0[f"{pkg}/msg"]
        assert DEADLINE <= float(r0[f"{pkg}/seconds"]) < DEADLINE + MARGIN
    msg = str(r0["port/msg"])
    assert msg.startswith("Stalled eager op 'stalled': submitted by rank 0 "
                          "but not completed after 3."), msg
    assert "suspected missing ranks: [1]" in msg
    assert msg.endswith("Active control-plane config: cycle_time=1.00ms, "
                        "fusion_threshold=67108864 bytes."), msg
    assert (re.sub(r"after \d+\.\ds", "after _s", msg)
            == _without_missing_parts(str(r0["ref/msg"])))


def test_a_late_completion_leaves_the_callers_tensor_alone(stall):
    r0, r1 = stall
    np.testing.assert_array_equal(r0["port/x_before"], [5.0, 5.0])
    np.testing.assert_array_equal(r0["port/x_after"], [5.0, 5.0])
    # Rank 1's in-place call got the sum, so rank 0's late entry ran.
    np.testing.assert_array_equal(r1["port/late"], [6.0, 6.0])
    assert int(r0["port/pending"]) == 0
    for res in (r0, r1):
        np.testing.assert_array_equal(res["sync"], [2.0, 2.0])


WATCH = r'''
import logging
import sys
import time

import numpy as np
import torch

import horovod_tpu_torch as thvd

out_dir = sys.argv[1]
thvd.init(device="cpu")
r = thvd.rank()
records = []


class Keep(logging.Handler):
    def emit(self, record):
        records.append(record.getMessage())


logging.getLogger("horovod_tpu_torch.runtime").addHandler(Keep())
thvd.allreduce(torch.ones(1), name="start")
if r == 1:
    time.sleep(3.5)
t0 = time.monotonic()
got = thvd.allreduce(torch.ones(2), op=thvd.Sum, name="slow")
np.savez(f"{out_dir}/rank{r}.npz", got=got.numpy(),
         seconds=np.array(time.monotonic() - t0),
         timeout=np.array(str(thvd.basics.runtime().op_timeout)),
         log=np.array("\n".join(records)))
thvd.shutdown()
'''


def test_without_a_deadline_the_wait_is_unbounded_and_the_watchdog_warns(
        tmp_path):
    (r0, r1), _ = run_port_job(WATCH, str(tmp_path), env={
        "HOROVOD_EAGER_OP_WARN_SECONDS": "1"})
    for res in (r0, r1):
        np.testing.assert_array_equal(res["got"], [2.0, 2.0])
        assert str(res["timeout"]) == "None"
    assert float(r0["seconds"]) > 3.0
    warnings = [line for line in str(r0["log"]).split("\n")
                if line.startswith("Stalled eager op 'slow': submitted by "
                                   "rank 0")]
    assert len(warnings) >= 2, r0["log"]
    assert "suspected missing ranks: [1]" in warnings[0]
