"""The port's logger (``horovod_tpu_torch/utils/logging.py``) held against
the reference's ``horovod_tpu/utils/logging.py``.

The configuration is process-wide (one handler on the package's root
logger, set up at the first ``get_logger``), so each case runs in a
subprocess under its own ``HOROVOD_LOG_LEVEL`` and
``HOROVOD_LOG_HIDE_TIME``.  There both packages must give the same
level, format, handler count, propagation and ``TRACE`` behaviour, and
the same lines for the same calls (timestamps and the root's name
aside); a record prints once, never again through Python's root logger.
The reference's module is loaded from its file, which imports no JAX.
"""

import json
import os
import subprocess
import sys

import pytest

from torch_support import REPO

CASE = r'''
import importlib.util, io, json, logging, re, sys
rootbuf = io.StringIO()
logging.basicConfig(stream=rootbuf, level=logging.DEBUG)
spec = importlib.util.spec_from_file_location(
    "reference_logging", "horovod_tpu/utils/logging.py")
ref = importlib.util.module_from_spec(spec)
spec.loader.exec_module(ref)
from horovod_tpu_torch.utils import logging as port

out = {}
for mod, root in ((ref, "horovod_tpu"), (port, "horovod_tpu_torch")):
    log = mod.get_logger("serving.router")
    again = mod.get_logger(root + ".serving.router")
    top = logging.getLogger(root)
    (h,) = top.handlers
    buf = io.StringIO()
    h.setStream(buf)
    log.trace("trace %d", 1)
    log.debug("debug %s", "x")
    log.info("info")
    log.warning("warning")
    log.error("error")
    lines = [re.sub(r"^\[\d{4}-\d\d-\d\d \d\d:\d\d:\d\d\.\d{3} ", "[T ",
                    line).replace(root, "ROOT")
             for line in buf.getvalue().splitlines()]
    out[root] = {
        "name": log.name.replace(root, "ROOT"), "same": log is again,
        "level": top.level, "propagate": top.propagate,
        "fmt": h.formatter._fmt, "datefmt": h.formatter.datefmt,
        "TRACE": mod.TRACE,
        "trace_name": logging.getLevelName(mod.TRACE),
        "trace_on": log.isEnabledFor(mod.TRACE), "lines": lines,
    }
out["root_lines"] = rootbuf.getvalue()
print(json.dumps(out))
'''

CASES = [(None, None), ("Trace", "1"), ("debug", "0"), ("error", None),
         ("none", "1"), ("loud", "true")]


def _run(level, hide):
    env = dict(os.environ, PYTHONPATH=REPO)
    for var, value in (("HOROVOD_LOG_LEVEL", level),
                       ("HOROVOD_LOG_HIDE_TIME", hide)):
        env.pop(var, None)
        if value is not None:
            env[var] = value
    p = subprocess.run([sys.executable, "-c", CASE], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr[-4000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("level,hide", CASES)
def test_level_format_and_trace_match_the_reference(level, hide):
    out = _run(level, hide)
    ref, port = out["horovod_tpu"], out["horovod_tpu_torch"]
    assert port == ref
    assert out["root_lines"] == ""          # printed once, not propagated
    assert port["name"] == "ROOT.serving.router" and port["same"]
    assert port["TRACE"] == 5 and port["trace_name"] == "TRACE"
    assert not port["propagate"]
    want_level = {None: 30, "Trace": 5, "debug": 10, "error": 40,
                  "none": 60, "loud": 30}[level]
    assert port["level"] == want_level
    assert port["trace_on"] == (want_level <= 5)
    shown = {"trace": 5, "debug": 10, "info": 20, "warning": 30,
             "error": 40}
    assert [line.split("] ")[1].split()[0] for line in port["lines"]] == [
        w for w, lv in shown.items() if lv >= want_level]
    if hide == "1":
        assert port["fmt"] == "[%(levelname).1s %(name)s] %(message)s"
        if port["lines"]:
            assert port["lines"][-1] == "[E ROOT.serving.router] error"
    else:
        assert "%(asctime)s" in port["fmt"]
        if port["lines"]:
            assert port["lines"][-1].startswith("[T E ROOT.serving.router]")


def test_the_ports_modules_log_under_its_root():
    code = ("import horovod_tpu_torch.native.runtime as r, "
            "horovod_tpu_torch.checkpoint as c, horovod_tpu_torch.config as "
            "g, horovod_tpu_torch.models.transformer, logging\n"
            "root = logging.getLogger('horovod_tpu_torch')\n"
            "print(r.log.name, c.log.name, g.log.name, len(root.handlers),"
            " root.propagate)\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       env=dict(os.environ, PYTHONPATH=REPO),
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr[-4000:]
    assert p.stdout.split() == ["horovod_tpu_torch.runtime",
                                "horovod_tpu_torch.checkpoint",
                                "horovod_tpu_torch.config", "1", "False"]
