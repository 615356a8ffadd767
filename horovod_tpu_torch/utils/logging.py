"""The port's logger, read from the environment as the reference's is.

Counterpart of ``horovod_tpu/utils/logging.py``: ``HOROVOD_LOG_LEVEL``
(``trace``, ``debug``, ``info``, ``warning``, ``error``, ``fatal`` or
``none``; default ``warning``) sets the level of the ``horovod_tpu_torch``
root logger, and ``HOROVOD_LOG_HIDE_TIME=1`` drops the timestamp from
its one stderr handler's format.  ``TRACE`` (5) is a real level below
DEBUG, with ``Logger.trace``.  The root does not propagate, so a record
prints once however the application configures Python's root logger.
The two variables are read here from ``os.environ``, not through
:mod:`horovod_tpu_torch.config`, which logs through this module.
"""

from __future__ import annotations

import logging
import os
import sys

TRACE = 5
logging.addLevelName(TRACE, "TRACE")


def _trace(self, msg, *args, **kwargs):
    if self.isEnabledFor(TRACE):
        self._log(TRACE, msg, args, **kwargs)


if not hasattr(logging.Logger, "trace"):
    logging.Logger.trace = _trace

_LEVELS = {
    "trace": TRACE,
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "fatal": logging.CRITICAL,
    "none": logging.CRITICAL + 10,
}

ROOT = "horovod_tpu_torch"

_configured = False


def _configure() -> None:
    global _configured
    if _configured:
        return
    level_name = os.environ.get("HOROVOD_LOG_LEVEL", "warning").lower()
    level = _LEVELS.get(level_name, logging.WARNING)
    hide_time = os.environ.get("HOROVOD_LOG_HIDE_TIME", "0") == "1"
    fmt = "[%(levelname).1s %(name)s] %(message)s" if hide_time else \
          "[%(asctime)s.%(msecs)03d %(levelname).1s %(name)s] %(message)s"
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(logging.Formatter(fmt, datefmt="%Y-%m-%d %H:%M:%S"))
    root = logging.getLogger(ROOT)
    root.addHandler(handler)
    root.setLevel(level)
    root.propagate = False
    _configured = True


def get_logger(name: str) -> logging.Logger:
    """The logger ``name`` under the ``horovod_tpu_torch`` root (the
    prefix is added when ``name`` lacks it)."""
    _configure()
    if not name.startswith(ROOT):
        name = f"{ROOT}.{name}"
    return logging.getLogger(name)
