"""The stall inspector: names that some ranks submitted and others not.

Counterpart of ``horovod_tpu/native/cc/src/stall_inspector.cc``.  After
``HOROVOD_STALL_CHECK_TIME_SECONDS`` a pending name is logged with its
ready and missing ranks, at most one report per interval; after
``HOROVOD_STALL_SHUTDOWN_TIME_SECONDS`` (when above 0) the coordinator
answers the name with an error on every rank.  The clock is injectable
so the tests need not wait.
"""

from __future__ import annotations

import time
from typing import Callable, Sequence
from horovod_tpu_torch.utils.logging import get_logger

log = get_logger("horovod_tpu_torch.stall_inspector")


class StallInspector:
    def __init__(self, warn_s: float, shutdown_s: float,
                 clock: Callable[[], float] = time.monotonic):
        self.warn_s = warn_s
        self.shutdown_s = shutdown_s
        self.clock = clock
        self._last_report = clock()

    def check(self, name: str, submitted: Sequence[bool],
              first_seen: float) -> bool:
        """Warn about ``name`` when it has waited past the check time;
        True when it has waited past the shutdown time."""
        now = self.clock()
        age = now - first_seen
        if age < self.warn_s:
            return False
        if now - self._last_report >= self.warn_s:
            self._last_report = now
            ready = "".join(f"{r} " for r, s in enumerate(submitted) if s)
            missing = "".join(f"{r} " for r, s in enumerate(submitted)
                              if not s)
            log.warning(
                "One or more tensors were submitted to be reduced, gathered "
                "or broadcasted by subset of ranks and are waiting for "
                "remainder of ranks for more than %g seconds. Tensor: %s "
                "ready ranks: [%s] missing ranks: [%s]", self.warn_s, name,
                ready, missing)
        return self.shutdown_s > 0 and age >= self.shutdown_s
