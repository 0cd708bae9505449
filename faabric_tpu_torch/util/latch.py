"""Count-down latch.

The ``Latch`` of ``faabric_tpu/util/latch.py``: the RPC servers use it to
synchronise tests with request handling.
"""

from __future__ import annotations

import threading

DEFAULT_LATCH_TIMEOUT = 10.0


class LatchTimeoutException(Exception):
    pass


class Latch:
    """Count-down latch: ``count`` parties call wait(); all are released
    when the last arrives. Single-use."""

    def __init__(self, count: int,
                 timeout: float = DEFAULT_LATCH_TIMEOUT) -> None:
        self.count = count
        self.timeout = timeout
        self._waiters = 0
        self._cond = threading.Condition()

    def wait(self) -> None:
        with self._cond:
            self._waiters += 1
            if self._waiters > self.count:
                raise RuntimeError("Latch already used")
            if self._waiters == self.count:
                self._cond.notify_all()
                return
            if not self._cond.wait_for(
                    lambda: self._waiters >= self.count, self.timeout):
                raise LatchTimeoutException("Latch timed out")

