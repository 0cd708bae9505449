"""Periodic background work.

Counterpart of ``faabric_tpu/util/periodic.py``: ``start(interval)``
runs ``do_work()`` every interval seconds until ``stop()``, which wakes
the sleeper at once. The planner's expiry reaper, the worker's
keep-alive and the scheduler's executor reaper are these.
"""

from __future__ import annotations

import threading

from faabric_tpu_torch.util.logging import get_logger

logger = get_logger(__name__)


class PeriodicBackgroundThread:
    thread_name: str | None = None

    def __init__(self) -> None:
        self._thread: threading.Thread | None = None
        self._stop_event = threading.Event()
        self.interval: float = 0.0

    def do_work(self) -> None:
        raise NotImplementedError

    def start(self, interval_seconds: float) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self.interval = interval_seconds
        self._stop_event.clear()
        self._thread = threading.Thread(
            target=self._loop,
            name=self.thread_name or f"{type(self).__name__}-periodic",
            daemon=True,
        )
        self._thread.start()

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop_event.set()
        self._thread.join(timeout=5.0)
        if self._thread.is_alive():
            # do_work is stuck; the loop exits as soon as it returns
            logger.warning("%s did not stop within timeout",
                           type(self).__name__)
            return
        self._thread = None

    def _loop(self) -> None:
        while not self._stop_event.wait(self.interval):
            try:
                self.do_work()
            except Exception:  # noqa: BLE001 — periodic work must not die
                logger.exception("%s periodic work failed",
                                 type(self).__name__)
