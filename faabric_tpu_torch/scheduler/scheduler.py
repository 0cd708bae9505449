"""Host-local scheduler.

Counterpart of ``faabric_tpu/scheduler/scheduler.py`` (reference
src/scheduler/Scheduler.cpp:250-386 executeBatch/claimExecutor and
:160-237 the reaper). Each worker host runs one. It takes the batches
the planner dispatches, claims a warm executor per message (creating
one through the factory when none is idle), and reports each result to
the planner. Executors idle longer than ``bound_timeout`` are reaped
periodically.

FUNCTIONS batches only: a batch of another type reports FAILED for each
of its messages, with the reason, and runs nothing. Instantiable per
host identity, so several hosts can run in one process.
"""

from __future__ import annotations

import threading
from typing import TYPE_CHECKING, Optional

from faabric_tpu_torch.executor.executor import Executor
from faabric_tpu_torch.executor.factory import get_executor_factory
from faabric_tpu_torch.proto import (
    BatchExecuteRequest,
    BatchExecuteType,
    Message,
    ReturnValue,
    func_to_string,
)
from faabric_tpu_torch.util.config import get_system_config
from faabric_tpu_torch.util.logging import get_logger
from faabric_tpu_torch.util.periodic import PeriodicBackgroundThread

if TYPE_CHECKING:  # pragma: no cover
    from faabric_tpu_torch.planner.client import PlannerClient

logger = get_logger(__name__)


class ReaperThread(PeriodicBackgroundThread):
    """Reaps executors idle beyond bound_timeout."""

    thread_name = "scheduler/reaper"

    def __init__(self, scheduler: "Scheduler") -> None:
        super().__init__()
        self.scheduler = scheduler

    def do_work(self) -> None:
        self.scheduler.reap_idle_executors()


class Scheduler:
    def __init__(self, host: str, planner_client: "PlannerClient") -> None:
        self.host = host
        self.planner_client = planner_client

        self._lock = threading.RLock()
        # func string → executors (the warm pool)
        self._executors: dict[str, list[Executor]] = {}
        # func string → executors that announced idle: the claim
        # free-list. Entries may be stale (claimed through the scan, or
        # reaped); a failed try_claim drops them.
        self._idle: dict[str, list[Executor]] = {}
        # id()s of registered executors: only these may park as idle
        self._parkable: set[int] = set()

        self._reaper = ReaperThread(self)
        self._started = False

        # Set by the WorkerRuntime: this host's point-to-point broker,
        # MPI world registry and state KV, which guest code reaches
        # through its context
        self.ptp_broker = None
        self.mpi_registry = None
        self.state = None

    # ------------------------------------------------------------------
    # Lifecycle
    # ------------------------------------------------------------------
    def start(self) -> None:
        if self._started:
            return
        self._started = True
        self._reaper.start(get_system_config().reaper_interval_secs)

    def shutdown(self) -> None:
        self._reaper.stop()
        with self._lock:
            executors = [e for lst in self._executors.values() for e in lst]
            self._executors.clear()
            self._idle.clear()
            self._parkable.clear()
        for e in executors:
            e.shutdown()
        self._started = False

    # ------------------------------------------------------------------
    # Batch execution (reference Scheduler.cpp:250-325)
    # ------------------------------------------------------------------
    def execute_batch(self, req: BatchExecuteRequest) -> None:
        if req.type != int(BatchExecuteType.FUNCTIONS):
            self._fail(req.messages, (
                f"batch type {BatchExecuteType(req.type).name} is not "
                f"served by this host").encode())
            return
        # One executor per message
        for idx, msg in enumerate(req.messages):
            executor = self.claim_executor(msg)
            if executor is None:
                self._fail([msg], b"No executor available")
                continue
            executor.execute_tasks([idx], req)

    def _fail(self, msgs: list[Message], reason: bytes) -> None:
        for msg in msgs:
            msg.return_value = int(ReturnValue.FAILED)
            msg.output_data = reason
            self.report_message_result(msg)

    def claim_executor(self, msg: Message) -> Optional[Executor]:
        """Reuse a warm executor or create one through the factory
        (reference Scheduler.cpp:339-386)."""
        func = func_to_string(msg)
        with self._lock:
            idle = self._idle.get(func)
            while idle:
                e = idle.pop()
                if e.try_claim():
                    return e
            for e in self._executors.get(func, []):
                if e.try_claim():
                    return e
            try:
                factory = get_executor_factory()
            except RuntimeError:
                logger.error("No executor factory while claiming for %s",
                             func)
                return None
            executor = factory.create_executor(msg)
            executor.scheduler = self
            executor.try_claim()
            self._executors.setdefault(func, []).append(executor)
            self._parkable.add(id(executor))
            logger.debug("%s created executor %s (%d warm)", self.host,
                         executor.id, len(self._executors[func]))
            return executor

    def notify_executor_idle(self, executor: Executor) -> None:
        """The executor's batch drained: park it on the free-list, unless
        a shutdown dropped it meanwhile."""
        func = func_to_string(executor.bound_msg)
        with self._lock:
            if id(executor) in self._parkable:
                self._idle.setdefault(func, []).append(executor)

    def reap_idle_executors(self) -> None:
        timeout = get_system_config().bound_timeout
        to_shutdown: list[Executor] = []
        with self._lock:
            for func, lst in list(self._executors.items()):
                keep = []
                for e in lst:
                    if not e.is_claimed() and e.uptime_idle() > timeout:
                        to_shutdown.append(e)
                        self._parkable.discard(id(e))
                    else:
                        keep.append(e)
                if keep:
                    self._executors[func] = keep
                else:
                    self._executors.pop(func, None)
                if func in self._idle:
                    kept = set(map(id, keep))
                    self._idle[func] = [e for e in self._idle[func]
                                        if id(e) in kept]
        for e in to_shutdown:
            logger.debug("Reaping executor %s", e.id)
            e.shutdown()

    def report_message_result(self, msg: Message) -> None:
        self.planner_client.set_message_result(msg)
