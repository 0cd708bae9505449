"""Host-local scheduler.

Counterpart of ``faabric_tpu/scheduler/scheduler.py`` (reference
src/scheduler/Scheduler.cpp:250-386 executeBatch/claimExecutor and
:160-237 the reaper). Each worker host runs one. It takes the batches
the planner dispatches and claims a warm executor (creating one
through the factory when none is idle): one per message of a FUNCTIONS
or PROCESSES batch, one for every message of a THREADS batch, whose
threads share that executor's memory. Results go to the planner; a
THREADS result first queues its host's snapshot diffs on the main
host's snapshot (locally, or pushed over the snapshot RPC) and wakes
``await_thread_result`` there (:261-306). ``flush`` drops the warm
executors and runs the factory's ``flush_host``. Executors idle longer
than ``bound_timeout`` are reaped periodically. Instantiable per host
identity, so several hosts can run in one process.
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
from faabric_tpu_torch.snapshot.remote import SnapshotClient
from faabric_tpu_torch.transport.client_pool import ClientPool
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
        # MPI world registry, state KV and snapshot registry, which
        # guest code reaches through its context
        self.ptp_broker = None
        self.mpi_registry = None
        self.state = None
        self.snapshot_registry = None
        self._snapshot_clients = ClientPool(SnapshotClient)

        # THREADS results on this host: msg id → (return value, message)
        self._thread_results: dict[int, tuple[int, Message]] = {}
        self._thread_result_cv = threading.Condition()

    # ------------------------------------------------------------------
    # Lifecycle
    # ------------------------------------------------------------------
    def start(self) -> None:
        if self._started:
            return
        self._started = True
        self._reaper.start(get_system_config().reaper_interval_secs)

    def _drop_executors(self) -> None:
        with self._lock:
            executors = [e for lst in self._executors.values() for e in lst]
            self._executors.clear()
            self._idle.clear()
            self._parkable.clear()
        for e in executors:
            e.shutdown()

    def shutdown(self) -> None:
        self._reaper.stop()
        self._drop_executors()
        self._snapshot_clients.close_all()
        self._started = False

    def reset(self) -> None:
        """Test reset: drop executors and thread results, keep identity."""
        self.shutdown()
        with self._thread_result_cv:
            self._thread_results.clear()

    def flush(self) -> None:
        """Host flush (reference FunctionCallServer::recvFlush): drop the
        executors and run the factory's flush hook."""
        logger.debug("Flushing host %s", self.host)
        self._drop_executors()
        try:
            factory = get_executor_factory()
        except RuntimeError:
            return
        factory.flush_host()

    # ------------------------------------------------------------------
    # Batch execution (reference Scheduler.cpp:250-325)
    # ------------------------------------------------------------------
    def execute_batch(self, req: BatchExecuteRequest) -> None:
        if req.n_messages() == 0:
            return
        if req.type == int(BatchExecuteType.THREADS):
            # One executor runs every thread of the batch (shared memory)
            executor = self.claim_executor(req.messages[0])
            if executor is None:
                self._fail(req.messages, b"No executor available")
                return
            executor.execute_tasks(list(range(req.n_messages())), req)
            return
        # FUNCTIONS, PROCESSES: one executor per message
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

    def get_executor_count(self, msg: Message | None = None) -> int:
        with self._lock:
            if msg is not None:
                return len(self._executors.get(func_to_string(msg), []))
            return sum(len(v) for v in self._executors.values())

    # ------------------------------------------------------------------
    # Results
    # ------------------------------------------------------------------
    def report_message_result(self, msg: Message) -> None:
        self.planner_client.set_message_result(msg)

    def set_thread_result_locally(self, msg: Message,
                                  return_value: int) -> None:
        """Keep a thread's result on this host and wake its waiters
        (reference setThreadResultLocally; the SnapshotServer calls it
        when a remote thread's result arrives)."""
        with self._thread_result_cv:
            self._thread_results[msg.id] = (return_value, msg)
            self._thread_result_cv.notify_all()

    def report_thread_result(self, msg: Message, return_value: int,
                             snapshot_key: str = "", diffs=None) -> None:
        """A THREADS result. Its diffs queue on the main host's snapshot,
        locally when this is the main host and through its
        SnapshotServer otherwise, before the planner learns the result:
        a caller that awaits the results may then write the queued
        diffs (reference Executor::setThreadResult :271-305)."""
        main_host = msg.main_host or self.host
        if main_host == self.host:
            if diffs and snapshot_key and self.snapshot_registry is not None:
                snap = self.snapshot_registry.try_get_snapshot(snapshot_key)
                if snap is not None:
                    snap.queue_diffs(diffs)
            self.set_thread_result_locally(msg, return_value)
        else:
            try:
                self._snapshot_clients.get(main_host).push_thread_result(
                    msg.app_id, msg.id, return_value, snapshot_key,
                    diffs or [])
            except Exception:  # noqa: BLE001 — the planner must learn the
                # result even when the main host is unreachable
                logger.exception("Failed pushing thread result %d to %s",
                                 msg.id, main_host)
        self.planner_client.set_message_result(msg)

    def await_thread_result(self, msg_id: int,
                            timeout: float | None = None) -> int:
        """A thread's return value once its result is on this host;
        ``TimeoutError`` after ``timeout`` seconds (the global message
        timeout when None)."""
        if timeout is None:
            timeout = get_system_config().global_message_timeout
        with self._thread_result_cv:
            if not self._thread_result_cv.wait_for(
                    lambda: msg_id in self._thread_results, timeout=timeout):
                raise TimeoutError(
                    f"Timed out waiting for thread result {msg_id}")
            return self._thread_results[msg_id][0]
