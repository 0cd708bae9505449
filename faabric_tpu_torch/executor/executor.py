"""Executor: a host's execution engine for one function.

Counterpart of ``faabric_tpu/executor/executor.py`` (reference
src/executor/Executor.cpp:111-215 and :307-581). An executor is bound
to one function (user/function) and runs one batch at a time (claim and
release). It owns one worker thread with its task queue; the
scheduler claims one executor per message of a FUNCTIONS batch, so
each executor runs one task a batch. ``execute_task`` is what the
embedding runtime implements. A task that
raises reports FAILED with the error text in ``output_data``. The last
task of a batch returns the executor to its scheduler's warm pool.

FUNCTIONS batches only: the snapshot restore and dirty tracking of
THREADS batches (and with them the reference's pool of threads per
executor), and the migrated and frozen return paths, are not ported
(``ROADMAP.md`` Queue 1 #9).
"""

from __future__ import annotations

import threading
import time
from typing import TYPE_CHECKING, Optional

from faabric_tpu_torch.executor.context import ExecutorContext
from faabric_tpu_torch.proto import BatchExecuteRequest, Message, ReturnValue
from faabric_tpu_torch.util.logging import get_logger
from faabric_tpu_torch.util.queues import Queue

if TYPE_CHECKING:  # pragma: no cover
    from faabric_tpu_torch.scheduler.scheduler import Scheduler

logger = get_logger(__name__)

# Put on the worker thread's queue to end it; compared by identity
_SHUTDOWN = object()


class ExecutorTask:
    def __init__(self, msg_idx: int, req: BatchExecuteRequest) -> None:
        self.msg_idx = msg_idx
        self.req = req


class Executor:
    """Base executor; subclasses implement ``execute_task``."""

    def __init__(self, msg: Message) -> None:
        self.bound_msg = msg
        self.id = f"{msg.user}/{msg.function}-{msg.id}"
        self._task_queue = Queue()
        self._worker: Optional[threading.Thread] = None

        self._claimed = False
        self._claim_lock = threading.Lock()
        self.last_exec: float = time.monotonic()

        # Tasks outstanding in the current batch
        self._batch_lock = threading.Lock()
        self._tasks_outstanding = 0
        self._shutdown = False

        # Set by the scheduler right after the factory creates the
        # executor: host identity and the result path
        self.scheduler: Optional["Scheduler"] = None

    def execute_task(self, thread_pool_idx: int, msg_idx: int,
                     req: BatchExecuteRequest) -> int:
        raise NotImplementedError

    def reset(self, msg: Message) -> None:
        """Return the executor to a clean state between batches."""

    # ------------------------------------------------------------------
    # Claiming (reference Executor::tryClaim/releaseClaim)
    # ------------------------------------------------------------------
    def try_claim(self) -> bool:
        with self._claim_lock:
            if self._claimed:
                return False
            self._claimed = True
            return True

    def release_claim(self) -> None:
        with self._claim_lock:
            self._claimed = False

    def is_claimed(self) -> bool:
        with self._claim_lock:
            return self._claimed

    # ------------------------------------------------------------------
    # Batch execution
    # ------------------------------------------------------------------
    def execute_tasks(self, msg_idxs: list[int],
                      req: BatchExecuteRequest) -> None:
        logger.debug("%s executing %d/%d tasks of app %d", self.id,
                     len(msg_idxs), req.n_messages(), req.app_id)
        self.last_exec = time.monotonic()
        with self._batch_lock:
            self._tasks_outstanding += len(msg_idxs)
        if self._worker is None:
            self._worker = threading.Thread(
                target=self._worker_loop, name=f"executor/{self.id}",
                daemon=True)
            self._worker.start()
        for msg_idx in msg_idxs:
            self._task_queue.enqueue(ExecutorTask(msg_idx, req))

    def _worker_loop(self) -> None:
        while not self._shutdown:
            task = self._task_queue.dequeue()
            if task is _SHUTDOWN:
                return
            try:
                self._run_task(0, task)
            except Exception:  # noqa: BLE001 — a reporting failure must not
                # end the worker thread; the task's own error is its result
                logger.exception("%s result handling failed for task %d",
                                 self.id, task.msg_idx)

    def _run_task(self, pool_idx: int, task: ExecutorTask) -> None:
        req = task.req
        msg = req.messages[task.msg_idx]
        msg.executed_host = self.scheduler.host if self.scheduler else ""
        ExecutorContext.set(self, req, task.msg_idx)
        try:
            ret = self.execute_task(pool_idx, task.msg_idx, req)
        except Exception as e:  # noqa: BLE001 — guest errors become results
            logger.exception("%s task %d failed", self.id, msg.id)
            ret = int(ReturnValue.FAILED)
            msg.output_data = str(e).encode()
        finally:
            ExecutorContext.unset()
        msg.return_value = ret
        msg.finish_timestamp = time.time()
        self.last_exec = time.monotonic()

        with self._batch_lock:
            self._tasks_outstanding -= 1
            last_in_batch = self._tasks_outstanding == 0
        if self.scheduler is not None:
            self.scheduler.report_message_result(msg)
        # The last task of the batch returns the executor to the pool
        # (reference Executor.cpp:520-570)
        if last_in_batch:
            self.reset(self.bound_msg)
            self.release_claim()
            if self.scheduler is not None:
                self.scheduler.notify_executor_idle(self)

    def shutdown(self) -> None:
        self._shutdown = True
        if self._worker is not None:
            self._task_queue.enqueue(_SHUTDOWN)
            self._worker.join(timeout=2.0)
            self._worker = None

    def uptime_idle(self) -> float:
        return time.monotonic() - self.last_exec
