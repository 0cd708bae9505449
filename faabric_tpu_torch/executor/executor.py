"""Executor: a host's execution engine for one function.

Counterpart of ``faabric_tpu/executor/executor.py`` (reference
src/executor/Executor.cpp:111-215 executeTasks, :307-581
threadPoolThread). An executor is bound to one function (user/function)
and runs one batch at a time (claim and release). It owns a pool of
``get_usable_cores()`` threads with a task queue each; a task goes to
pool thread ``msg_idx % pool_size``, so a THREADS batch of up to that
many threads runs one a thread. ``execute_task`` is what the embedding
runtime implements. A task that raises reports FAILED with the error
text in ``output_data``; each result carries its queue and run times
in ``int_exec_graph_details`` (``queue_us``, ``exec_us``), which
``util/exec_graph.py::node_timing`` reads.

A THREADS batch spread over several hosts restores the executor's
memory (``restore``, ``get_memory_view``, ``set_memory_size``) from the
main thread's snapshot and tracks dirty pages: a batch-level bracket,
and a thread-local one around each task whose page flags are OR-ed
into the batch's before the outstanding count drops. The last thread
of a host diffs the memory against the snapshot over those pages and
reports every thread's result with the diffs through the scheduler's
``report_thread_result``. The last task of a batch returns the
executor to its scheduler's warm pool; a THREADS batch keeps its
memory (no ``reset``). Chained calls are recorded per executor
(``add_chained_message``).

Telemetry, as the reference's: each task passes the ``executor.run``
fault point (a ``raise`` rule fails it like a guest error), runs in an
``executor``/``execute_task`` span while tracing, is stamped into its
message's lifecycle ledger (queue exit, run start and end), and goes
into the queue-wait and run histograms; a guest exception is
flight-recorded and dumps the ring.

Not ported: the migrated and frozen return paths with their exceptions
(``ROADMAP.md`` Queue 1 #7 part C).
"""

from __future__ import annotations

import threading
import time
from typing import TYPE_CHECKING, Optional

import numpy as np

from faabric_tpu_torch.executor.context import ExecutorContext
from faabric_tpu_torch.faults import fault_point, faults_enabled
from faabric_tpu_torch.proto import (
    BatchExecuteRequest,
    BatchExecuteType,
    Message,
    ReturnValue,
)
from faabric_tpu_torch.telemetry import (
    NULL_SPAN,
    get_lifecycle,
    get_metrics,
    span,
    tracing_enabled,
)
from faabric_tpu_torch.telemetry.lifecycle import (
    PHASE_EXEC_QUEUE_EXIT,
    PHASE_RUN_END,
    PHASE_RUN_START,
)
from faabric_tpu_torch.util.config import get_system_config
from faabric_tpu_torch.util.logging import get_logger
from faabric_tpu_torch.util.queues import Queue

if TYPE_CHECKING:  # pragma: no cover
    from faabric_tpu_torch.scheduler.scheduler import Scheduler

logger = get_logger(__name__)

# Put on a pool thread's queue to end it; compared by identity
_SHUTDOWN = object()

_FAULTS = faults_enabled()
_FP_RUN = fault_point("executor.run")

_LC = get_lifecycle()

_metrics = get_metrics()
_QUEUE_WAIT_SECONDS = _metrics.histogram(
    "faabric_executor_queue_wait_seconds",
    "Task time spent queued before a pool thread picked it up")
_RUN_SECONDS = _metrics.histogram(
    "faabric_executor_run_seconds",
    "Guest execute_task run time")
_TASKS_TOTAL = _metrics.counter(
    "faabric_executor_tasks_total", "Tasks executed")


class ExecutorTask:
    def __init__(self, msg_idx: int, req: BatchExecuteRequest) -> None:
        self.msg_idx = msg_idx
        self.req = req
        self.enqueue_ts = time.monotonic()


def _merge_dirty_flags(acc: Optional[np.ndarray],
                       new: np.ndarray) -> np.ndarray:
    """OR page-flag arrays that may differ in length (memory grown
    mid-batch: the pages one thread has not seen count as dirty)."""
    if acc is None:
        return new
    if acc.size == new.size:
        return acc | new
    n, m = max(acc.size, new.size), min(acc.size, new.size)
    out = np.ones(n, dtype=bool)
    out[:m] = acc[:m] | new[:m]
    return out


class Executor:
    """Base executor; subclasses implement ``execute_task`` and, for
    THREADS batches, the memory hooks."""

    def __init__(self, msg: Message) -> None:
        self.bound_msg = msg
        self.id = f"{msg.user}/{msg.function}-{msg.id}"

        self.pool_size = get_system_config().get_usable_cores()
        self._task_queues: dict[int, Queue] = {}
        self._pool_threads: dict[int, threading.Thread] = {}

        self._claimed = False
        self._claim_lock = threading.Lock()
        self.last_exec: float = time.monotonic()

        # Tasks outstanding in the current batch
        self._batch_lock = threading.Lock()
        self._tasks_outstanding = 0

        self._chained_lock = threading.Lock()
        self._chained_messages: dict[int, Message] = {}

        self._shutdown = False

        # Set by the scheduler right after the factory creates the
        # executor: host identity, registries and the result path
        self.scheduler: Optional["Scheduler"] = None

        # A multi-host THREADS batch's snapshot state (execute_tasks)
        self._batch_snapshot_key = ""
        self._batch_tracker = None
        self._batch_dirty: Optional[np.ndarray] = None  # OR of threads'
        self._batch_hints = None  # (offset, length) write extents or None

    def _region_hints_for(self, snapshot_key: str):
        """The snapshot's merge regions as write-extent hints, when
        ``DIRTY_REGION_HINTS`` promises that guests write only inside
        declared regions and those cover under half the image."""
        if not get_system_config().dirty_region_hints:
            return None
        registry = getattr(self.scheduler, "snapshot_registry", None)
        snap = (None if registry is None
                else registry.try_get_snapshot(snapshot_key))
        if snap is None:
            return None
        regions = snap.get_merge_regions()
        # Regions that cover most of the image (after an earlier batch's
        # fill_gaps_with_bytewise_regions, say) bracket slower as hints
        # than plain tracking does
        if not regions or 2 * sum(r.length for r in regions) >= snap.size:
            return None
        return [(r.offset, r.length) for r in regions]

    # ------------------------------------------------------------------
    # Virtual hooks (reference Executor.h:60-104)
    # ------------------------------------------------------------------
    def execute_task(self, thread_pool_idx: int, msg_idx: int,
                     req: BatchExecuteRequest) -> int:
        raise NotImplementedError

    def reset(self, msg: Message) -> None:
        """Return the executor to a clean state between batches."""

    def restore(self, snapshot_key: str) -> None:
        """Copy a snapshot from the host's registry into this executor's
        memory, grown to its size (reference Executor.cpp:640-654)."""
        registry = getattr(self.scheduler, "snapshot_registry", None)
        if registry is None:
            return
        snap = registry.get_snapshot(snapshot_key)
        self.set_memory_size(snap.size)
        mem = self.get_memory_view()
        if mem is not None:
            snap.map_to_memory(mem)

    def get_memory_view(self):
        return None

    def set_memory_size(self, size: int) -> None:
        pass

    def get_max_memory_size(self) -> int:
        return 0

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

        # A THREADS batch over several hosts restores from the main
        # thread's snapshot before any task runs, and tracks dirty pages
        # so that its writes merge back as diffs (reference
        # Executor.cpp:137-160)
        self._batch_snapshot_key = ""
        self._batch_tracker = None
        self._batch_dirty = None
        if (req.type == int(BatchExecuteType.THREADS) and not req.single_host
                and req.snapshot_key):
            self.restore(req.snapshot_key)
            # Fetched after restore: set_memory_size may replace the buffer
            mem = self.get_memory_view()
            if mem is not None:
                from faabric_tpu_torch.util.dirty import make_dirty_tracker

                self._batch_snapshot_key = req.snapshot_key
                self._batch_tracker = make_dirty_tracker()
                self._batch_hints = self._region_hints_for(req.snapshot_key)
                self._batch_tracker.start_tracking(
                    mem, region_hints=self._batch_hints)

        with self._batch_lock:
            self._tasks_outstanding += len(msg_idxs)
        for msg_idx in msg_idxs:
            self._enqueue(msg_idx % self.pool_size, ExecutorTask(msg_idx, req))

    def _enqueue(self, pool_idx: int, task: ExecutorTask) -> None:
        if pool_idx not in self._task_queues:
            self._task_queues[pool_idx] = Queue()
            t = threading.Thread(
                target=self._pool_thread_loop, args=(pool_idx,),
                name=f"executor/pool@{self.id}-{pool_idx}", daemon=True)
            self._pool_threads[pool_idx] = t
            t.start()
        self._task_queues[pool_idx].enqueue(task)

    def _pool_thread_loop(self, pool_idx: int) -> None:
        q = self._task_queues[pool_idx]
        while not self._shutdown:
            task = q.dequeue()
            if task is _SHUTDOWN:
                return
            try:
                self._run_task(pool_idx, task)
            except Exception:  # noqa: BLE001 — a reporting failure must not
                # end the pool thread; the task's own error is its result
                logger.exception("%s result handling failed for task %d",
                                 self.id, task.msg_idx)

    def _run_task(self, pool_idx: int, task: ExecutorTask) -> None:
        req = task.req
        msg = req.messages[task.msg_idx]
        is_threads = req.type == int(BatchExecuteType.THREADS)
        msg.executed_host = self.scheduler.host if self.scheduler else ""
        # The pool thread has the task
        _LC.stamp(msg, PHASE_EXEC_QUEUE_EXIT)
        queue_wait = time.monotonic() - task.enqueue_ts
        _QUEUE_WAIT_SECONDS.observe(queue_wait)

        # Thread-local tracking brackets the task, so that each thread
        # reports only its own writes (reference Executor.cpp:464-476)
        tracker = self._batch_tracker
        mem = self.get_memory_view() if tracker is not None else None
        if mem is not None:
            tracker.start_thread_local_tracking(
                mem, region_hints=self._batch_hints)

        ExecutorContext.set(self, req, task.msg_idx)
        _LC.stamp(msg, PHASE_RUN_START)
        run_t0 = time.monotonic()
        try:
            if _FAULTS:
                # delay rules make stragglers; raise rules fail the task
                # (folded into its result below)
                _FP_RUN.fire(function=f"{msg.user}/{msg.function}",
                             msg_id=msg.id)
            with span("executor", "execute_task", msg_id=msg.id,
                      function=f"{msg.user}/{msg.function}") \
                    if tracing_enabled() else NULL_SPAN:
                ret = self.execute_task(pool_idx, task.msg_idx, req)
        except Exception as e:  # noqa: BLE001 — guest errors become results
            logger.exception("%s task %d failed", self.id, msg.id)
            ret = int(ReturnValue.FAILED)
            msg.output_data = str(e).encode()
            # The guest exception triggers a flight dump: the ring's
            # recent sends and faults are the context a stack trace
            # lacks. Recording must never replace the FAILED result
            try:
                from faabric_tpu_torch.telemetry import (
                    flight_dump,
                    flight_record,
                )

                flight_record("executor_exception", msg_id=msg.id,
                              function=f"{msg.user}/{msg.function}",
                              error=str(e)[:200])
                flight_dump("executor_exception")
            except Exception:  # noqa: BLE001
                logger.exception("Flight dump on task failure failed")
        finally:
            ExecutorContext.unset()
        _LC.stamp(msg, PHASE_RUN_END)
        run_seconds = time.monotonic() - run_t0
        _RUN_SECONDS.observe(run_seconds)
        _TASKS_TOTAL.inc()
        msg.return_value = ret
        msg.finish_timestamp = time.time()
        msg.int_exec_graph_details["queue_us"] = int(queue_wait * 1e6)
        msg.int_exec_graph_details["exec_us"] = int(run_seconds * 1e6)
        self.last_exec = time.monotonic()

        # Each thread's pages join the batch's BEFORE the outstanding
        # count drops: the decrement elects the last thread, which must
        # see every other thread's pages when it diffs (reference
        # Executor.cpp:684-737 mergeDirtyRegions)
        if is_threads and mem is not None:
            tracker.stop_thread_local_tracking(mem)
            dirty = tracker.get_thread_local_dirty_pages(mem)
            with self._batch_lock:
                self._batch_dirty = _merge_dirty_flags(self._batch_dirty,
                                                       dirty)
        with self._batch_lock:
            self._tasks_outstanding -= 1
            last_in_batch = self._tasks_outstanding == 0

        # A THREADS result carries its host's diffs to the main host (the
        # last thread computes them once); any other reports to the planner
        if self.scheduler is not None:
            if is_threads:
                diffs = (self._batch_diffs(mem)
                         if last_in_batch and mem is not None else None)
                self.scheduler.report_thread_result(
                    msg, ret, self._batch_snapshot_key, diffs)
            else:
                self.scheduler.report_message_result(msg)

        # The last task of the batch returns the executor to the pool
        # (reference Executor.cpp:520-570)
        if last_in_batch:
            if is_threads and self._batch_tracker is not None:
                # Retire the batch bracket now, not at the next batch: a
                # write-fault tracker would leave pages protected
                view = mem if mem is not None else self.get_memory_view()
                if view is not None:
                    self._batch_tracker.stop_tracking(view)
                self._batch_tracker = None
            if not is_threads:
                self.reset(self.bound_msg)
            self.release_claim()
            if self.scheduler is not None:
                self.scheduler.notify_executor_idle(self)

    def _batch_diffs(self, mem):
        """The host's diffs of the batch against its snapshot, over the
        threads' dirty pages; None without a snapshot or pages."""
        registry = getattr(self.scheduler, "snapshot_registry", None)
        if registry is None or not self._batch_snapshot_key:
            return None
        snap = registry.try_get_snapshot(self._batch_snapshot_key)
        with self._batch_lock:
            batch_dirty = self._batch_dirty
        if snap is None or batch_dirty is None:
            return None
        # Writes outside the declared merge regions must not vanish
        # (reference Executor.cpp:713)
        snap.fill_gaps_with_bytewise_regions()
        return snap.diff_with_dirty_regions(mem, batch_dirty)

    # ------------------------------------------------------------------
    # Chained messages (reference Executor::getChainedMessage)
    # ------------------------------------------------------------------
    def add_chained_message(self, msg: Message) -> None:
        with self._chained_lock:
            self._chained_messages[msg.id] = msg

    def get_chained_message(self, msg_id: int) -> Message:
        with self._chained_lock:
            return self._chained_messages[msg_id]

    def get_chained_message_ids(self) -> list[int]:
        with self._chained_lock:
            return list(self._chained_messages)

    # ------------------------------------------------------------------
    def shutdown(self) -> None:
        self._shutdown = True
        for q in self._task_queues.values():
            q.enqueue(_SHUTDOWN)
        for t in self._pool_threads.values():
            t.join(timeout=2.0)
        self._pool_threads.clear()
        self._task_queues.clear()

    def uptime_idle(self) -> float:
        return time.monotonic() - self.last_exec
