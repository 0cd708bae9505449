"""Batched scheduling ticks: the planner's invocation path.

Counterpart of ``faabric_tpu/ingress/tick.py``. Batchable NEW
invocations accumulate in a queue, and a tick thread (period
``FAABRIC_PLANNER_TICK_MS``) hands the whole batch to
``Planner.call_batch_group``: one planner-lock pass, one host-map build
and expiry sweep, the decision cache as an admission fast path (a
repeated signature skips the policy), one group-commit journal record,
mappings batched per host and one EXECUTE_BATCHES dispatch per (host,
tick).

Immediate-path cutover: when the queue is idle a submission runs the
classic ``call_batch`` inline, so a lone invocation never waits out a
tick. The batched path engages once submissions overlap.

Backpressure with ``admission.py``: an invocation holds its admission
credits from ``try_admit`` until it resolves (scheduled, failed, or
shed at its deadline). When the cluster is out of slots the batch stays
queued (capacity frees as results land), and only the queue bound sheds
new arrivals. A queued invocation that outlives
``FAABRIC_INGRESS_QUEUE_TIMEOUT`` resolves as NOT_ENOUGH_SLOTS (a sync
waiter) or as FAILED results (a fire-and-forget submission, through
``Planner.fail_unscheduled``), so that no caller hangs on a full
cluster. Ineligible requests (anything but a plain NEW FUNCTIONS or
PROCESSES batch: MPI worlds, THREADS forks, migrations, scale changes,
preloaded or frozen apps) bypass the queue and take ``call_batch``.

Every deadline reads ``_clock`` (``time.monotonic``), which a test may
replace to move queue time without waiting for it.
"""

from __future__ import annotations

import threading
import time
from typing import TYPE_CHECKING, Optional

from faabric_tpu_torch.batch_scheduler.decision import (
    NOT_ENOUGH_SLOTS,
    SchedulingDecision,
    not_enough_slots_decision,
)
from faabric_tpu_torch.ingress.admission import (
    AdmissionController,
    IngressShedError,
)
from faabric_tpu_torch.telemetry import get_lifecycle, get_metrics
from faabric_tpu_torch.telemetry.lifecycle import (
    PHASE_ADMIT,
    PHASE_QUEUE_EXIT,
)
from faabric_tpu_torch.util.logging import get_logger

if TYPE_CHECKING:  # pragma: no cover
    from faabric_tpu_torch.planner.planner import Planner
    from faabric_tpu_torch.proto import BatchExecuteRequest

logger = get_logger(__name__)

_metrics = get_metrics()
_TICKS = _metrics.counter(
    "faabric_ingress_ticks_total",
    "Scheduling ticks that processed at least one queued invocation")
_TICK_BATCH = _metrics.histogram(
    "faabric_ingress_tick_batch_requests",
    "Queued invocation requests scheduled per tick")
_IMMEDIATE = _metrics.counter(
    "faabric_ingress_immediate_total",
    "Invocations that took the immediate (tickless) cutover path")
_BATCHED = _metrics.counter(
    "faabric_ingress_batched_total",
    "Invocations scheduled through a batched tick")
_QUEUE_WAIT = _metrics.histogram(
    "faabric_ingress_queue_wait_seconds",
    "Enqueue to decision latency for tick-batched invocations")

# The lifecycle ledger: the admission and queue-exit stamps ride the
# messages (a shared no-op while metrics are off)
_LC = get_lifecycle()

# Queue time: deadlines, waits and tick durations (a test may replace it)
_clock = time.monotonic


class _Pending:
    __slots__ = ("req", "source", "deadline", "shed_deadline", "event",
                 "result", "enq_ts", "wait")

    def __init__(self, req, source: str, deadline: float,
                 wait: bool, grace: float = 0.0) -> None:
        self.req = req
        self.source = source
        self.deadline = deadline
        # Ticks must not shed an entry its sync waiter would still
        # accept: the waiter only withdraws at deadline + its grace, so
        # shedding at the bare deadline would return spurious
        # NOT_ENOUGH_SLOTS from a busy (not full) cluster. Fire-and-
        # forget entries (grace=0) shed at the queue-timeout policy
        # deadline itself.
        self.shed_deadline = deadline + grace
        self.wait = wait
        self.event = threading.Event()
        self.result: Optional[SchedulingDecision] = None
        self.enq_ts = _clock()


class IngressCoordinator:
    """Admission + tick batching between the endpoints and the planner
    core. One per Planner; the tick thread starts lazily on the first
    batched submission and stops with the owning PlannerServer."""

    # Concurrency contract: the queue and the tick state under one leaf
    # lock, held only for list and dict ops; scheduling itself
    # (call_batch_group: the planner lock and the network) runs outside
    # it. The totals are guarded too, for a consistent stats()
    GUARDS = {
        "_queue": "_lock",
        "_inline": "_lock",
        "_tick_busy": "_lock",
        "_thread": "_lock",
        "_stop": "_lock",
        "_stopped": "_lock",
        "_immediate_total": "_lock",
        "_batched_total": "_lock",
        "_ticks": "_lock",
        "_last_tick_batch": "_lock",
        "_last_tick_s": "_lock",
    }

    # How long stop() waits for a tick stalled in the network
    STOP_JOIN_SECONDS = 5.0

    def __init__(self, planner: "Planner",
                 admission: AdmissionController | None = None) -> None:
        self._planner = planner
        self.admission = admission or AdmissionController()
        # The class prefix ``ingress/tick`` keeps the profiler's thread
        # classes stable; the ``@instance`` suffix lets a test or the
        # doctor tell this coordinator's thread from another's
        self._tick_name = f"ingress/tick@{id(self):x}"
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._queue: list[_Pending] = []
        self._inline = 0  # submissions currently on the immediate path
        self._tick_busy = False
        self._thread: Optional[threading.Thread] = None
        self._stop = False
        # Latched by stop(), cleared only by an explicit start():
        # submissions racing a server shutdown must shed, not silently
        # re-arm a fresh tick thread that dispatches into the closing
        # server (and outlives it)
        self._stopped = False
        self._immediate_total = 0
        self._batched_total = 0
        self._ticks = 0
        self._last_tick_batch = 0
        self._last_tick_s = 0.0

    # ------------------------------------------------------------------
    def submit(self, req: "BatchExecuteRequest", source: str = "",
               wait: bool = True,
               timeout: float | None = None) -> Optional[SchedulingDecision]:
        """Run one invocation through admission + the tick machinery.

        Returns the scheduling decision (``wait=True``) or ``None``
        after a successful enqueue (``wait=False`` — results flow back
        through the normal result plane). Raises ``IngressShedError``
        when admission sheds the invocation."""
        from faabric_tpu_torch.util.config import get_system_config

        # Ledger t0: everything entering the planner through the
        # ingress — batchable or not — stamps admit here
        _LC.stamp_many(req.messages, PHASE_ADMIT)

        # Shape check only — lock-free. Requests with existing planner
        # state (scale changes, thaws, preloads) that slip through are
        # deferred to the classic path by the tick's stateful re-check.
        if not self._planner.is_batchable_shape(req):
            return self._planner.call_batch(req)

        # concheck: ok(guard-unlocked) — latched flag, racy read by
        # design: the post-stop enqueue race is closed by the second
        # check under the lock below
        if self._stopped:
            raise IngressShedError(0.5, "ingress stopped")

        n = req.n_messages()
        verdict = self.admission.try_admit(source, n)
        if not verdict.admitted:
            raise IngressShedError(verdict.retry_after, verdict.reason)

        # Immediate-path cutover: with nothing queued and nothing in
        # flight, this invocation IS the tick — run it inline so a
        # single caller pays classic call_batch latency, not tick_ms.
        with self._lock:
            idle = (not self._queue and self._inline == 0
                    and not self._tick_busy)
            if idle:
                self._inline += 1
                self._immediate_total += 1
        if idle:
            try:
                # The queue was never entered: zero-wait queue exit
                _LC.stamp_many(req.messages, PHASE_QUEUE_EXIT)
                return self._planner.call_batch(req)
            finally:
                with self._lock:
                    self._inline -= 1
                self.admission.release(source, n)
                _IMMEDIATE.inc()

        conf = get_system_config()
        if timeout is None:
            timeout = conf.ingress_queue_timeout
        # The extra grace covers the scheduling latency of the tick
        # that fires the deadline (ticks run tens of ms under load).
        # Kept short: the RPC plane calls this with sub-second timeouts
        # from a small sync worker pool.
        grace = max(0.5, conf.planner_tick_ms / 100)
        pending = _Pending(req, source, _clock() + timeout, wait,
                           grace=grace)
        with self._lock:
            if self._stopped:
                self.admission.release(source, n)
                raise IngressShedError(0.5, "ingress stopped")
            self._queue.append(pending)
            self._ensure_thread_locked()
        if not wait:
            return None
        if not pending.event.wait(timeout + grace):
            # Timed out. If the request is still QUEUED, withdraw it —
            # returning NOT_ENOUGH_SLOTS while leaving it schedulable
            # would let a later tick dispatch work the caller already
            # gave up on (duplicate execution on retry). If a tick is
            # mid-flight with it, the decision is imminent and may
            # already be dispatched: wait it out rather than lie.
            with self._lock:
                withdrawn = pending in self._queue
                if withdrawn:
                    self._queue.remove(pending)
            if withdrawn:
                self.admission.release(source, n)
                return not_enough_slots_decision()
            # A tick holds the entry: its decision (or its deadline
            # shed — ticks pre-filter expired entries) is coming, and
            # the work may ALREADY be dispatched, so returning
            # NOT_ENOUGH_SLOTS here would invite a duplicating retry.
            # Wait it out up to the system-wide message timeout — a
            # tick stalled past that means a wedged planner, where the
            # caller's own RPC socket timeout governs anyway.
            pending.event.wait(max(
                conf.global_message_timeout,
                pending.deadline - _clock() + 1.0))
        result = pending.result
        if result is None:
            # The tick loop died or stop() raced us: resolve locally so
            # the caller never hangs (credits were released by whoever
            # removed us from the queue, or will be by stop()).
            return not_enough_slots_decision()
        return result

    def submit_many(self, reqs: list["BatchExecuteRequest"],
                    source: str = "") -> None:
        """Bulk fire-and-forget submission: admit the whole set under
        one credit grant (all-or-nothing) and enqueue every batchable
        request for the next tick; results flow back through the
        normal result plane. The rare non-batchable request in a bulk
        submission takes the classic synchronous path inline."""
        from faabric_tpu_torch.util.config import get_system_config

        for r in reqs:
            _LC.stamp_many(r.messages, PHASE_ADMIT)
        batchable: list = []
        direct: list = []
        for r in reqs:
            (batchable if self._planner.is_batchable_shape(r)
             else direct).append(r)
        # concheck: ok(guard-unlocked) — latched flag, racy read by
        # design; the enqueue below re-checks under the lock
        if self._stopped:
            raise IngressShedError(0.5, "ingress stopped")
        total = sum(r.n_messages() for r in batchable)
        if total:
            verdict = self.admission.try_admit(source, total)
            if not verdict.admitted:
                raise IngressShedError(verdict.retry_after, verdict.reason)
            deadline = (_clock()
                        + get_system_config().ingress_queue_timeout)
            pendings = [_Pending(r, source, deadline, wait=False)
                        for r in batchable]
            # Credits were granted as one block; release per-request as
            # each pending resolves — hand each its own share
            with self._lock:
                if self._stopped:
                    self.admission.release(source, total)
                    raise IngressShedError(0.5, "ingress stopped")
                self._queue.extend(pendings)
                self._ensure_thread_locked()
        for req in direct:
            # Fire-and-forget contract: the bulk was ACCEPTED, so every
            # request must reach a terminal state the submitter's
            # batch-status polls can see — a dropped NOT_ENOUGH_SLOTS
            # (or a raising call_batch) would leave its app finishing
            # never, and propagating the error would make the client
            # retry (and duplicate) the already-enqueued batchables.
            try:
                d = self._planner.call_batch(req)
                if d.app_id == NOT_ENOUGH_SLOTS:
                    self._planner.fail_unscheduled(
                        req, b"Shed: no capacity for non-batchable "
                        b"bulk submission")
            except Exception:  # noqa: BLE001
                logger.exception("Direct call_batch failed for bulk-"
                                 "submitted app %d", req.app_id)
                try:
                    self._planner.fail_unscheduled(
                        req, b"Bulk submission failed")
                except Exception:  # noqa: BLE001
                    logger.exception("Failing bulk app %d", req.app_id)

    # ------------------------------------------------------------------
    def _ensure_thread_locked(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop = False
        t = threading.Thread(target=self._tick_loop,
                             name=self._tick_name, daemon=True)
        self._thread = t
        t.start()

    def _tick_loop(self) -> None:
        from faabric_tpu_torch.util.config import get_system_config

        while True:
            tick_s = max(0.0005, get_system_config().planner_tick_ms
                         / 1000.0)
            self._wake.wait(tick_s)
            self._wake.clear()
            with self._lock:
                # Identity check, not just the flag: a stop() whose 5s
                # join expired on a network-stalled tick leaves this
                # thread a zombie, and a later start() + submission
                # resets _stop for its NEW thread — the zombie must see
                # it no longer owns the loop and exit, not resurrect.
                if self._stop or self._thread is not threading.current_thread():
                    return
                batch = self._queue
                self._queue = []
                self._tick_busy = bool(batch)
            if not batch:
                continue
            try:
                self._run_tick(batch)
            except Exception:  # noqa: BLE001 — a tick must never kill
                # the loop. Unresolved entries are FAILED, not requeued:
                # call_batch_group may have registered some of them
                # in-flight before raising (e.g. ENOSPC from the group
                # journal commit), and a re-run would classify those as
                # SCALE_CHANGE and dispatch the same messages twice.
                # fail_unscheduled no-ops for apps that did register —
                # they are in the same stranded-but-consistent state a
                # raising classic call_batch leaves behind.
                logger.exception("Ingress tick failed (%d requests)",
                                 len(batch))
                for pending in batch:
                    if pending.result is None:
                        self._shed_at_deadline(pending)
            finally:
                with self._lock:
                    self._tick_busy = False

    def _run_tick(self, batch: list[_Pending]) -> None:
        t0 = _clock()
        # Deadline pre-filter: an entry past its deadline must never be
        # scheduled — its sync waiter may already have given up with
        # NOT_ENOUGH_SLOTS, and dispatching it now would execute work
        # the caller believes was rejected (duplicate on retry).
        live: list[_Pending] = []
        expired = 0
        for pending in batch:
            if t0 >= pending.shed_deadline:
                self._shed_at_deadline(pending)
                expired += 1
            else:
                live.append(pending)
        batch = live
        if expired:
            logger.debug("Tick shed %d expired queue entr(ies) before "
                         "scheduling", expired)
        if not batch:
            return
        for pending in batch:
            _LC.stamp_many(pending.req.messages, PHASE_QUEUE_EXIT)
        results, deferred = self._planner.call_batch_group(
            [p.req for p in batch])
        backlog: list[_Pending] = []
        resolved = 0
        resolved_msgs = 0
        now = _clock()
        for i, pending in enumerate(batch):
            if i in deferred:
                # Raced out of batch eligibility (e.g. a scale-change
                # arriving as its app went in-flight): classic path.
                try:
                    d = self._planner.call_batch(pending.req)
                except Exception:  # noqa: BLE001
                    logger.exception("Deferred ingress call_batch failed "
                                     "(app %d)", pending.req.app_id)
                    d = not_enough_slots_decision()
                if d.app_id == NOT_ENOUGH_SLOTS and not pending.wait:
                    # Fire-and-forget contract: an unplaceable deferred
                    # submission still needs terminal results or its
                    # batch-status poller hangs forever
                    try:
                        self._planner.fail_unscheduled(
                            pending.req, b"Shed: deferred submission "
                            b"could not be scheduled")
                    except Exception:  # noqa: BLE001
                        logger.exception("Failing deferred app %d",
                                         pending.req.app_id)
                self._resolve(pending, d)
                resolved += 1
                resolved_msgs += pending.req.n_messages()
                continue
            decision = results[i]
            if decision is None:
                # No capacity this tick: requeue unless the deadline
                # passed — slots free as results land.
                if now >= pending.shed_deadline:
                    self._shed_at_deadline(pending)
                    resolved += 1
                    resolved_msgs += pending.req.n_messages()
                else:
                    backlog.append(pending)
                continue
            _QUEUE_WAIT.observe(now - pending.enq_ts)
            self._resolve(pending, decision)
            resolved += 1
            resolved_msgs += pending.req.n_messages()
        with self._lock:
            stopped = self._stopped
            if not stopped:
                # Backlog keeps FIFO order ahead of newer arrivals
                self._queue[:0] = backlog
            self._ticks += 1
            self._last_tick_batch = resolved
            self._last_tick_s = _clock() - t0
            self._batched_total += resolved
        if stopped:
            # stop() already drained the queue (its 5s join can expire
            # while a tick is stalled in network): re-inserting would
            # strand these entries with their credits in a latched-
            # closed coordinator — shed them like the rest
            for pending in backlog:
                self._shed_at_deadline(pending)
        _TICKS.inc()
        _TICK_BATCH.observe(resolved)
        _BATCHED.inc(resolved)
        if resolved_msgs:
            # MESSAGE count, not request count: admission depth and the
            # retry_after hint are accounted in messages
            self.admission.note_drained(resolved_msgs,
                                        _clock() - t0)

    def _resolve(self, pending: _Pending,
                 decision: SchedulingDecision) -> None:
        self.admission.release(pending.source, pending.req.n_messages())
        pending.result = decision
        pending.event.set()

    def _shed_at_deadline(self, pending: _Pending) -> None:
        """A queued invocation outlived its deadline without capacity:
        sync waiters get NOT_ENOUGH_SLOTS; fire-and-forget submissions
        get terminal FAILED results so batch-status pollers finish."""
        logger.warning(
            "Shedding app %d after %.1fs in the ingress queue (no "
            "capacity)", pending.req.app_id,
            _clock() - pending.enq_ts)
        if not pending.wait:
            try:
                self._planner.fail_unscheduled(
                    pending.req, b"Shed: no capacity within the ingress "
                    b"queue timeout")
            except Exception:  # noqa: BLE001
                logger.exception("Failing shed app %d", pending.req.app_id)
        self._resolve(pending, not_enough_slots_decision())

    # ------------------------------------------------------------------
    def start(self) -> None:
        """Re-arm a stopped coordinator (in-process PlannerServer
        start/stop cycles). The tick thread itself still starts lazily
        on the first batched submission."""
        with self._lock:
            self._stopped = False

    def stop(self) -> None:
        """Stop the tick thread, latch the coordinator closed (new
        submissions shed until start()), and resolve everything still
        queued as unschedulable — nothing will ever schedule it."""
        with self._lock:
            self._stop = True
            self._stopped = True
            thread = self._thread
            self._thread = None
        self._wake.set()
        if thread is not None and thread.is_alive():
            thread.join(timeout=self.STOP_JOIN_SECONDS)
        self.shed_all("ingress stopped")

    def shed_all(self, reason: str) -> None:
        """Resolve every queued entry as unschedulable (planner reset /
        shutdown). Fire-and-forget submissions additionally get
        terminal FAILED results — their submitters poll batch status
        and would otherwise hang on apps nobody will ever place."""
        with self._lock:
            drained = self._queue
            self._queue = []
        for pending in drained:
            logger.warning("Shedding queued app %d: %s",
                           pending.req.app_id, reason)
            if not pending.wait:
                try:
                    self._planner.fail_unscheduled(
                        pending.req, b"Shed: " + reason.encode())
                except Exception:  # noqa: BLE001
                    logger.exception("Failing shed app %d",
                                     pending.req.app_id)
            self._resolve(pending, not_enough_slots_decision())

    def last_tick_ms(self) -> float:
        """Duration of the most recent non-empty tick (time-series
        gauge: a tick trending toward the tick period is the planner
        saturating)."""
        with self._lock:
            return self._last_tick_s * 1000.0

    # ------------------------------------------------------------------
    def stats(self) -> dict:
        out = self.admission.stats()
        with self._lock:
            queued_msgs = sum(p.req.n_messages() for p in self._queue)
            out.update({
                "queuedRequests": len(self._queue),
                "queuedMessages": queued_msgs,
                "lastTickMs": round(self._last_tick_s * 1000.0, 3),
                "immediateTotal": self._immediate_total,
                "batchedTotal": self._batched_total,
                "ticks": self._ticks,
                "lastTickBatch": self._last_tick_batch,
                "avgTickOccupancy": (
                    round(self._batched_total / self._ticks, 2)
                    if self._ticks else 0.0),
                "tickThreadAlive": (self._thread is not None
                                    and self._thread.is_alive()),
            })
        return out
