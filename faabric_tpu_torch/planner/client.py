"""A worker host's planner client.

Counterpart of ``faabric_tpu/planner/client.py`` (reference
src/planner/PlannerClient.cpp) for the calls of the gang path:
registration with a keep-alive thread that re-registers every half
host-timeout (and rejoins as a boot when the planner no longer knows
the host), ``call_functions``, result pushes, and the blocking
``get_message_result``: it registers this host's interest, and the
planner pushes the result to the host's FunctionCallServer, which
resolves the local promise (:202-270). ``call_functions`` of a THREADS
batch makes this host the main host of its messages, defaults the
snapshot key to the main thread's, and pushes that snapshot whole to
the planner's SnapshotServer, from which the planner serves the other
hosts (:343-365). Mock mode records batch calls and results instead of
sending them.

Each keep-alive passes the ``keepalive`` fault point (``suppress``
skips it, so the planner expires a live host); a failed one and the
first after it are flight-recorded. A pushed result is stamped
``rsp`` and a woken local waiter ``wwk`` in the message's lifecycle
ledger.

``check_migration`` and ``get_num_migrations`` reach the planner's
migration path; ``relay_group_abort`` hands the planner a group abort
for the hosts this one could not reach (reference :770-793).

The result plane (reference :86-146, :173-750): result pushes coalesce,
so that one ``msgs`` frame carries whatever landed while a push was in
flight; a push the planner cannot take buffers locally (bounded by
count and bytes, oldest dropped) and drains through the confirmed
``FLUSH_RESULTS`` call; results pushed in the last 60 s are kept and
re-delivered when the planner may have lost them (a push that needed a
reconnect, a changed ``boot`` id, a ``known: false`` rejoin, the end of
an outage), the planner's first-write-wins dropping the ones that had
landed. The keep-alive never raises: it flushes, and after any of those
restart signals re-registers this host's interest in every result it
waits on, since a restarted planner replays results but not its waiter
map. A blocked ``get_message_result`` nudges the keep-alive to re-poll
its own id every half host timeout at first, doubling up to 240 s (a
push lost on a dead pooled connection fires no restart signal); a
client with no keep-alive thread gets no lost-push recovery. Waiters of
one id share its event and are counted, so that only the last to leave
unregisters it.

``submit_functions_many`` (reference :376-410) puts batches into the
planner's ingress queue with one SUBMIT_BATCH call and answer ``(accepted, retry_after)`` at once; the
results come back as any others do. ``preload_scheduling_decision``
records a decision the planner places an app's batches by.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from faabric_tpu_torch.batch_scheduler.decision import SchedulingDecision
from faabric_tpu_torch.faults import SUPPRESS, fault_point, faults_enabled
from faabric_tpu_torch.planner.server import PlannerCalls
from faabric_tpu_torch.proto import (
    BatchExecuteRequest,
    BatchExecuteRequestStatus,
    BatchExecuteType,
    Message,
    ber_to_wire,
    bers_to_wire,
    get_main_thread_snapshot_key,
    messages_from_wire,
    messages_to_wire,
)
from faabric_tpu_torch.snapshot.remote import SnapshotClient
from faabric_tpu_torch.telemetry import (
    flight_record,
    get_lifecycle,
    get_metrics,
)
from faabric_tpu_torch.telemetry.lifecycle import (
    PHASE_RESULT_PUSH,
    PHASE_WAITER_WAKE,
)
from faabric_tpu_torch.transport.client import MessageEndpointClient, RpcError
from faabric_tpu_torch.transport.common import (
    PLANNER_ASYNC_PORT,
    PLANNER_SYNC_PORT,
)
from faabric_tpu_torch.util.config import get_system_config
from faabric_tpu_torch.util.logging import get_logger
from faabric_tpu_torch.util.periodic import PeriodicBackgroundThread
from faabric_tpu_torch.util.testing import is_mock_mode

logger = get_logger(__name__)

_FAULTS = faults_enabled()
_FP_KEEPALIVE = fault_point("keepalive")

_LC = get_lifecycle()

_metrics = get_metrics()
_BUFFERED_RESULTS = _metrics.counter(
    "faabric_planner_client_buffered_results_total",
    "Results queued locally because the planner was unreachable")
_FLUSHED_RESULTS = _metrics.counter(
    "faabric_planner_client_flushed_results_total",
    "Buffered results delivered to the planner after reconnect")
_DROPPED_RESULTS = _metrics.counter(
    "faabric_planner_client_dropped_results_total",
    "Buffered results dropped because the outage queue overflowed")

# ---------------------------------------------------------------------------
# Mock recording
# ---------------------------------------------------------------------------
_mock_lock = threading.Lock()
_mock_batch_calls: list[BatchExecuteRequest] = []
_mock_results: list[Message] = []


def get_mock_batch_calls() -> list[BatchExecuteRequest]:
    with _mock_lock:
        return list(_mock_batch_calls)


def get_mock_set_results() -> list[Message]:
    with _mock_lock:
        return list(_mock_results)


def clear_mock_planner_calls() -> None:
    with _mock_lock:
        _mock_batch_calls.clear()
        _mock_results.clear()


class KeepAliveThread(PeriodicBackgroundThread):
    thread_name = "runtime/keep-alive"

    def __init__(self, client: "PlannerClient", slots: int,
                 n_devices: int) -> None:
        super().__init__()
        self.client = client
        self.slots = slots
        self.n_devices = n_devices

    def do_work(self) -> None:
        if _FAULTS and _FP_KEEPALIVE.fire(
                host=self.client.this_host) is SUPPRESS:
            # An injected keep-alive loss: the planner expires this live
            # host
            return
        client = self.client
        try:
            client.register_host(self.slots, self.n_devices, rejoin=True)
        except RpcError as e:
            # Never raise out of the keep-alive and never spin: the
            # interval paces the retries and the breaker makes a failed
            # tick instant while it is open. One log an outage
            if not client.planner_down:
                logger.warning("Planner unreachable from %s (%s); the "
                               "keep-alive retries and results buffer "
                               "locally", client.this_host, e)
                flight_record("planner_unreachable", host=client.this_host)
            client.planner_down = True
            return
        if client.planner_down:
            client.planner_down = False
            logger.warning("Planner reachable again from %s; draining "
                           "buffered results", client.this_host)
            flight_record("planner_reconnected", host=client.this_host)
            # A result pushed just before the outage may have died in
            # the old connection's kernel buffer: re-deliver the recent
            # window (first write wins at the planner), and resync once,
            # since the planner behind the outage may be a restarted one
            client.requeue_recent_results()
            client._resync_all = True
        # The flush is a no-op check while nothing is pending; the resync
        # (one sync RPC per covered wait) runs only while a restart
        # signal or a waiter's nudge is live
        client.flush_pending_results()
        if client._resync_all or client._resync_nudged:
            client.resync_result_interest()


class PlannerClient(MessageEndpointClient):
    """One per worker runtime, carrying the worker's host identity."""

    # Concurrency contract (analysis/concheck.py): waiter machinery under
    # _results_lock, outage buffers under _pending_lock. Deliberately
    # unlisted: planner_down and _resync_all are set-only signal flags
    # whose races are benign (consumed under _results_lock /
    # re-checked by the keep-alive tick); _planner_boot is only touched
    # from the keep-alive thread; _keep_alive and the snapshot-client
    # handles are start/stop sequenced by the runtime.
    GUARDS = {
        "_local_results": "_results_lock",
        "_local_results_order": "_results_lock",
        "_result_events": "_results_lock",
        "_result_waiters": "_results_lock",
        "_result_interest": "_results_lock",
        "_resync_nudged": "_results_lock",
        "_pending_results": "_pending_lock",
        "_pending_bytes": "_pending_lock",
        "_recent_results": "_pending_lock",
        "_recent_bytes": "_pending_lock",
        "_out_results": "_pending_lock",
        "_out_sending": "_pending_lock",
    }

    # Results kept locally for repeated reads, oldest dropped first
    MAX_CACHED_RESULTS = 10_000
    # Both outage buffers are bounded by count and by payload bytes
    MAX_PENDING_RESULTS = 10_000
    MAX_PENDING_BYTES = 256 << 20
    MAX_RECENT_RESULTS = 512
    MAX_RECENT_BYTES = 64 << 20
    RECENT_RESULT_WINDOW = 60.0

    def __init__(self, this_host: str = "",
                 planner_host: str | None = None) -> None:
        super().__init__(planner_host or get_system_config().planner_host,
                         PLANNER_ASYNC_PORT, PLANNER_SYNC_PORT)
        self.this_host = this_host
        self._keep_alive: Optional[KeepAliveThread] = None
        # Set while keep-alives fail (one flight record an outage)
        self.planner_down = False
        # Local result promises: results land through the planner's push
        # to this host's FunctionCallServer or in a direct response
        self._results_lock = threading.Lock()
        self._local_results: dict[int, Message] = {}
        self._local_results_order: list[int] = []
        self._result_events: dict[int, threading.Event] = {}
        # msg_id → threads blocked on its shared event: the registration
        # unwinds only when the last of them leaves
        self._result_waiters: dict[int, int] = {}
        # msg_id → app_id of every outstanding wait, re-registered with a
        # restarted planner (resync_result_interest)
        self._result_interest: dict[int, int] = {}
        # The outage buffers, under _pending_lock: results the planner
        # could not take (drained by FLUSH_RESULTS), results queued
        # behind a push in flight (they ride the next frame), and results
        # pushed recently (re-delivered when the planner may have lost
        # them)
        self._pending_lock = threading.Lock()
        self._pending_results: list[Message] = []
        self._pending_bytes = 0
        self._out_results: list[Message] = []
        self._out_sending = False
        self._recent_results: list[tuple[float, Message]] = []
        self._recent_bytes = 0
        # The planner's boot id last seen, and what the next resync
        # round owes: every wait after a restart signal, else only the
        # ids that blocked waiters nudged
        self._planner_boot: str | None = None
        self._resync_all = False
        self._resync_nudged: set[int] = set()
        # Set by the WorkerRuntime: this host's snapshot registry, from
        # which THREADS batches push the main thread's snapshot
        self.snapshot_registry = None
        self._planner_snapshot_client = None

    # ------------------------------------------------------------------
    def ping(self) -> bool:
        resp = self.sync_send(int(PlannerCalls.PING), idempotent=True)
        return bool(resp.header.get("pong"))

    def register_host(self, slots: int, n_devices: int = 0,
                      overwrite: bool = False, start_keep_alive: bool = False,
                      rejoin: bool = False) -> float:
        """Register this host; returns the planner's host timeout. A
        keep-alive (``rejoin``) that finds the host unknown to the
        planner (it expired while alive) registers again as a boot."""
        header = {"host": self.this_host, "slots": slots,
                  "n_devices": n_devices, "overwrite": overwrite}
        resp = self.sync_send(int(PlannerCalls.REGISTER_HOST), header,
                              idempotent=True)
        timeout = float(resp.header.get("host_timeout", 30.0))
        boot = resp.header.get("boot")
        if boot is not None:
            if self._planner_boot is not None and boot != self._planner_boot:
                # The planner restarted between ticks; its replay may
                # keep this host known, but its waiter map and any result
                # write in the old incarnation's socket buffer are gone
                logger.warning("Planner incarnation changed under %s; "
                               "re-delivering recent results and waits",
                               self.this_host)
                self.requeue_recent_results()
                self._resync_all = True
            self._planner_boot = boot
        if rejoin and not overwrite and not resp.header.get("known", True):
            logger.warning("Host %s was unknown to the planner; rejoining",
                           self.this_host)
            self.sync_send(int(PlannerCalls.REGISTER_HOST),
                           {**header, "overwrite": True}, idempotent=True)
            # The planner restarted or expired this host: re-deliver the
            # recent results through the confirmed flush
            self.requeue_recent_results()
            self._resync_all = True
        if start_keep_alive and self._keep_alive is None:
            self._keep_alive = KeepAliveThread(self, slots, n_devices)
            self._keep_alive.start(max(0.5, timeout / 2))
        return timeout

    def _stop_keep_alive(self) -> None:
        if self._keep_alive is not None:
            self._keep_alive.stop()
            self._keep_alive = None

    def remove_host(self) -> None:
        """Deregister; best-effort, since the planner's expiry reaps the
        host anyway. Results buffered in an outage get a last flush."""
        self._stop_keep_alive()
        try:
            self.flush_pending_results()
            self.sync_send(int(PlannerCalls.REMOVE_HOST),
                           {"host": self.this_host}, idempotent=True)
        except RpcError as e:
            logger.debug("Deregister of %s skipped: %s", self.this_host, e)

    def get_available_hosts(self) -> list[dict]:
        resp = self.sync_send(int(PlannerCalls.GET_AVAILABLE_HOSTS),
                              idempotent=True)
        return resp.header.get("hosts", [])

    # ------------------------------------------------------------------
    def call_functions(self, req: BatchExecuteRequest) -> SchedulingDecision:
        """Invoke a batch through the planner (reference callFunctions)."""
        if is_mock_mode():
            with _mock_lock:
                _mock_batch_calls.append(req)
            return SchedulingDecision(req.app_id, req.group_id)
        if req.type == int(BatchExecuteType.THREADS) and req.messages:
            self._push_main_thread_snapshot(req)
        header, tail = ber_to_wire(req)
        resp = self.sync_send(int(PlannerCalls.CALL_BATCH),
                              {"ber": header, "host": self.this_host}, tail)
        return SchedulingDecision.from_dict(resp.header["decision"])

    def submit_functions_many(self, reqs: list[BatchExecuteRequest]
                              ) -> tuple[bool, float]:
        """Put independent batches into the planner's ingress queue with
        one SUBMIT_BATCH call and return ``(accepted, retry_after)`` at
        once: no decision comes back, and the results arrive as any
        others do. Admission takes or sheds them all together; not
        accepted means back off ``retry_after`` seconds and retry."""
        if not reqs:
            return True, 0.0
        if is_mock_mode():
            with _mock_lock:
                _mock_batch_calls.extend(reqs)
            return True, 0.0
        header, tail = bers_to_wire(reqs)
        header["host"] = self.this_host
        resp = self.sync_send(int(PlannerCalls.SUBMIT_BATCH), header, tail)
        return (bool(resp.header.get("accepted")),
                float(resp.header.get("retry_after", 0.0)))

    def _push_main_thread_snapshot(self, req: BatchExecuteRequest) -> None:
        """This host is the THREADS batch's main host; its main-thread
        snapshot goes to the planner whole, every batch, so that a
        repeated batch on one key never leaves the planner a pre-merge
        copy (the reference's diff-only repeat push is not taken)."""
        for m in req.messages:
            m.main_host = self.this_host
        if not req.snapshot_key:
            req.snapshot_key = get_main_thread_snapshot_key(req.messages[0])
        if self.snapshot_registry is None:
            return
        snap = self.snapshot_registry.try_get_snapshot(req.snapshot_key)
        if snap is None:
            return
        if self._planner_snapshot_client is None:
            self._planner_snapshot_client = SnapshotClient(self.host)
        self._planner_snapshot_client.push_snapshot(req.snapshot_key, snap)

    def set_message_result(self, msg: Message) -> None:
        if is_mock_mode():
            with _mock_lock:
                _mock_results.append(msg)
            return
        # The last stamp on this host's side of the wire
        _LC.stamp(msg, PHASE_RESULT_PUSH)
        # Buffered results go first, so that the planner sees completion
        # order
        # concheck: ok(guard-unlocked) — racy emptiness probe by design:
        # flush_pending_results re-checks under _pending_lock, so a torn
        # read only costs one early/late flush attempt
        if self._pending_results:
            self.flush_pending_results()
        with self._pending_lock:
            self._out_results.append(msg)
            if self._out_sending:
                # Another thread's push is in flight; this result rides
                # its next frame
                return
            self._out_sending = True
        self._drain_out_results()

    def _drain_out_results(self) -> None:
        """Send what has accumulated as one push, until the queue is
        empty. One thread owns the loop at a time (``_out_sending``), so
        every exit clears the flag: a flag left set would park every
        later result of this host."""
        try:
            while True:
                with self._pending_lock:
                    batch = self._out_results
                    self._out_results = []
                    if not batch:
                        self._out_sending = False
                        return
                try:
                    dicts, tail = messages_to_wire(batch)
                    header = ({"msg": dicts[0]} if len(dicts) == 1
                              else {"msgs": dicts})
                    retried = self.async_send(
                        int(PlannerCalls.SET_MESSAGE_RESULT), header, tail)
                except RpcError:
                    for m in batch:
                        self._buffer_result(m)
                    continue
                except Exception:  # noqa: BLE001 — one message that cannot
                    # be encoded must not sink the batch: each result is
                    # pushed alone and only that one is dropped
                    logger.exception("Batched result push from %s failed; "
                                     "pushing the %d result(s) one by one",
                                     self.this_host, len(batch))
                    self._push_results_individually(batch)
                    continue
                with self._pending_lock:
                    for m in batch:
                        self._remember_result_locked(m)
                if retried:
                    # The frame went out only after a reconnect: an
                    # earlier push on the old connection may have died in
                    # the peer's kernel buffer
                    logger.warning("Result push from %s needed a reconnect; "
                                   "re-delivering the recent results",
                                   self.this_host)
                    self.requeue_recent_results()
                    self.flush_pending_results()
        except BaseException:
            with self._pending_lock:
                self._out_sending = False
            raise

    def _push_results_individually(self, batch: list[Message]) -> None:
        for m in batch:
            try:
                dicts, tail = messages_to_wire([m])
                self.async_send(int(PlannerCalls.SET_MESSAGE_RESULT),
                                {"msg": dicts[0]}, tail)
            except RpcError:
                self._buffer_result(m)
            except Exception:  # noqa: BLE001
                logger.exception("Dropping unsendable result %d from %s",
                                 m.id, self.this_host)
            else:
                with self._pending_lock:
                    self._remember_result_locked(m)

    @staticmethod
    def _result_cost(msg: Message) -> int:
        """A buffered result's retained bytes, roughly."""
        return len(msg.output_data) + len(msg.input_data) + 512

    def _remember_result_locked(self, msg: Message) -> None:
        now = time.monotonic()
        recent = self._recent_results
        recent.append((now, msg))
        self._recent_bytes += self._result_cost(msg)
        cutoff = now - self.RECENT_RESULT_WINDOW
        while recent and (recent[0][0] < cutoff
                          or len(recent) > self.MAX_RECENT_RESULTS
                          or self._recent_bytes > self.MAX_RECENT_BYTES):
            self._recent_bytes -= self._result_cost(recent.pop(0)[1])

    def requeue_recent_results(self) -> None:
        """Move the recent results onto the pending queue, which the next
        flush delivers: the planner they were pushed to may have died
        with them in a kernel buffer."""
        with self._pending_lock:
            if not self._recent_results:
                return
            have = {m.id for m in self._pending_results}
            resend = [m for _, m in self._recent_results
                      if m.id not in have]
            self._pending_results[:0] = resend
            self._pending_bytes += sum(self._result_cost(m) for m in resend)
            self._recent_results.clear()
            self._recent_bytes = 0
        if resend:
            logger.info("Re-delivering %d recently pushed result(s) from "
                        "%s", len(resend), self.this_host)

    def _buffer_result(self, msg: Message) -> None:
        """Queue a result the planner could not be reached for; the
        keep-alive or the next push flushes it. Drop-oldest past the
        bounds: a long outage must not exhaust a busy worker's memory."""
        with self._pending_lock:
            pending = self._pending_results
            pending.append(msg)
            self._pending_bytes += self._result_cost(msg)
            dropped = 0
            while pending and (len(pending) > self.MAX_PENDING_RESULTS
                               or self._pending_bytes
                               > self.MAX_PENDING_BYTES):
                self._pending_bytes -= self._result_cost(pending.pop(0))
                dropped += 1
            n = len(pending)
        if dropped:
            _DROPPED_RESULTS.inc(dropped)
            logger.warning("Outage result queue overflowed on %s; dropped "
                           "%d oldest result(s)", self.this_host, dropped)
        _BUFFERED_RESULTS.inc()
        if not self.planner_down:
            self.planner_down = True
            logger.warning("Planner unreachable from %s; buffering results "
                           "locally (%d queued)", self.this_host, n)
            flight_record("planner_unreachable", host=self.this_host)

    def flush_pending_results(self) -> None:
        """Deliver the queued results through the sync ``FLUSH_RESULTS``
        call, which confirms delivery. On failure they go back to the
        queue's head for the next keep-alive tick."""
        with self._pending_lock:
            if not self._pending_results:
                return
            batch = self._pending_results
            self._pending_results = []
            self._pending_bytes = 0
        try:
            dicts, tail = messages_to_wire(batch)
            resp = self.sync_send(int(PlannerCalls.FLUSH_RESULTS),
                                  {"msgs": dicts, "host": self.this_host},
                                  tail, idempotent=True)
        except RpcError:
            with self._pending_lock:
                self._pending_results[:0] = batch
                self._pending_bytes += sum(self._result_cost(m)
                                           for m in batch)
            return
        accepted = int(resp.header.get("accepted", len(batch)))
        _FLUSHED_RESULTS.inc(accepted)
        logger.info("Flushed %d buffered result(s) from %s to the planner",
                    accepted, self.this_host)
        flight_record("results_flushed", host=self.this_host, n=accepted)

    def resync_result_interest(self) -> bool:
        """Register this host's interest again in the results it waits
        on: every outstanding wait after a restart signal (a restarted
        planner replays results but not its waiter map), else only the
        ids blocked waiters nudged. Returns False when an RpcError cut
        the round short; ``_resync_all`` then stays set for the next
        tick, and the waiters' own intervals nudge again."""
        with self._results_lock:
            full = self._resync_all
            nudged = self._resync_nudged
            self._resync_nudged = set()
            pending = [(mid, app) for mid, app in
                       self._result_interest.items()
                       if mid in self._result_events
                       and (full or mid in nudged)]
        for msg_id, app_id in pending:
            try:
                self._ask_result(app_id, msg_id)
            except RpcError:
                return False
        if full:
            with self._results_lock:
                self._resync_all = False
        return True

    def set_message_result_locally(self, msg: Message) -> None:
        """Resolve a local waiter (this host's FunctionCallServer calls
        this when the planner pushes a result)."""
        _LC.stamp(msg, PHASE_WAITER_WAKE)
        with self._results_lock:
            if msg.id not in self._local_results:
                self._local_results_order.append(msg.id)
            self._local_results[msg.id] = msg
            while len(self._local_results_order) > self.MAX_CACHED_RESULTS:
                self._local_results.pop(self._local_results_order.pop(0),
                                        None)
            self._result_interest.pop(msg.id, None)
            self._result_waiters.pop(msg.id, None)
            self._resync_nudged.discard(msg.id)
            ev = self._result_events.pop(msg.id, None)
        if ev is not None:
            ev.set()

    def _drop_result_waiter_locked(self, msg_id: int) -> None:
        """One waiter left (an error or its timeout). The event is shared
        by every thread waiting on ``msg_id``, so the registration
        unwinds only when the last one leaves."""
        n = self._result_waiters.get(msg_id, 1) - 1
        if n > 0:
            self._result_waiters[msg_id] = n
            return
        self._result_waiters.pop(msg_id, None)
        self._result_events.pop(msg_id, None)
        self._result_interest.pop(msg_id, None)
        self._resync_nudged.discard(msg_id)

    def _ask_result(self, app_id: int, msg_id: int) -> Optional[Message]:
        """One GET_MESSAGE_RESULT round: the result, or None after the
        planner registered this host for the push."""
        resp = self.sync_send(int(PlannerCalls.GET_MESSAGE_RESULT), {
            "app_id": app_id, "msg_id": msg_id, "host": self.this_host,
        }, idempotent=True)
        if not resp.header.get("found"):
            return None
        result = messages_from_wire([resp.header["msg"]], resp.payload)[0]
        self.set_message_result_locally(result)
        return result

    def get_message_result(self, app_id: int, msg_id: int,
                           timeout: float | None = None) -> Message:
        """Blocking result fetch; raises TimeoutError after ``timeout``
        seconds (the global message timeout when None). It asks the
        planner once, which registers this host for the push; after
        that it only nudges the keep-alive to re-poll this id, never
        calling the planner itself (a hung planner would hold the sync
        lock past the deadline)."""
        conf = get_system_config()
        timeout = conf.global_message_timeout if timeout is None else timeout
        with self._results_lock:
            cached = self._local_results.get(msg_id)
            if cached is not None:
                return cached
            ev = self._result_events.setdefault(msg_id, threading.Event())
            self._result_interest[msg_id] = app_id
            self._result_waiters[msg_id] = (
                self._result_waiters.get(msg_id, 0) + 1)
        try:
            result = self._ask_result(app_id, msg_id)
        except Exception:
            # The caller owns the retry; a registration left behind
            # would be re-polled by every resync round
            with self._results_lock:
                self._drop_result_waiter_locked(msg_id)
            raise
        if result is not None:
            return result
        deadline = time.monotonic() + timeout
        poll = max(0.1, conf.planner_host_timeout / 2)
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                with self._results_lock:
                    # A result that landed as the wait expired wins
                    late = self._local_results.get(msg_id)
                    if late is not None:
                        return late
                    self._drop_result_waiter_locked(msg_id)
                raise TimeoutError(f"Timed out waiting for result of msg "
                                   f"{msg_id} (app {app_id})")
            if ev.wait(min(remaining, poll)):
                with self._results_lock:
                    return self._local_results[msg_id]
            with self._results_lock:
                self._resync_nudged.add(msg_id)
            poll = min(poll * 2, 240.0)

    def get_batch_results(self, app_id: int) -> BatchExecuteRequestStatus:
        resp = self.sync_send(int(PlannerCalls.GET_BATCH_RESULTS),
                              {"app_id": app_id}, idempotent=True)
        return BatchExecuteRequestStatus(
            app_id=resp.header["app_id"],
            finished=resp.header["finished"],
            message_results=messages_from_wire(
                resp.header.get("messages", []), resp.payload),
            expected_num_messages=resp.header["expected_num_messages"])

    def get_scheduling_decision(self, app_id: int
                                ) -> Optional[SchedulingDecision]:
        resp = self.sync_send(int(PlannerCalls.GET_SCHEDULING_DECISION),
                              {"app_id": app_id}, idempotent=True)
        if not resp.header.get("found"):
            return None
        return SchedulingDecision.from_dict(resp.header["decision"])

    def relay_group_abort(self, group_id: int, reason: str,
                          hosts: list[str]) -> None:
        """Ask the planner to deliver a group abort to ``hosts``, which
        this process could not reach directly. Fire and forget: the
        relay is best effort on top of keep-alive expiry."""
        if is_mock_mode():
            return
        self.async_send(int(PlannerCalls.RELAY_GROUP_ABORT), {
            "group_id": group_id, "reason": reason, "hosts": list(hosts)})

    def get_num_migrations(self) -> int:
        resp = self.sync_send(int(PlannerCalls.GET_NUM_MIGRATIONS),
                              idempotent=True)
        return int(resp.header["num_migrations"])

    def join_device_plane(self, n_processes: int):
        """One join or poll of the multi-process device plane
        (parallel/distributed.py): None until the roster is full, then
        this host's ``DevicePlaneSpec``. Idempotent: the planner keeps
        this host's place across polls."""
        from faabric_tpu_torch.parallel.distributed import DevicePlaneSpec

        resp = self.sync_send(int(PlannerCalls.JOIN_DEVICE_PLANE), {
            "host": self.this_host, "n_processes": n_processes,
        }, idempotent=True)
        if not resp.header.get("found"):
            return None
        return DevicePlaneSpec.from_dict(resp.header["spec"])

    def check_migration(self, app_id: int) -> Optional[SchedulingDecision]:
        """The app's new placement when the planner finds a better one,
        the MUST_FREEZE sentinel when the app must park, else None."""
        resp = self.sync_send(int(PlannerCalls.CHECK_MIGRATION),
                              {"app_id": app_id})
        if not resp.header.get("found"):
            return None
        return SchedulingDecision.from_dict(resp.header["decision"])

    def claim_state_master(self, user: str,
                           key: str) -> tuple[str, str, int]:
        """A key's placement, claiming mastership for this host if the
        key is unowned: ``(master, backup, epoch)``; backup "" and epoch
        0 with ``FAABRIC_STATE_REPLICAS=0``."""
        resp = self.sync_send(int(PlannerCalls.CLAIM_STATE_MASTER), {
            "user": user, "key": key, "host": self.this_host,
        }, idempotent=True)
        h = resp.header
        return (h["master"], h.get("backup", ""), int(h.get("epoch", 0)))

    def drop_state_master(self, user: str, key: str) -> None:
        self.sync_send(int(PlannerCalls.DROP_STATE_MASTER),
                       {"user": user, "key": key}, idempotent=True)

    def preload_scheduling_decision(self,
                                    decision: SchedulingDecision) -> None:
        self.sync_send(int(PlannerCalls.PRELOAD_SCHEDULING_DECISION),
                       {"decision": decision.to_dict()}, idempotent=True)

    def close(self) -> None:
        self._stop_keep_alive()
        if self._planner_snapshot_client is not None:
            self._planner_snapshot_client.close()
            self._planner_snapshot_client = None
        super().close()
