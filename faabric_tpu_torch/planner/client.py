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

Not ported (``ROADMAP.md`` Queue 1 #9 parts C and D): buffering results
while the planner is down, coalesced result pushes and the high-rate
submission path.
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
    get_main_thread_snapshot_key,
    messages_from_wire,
    messages_to_wire,
)
from faabric_tpu_torch.snapshot.remote import SnapshotClient
from faabric_tpu_torch.telemetry import flight_record, get_lifecycle
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
        try:
            self.client.register_host(self.slots, self.n_devices,
                                      rejoin=True)
        except RpcError as e:
            # The interval paces the retries; the breaker makes a failed
            # tick instant while it is open
            if not self.client.planner_down:
                logger.warning("Keep-alive of %s failed: %s",
                               self.client.this_host, e)
                flight_record("planner_unreachable",
                              host=self.client.this_host)
            self.client.planner_down = True
            return
        if self.client.planner_down:
            self.client.planner_down = False
            flight_record("planner_reconnected", host=self.client.this_host)


class PlannerClient(MessageEndpointClient):
    """One per worker runtime, carrying the worker's host identity."""

    # Results kept locally for repeated reads, oldest dropped first
    MAX_CACHED_RESULTS = 10_000

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
        if rejoin and not overwrite and not resp.header.get("known", True):
            logger.warning("Host %s was unknown to the planner; rejoining",
                           self.this_host)
            self.sync_send(int(PlannerCalls.REGISTER_HOST),
                           {**header, "overwrite": True}, idempotent=True)
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
        host anyway."""
        self._stop_keep_alive()
        try:
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
        dicts, tail = messages_to_wire([msg])
        self.async_send(int(PlannerCalls.SET_MESSAGE_RESULT),
                        {"msg": dicts[0]}, tail)

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
            ev = self._result_events.pop(msg.id, None)
        if ev is not None:
            ev.set()

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
        seconds (the global message timeout when None). Between pushes it
        asks the planner again at a doubling interval, in case a push
        was lost."""
        conf = get_system_config()
        timeout = conf.global_message_timeout if timeout is None else timeout
        with self._results_lock:
            cached = self._local_results.get(msg_id)
            if cached is not None:
                return cached
            ev = self._result_events.setdefault(msg_id, threading.Event())
        deadline = time.monotonic() + timeout
        poll = max(0.1, conf.planner_host_timeout / 2)
        while True:
            result = self._ask_result(app_id, msg_id)
            if result is not None:
                return result
            remaining = deadline - time.monotonic()
            if remaining > 0 and ev.wait(min(remaining, poll)):
                with self._results_lock:
                    return self._local_results[msg_id]
            if time.monotonic() >= deadline:
                with self._results_lock:
                    late = self._local_results.get(msg_id)
                    if late is not None:
                        return late
                    self._result_events.pop(msg_id, None)
                raise TimeoutError(f"Timed out waiting for result of msg "
                                   f"{msg_id} (app {app_id})")
            poll *= 2

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

    def close(self) -> None:
        self._stop_keep_alive()
        if self._planner_snapshot_client is not None:
            self._planner_snapshot_client.close()
            self._planner_snapshot_client = None
        super().close()
