"""Planner RPC server (ports 8011/8012).

Counterpart of ``faabric_tpu/planner/server.py`` (reference
src/planner/PlannerServer.cpp) for the calls that the gang path makes,
under the reference's call numbers, and the planner's own
``SnapshotServer`` over ``planner.snapshot_registry`` at host
``"planner"``, which takes THREADS batches' main-thread snapshots and
the images of frozen apps (the reference's planner_server runs both,
src/planner/planner_server.cpp:9-43). An expiry reaper drives host
expiry on a clock, so a dead worker's messages are recovered even when
nobody schedules. ``RELAY_GROUP_ABORT`` fans a group abort out to the
hosts its originator could not reach (reference :192-230).
``FLUSH_RESULTS`` takes the results a worker buffered while the planner
was down (reference :357-367), ``REGISTER_HOST`` answers with the
planner's ``boot`` id, and ``stop()`` drains, fsyncs and closes the
planner's journal.

Invocations enter through the planner's ingress (reference :299-335):
``CALL_BATCH`` submits and waits for the decision, its queue wait
capped at ``max(0.05, tick_ms / 250)`` s so that a full cluster keeps
answering NOT_ENOUGH_SLOTS promptly (a shed answers NOT_ENOUGH_SLOTS
too); ``SUBMIT_BATCH`` enqueues many independent batches and answers at
once with the admission verdict and its retry hint.
``PRELOAD_SCHEDULING_DECISION`` records a decision for an app. The
server starts the ingress before its transport and stops it before the
transport closes, and samples the ingress's depth, shed count and tick
time beside the planner's gauges.
"""

from __future__ import annotations

import enum
import threading

from faabric_tpu_torch.batch_scheduler.decision import (
    SchedulingDecision,
    not_enough_slots_decision,
)
from faabric_tpu_torch.ingress import IngressShedError
from faabric_tpu_torch.planner.planner import get_planner
from faabric_tpu_torch.proto import (
    ber_from_wire,
    bers_from_wire,
    messages_from_wire,
    messages_to_wire,
)
from faabric_tpu_torch.snapshot.remote import SnapshotServer
from faabric_tpu_torch.transport.common import (
    PLANNER_ASYNC_PORT,
    PLANNER_SYNC_PORT,
)
from faabric_tpu_torch.transport.message import TransportMessage
from faabric_tpu_torch.transport.server import (
    MessageEndpointServer,
    handler_response,
)
from faabric_tpu_torch.util.config import get_system_config
from faabric_tpu_torch.util.logging import get_logger
from faabric_tpu_torch.util.periodic import PeriodicBackgroundThread

logger = get_logger(__name__)


class _ExpiryReaper(PeriodicBackgroundThread):
    thread_name = "planner/reaper"

    def __init__(self, planner) -> None:
        super().__init__()
        self.planner = planner

    def do_work(self) -> None:
        self.planner.expire_hosts()


class PlannerCalls(enum.IntEnum):
    NO_CALL = 0
    PING = 1
    REGISTER_HOST = 2
    REMOVE_HOST = 3
    GET_AVAILABLE_HOSTS = 4
    SET_MESSAGE_RESULT = 5
    GET_MESSAGE_RESULT = 6
    GET_BATCH_RESULTS = 7
    GET_SCHEDULING_DECISION = 8
    GET_NUM_MIGRATIONS = 9
    CALL_BATCH = 10
    PRELOAD_SCHEDULING_DECISION = 11
    CLAIM_STATE_MASTER = 12
    DROP_STATE_MASTER = 13
    CHECK_MIGRATION = 14
    # A worker's join (or poll) of the multi-process device plane
    JOIN_DEVICE_PLANE = 15
    # A worker's results buffered while the planner was down, delivered
    # with a confirmation (the push is fire and forget)
    FLUSH_RESULTS = 16
    # A host that aborts a group but cannot reach some of its peers (the
    # direct abort rides the link that just died) hands the planner the
    # unreachable hosts: the planner's links are independent of the
    # worker pair's
    RELAY_GROUP_ABORT = 17
    # Many independent batches into the ingress queue; the answer is the
    # admission verdict, not a decision
    SUBMIT_BATCH = 18


class PlannerServer(MessageEndpointServer):
    def __init__(self, port_offset: int = 0, n_threads: int = 4) -> None:
        super().__init__(PLANNER_ASYNC_PORT + port_offset,
                         PLANNER_SYNC_PORT + port_offset,
                         label="planner-server", n_threads=n_threads)
        self.planner = get_planner()
        self.snapshot_server = SnapshotServer(
            self.planner.snapshot_registry, host="planner",
            port_offset=port_offset)
        self.expiry_reaper = _ExpiryReaper(self.planner)

    def start(self) -> None:
        from faabric_tpu_torch.faults import set_fault_identity
        from faabric_tpu_torch.telemetry import (
            get_timeseries,
            set_process_label,
            start_profiler,
            start_sampler,
        )

        set_process_label("planner")
        set_fault_identity("planner")
        # Re-arm a stopped ingress before the transport delivers
        # submissions
        self.planner.ingress.start()
        super().start()
        self.snapshot_server.start()
        # Quarter of the host timeout: an expiry is seen well inside one
        # more keep-alive period
        timeout = get_system_config().planner_host_timeout
        self.expiry_reaper.start(max(0.5, timeout / 4.0))
        # Control-plane gauges sampled continuously into the time-series
        # ring (trends, not instants). The sampler and the stack
        # profiler are shared and refcounted: stop() releases only the
        # shares this start() took
        ring = get_timeseries()
        planner = self.planner
        self._ring_series = {
            "ingress_depth": lambda: planner.ingress.admission.depth(),
            "ingress_shed_total":
                lambda: planner.ingress.admission.shed_total(),
            "free_slots": planner.free_slot_watermark,
            "tick_ms": planner.ingress.last_tick_ms,
            "result_backlog": planner.result_backlog,
            "in_flight_msgs": planner.in_flight_message_count,
            "results_total": planner.results_total,
        }
        for name, fn in self._ring_series.items():
            ring.register(name, fn)
        start_sampler()
        self._sampling = True
        start_profiler()
        self._profiling = True

    def stop(self) -> None:
        from faabric_tpu_torch.telemetry import (
            get_timeseries,
            stop_profiler,
            stop_sampler,
        )

        if getattr(self, "_sampling", False):
            self._sampling = False
            stop_sampler()
        if getattr(self, "_profiling", False):
            self._profiling = False
            stop_profiler()
        # Unregister what start() registered (matched by function, so a
        # co-resident server that registered over these keeps its rows)
        ring = get_timeseries()
        for name, fn in getattr(self, "_ring_series", {}).items():
            ring.unregister(name, fn)
        self._ring_series = {}
        self.expiry_reaper.stop()
        self.snapshot_server.stop()
        # The tick thread stops before the transport: what is still
        # queued resolves as unschedulable instead of dispatching into a
        # closing server
        self.planner.ingress.stop()
        super().stop()
        # A clean stop: drain the write-behind buffer, fsync, and release
        # the journal's fd and drain thread
        self.planner.close_journal()

    def do_async_recv(self, msg: TransportMessage) -> None:
        if msg.code == int(PlannerCalls.SET_MESSAGE_RESULT):
            # One result ("msg") or several ("msgs")
            dicts = msg.header.get("msgs") or [msg.header["msg"]]
            self.planner.set_message_results(
                messages_from_wire(dicts, msg.payload))
        elif msg.code == int(PlannerCalls.RELAY_GROUP_ABORT):
            self._relay_group_abort(int(msg.header["group_id"]),
                                    str(msg.header.get("reason", "")),
                                    list(msg.header.get("hosts", [])))
        else:
            raise ValueError(f"Unknown async planner call {msg.code}")

    @staticmethod
    def _relay_group_abort(group_id: int, reason: str,
                           hosts: list) -> None:
        """Send the abort to each of ``hosts`` on a thread of its own, so
        that a slow peer never holds a server worker."""
        from faabric_tpu_torch.telemetry import flight_record

        flight_record("abort_relayed", group=group_id, reason=reason,
                      n_hosts=len(hosts))
        logger.warning("Relaying abort of group %d to %s: %s", group_id,
                       hosts, reason)

        def relay() -> None:
            from faabric_tpu_torch.transport.ptp_remote import (
                PointToPointClient,
            )

            for host in hosts:
                try:
                    client = PointToPointClient(host)
                    try:
                        client.abort_group(group_id,
                                           f"{reason} (planner relay)")
                    finally:
                        client.close()
                except Exception:  # noqa: BLE001 — a host dead to the
                    # planner too is left to keep-alive expiry
                    logger.debug("Abort relay of group %d to %s failed",
                                 group_id, host, exc_info=True)

        threading.Thread(target=relay, name=f"planner/abort-relay@{group_id}",
                         daemon=True).start()

    def do_sync_recv(self, msg: TransportMessage) -> TransportMessage:
        code = msg.code
        h = msg.header
        planner = self.planner

        if code == int(PlannerCalls.PING):
            return handler_response(header={"pong": True})

        if code == int(PlannerCalls.REGISTER_HOST):
            # "known": whether the planner had this host before the call.
            # A keep-alive that finds it False rejoins as a boot.
            known = planner.is_host_registered(h["host"])
            timeout = planner.register_host(
                h["host"], h["slots"], h.get("n_devices", 0),
                overwrite=h.get("overwrite", False))
            return handler_response(header={"host_timeout": timeout,
                                            "known": known,
                                            "boot": planner.boot_id})

        if code == int(PlannerCalls.REMOVE_HOST):
            planner.remove_host(h["host"])
            return handler_response()

        if code == int(PlannerCalls.GET_AVAILABLE_HOSTS):
            return handler_response(header={"hosts": [
                {"ip": x.ip, "slots": x.slots, "used_slots": x.used_slots,
                 "n_devices": x.n_devices}
                for x in planner.get_available_hosts()]})

        if code == int(PlannerCalls.GET_MESSAGE_RESULT):
            result = planner.get_message_result(h["app_id"], h["msg_id"],
                                                h.get("host", ""))
            if result is None:
                return handler_response(header={"found": False})
            dicts, tail = messages_to_wire([result])
            return handler_response(header={"found": True, "msg": dicts[0]},
                                    payload=tail)

        if code == int(PlannerCalls.GET_BATCH_RESULTS):
            status = planner.get_batch_results(h["app_id"])
            dicts, tail = messages_to_wire(status.message_results)
            return handler_response(header={
                "app_id": status.app_id,
                "finished": status.finished,
                "expected_num_messages": status.expected_num_messages,
                "messages": dicts,
            }, payload=tail)

        if code == int(PlannerCalls.GET_SCHEDULING_DECISION):
            decision = planner.get_scheduling_decision(h["app_id"])
            if decision is None:
                return handler_response(header={"found": False})
            return handler_response(header={"found": True,
                                            "decision": decision.to_dict()})

        if code == int(PlannerCalls.GET_NUM_MIGRATIONS):
            return handler_response(
                header={"num_migrations": planner.get_num_migrations()})

        if code == int(PlannerCalls.CHECK_MIGRATION):
            decision = planner.check_migration(h["app_id"])
            if decision is None:
                return handler_response(header={"found": False})
            return handler_response(header={"found": True,
                                            "decision": decision.to_dict()})

        if code == int(PlannerCalls.JOIN_DEVICE_PLANE):
            spec = planner.join_device_plane(h["host"], h["n_processes"])
            if spec is None:
                return handler_response(header={"found": False})
            return handler_response(header={"found": True, "spec": spec})

        if code == int(PlannerCalls.CLAIM_STATE_MASTER):
            master, backup, epoch = planner.claim_state_master(
                h["user"], h["key"], h["host"])
            return handler_response(header={"master": master,
                                            "backup": backup,
                                            "epoch": epoch})

        if code == int(PlannerCalls.DROP_STATE_MASTER):
            planner.drop_state_master(h["user"], h["key"])
            return handler_response()

        if code == int(PlannerCalls.FLUSH_RESULTS):
            msgs = messages_from_wire(h.get("msgs", []), msg.payload)
            for result in msgs:
                # First write wins, so a flush retried after a
                # half-delivered attempt is harmless
                planner.set_message_result(result)
            logger.info("Flushed %d buffered result(s) from %s", len(msgs),
                        h.get("host", "?"))
            return handler_response(header={"accepted": len(msgs)})

        if code == int(PlannerCalls.CALL_BATCH):
            # A lone call takes the ingress's immediate path; overlapping
            # ones share a tick, and ineligible requests pass through.
            # The queue wait is capped: this plane's few workers must
            # keep answering keep-alives, and a full cluster answers
            # NOT_ENOUGH_SLOTS as before the ingress
            req = ber_from_wire(h["ber"], msg.payload)
            wait_s = max(0.05, get_system_config().planner_tick_ms / 250)
            try:
                decision = planner.ingress.submit(
                    req, source=h.get("host", ""), timeout=wait_s)
            except IngressShedError:
                decision = not_enough_slots_decision()
            return handler_response(header={"decision": decision.to_dict()})

        if code == int(PlannerCalls.SUBMIT_BATCH):
            try:
                planner.ingress.submit_many(bers_from_wire(h, msg.payload),
                                            source=h.get("host", ""))
            except IngressShedError as e:
                return handler_response(header={
                    "accepted": False, "retry_after": e.retry_after,
                    "reason": e.reason})
            return handler_response(header={"accepted": True})

        if code == int(PlannerCalls.PRELOAD_SCHEDULING_DECISION):
            planner.preload_scheduling_decision(
                SchedulingDecision.from_dict(h["decision"]))
            return handler_response()

        raise ValueError(f"Unknown sync planner call {code}")
