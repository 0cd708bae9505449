"""Planner RPC server (ports 8011/8012).

Counterpart of ``faabric_tpu/planner/server.py`` (reference
src/planner/PlannerServer.cpp) for the calls that the gang path makes,
under the reference's call numbers. An expiry reaper drives host expiry
on a clock, so a dead worker's messages report FAILED even when nobody
schedules.
"""

from __future__ import annotations

import enum

from faabric_tpu_torch.planner.planner import get_planner
from faabric_tpu_torch.proto import (
    ber_from_wire,
    messages_from_wire,
    messages_to_wire,
)
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
from faabric_tpu_torch.util.periodic import PeriodicBackgroundThread


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
    CALL_BATCH = 10
    CLAIM_STATE_MASTER = 12
    DROP_STATE_MASTER = 13


class PlannerServer(MessageEndpointServer):
    def __init__(self, port_offset: int = 0, n_threads: int = 4) -> None:
        super().__init__(PLANNER_ASYNC_PORT + port_offset,
                         PLANNER_SYNC_PORT + port_offset,
                         label="planner-server", n_threads=n_threads)
        self.planner = get_planner()
        self.expiry_reaper = _ExpiryReaper(self.planner)

    def start(self) -> None:
        super().start()
        # Quarter of the host timeout: an expiry is seen well inside one
        # more keep-alive period
        timeout = get_system_config().planner_host_timeout
        self.expiry_reaper.start(max(0.5, timeout / 4.0))

    def stop(self) -> None:
        self.expiry_reaper.stop()
        super().stop()

    def do_async_recv(self, msg: TransportMessage) -> None:
        if msg.code != int(PlannerCalls.SET_MESSAGE_RESULT):
            raise ValueError(f"Unknown async planner call {msg.code}")
        # One result ("msg") or several ("msgs")
        dicts = msg.header.get("msgs") or [msg.header["msg"]]
        self.planner.set_message_results(
            messages_from_wire(dicts, msg.payload))

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
                                            "known": known})

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

        if code == int(PlannerCalls.CLAIM_STATE_MASTER):
            master, backup, epoch = planner.claim_state_master(
                h["user"], h["key"], h["host"])
            return handler_response(header={"master": master,
                                            "backup": backup,
                                            "epoch": epoch})

        if code == int(PlannerCalls.DROP_STATE_MASTER):
            planner.drop_state_master(h["user"], h["key"])
            return handler_response()

        if code == int(PlannerCalls.CALL_BATCH):
            decision = planner.call_batch(ber_from_wire(h["ber"],
                                                        msg.payload))
            return handler_response(header={"decision": decision.to_dict()})

        raise ValueError(f"Unknown sync planner call {code}")
