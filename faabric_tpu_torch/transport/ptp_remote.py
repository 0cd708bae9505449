"""Point-to-point RPC: server (ports 8009/8010) and client.

Counterpart of ``faabric_tpu/transport/ptp_remote.py`` (:94-264): the
server delivers arriving messages into its host's broker in sequence
order, runs lock and unlock requests for the groups whose main idx it
holds, installs mappings, clears finished groups and aborts groups
(``ABORT_GROUP``, :177-182, :254-260); the client sends them, and records them instead in mock mode. The planner pushes every
decision's mappings through ``send_mappings_from_decision``.

The server owns its host's ``BulkServer`` (``transport/bulk.py``) on
the host's alias offset: it starts it after itself and stops it first.
The broker sends large payloads, and every data-channel payload to a
peer on this machine, on that plane; this server keeps the coordination
channel and is every plane's fallback. Its clients count the messages
and bytes they send, by channel (``faabric_ptp_rpc_{frames,bytes}_total``).
"""

from __future__ import annotations

import enum
import threading

from faabric_tpu_torch.proto import PointToPointMappings
from faabric_tpu_torch.telemetry import get_metrics
from faabric_tpu_torch.transport.bulk import BulkServer
from faabric_tpu_torch.transport.client import MessageEndpointClient
from faabric_tpu_torch.transport.common import (
    POINT_TO_POINT_ASYNC_PORT,
    POINT_TO_POINT_SYNC_PORT,
    get_host_alias_offset,
)
from faabric_tpu_torch.transport.message import TransportMessage
from faabric_tpu_torch.transport.point_to_point import (
    PointToPointBroker,
    mappings_from_decision,
)
from faabric_tpu_torch.transport.server import (
    MessageEndpointServer,
    handler_response,
)
from faabric_tpu_torch.util.config import get_system_config
from faabric_tpu_torch.util.logging import get_logger
from faabric_tpu_torch.util.testing import is_mock_mode

logger = get_logger(__name__)


class PointToPointCall(enum.IntEnum):
    MESSAGE = 1
    LOCK_GROUP = 2
    LOCK_GROUP_RECURSIVE = 3
    UNLOCK_GROUP = 4
    UNLOCK_GROUP_RECURSIVE = 5
    MAPPING = 6
    CLEAR_GROUP = 7
    ABORT_GROUP = 8


_LOCK_CALLS = {
    PointToPointCall.LOCK_GROUP: (True, False),
    PointToPointCall.LOCK_GROUP_RECURSIVE: (True, True),
    PointToPointCall.UNLOCK_GROUP: (False, False),
    PointToPointCall.UNLOCK_GROUP_RECURSIVE: (False, True),
}

_CHANNELS = ((0, "data"), (1, "coord"))
_RPC_FRAMES = {
    channel: get_metrics().counter(
        "faabric_ptp_rpc_frames_total",
        "Point-to-point messages sent on the RPC plane", channel=name)
    for channel, name in _CHANNELS
}
_RPC_BYTES = {
    channel: get_metrics().counter(
        "faabric_ptp_rpc_bytes_total",
        "Point-to-point payload bytes sent on the RPC plane", channel=name)
    for channel, name in _CHANNELS
}


# Lock handlers run on the server's worker pool: a lock for a group
# whose mappings never come must not hold a worker for long
LOCK_MAPPING_WAIT_SECONDS = 5.0


# ---------------------------------------------------------------------------
# Mock recording (reference PointToPointClient.cpp:11-48)
# ---------------------------------------------------------------------------
_mock_lock = threading.Lock()
# (host, group_id, send_idx, recv_idx, payload)
_sent_messages: list[tuple[str, int, int, int, bytes]] = []
# (host, PointToPointMappings)
_sent_mappings: list[tuple[str, PointToPointMappings]] = []
# (call, host, group_id, group_idx)
_lock_ops: list[tuple[int, str, int, int]] = []


def get_sent_ptp_messages() -> list[tuple[str, int, int, int, bytes]]:
    with _mock_lock:
        return list(_sent_messages)


def get_sent_mappings() -> list[tuple[str, PointToPointMappings]]:
    with _mock_lock:
        return list(_sent_mappings)


def get_lock_ops() -> list[tuple[int, str, int, int]]:
    with _mock_lock:
        return list(_lock_ops)


def clear_sent_ptp() -> None:
    with _mock_lock:
        _sent_messages.clear()
        _sent_mappings.clear()
        _lock_ops.clear()


# ---------------------------------------------------------------------------

class PointToPointClient(MessageEndpointClient):
    def __init__(self, host: str) -> None:
        super().__init__(host, POINT_TO_POINT_ASYNC_PORT,
                         POINT_TO_POINT_SYNC_PORT)

    def send_mappings(self, mappings: PointToPointMappings) -> None:
        if is_mock_mode():
            with _mock_lock:
                _sent_mappings.append((self.host, mappings))
            return
        self.sync_send(int(PointToPointCall.MAPPING),
                       {"mappings": mappings.to_dict()}, idempotent=True)

    def send_message(self, group_id: int, send_idx: int, recv_idx: int,
                     data, seq: int = -1, channel: int = 0) -> None:
        """``data`` is bytes, or a list of byte buffers sent back to back
        as one payload (an MPI payload's header and array)."""
        if is_mock_mode():
            if isinstance(data, list):
                data = b"".join(bytes(b) for b in data)
            with _mock_lock:
                _sent_messages.append(
                    (self.host, group_id, send_idx, recv_idx, data))
            return
        if channel in _RPC_FRAMES:
            _RPC_FRAMES[channel].inc()
            _RPC_BYTES[channel].inc(
                sum(memoryview(b).nbytes for b in data)
                if isinstance(data, list) else len(data))
        self.async_send(int(PointToPointCall.MESSAGE), {
            "group_id": group_id, "send_idx": send_idx, "recv_idx": recv_idx,
            "channel": channel,
        }, data, seqnum=seq)

    def _lock_op(self, call: PointToPointCall, app_id: int, group_id: int,
                 group_idx: int) -> None:
        if is_mock_mode():
            with _mock_lock:
                _lock_ops.append((int(call), self.host, group_id, group_idx))
            return
        self.async_send(int(call), {"app_id": app_id, "group_id": group_id,
                                    "group_idx": group_idx})

    def group_lock(self, app_id: int, group_id: int, group_idx: int,
                   recursive: bool = False) -> None:
        self._lock_op(PointToPointCall.LOCK_GROUP_RECURSIVE if recursive
                      else PointToPointCall.LOCK_GROUP,
                      app_id, group_id, group_idx)

    def group_unlock(self, app_id: int, group_id: int, group_idx: int,
                     recursive: bool = False) -> None:
        self._lock_op(PointToPointCall.UNLOCK_GROUP_RECURSIVE if recursive
                      else PointToPointCall.UNLOCK_GROUP,
                      app_id, group_id, group_idx)

    def clear_groups(self, group_ids: list[int]) -> None:
        if is_mock_mode() or not group_ids:
            return
        self.async_send(int(PointToPointCall.CLEAR_GROUP),
                        {"group_ids": list(group_ids)})

    def abort_group(self, group_id: int, reason: str) -> None:
        if is_mock_mode():
            return
        self.async_send(int(PointToPointCall.ABORT_GROUP),
                        {"group_id": group_id, "reason": reason})


class PointToPointServer(MessageEndpointServer):
    def __init__(self, broker: PointToPointBroker) -> None:
        offset = get_host_alias_offset(broker.host)
        super().__init__(
            POINT_TO_POINT_ASYNC_PORT + offset,
            POINT_TO_POINT_SYNC_PORT + offset,
            label=f"ptp-server-{broker.host}",
            n_threads=get_system_config().point_to_point_server_threads,
        )
        self.broker = broker
        self._bulk_server = BulkServer(broker, port_offset=offset)

    def start(self) -> None:
        super().start()
        self._bulk_server.start()

    def stop(self) -> None:
        self._bulk_server.stop()
        super().stop()

    def do_async_recv(self, msg: TransportMessage) -> None:
        h = msg.header
        code = PointToPointCall(msg.code)
        if code == PointToPointCall.MESSAGE:
            self.broker.deliver(h["group_id"], h["send_idx"], h["recv_idx"],
                                msg.payload, msg.seqnum, h.get("channel", 0))
        elif code in _LOCK_CALLS:
            is_lock, recursive = _LOCK_CALLS[code]
            # The mappings may still be on their way when the first lock
            # arrives
            try:
                self.broker.wait_for_mappings(h["group_id"],
                                              LOCK_MAPPING_WAIT_SECONDS)
            except TimeoutError:
                logger.warning("Dropping %s for unknown group %d",
                               "lock" if is_lock else "unlock",
                               h["group_id"])
                return
            group = self.broker.get_group(h["group_id"])
            if is_lock:
                group.lock(h["group_idx"], recursive)
            else:
                group.unlock(h["group_idx"], recursive)
        elif code == PointToPointCall.CLEAR_GROUP:
            for gid in h["group_ids"]:
                self.broker.clear_group(gid)
        elif code == PointToPointCall.ABORT_GROUP:
            # The originator told every member host itself: passing the
            # abort on would only bounce it around the group
            self.broker.abort_group(h["group_id"],
                                    h.get("reason", "remote abort"),
                                    propagate=False)
        else:
            raise ValueError(f"Unknown async PTP call {msg.code}")

    def do_sync_recv(self, msg: TransportMessage) -> TransportMessage:
        if msg.code == int(PointToPointCall.MAPPING):
            self.broker.set_up_local_mappings_from_mappings(
                PointToPointMappings.from_dict(msg.header["mappings"]))
            return handler_response()
        raise ValueError(f"Unknown sync PTP call {msg.code}")


# ---------------------------------------------------------------------------
# Planner-side mapping distribution and group cleanup
# (reference PointToPointBroker::setAndSendMappingsFromSchedulingDecision)
# ---------------------------------------------------------------------------

_dist_clients: dict[str, PointToPointClient] = {}
_dist_lock = threading.Lock()


def _get_dist_client(host: str) -> PointToPointClient:
    with _dist_lock:
        client = _dist_clients.get(host)
        if client is None:
            client = _dist_clients[host] = PointToPointClient(host)
        return client


def send_mappings_from_decision(decision) -> None:
    """Install the decision's group mappings on every host it involves.
    A host that cannot be reached is logged and skipped, so it does not
    stall the others."""
    if decision.n_messages == 0 or not decision.group_id:
        return
    mappings = mappings_from_decision(decision)
    for host in decision.unique_hosts():
        try:
            _get_dist_client(host).send_mappings(mappings)
        except Exception:  # noqa: BLE001 — a dead host must not stall others
            logger.exception("Failed sending mappings of group %d to %s",
                             decision.group_id, host)


def send_clear_groups(host: str, group_ids: list[int]) -> None:
    """Tell ``host`` to drop finished groups' broker state."""
    try:
        _get_dist_client(host).clear_groups(group_ids)
    except Exception:  # noqa: BLE001 — cleanup is best-effort
        logger.exception("Failed sending clear-groups %s to %s", group_ids,
                         host)


def close_mapping_clients() -> None:
    with _dist_lock:
        clients = list(_dist_clients.values())
        _dist_clients.clear()
    for c in clients:
        c.close()
