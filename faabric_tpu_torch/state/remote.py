"""State RPC: the server (ports 8003/8004) and its client, with mock
recording.

Counterpart of ``faabric_tpu/state/remote.py`` (reference
src/state/StateServer.cpp, include/faabric/state/State.h:11-21), under
the reference's call numbers and header fields, so a port client talks
to a reference server and the reverse. Chunk bytes ride the frame's
binary tail. Every op carries the key's fencing ``epoch`` (kept off the
wire when 0, the unreplicated header shape). REPLICATE and
REPLICATE_APPEND carry a master's forwards into its backup's passive
:class:`~faabric_tpu_torch.state.replica.StateReplica`; PROMOTE turns
that replica into the master after a failover. A master op older than
the receiver's epoch raises :class:`StaleStateEpoch`, whose text crosses
the transport's error channel: clients re-resolve through the planner
and retry.
"""

from __future__ import annotations

import enum
import threading
from typing import TYPE_CHECKING

from faabric_tpu_torch.transport.client import MessageEndpointClient
from faabric_tpu_torch.transport.common import (
    STATE_ASYNC_PORT,
    STATE_SYNC_PORT,
    get_host_alias_offset,
)
from faabric_tpu_torch.transport.message import TransportMessage
from faabric_tpu_torch.transport.server import (
    MessageEndpointServer,
    handler_response,
)
from faabric_tpu_torch.util.config import get_system_config
from faabric_tpu_torch.util.logging import get_logger
from faabric_tpu_torch.util.testing import is_mock_mode

if TYPE_CHECKING:  # pragma: no cover
    from faabric_tpu_torch.state.state import State

logger = get_logger(__name__)


class StateCalls(enum.IntEnum):
    PULL = 1
    PUSH = 2
    SIZE = 3
    APPEND = 4
    PULL_APPENDED = 5
    CLEAR_APPENDED = 6
    DELETE = 7
    LOCK = 8
    UNLOCK = 9
    # Replication: master -> backup forwards, and the planner's
    # promotion after a failover
    REPLICATE = 10
    REPLICATE_APPEND = 11
    PROMOTE = 12


_mock_lock = threading.Lock()
# (host, user, key, offset, data)
_mock_pushes: list[tuple[str, str, str, int, bytes]] = []


def get_mock_state_pushes() -> list[tuple[str, str, str, int, bytes]]:
    with _mock_lock:
        return list(_mock_pushes)


def clear_mock_state_requests() -> None:
    with _mock_lock:
        _mock_pushes.clear()


def _with_epoch(header: dict, epoch: int) -> dict:
    # Epoch 0 stays off the wire: the unreplicated header shape
    if epoch:
        header["epoch"] = epoch
    return header


def _split(payload: bytes, lengths) -> list[bytes]:
    out, off = [], 0
    for n in lengths:
        out.append(payload[off:off + n])
        off += n
    return out


class StateClient(MessageEndpointClient):
    def __init__(self, host: str) -> None:
        super().__init__(host, STATE_ASYNC_PORT, STATE_SYNC_PORT)

    def pull_chunk(self, user: str, key: str, offset: int,
                   length: int, epoch: int = 0) -> bytes:
        resp = self.sync_send(int(StateCalls.PULL), _with_epoch({
            "user": user, "key": key, "offset": offset, "length": length,
        }, epoch), idempotent=True)
        return resp.payload

    def push_chunk(self, user: str, key: str, offset: int,
                   data: bytes, epoch: int = 0) -> None:
        if is_mock_mode():
            with _mock_lock:
                _mock_pushes.append((self.host, user, key, offset, data))
            return
        # Idempotent: the same bytes pushed twice converge
        self.sync_send(int(StateCalls.PUSH), _with_epoch(
            {"user": user, "key": key, "offset": offset}, epoch), data,
            idempotent=True)

    def state_size(self, user: str, key: str, epoch: int = 0) -> int:
        resp = self.sync_send(int(StateCalls.SIZE), _with_epoch(
            {"user": user, "key": key}, epoch), idempotent=True)
        return int(resp.header["size"])

    def append(self, user: str, key: str, data: bytes,
               epoch: int = 0) -> None:
        self.sync_send(int(StateCalls.APPEND), _with_epoch(
            {"user": user, "key": key}, epoch), data)

    def pull_appended(self, user: str, key: str,
                      n_values: int, epoch: int = 0) -> list[bytes]:
        resp = self.sync_send(int(StateCalls.PULL_APPENDED), _with_epoch({
            "user": user, "key": key, "n_values": n_values,
        }, epoch), idempotent=True)
        return _split(resp.payload, resp.header.get("lengths", []))

    def clear_appended(self, user: str, key: str, epoch: int = 0) -> None:
        self.sync_send(int(StateCalls.CLEAR_APPENDED), _with_epoch(
            {"user": user, "key": key}, epoch), idempotent=True)

    def delete(self, user: str, key: str) -> None:
        self.sync_send(int(StateCalls.DELETE),
                       {"user": user, "key": key}, idempotent=True)

    def lock(self, user: str, key: str, epoch: int = 0) -> None:
        self.sync_send(int(StateCalls.LOCK), _with_epoch(
            {"user": user, "key": key}, epoch))

    def unlock(self, user: str, key: str, epoch: int = 0) -> None:
        self.sync_send(int(StateCalls.UNLOCK), _with_epoch(
            {"user": user, "key": key}, epoch))

    # -- replication (master and planner side) --------------------------
    def replicate_chunks(self, user: str, key: str, epoch: int,
                         size: int, writes: list[tuple[int, bytes]]) -> None:
        """Forward written chunks to the backup. Idempotent: the same
        bytes at the same epoch converge."""
        if is_mock_mode():
            return
        self.sync_send(int(StateCalls.REPLICATE), {
            "user": user, "key": key, "epoch": epoch, "size": size,
            "offsets": [int(o) for o, _d in writes],
            "lengths": [len(d) for _o, d in writes],
        }, b"".join(d for _o, d in writes), idempotent=True)

    def replicate_append(self, user: str, key: str, epoch: int, size: int,
                         values: list[bytes], replace: bool = False) -> None:
        """Forward appended values; ``replace`` swaps the whole log (a
        full sync), which makes it idempotent, unlike the additive form."""
        if is_mock_mode():
            return
        self.sync_send(int(StateCalls.REPLICATE_APPEND), {
            "user": user, "key": key, "epoch": epoch, "size": size,
            "lengths": [len(v) for v in values], "replace": bool(replace),
        }, b"".join(values), idempotent=bool(replace))

    def promote(self, user: str, key: str, epoch: int,
                backup: str) -> bool:
        """Planner -> new master after a failover: turn the host's
        replica into the master copy at ``epoch`` and sync ``backup``.
        False: no replica there."""
        if is_mock_mode():
            return True
        resp = self.sync_send(int(StateCalls.PROMOTE), {
            "user": user, "key": key, "epoch": epoch, "backup": backup,
        }, idempotent=True)
        return bool(resp.header.get("ok"))


class StateServer(MessageEndpointServer):
    def __init__(self, state: "State", host: str = "") -> None:
        offset = get_host_alias_offset(host or state.host)
        super().__init__(
            STATE_ASYNC_PORT + offset,
            STATE_SYNC_PORT + offset,
            label=f"state-server-{host or state.host}",
            n_threads=get_system_config().state_server_threads,
        )
        self.state = state

    def do_async_recv(self, msg: TransportMessage) -> None:
        logger.warning("Unknown async state call %d", msg.code)

    def do_sync_recv(self, msg: TransportMessage) -> TransportMessage:
        code = msg.code
        h = msg.header
        user, key = h["user"], h["key"]

        # The replication calls reach the backup, which holds no master
        # KV: they come before the master check
        if code == int(StateCalls.REPLICATE):
            writes = list(zip((int(o) for o in h["offsets"]),
                              _split(msg.payload, h["lengths"])))
            self.state.apply_replica_chunks(
                user, key, int(h["epoch"]), int(h["size"]), writes)
            return handler_response()

        if code == int(StateCalls.REPLICATE_APPEND):
            self.state.apply_replica_append(
                user, key, int(h["epoch"]), int(h["size"]),
                _split(msg.payload, h["lengths"]),
                replace=bool(h.get("replace")))
            return handler_response()

        if code == int(StateCalls.PROMOTE):
            ok = self.state.promote_replica(
                user, key, int(h["epoch"]), h.get("backup", ""))
            return handler_response(header={"ok": ok})

        req_epoch = int(h.get("epoch", 0))
        kv = self.state.try_get_kv(user, key)
        if (kv is None or not kv.is_master) and req_epoch:
            # A fenced client op can arrive after a failover before (or
            # instead of) the planner's PROMOTE: a replica older than
            # the request is the owner's data, so promote it now
            kv = self.state.maybe_self_promote(user, key, req_epoch)
        if kv is None or not kv.is_master:
            raise KeyError(f"Host is not master for state {user}/{key}")

        # Reject ops older than our epoch, adopt newer ones, reject all
        # once this master knows it was fenced out
        kv.check_epoch(req_epoch)

        if code == int(StateCalls.PULL):
            return handler_response(
                payload=kv.server_pull_chunk(h["offset"], h["length"]))

        if code == int(StateCalls.PUSH):
            kv.server_push_chunk(h["offset"], msg.payload)
            return handler_response()

        if code == int(StateCalls.SIZE):
            return handler_response(header={"size": kv.size})

        if code == int(StateCalls.APPEND):
            kv.server_append(msg.payload)
            return handler_response()

        if code == int(StateCalls.PULL_APPENDED):
            values = kv.get_appended(h["n_values"])
            return handler_response(
                header={"lengths": [len(v) for v in values]},
                payload=b"".join(values))

        if code == int(StateCalls.CLEAR_APPENDED):
            kv.clear_appended()
            return handler_response()

        if code == int(StateCalls.DELETE):
            self.state.delete_kv(user, key)
            return handler_response()

        if code == int(StateCalls.LOCK):
            kv.lock_global()
            return handler_response()

        if code == int(StateCalls.UNLOCK):
            kv.unlock_global()
            return handler_response()

        raise ValueError(f"Unknown sync state call {code}")
