"""Snapshot RPC: the server (ports 8007/8008) and its client, with mock
recording.

Counterpart of ``faabric_tpu/snapshot/remote.py`` (reference
src/snapshot/SnapshotServer.cpp:64-105, src/snapshot/SnapshotClient.cpp),
under the reference's call numbers and header fields, so a port client
talks to a reference server and the reverse. Snapshot contents and diff
bytes ride the frame's binary tail; merge regions and diff metadata
travel in the JSON header.

``THREAD_RESULT`` carries a remote thread's return value and its host's
diffs to the main host: the server queues the diffs on the snapshot when
it has it (a missing key drops them) and always hands the result to its
scheduler's ``set_thread_result_locally``, which wakes
``await_thread_result``. Each push is a ``snapshot`` span and a ``push``
event of the state ledger, as the reference's.
"""

from __future__ import annotations

import enum
import threading
import time
from typing import TYPE_CHECKING

from faabric_tpu_torch.proto import Message
from faabric_tpu_torch.snapshot.snapshot import (
    MergeRegion,
    SnapshotData,
    SnapshotDataType,
    SnapshotDiff,
    SnapshotMergeOperation,
)
from faabric_tpu_torch.telemetry import span
from faabric_tpu_torch.telemetry.statestats import get_state_stats
from faabric_tpu_torch.transport.client import MessageEndpointClient, _nbytes
from faabric_tpu_torch.transport.common import (
    SNAPSHOT_ASYNC_PORT,
    SNAPSHOT_SYNC_PORT,
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
    from faabric_tpu_torch.snapshot.registry import SnapshotRegistry

logger = get_logger(__name__)


class SnapshotCalls(enum.IntEnum):
    PUSH_SNAPSHOT = 1
    PUSH_SNAPSHOT_UPDATE = 2
    THREAD_RESULT = 3
    DELETE_SNAPSHOT = 4


# ---------------------------------------------------------------------------
# Mock recording (reference SnapshotClient mocks)
# ---------------------------------------------------------------------------
_mock_lock = threading.Lock()
_pushes: list[tuple[str, str, SnapshotData]] = []
_diff_pushes: list[tuple[str, str, list[SnapshotDiff]]] = []
_thread_results: list[tuple[str, int, int, int]] = []


def get_snapshot_pushes() -> list[tuple[str, str, SnapshotData]]:
    with _mock_lock:
        return list(_pushes)


def get_snapshot_diff_pushes() -> list[tuple[str, str, list[SnapshotDiff]]]:
    with _mock_lock:
        return list(_diff_pushes)


def get_mock_thread_results() -> list[tuple[str, int, int, int]]:
    with _mock_lock:
        return list(_thread_results)


def clear_mock_snapshot_requests() -> None:
    with _mock_lock:
        _pushes.clear()
        _diff_pushes.clear()
        _thread_results.clear()


# ---------------------------------------------------------------------------
# Wire helpers: diff metadata in the header, bytes back to back in the tail
# ---------------------------------------------------------------------------

def diffs_to_wire(diffs: list[SnapshotDiff]) -> tuple[list[dict], bytes]:
    metas = [d.to_dict() for d in diffs]
    return metas, b"".join(d.data for d in diffs)


def diffs_from_wire(metas: list[dict], tail: bytes) -> list[SnapshotDiff]:
    out = []
    off = 0
    for m in metas:
        length = int(m["length"])
        out.append(SnapshotDiff(
            offset=int(m["offset"]),
            data=tail[off:off + length],
            data_type=SnapshotDataType(m.get("data_type", 0)),
            operation=SnapshotMergeOperation(m.get("operation", 0)),
        ))
        off += length
    return out


class SnapshotClient(MessageEndpointClient):
    def __init__(self, host: str) -> None:
        super().__init__(host, SNAPSHOT_ASYNC_PORT, SNAPSHOT_SYNC_PORT)

    def push_snapshot(self, key: str, snap: SnapshotData) -> None:
        if is_mock_mode():
            with _mock_lock:
                _pushes.append((self.host, key, snap))
            return
        header = {
            "key": key,
            "max_size": snap.max_size,
            "merge_regions": [r.to_dict() for r in snap.get_merge_regions()],
        }
        logger.debug("Pushing snapshot %s (%d bytes) to %s", key,
                     snap.size, self.host)
        stats = get_state_stats()
        t0 = time.perf_counter() if stats.enabled else 0.0
        with span("snapshot", "push", key=key, nbytes=snap.size):
            # The image goes out as it lies, without a copy into bytes
            self.sync_send(int(SnapshotCalls.PUSH_SNAPSHOT), header,
                           [memoryview(snap.data)])
        if stats.enabled:
            stats.snapshot_event("push", nbytes=snap.size,
                                 seconds=time.perf_counter() - t0)

    def push_snapshot_update(self, key: str,
                             diffs: list[SnapshotDiff]) -> None:
        if is_mock_mode():
            with _mock_lock:
                _diff_pushes.append((self.host, key, diffs))
            return
        metas, tail = diffs_to_wire(diffs)
        stats = get_state_stats()
        t0 = time.perf_counter() if stats.enabled else 0.0
        with span("snapshot", "push_update", key=key, nbytes=_nbytes(tail)):
            self.sync_send(int(SnapshotCalls.PUSH_SNAPSHOT_UPDATE),
                           {"key": key, "diffs": metas}, tail)
        if stats.enabled:
            stats.snapshot_event("push", nbytes=_nbytes(tail),
                                 regions=len(diffs),
                                 seconds=time.perf_counter() - t0)

    def push_thread_result(self, app_id: int, msg_id: int, return_value: int,
                           key: str, diffs: list[SnapshotDiff]) -> None:
        """A remote THREADS result: the return value and this thread's
        diffs, queued on the main host's snapshot (reference
        pushThreadResult)."""
        if is_mock_mode():
            with _mock_lock:
                _thread_results.append((self.host, app_id, msg_id,
                                        return_value))
                _diff_pushes.append((self.host, key, diffs))
            return
        metas, tail = diffs_to_wire(diffs)
        stats = get_state_stats()
        t0 = time.perf_counter() if stats.enabled else 0.0
        with span("snapshot", "thread_result", key=key,
                  nbytes=_nbytes(tail)):
            self.sync_send(int(SnapshotCalls.THREAD_RESULT), {
                "app_id": app_id, "msg_id": msg_id,
                "return_value": return_value, "key": key, "diffs": metas,
            }, tail)
        if stats.enabled:
            stats.snapshot_event("push", nbytes=_nbytes(tail),
                                 regions=len(diffs),
                                 seconds=time.perf_counter() - t0)

    def delete_snapshot(self, key: str) -> None:
        if is_mock_mode():
            return
        self.async_send(int(SnapshotCalls.DELETE_SNAPSHOT), {"key": key})


class SnapshotServer(MessageEndpointServer):
    def __init__(self, registry: "SnapshotRegistry", host: str = "",
                 scheduler=None, port_offset: int | None = None) -> None:
        conf = get_system_config()
        offset = port_offset if port_offset is not None \
            else get_host_alias_offset(host)
        super().__init__(
            SNAPSHOT_ASYNC_PORT + offset,
            SNAPSHOT_SYNC_PORT + offset,
            label=f"snapshot-server-{host or 'local'}",
            n_threads=conf.snapshot_server_threads,
        )
        self.registry = registry
        self.scheduler = scheduler  # takes the thread results

    def do_async_recv(self, msg: TransportMessage) -> None:
        if msg.code == int(SnapshotCalls.DELETE_SNAPSHOT):
            self.registry.delete_snapshot(msg.header["key"])
        else:
            logger.warning("Unknown async snapshot call %d", msg.code)

    def do_sync_recv(self, msg: TransportMessage) -> TransportMessage:
        code = msg.code
        h = msg.header

        if code == int(SnapshotCalls.PUSH_SNAPSHOT):
            snap = SnapshotData(msg.payload, max_size=h.get("max_size", 0))
            for r in h.get("merge_regions", []):
                region = MergeRegion.from_dict(r)
                snap.add_merge_region(region.offset, region.length,
                                      region.data_type, region.operation)
            self.registry.register_snapshot(h["key"], snap)
            return handler_response()

        if code == int(SnapshotCalls.PUSH_SNAPSHOT_UPDATE):
            snap = self.registry.get_snapshot(h["key"])
            diffs = diffs_from_wire(h.get("diffs", []), msg.payload)
            snap.queue_diffs(diffs)
            return handler_response(header={"queued": len(diffs)})

        if code == int(SnapshotCalls.THREAD_RESULT):
            # The result is delivered whatever the snapshot lookup finds:
            # a missing or empty key drops the diffs, never the result
            key = h.get("key", "")
            snap = self.registry.try_get_snapshot(key) if key else None
            diffs = diffs_from_wire(h.get("diffs", []), msg.payload)
            if snap is not None:
                snap.queue_diffs(diffs)
            elif diffs:
                logger.warning(
                    "Dropping %d thread diffs for unknown snapshot %r",
                    len(diffs), key)
            if self.scheduler is not None:
                result = Message(id=h["msg_id"], app_id=h["app_id"],
                                 return_value=h["return_value"])
                self.scheduler.set_thread_result_locally(
                    result, h["return_value"])
            return handler_response()

        raise ValueError(f"Unknown sync snapshot call {code}")
