"""Message schema: a copy of ``faabric_tpu/proto.py``.

Dataclasses for messages, batches, their status and the point-to-point
mappings, with the same JSON form and the same wire form: control
fields travel as JSON and the input/output payloads in the transport
frame's binary tail, so both packages encode a message to the same
bytes and decode each other's.
"""

from __future__ import annotations

import dataclasses
import enum
import json
import time
from typing import Any

from faabric_tpu_torch.util.gids import generate_gid


class BatchExecuteType(enum.IntEnum):
    # faabric.proto:26-31
    FUNCTIONS = 0
    THREADS = 1
    PROCESSES = 2
    MIGRATION = 3


class MessageType(enum.IntEnum):
    # faabric.proto:93-99
    CALL = 0
    KILL = 1
    EMPTY = 2
    FLUSH = 3


class ReturnValue(enum.IntEnum):
    SUCCESS = 0
    FAILED = 1
    MIGRATED = -99  # MIGRATED_FUNCTION_RETURN_VALUE
    FROZEN = -98


@dataclasses.dataclass
class Message:
    """A single function invocation (faabric.proto:91-151)."""

    id: int = 0
    app_id: int = 0
    app_idx: int = 0
    main_host: str = ""
    type: int = int(MessageType.CALL)

    user: str = ""
    function: str = ""

    input_data: bytes = b""
    output_data: bytes = b""

    timestamp: float = 0.0
    executed_host: str = ""
    finish_timestamp: float = 0.0

    return_value: int = 0

    # Snapshots
    snapshot_key: str = ""

    # Function groups (PTP)
    group_id: int = 0
    group_idx: int = 0
    group_size: int = 0

    # MPI
    is_mpi: bool = False
    mpi_world_id: int = 0
    mpi_rank: int = 0
    mpi_world_size: int = 0

    # OpenMP-style shared-memory parallelism
    is_omp: bool = False
    omp_num_threads: int = 0

    # Exec-graph
    record_exec_graph: bool = False
    exec_graph_details: dict[str, str] = dataclasses.field(default_factory=dict)
    int_exec_graph_details: dict[str, int] = dataclasses.field(default_factory=dict)
    chained_msg_ids: list[int] = dataclasses.field(default_factory=list)

    # Migration
    is_migration: bool = False

    # Invocation lifecycle ledger: phase → monotonic ns stamp. The port
    # stamps nothing yet; the field rides the wire untouched so a
    # message keeps the stamps the reference's hosts put on it.
    lc: dict[str, int] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict[str, Any]:
        """REST/journal form: payloads hex-encoded in place. Built on
        the one hand-rolled field list (to_wire_dict)."""
        d = self.to_wire_dict()
        d["input_data"] = self.input_data.hex()
        d["output_data"] = self.output_data.hex()
        return d

    def to_wire_dict(self) -> dict[str, Any]:
        """THE hand-rolled field dict (the list must track the
        dataclass): payload fields carry LENGTHS — the bytes ride the
        transport frame's binary tail. Hand-rolled, not
        dataclasses.asdict (which deep-copies recursively): this
        sits on every dispatch, result push and journal append."""
        return {
            "id": self.id,
            "app_id": self.app_id,
            "app_idx": self.app_idx,
            "main_host": self.main_host,
            "type": self.type,
            "user": self.user,
            "function": self.function,
            "input_data": len(self.input_data),
            "output_data": len(self.output_data),
            "timestamp": self.timestamp,
            "executed_host": self.executed_host,
            "finish_timestamp": self.finish_timestamp,
            "return_value": self.return_value,
            "snapshot_key": self.snapshot_key,
            "group_id": self.group_id,
            "group_idx": self.group_idx,
            "group_size": self.group_size,
            "is_mpi": self.is_mpi,
            "mpi_world_id": self.mpi_world_id,
            "mpi_rank": self.mpi_rank,
            "mpi_world_size": self.mpi_world_size,
            "is_omp": self.is_omp,
            "omp_num_threads": self.omp_num_threads,
            "record_exec_graph": self.record_exec_graph,
            "exec_graph_details": dict(self.exec_graph_details),
            "int_exec_graph_details": dict(self.int_exec_graph_details),
            "chained_msg_ids": list(self.chained_msg_ids),
            "is_migration": self.is_migration,
            "lc": dict(self.lc),
        }

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Message":
        d = dict(d)
        d["input_data"] = bytes.fromhex(d.get("input_data", ""))
        d["output_data"] = bytes.fromhex(d.get("output_data", ""))
        field_names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in field_names})


@dataclasses.dataclass
class HostResources:
    # faabric.proto:75-78
    slots: int = 0
    used_slots: int = 0

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "HostResources":
        return cls(slots=d.get("slots", 0), used_slots=d.get("used_slots", 0))


@dataclasses.dataclass
class BatchExecuteRequest:
    """A batch of messages executed as one app (faabric.proto:21-60)."""

    app_id: int = 0
    group_id: int = 0
    user: str = ""
    function: str = ""
    type: int = int(BatchExecuteType.FUNCTIONS)
    # Tenant/user tag for multi-tenant scheduling (reference wedges this into
    # the protobuf subtype field; CompactScheduler.cpp filterHosts).
    subtype: int = 0
    messages: list[Message] = dataclasses.field(default_factory=list)

    # Single-host optimisations
    single_host_hint: bool = False
    single_host: bool = False

    # Elastic scaling hint (OpenMP fork grows to free slots on main host)
    elastic_scale_hint: bool = False

    # Main-thread snapshot for THREADS batches
    snapshot_key: str = ""

    # Migration / spot
    evicted_host: str = ""

    def n_messages(self) -> int:
        return len(self.messages)

    def to_dict(self) -> dict[str, Any]:
        return {
            "app_id": self.app_id,
            "group_id": self.group_id,
            "user": self.user,
            "function": self.function,
            "type": self.type,
            "subtype": self.subtype,
            "messages": [m.to_dict() for m in self.messages],
            "single_host_hint": self.single_host_hint,
            "single_host": self.single_host,
            "elastic_scale_hint": self.elastic_scale_hint,
            "snapshot_key": self.snapshot_key,
            "evicted_host": self.evicted_host,
        }

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "BatchExecuteRequest":
        req = cls(
            app_id=d.get("app_id", 0),
            group_id=d.get("group_id", 0),
            user=d.get("user", ""),
            function=d.get("function", ""),
            type=d.get("type", 0),
            subtype=d.get("subtype", 0),
            single_host_hint=d.get("single_host_hint", False),
            single_host=d.get("single_host", False),
            elastic_scale_hint=d.get("elastic_scale_hint", False),
            snapshot_key=d.get("snapshot_key", ""),
            evicted_host=d.get("evicted_host", ""),
        )
        req.messages = [Message.from_dict(m) for m in d.get("messages", [])]
        return req


@dataclasses.dataclass
class BatchExecuteRequestStatus:
    # faabric.proto:62-73
    app_id: int = 0
    finished: bool = False
    message_results: list[Message] = dataclasses.field(default_factory=list)
    expected_num_messages: int = 0

    def to_dict(self) -> dict[str, Any]:
        return {
            "app_id": self.app_id,
            "finished": self.finished,
            "message_results": [m.to_dict() for m in self.message_results],
            "expected_num_messages": self.expected_num_messages,
        }

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "BatchExecuteRequestStatus":
        s = cls(
            app_id=d.get("app_id", 0),
            finished=d.get("finished", False),
            expected_num_messages=d.get("expected_num_messages", 0),
        )
        s.message_results = [Message.from_dict(m) for m in d.get("message_results", [])]
        return s


@dataclasses.dataclass
class PointToPointMessage:
    # faabric.proto:208-219 — payload travels in the transport binary tail
    app_id: int = 0
    group_id: int = 0
    send_idx: int = 0
    recv_idx: int = 0

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "PointToPointMessage":
        return cls(
            app_id=d.get("app_id", 0),
            group_id=d.get("group_id", 0),
            send_idx=d.get("send_idx", 0),
            recv_idx=d.get("recv_idx", 0),
        )


@dataclasses.dataclass
class PointToPointMapping:
    # faabric.proto:221-230 (one entry of PointToPointMappings, + mpiPort)
    host: str = ""
    message_id: int = 0
    app_idx: int = 0
    group_idx: int = 0
    mpi_port: int = 0
    device_ids: list[int] = dataclasses.field(default_factory=list)

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "PointToPointMapping":
        return cls(
            host=d.get("host", ""),
            message_id=d.get("message_id", 0),
            app_idx=d.get("app_idx", 0),
            group_idx=d.get("group_idx", 0),
            mpi_port=d.get("mpi_port", 0),
            device_ids=list(d.get("device_ids", [])),
        )


@dataclasses.dataclass
class PointToPointMappings:
    app_id: int = 0
    group_id: int = 0
    mappings: list[PointToPointMapping] = dataclasses.field(default_factory=list)

    def to_dict(self) -> dict[str, Any]:
        return {
            "app_id": self.app_id,
            "group_id": self.group_id,
            "mappings": [m.to_dict() for m in self.mappings],
        }

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "PointToPointMappings":
        out = cls(app_id=d.get("app_id", 0), group_id=d.get("group_id", 0))
        out.mappings = [PointToPointMapping.from_dict(m) for m in d.get("mappings", [])]
        return out


@dataclasses.dataclass
class PendingMigration:
    # faabric.proto:236-242
    app_id: int = 0
    group_id: int = 0
    group_idx: int = 0
    src_host: str = ""
    dst_host: str = ""

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "PendingMigration":
        return cls(**{k: d.get(k, v) for k, v in
                      (("app_id", 0), ("group_id", 0), ("group_idx", 0),
                       ("src_host", ""), ("dst_host", ""))})


# ---------------------------------------------------------------------------
# Factories (reference: include/faabric/util/batch.h:11-39, func.h:29-57)
# ---------------------------------------------------------------------------

def message_factory(user: str, function: str) -> Message:
    msg = Message(
        id=generate_gid(),
        app_id=generate_gid(),
        user=user,
        function=function,
        timestamp=time.time(),
    )
    return msg


def batch_exec_factory(user: str, function: str, count: int = 1) -> BatchExecuteRequest:
    req = BatchExecuteRequest(app_id=generate_gid(), user=user, function=function)
    for i in range(count):
        msg = message_factory(user, function)
        msg.app_id = req.app_id
        msg.app_idx = i
        req.messages.append(msg)
    return req


def func_to_string(msg: Message, include_id: bool = False) -> str:
    base = f"{msg.user}/{msg.function}"
    if include_id:
        base += f":{msg.id}"
    return base


def get_main_thread_snapshot_key(msg: Message) -> str:
    # reference src/util/func.cpp:152 — key must include the app id so two
    # concurrent apps of the same function never share a main-thread snapshot
    if msg.app_id <= 0:
        raise ValueError(f"Invalid app id for snapshot key: {msg.app_id}")
    return f"{msg.user}/{msg.function}_{msg.app_id}"


def is_batch_exec_request_valid(req: BatchExecuteRequest | None) -> bool:
    if req is None:
        return False
    if not req.user or not req.function:
        return False
    return req.n_messages() > 0


def update_batch_exec_app_id(req: BatchExecuteRequest, app_id: int) -> None:
    req.app_id = app_id
    for m in req.messages:
        m.app_id = app_id


def update_batch_exec_group_id(req: BatchExecuteRequest, group_id: int) -> None:
    req.group_id = group_id
    for m in req.messages:
        m.group_id = group_id


def message_to_json(msg: Message) -> str:
    return json.dumps(msg.to_dict())


def message_from_json(s: str) -> Message:
    return Message.from_dict(json.loads(s))


# ---------------------------------------------------------------------------
# Wire form: binary-tail payload convention.
#
# Hex-in-JSON (to_dict/from_dict) is reserved for the human-facing REST
# surface. RPC transport uses these helpers instead: message control fields
# travel as JSON, while input/output payloads are concatenated into the
# transport frame's binary tail (the flatbuffers analog, src/flat/faabric.fbs)
# so bulk data never passes through JSON.
# ---------------------------------------------------------------------------

def messages_to_wire(msgs: list[Message]) -> tuple[list[dict[str, Any]], bytes]:
    tail = bytearray()
    dicts: list[dict[str, Any]] = []
    for m in msgs:
        # to_wire_dict, not dataclasses.asdict: asdict deep-copies
        # recursively, and this sits on every dispatch and result push
        dicts.append(m.to_wire_dict())
        tail += m.input_data
        tail += m.output_data
    return dicts, bytes(tail)


def messages_from_wire(dicts: list[dict[str, Any]], tail: bytes) -> list[Message]:
    field_names = {f.name for f in dataclasses.fields(Message)}
    msgs: list[Message] = []
    off = 0
    for d in dicts:
        d = dict(d)
        in_len = int(d.get("input_data", 0))
        out_len = int(d.get("output_data", 0))
        if in_len < 0 or out_len < 0 or off + in_len + out_len > len(tail):
            raise ValueError(
                f"Wire message payload lengths ({in_len}, {out_len}) do not "
                f"fit the binary tail (offset {off}, tail {len(tail)})"
            )
        d["input_data"] = tail[off:off + in_len]
        off += in_len
        d["output_data"] = tail[off:off + out_len]
        off += out_len
        msgs.append(Message(**{k: v for k, v in d.items() if k in field_names}))
    if off != len(tail):
        raise ValueError(f"Binary tail has {len(tail) - off} trailing bytes")
    return msgs


def ber_to_wire(req: BatchExecuteRequest) -> tuple[dict[str, Any], bytes]:
    # Build the header directly — req.to_dict() would hex-encode every
    # payload only for it to be discarded, which is exactly what the binary
    # tail exists to avoid.
    msg_dicts, tail = messages_to_wire(req.messages)
    header = {
        "app_id": req.app_id,
        "group_id": req.group_id,
        "user": req.user,
        "function": req.function,
        "type": req.type,
        "subtype": req.subtype,
        "messages": msg_dicts,
        "single_host_hint": req.single_host_hint,
        "single_host": req.single_host,
        "elastic_scale_hint": req.elastic_scale_hint,
        "snapshot_key": req.snapshot_key,
        "evicted_host": req.evicted_host,
    }
    return header, tail


def bers_to_wire(reqs: list[BatchExecuteRequest]
                 ) -> tuple[dict[str, Any], bytes]:
    """Pipelined wire form: many independent batches in one
    frame — per-request headers under ``bers`` with per-request tail
    lengths under ``tails``, binary tails concatenated in order. Shared
    by EXECUTE_BATCHES dispatch and bulk SUBMIT_BATCH so the offset
    arithmetic exists exactly once per direction."""
    headers: list[dict[str, Any]] = []
    tails: list[bytes] = []
    for req in reqs:
        header, tail = ber_to_wire(req)
        headers.append(header)
        tails.append(tail)
    return ({"bers": headers, "tails": [len(t) for t in tails]},
            b"".join(tails))


def bers_from_wire(header: dict[str, Any],
                   payload: bytes) -> list[BatchExecuteRequest]:
    """Inverse of ``bers_to_wire``."""
    bers = header.get("bers", [])
    lengths = [int(n) for n in header.get("tails", [])]
    if len(bers) != len(lengths):
        raise ValueError(
            f"Wire batch list has {len(bers)} headers but "
            f"{len(lengths)} tail lengths")
    if sum(lengths) != len(payload):
        raise ValueError(
            f"Wire batch tails declare {sum(lengths)} bytes but the "
            f"payload carries {len(payload)}")
    out: list[BatchExecuteRequest] = []
    off = 0
    for h, n in zip(bers, lengths):
        out.append(ber_from_wire(h, payload[off:off + n]))
        off += n
    return out


def ber_from_wire(header: dict[str, Any], tail: bytes) -> BatchExecuteRequest:
    d = dict(header)
    msg_dicts = d.pop("messages", [])
    req = BatchExecuteRequest.from_dict({**d, "messages": []})
    req.messages = messages_from_wire(msg_dicts, tail)
    return req
