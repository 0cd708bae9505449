"""Wire framing: the frame of ``faabric_tpu/transport/message.py``.

A 24-byte header over a TCP stream carrying a JSON control section and a
raw binary tail, so big payloads never pass through JSON:

    magic u16 | code u8 | resp u8 | seqnum i64 | json_len u32 | bin_len u64

SHUTDOWN uses header code 220 with a magic payload, as the reference does
(Message.h:22-23).
"""

from __future__ import annotations

import dataclasses
import enum
import json
import socket
import struct
from typing import Any

HEADER_FMT = "<HBBqIQ"
HEADER_LEN = struct.calcsize(HEADER_FMT)
MAGIC = 0xFAAB

SHUTDOWN_CODE = 220
SHUTDOWN_PAYLOAD = b"\x00\x00\x42\x99"

NO_SEQUENCE_NUM = -1

# Sanity bounds on incoming frames: a corrupt/hostile frame with valid magic
# must not trigger a multi-GB allocation. The JSON control section is small
# by design (bulk data rides the binary tail); the tail is bounded at 8 GiB
# (largest legitimate payloads are snapshot contents / MPI buffers).
MAX_JSON_LEN = 64 * 1024 * 1024
MAX_BIN_LEN = 8 * 1024 * 1024 * 1024


class MessageResponseCode(enum.IntEnum):
    SUCCESS = 0
    TERM = 1
    TIMEOUT = 2
    ERROR = 3


class TransportError(Exception):
    pass


class ConnectionClosed(TransportError):
    pass


@dataclasses.dataclass
class TransportMessage:
    code: int
    header: dict[str, Any] = dataclasses.field(default_factory=dict)
    payload: bytes = b""
    seqnum: int = NO_SEQUENCE_NUM
    response_code: int = int(MessageResponseCode.SUCCESS)

    def is_shutdown(self) -> bool:
        return self.code == SHUTDOWN_CODE and self.payload == SHUTDOWN_PAYLOAD

    @classmethod
    def shutdown(cls) -> "TransportMessage":
        return cls(code=SHUTDOWN_CODE, payload=SHUTDOWN_PAYLOAD)


def send_frame(sock: socket.socket, msg: TransportMessage) -> None:
    """``msg.payload`` is bytes, or a list of byte buffers that go out
    back to back as one payload (an MPI payload's header and array,
    never joined into one copy)."""
    header_json = json.dumps(msg.header).encode() if msg.header else b""
    parts = (list(msg.payload) if isinstance(msg.payload, (list, tuple))
             else [msg.payload or b""])
    n_payload = sum(memoryview(p).nbytes for p in parts)
    head = struct.pack(
        HEADER_FMT,
        MAGIC,
        msg.code & 0xFF,
        msg.response_code & 0xFF,
        msg.seqnum,
        len(header_json),
        n_payload,
    )
    # One syscall for small messages; for large payloads sendall the tail
    # separately to avoid a copy of the payload bytes.
    if n_payload <= 65536:
        sock.sendall(b"".join([head, header_json, *parts]))
    else:
        sock.sendall(head + header_json)
        for p in parts:
            sock.sendall(p)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    if n == 0:
        return b""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    try:
        while got < n:
            r = sock.recv_into(view[got:], n - got)
            if r == 0:
                raise ConnectionClosed("Socket closed mid-frame")
            got += r
    except (ConnectionClosed, OSError) as e:
        e.bytes_read = got  # type: ignore[attr-defined]
        raise
    return bytes(buf)


def recv_frame(sock: socket.socket) -> TransportMessage:
    try:
        head = _recv_exact(sock, HEADER_LEN)
    except (ConnectionClosed, OSError) as e:
        # Nothing of the response arrived: lets callers distinguish a stale
        # keep-alive connection (safe to retry the request on a fresh dial)
        # from a connection dropped mid-response.
        if getattr(e, "bytes_read", 1) == 0:
            e.no_response_data = True  # type: ignore[attr-defined]
        raise
    magic, code, resp, seqnum, json_len, bin_len = struct.unpack(HEADER_FMT, head)
    if magic != MAGIC:
        raise TransportError(f"Bad frame magic: {magic:#x}")
    if json_len > MAX_JSON_LEN or bin_len > MAX_BIN_LEN:
        raise TransportError(
            f"Frame exceeds size bounds (json={json_len} B, bin={bin_len} B)")
    header_json = _recv_exact(sock, json_len)
    payload = _recv_exact(sock, bin_len)
    header = json.loads(header_json) if header_json else {}
    return TransportMessage(
        code=code, header=header, payload=payload, seqnum=seqnum, response_code=resp
    )



def tune_socket(sock: socket.socket) -> None:
    """Data-plane socket tuning, the reference's OpenMPI-style options:
    TCP_NODELAY and 16 MiB send and receive buffers."""
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    try:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 16 * 1024 * 1024)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 16 * 1024 * 1024)
    except OSError:
        pass
