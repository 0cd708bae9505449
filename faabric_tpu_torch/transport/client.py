"""RPC client base.

Counterpart of ``faabric_tpu/transport/client.py``
(``MessageEndpointClient``): one persistent connection per plane (async
push, sync request and response), dialled lazily through the host alias
table, with a ``RetryPolicy`` (exponential backoff with jitter) and a
circuit breaker per peer, so a peer that keeps failing fails the next
call at once. Connections go through ``safe_create_connection``.
"""

from __future__ import annotations

import socket
import threading
from typing import Any

from faabric_tpu_torch.transport.common import (
    DEFAULT_SOCKET_TIMEOUT,
    resolve_host,
)
from faabric_tpu_torch.transport.message import (
    MessageResponseCode,
    TransportError,
    TransportMessage,
    recv_frame,
    send_frame,
)
from faabric_tpu_torch.util.network import safe_create_connection
from faabric_tpu_torch.util.retry import (
    RetryPolicy,
    default_transport_retry_policy,
)


class RpcError(Exception):
    pass


class MessageEndpointClient:
    def __init__(self, host: str, async_port: int, sync_port: int,
                 timeout: float = DEFAULT_SOCKET_TIMEOUT,
                 retry_policy: RetryPolicy | None = None) -> None:
        self.host = host
        self.async_port = async_port
        self.sync_port = sync_port
        self.timeout = timeout
        self.retry = retry_policy or default_transport_retry_policy()
        # One breaker per peer: a dead process is dead on both planes
        self.breaker = self.retry.new_breaker()
        self._socks: dict[str, socket.socket | None] = {"async": None,
                                                        "sync": None}
        self._locks = {"async": threading.Lock(), "sync": threading.Lock()}

    def _check_breaker(self, plane: str) -> None:
        if not self.breaker.allow():
            raise RpcError(
                f"circuit open to {self.host} "
                f"({plane}; {self.breaker.threshold} consecutive failures)")

    def _get_sock(self, plane: str) -> socket.socket:
        s = self._socks[plane]
        if s is None:
            port = self.async_port if plane == "async" else self.sync_port
            s = safe_create_connection(resolve_host(self.host, port),
                                       timeout=self.timeout)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._socks[plane] = s
        return s

    def _reset_sock(self, plane: str) -> None:
        s = self._socks[plane]
        if s is not None:
            s.close()
        self._socks[plane] = None

    def async_send(self, code: int, header: dict[str, Any] | None = None,
                   payload: bytes = b"", seqnum: int = -1) -> None:
        """Fire-and-forget send, retried on a fresh connection under the
        retry policy."""
        msg = TransportMessage(code=code, header=header or {},
                               payload=payload, seqnum=seqnum)
        with self._locks["async"]:
            self._check_breaker("async")
            for attempt in range(self.retry.max_attempts):
                try:
                    send_frame(self._get_sock("async"), msg)
                    self.breaker.record_success()
                    return
                except (OSError, TransportError) as e:
                    self._reset_sock("async")
                    self.breaker.record_failure()
                    if attempt == self.retry.max_attempts - 1:
                        raise RpcError(f"async send to {self.host}:"
                                       f"{self.async_port} failed: {e}") from e
                    self.retry.sleep(attempt)

    def sync_send(self, code: int, header: dict[str, Any] | None = None,
                  payload: bytes = b"",
                  idempotent: bool = False) -> TransportMessage:
        """Send a request and wait for its response.

        A failure while dialling or sending is retried on a fresh
        connection: the request cannot have run. A failure after the
        request was sent is not retried, since the server may have run
        it, unless the caller passes ``idempotent=True``: then a reused
        connection that answered with no byte at all (a server restarted
        between requests) is retried too."""
        msg = TransportMessage(code=code, header=header or {},
                               payload=payload)
        with self._locks["sync"]:
            self._check_breaker("sync")
            for attempt in range(self.retry.max_attempts):
                fresh = self._socks["sync"] is None
                sent = False
                try:
                    sock = self._get_sock("sync")
                    send_frame(sock, msg)
                    sent = True
                    resp = recv_frame(sock)
                    self.breaker.record_success()
                    break
                except (OSError, TransportError) as e:
                    self._reset_sock("sync")
                    self.breaker.record_failure()
                    likely_stale = (idempotent and not fresh
                                    and not isinstance(e, socket.timeout)
                                    and getattr(e, "no_response_data", False))
                    if (attempt == self.retry.max_attempts - 1
                            or (sent and not likely_stale)):
                        raise RpcError(f"sync send to {self.host}:"
                                       f"{self.sync_port} failed: {e}") from e
                    self.retry.sleep(attempt)
        if resp.response_code != int(MessageResponseCode.SUCCESS):
            raise RpcError(
                f"RPC {code} to {self.host}:{self.sync_port} failed: "
                f"{resp.header.get('error', resp.response_code)}")
        return resp

    def close(self) -> None:
        # Without the plane locks: closing must not wait for a call
        # blocked on a dead peer, and the closed socket ends that call
        self._reset_sock("async")
        self._reset_sock("sync")
