"""RPC client base.

Counterpart of ``faabric_tpu/transport/client.py``
(``MessageEndpointClient``): one persistent connection per plane (async
push, sync request and response), dialled lazily through the host alias
table, with a ``RetryPolicy`` (exponential backoff with jitter) and a
circuit breaker per peer, so a peer that keeps failing fails the next
call at once. Connections go through ``safe_create_connection``.

Every send passes the ``transport.send`` fault point (host-pair rules
included); sends are counted per plane, sync round-trips go into the
RPC latency histogram and the perf store's ``ptp`` profile of the peer,
and while tracing is on the caller's trace context rides the header
(``_tc``) so the server's handler span links to it.
"""

from __future__ import annotations

import socket
import threading
import time
from typing import Any

from faabric_tpu_torch.faults import DROP, fault_point, faults_enabled
from faabric_tpu_torch.telemetry import (
    current_trace_context,
    get_metrics,
    get_perf_store,
    tracing_enabled,
)
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

_FAULTS = faults_enabled()
_FP_SEND = fault_point("transport.send")

_metrics = get_metrics()
_TX_FRAMES = {
    plane: _metrics.counter(
        "faabric_transport_tx_frames_total",
        "Frames sent on the shared RPC plane", plane=plane)
    for plane in ("async", "sync")
}
_TX_BYTES = {
    plane: _metrics.counter(
        "faabric_transport_tx_bytes_total",
        "Payload bytes sent on the shared RPC plane", plane=plane)
    for plane in ("async", "sync")
}
_RPC_SECONDS = _metrics.histogram(
    "faabric_transport_rpc_seconds",
    "Client-side sync RPC round-trip latency")
_PERF = get_perf_store()


def _nbytes(payload) -> int:
    """Bytes of a frame's payload: bytes, or a list of buffers that go
    out back to back."""
    if isinstance(payload, (list, tuple)):
        return sum(memoryview(p).nbytes for p in payload)
    return len(payload)


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

    @staticmethod
    def _with_trace_context(header: dict[str, Any] | None) -> dict:
        """While tracing, a copy of ``header`` with the caller's trace
        context under ``_tc``; callers may share header dicts."""
        if tracing_enabled():
            tc = current_trace_context()
            if tc is not None:
                header = dict(header) if header else {}
                header["_tc"] = tc
                return header
        return header or {}

    def async_send(self, code: int, header: dict[str, Any] | None = None,
                   payload: bytes = b"", seqnum: int = -1) -> int:
        """Fire-and-forget send, retried on a fresh connection under the
        retry policy. Returns the number of failed attempts before the
        frame went out. A non-zero count means an earlier async frame on
        the old connection may have been lost into a dead peer's kernel
        buffer (the first write after a peer dies "succeeds"; only the
        next one errors): the planner client re-delivers its recent
        results on it."""
        msg = TransportMessage(code=code,
                               header=self._with_trace_context(header),
                               payload=payload, seqnum=seqnum)
        with self._locks["async"]:
            self._check_breaker("async")
            for attempt in range(self.retry.max_attempts):
                try:
                    if _FAULTS and _FP_SEND.fire(
                            host=self.host, plane="async",
                            code=code) is DROP:
                        # Injected silent loss: the caller believes the
                        # send happened, so the breaker records success
                        # (a half-open trial never ends without one)
                        self.breaker.record_success()
                        return attempt
                    send_frame(self._get_sock("async"), msg)
                    _TX_FRAMES["async"].inc()
                    _TX_BYTES["async"].inc(_nbytes(payload))
                    self.breaker.record_success()
                    return attempt
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
        msg = TransportMessage(code=code,
                               header=self._with_trace_context(header),
                               payload=payload)
        t0 = time.monotonic()
        with self._locks["sync"]:
            self._check_breaker("sync")
            for attempt in range(self.retry.max_attempts):
                fresh = self._socks["sync"] is None
                sent = False
                try:
                    if _FAULTS and _FP_SEND.fire(
                            host=self.host, plane="sync",
                            code=code) is DROP:
                        # A dropped request has no response to wait for:
                        # it fails now, recorded as a failure so a
                        # half-open trial is never stranded
                        self.breaker.record_failure()
                        raise RpcError(
                            f"injected drop of sync RPC {code} to "
                            f"{self.host}:{self.sync_port}")
                    sock = self._get_sock("sync")
                    attempt_t0 = time.monotonic()
                    send_frame(sock, msg)
                    sent = True
                    _TX_FRAMES["sync"].inc()
                    _TX_BYTES["sync"].inc(_nbytes(payload))
                    resp = recv_frame(sock)
                    attempt_elapsed = time.monotonic() - attempt_t0
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
        _RPC_SECONDS.observe(time.monotonic() - t0)
        # Only the successful attempt's round-trip: backoff sleeps and
        # failed dials measure this client's patience, not the link
        _PERF.observe(self.host, "ptp", _nbytes(payload), attempt_elapsed)
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
