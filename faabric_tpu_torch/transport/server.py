"""RPC server base.

Counterpart of ``faabric_tpu/transport/server.py``
(``MessageEndpointServer``). Two listening ports per server: an async
plane (fire-and-forget pushes, handled by a pool of worker threads) and
a sync plane (request and response, handled on the connection's own
thread so that responses pair with their requests). A shutdown frame
per worker stops the pool. ``set_request_latch`` and
``await_request_latch`` let a test wait for the server to handle a
request.
"""

from __future__ import annotations

import errno
import socket
import threading
import time
from typing import Any

from faabric_tpu_torch.transport.message import (
    ConnectionClosed,
    MessageResponseCode,
    TransportError,
    TransportMessage,
    recv_frame,
    send_frame,
)
from faabric_tpu_torch.util.latch import Latch
from faabric_tpu_torch.util.logging import get_logger
from faabric_tpu_torch.util.queues import Queue

logger = get_logger(__name__)


class MessageEndpointServer:
    def __init__(self, async_port: int, sync_port: int, label: str = "",
                 n_threads: int = 2, bind_host: str = "0.0.0.0") -> None:
        self.async_port = async_port
        self.sync_port = sync_port
        self.label = label or self.__class__.__name__
        self.n_threads = max(1, n_threads)
        self.bind_host = bind_host

        self._async_listener: socket.socket | None = None
        self._sync_listener: socket.socket | None = None
        self._threads: list[threading.Thread] = []
        # The connection set and its reader threads are shared between
        # the accept loops and stop(): both under _conn_lock
        self._conn_threads: list[threading.Thread] = []
        self._conns: set[socket.socket] = set()
        self._conn_lock = threading.Lock()
        self._running = False
        self._work: Queue[TransportMessage] = Queue()
        self._request_latch: Latch | None = None
        self._latch_lock = threading.Lock()

    # ------------------------------------------------------------------
    # Handlers
    # ------------------------------------------------------------------
    def do_async_recv(self, msg: TransportMessage) -> None:
        raise NotImplementedError

    def do_sync_recv(self, msg: TransportMessage) -> TransportMessage:
        raise NotImplementedError

    # ------------------------------------------------------------------
    # Lifecycle
    # ------------------------------------------------------------------
    def start(self) -> None:
        if self._running:
            return
        self._running = True
        try:
            self._async_listener = self._listen(self.async_port)
            self._sync_listener = self._listen(self.sync_port)
        except OSError:
            # A half-started server must not keep its first listener:
            # nothing would ever close it
            self._running = False
            for listener in (self._async_listener, self._sync_listener):
                if listener is not None:
                    listener.close()
            self._async_listener = self._sync_listener = None
            raise
        for listener, plane in ((self._async_listener, "async"),
                                (self._sync_listener, "sync")):
            t = threading.Thread(
                target=self._accept_loop, args=(listener, plane),
                name=f"transport/accept@{self.label}-{plane}", daemon=True)
            t.start()
            self._threads.append(t)
        for i in range(self.n_threads):
            t = threading.Thread(
                target=self._worker_loop,
                name=f"transport/worker@{self.label}-{i}", daemon=True)
            t.start()
            self._threads.append(t)
        logger.debug("%s started (async=%d sync=%d threads=%d)", self.label,
                     self.async_port, self.sync_port, self.n_threads)

    def stop(self) -> None:
        if not self._running:
            return
        self._running = False
        for _ in range(self.n_threads):
            self._work.enqueue(TransportMessage.shutdown())
        for listener in (self._async_listener, self._sync_listener):
            if listener is not None:
                # shutdown() wakes a thread blocked in accept(); close()
                # alone keeps the port bound until accept returns
                try:
                    listener.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                listener.close()
        # Wake readers blocked in recv_frame
        with self._conn_lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        for t in self._threads:
            t.join(timeout=2.0)
        with self._conn_lock:
            conn_threads, self._conn_threads = self._conn_threads, []
        for t in conn_threads:
            t.join(timeout=2.0)
        self._threads.clear()
        with self._conn_lock:
            self._conns.clear()
        logger.debug("%s stopped", self.label)

    # ------------------------------------------------------------------
    # Test synchronisation
    # ------------------------------------------------------------------
    def set_request_latch(self) -> None:
        with self._latch_lock:
            self._request_latch = Latch(2)

    def await_request_latch(self) -> None:
        with self._latch_lock:
            latch = self._request_latch
        if latch is not None:
            latch.wait()
            with self._latch_lock:
                # Clear only the latch waited on: a test may have armed
                # a new one meanwhile
                if self._request_latch is latch:
                    self._request_latch = None

    def _fire_request_latch(self) -> None:
        with self._latch_lock:
            latch = self._request_latch
        if latch is not None:
            try:
                latch.wait()
            except Exception:  # noqa: BLE001 — a stale latch must not
                # break request handling
                logger.exception("%s request latch failed", self.label)

    # ------------------------------------------------------------------
    # Internals
    # ------------------------------------------------------------------
    def _listen(self, port: int) -> socket.socket:
        # A few retries on EADDRINUSE ride out a short-lived outgoing
        # connection that took the port as its ephemeral source port; a
        # port held by a real listener still fails after the last one
        last_error: OSError | None = None
        for attempt in range(5):
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            try:
                s.bind((self.bind_host, port))
                s.listen(128)
                return s
            except OSError as e:
                s.close()
                if e.errno != errno.EADDRINUSE:
                    raise
                last_error = e
                time.sleep(0.05 * (attempt + 1))
        raise last_error  # type: ignore[misc]

    def _accept_loop(self, listener: socket.socket, plane: str) -> None:
        while self._running:
            try:
                conn, _addr = listener.accept()
            except OSError:
                break
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            t = threading.Thread(
                target=self._conn_loop, args=(conn, plane),
                name=f"transport/conn@{self.label}-{plane}", daemon=True)
            with self._conn_lock:
                self._conns.add(conn)
                # Prune finished readers; start under the lock, since
                # stop() joins every thread of the list
                self._conn_threads = [x for x in self._conn_threads
                                      if x.is_alive()]
                self._conn_threads.append(t)
                t.start()

    def _conn_loop(self, conn: socket.socket, plane: str) -> None:
        try:
            while self._running:
                try:
                    msg = recv_frame(conn)
                except ConnectionClosed:
                    break
                except TransportError as e:
                    logger.warning("%s dropping %s connection on bad frame: "
                                   "%s", self.label, plane, e)
                    break
                except OSError:
                    break
                if msg.is_shutdown():
                    break
                if plane == "async":
                    self._work.enqueue(msg)
                else:
                    self._handle_sync(msg, conn)
        finally:
            with self._conn_lock:
                self._conns.discard(conn)
            conn.close()

    def _handle_sync(self, msg: TransportMessage, conn: socket.socket) -> None:
        try:
            resp = self.do_sync_recv(msg)
            if resp is None:
                resp = TransportMessage(code=msg.code)
            resp.response_code = int(MessageResponseCode.SUCCESS)
        except Exception as e:  # noqa: BLE001 — errors must cross the wire
            logger.exception("%s sync handler error", self.label)
            resp = TransportMessage(
                code=msg.code, header={"error": str(e)},
                response_code=int(MessageResponseCode.ERROR))
        try:
            send_frame(conn, resp)
        except OSError:
            pass
        self._fire_request_latch()

    def _worker_loop(self) -> None:
        while True:
            msg = self._work.dequeue()
            if msg.is_shutdown():
                return
            try:
                self.do_async_recv(msg)
            except Exception:  # noqa: BLE001 — one bad request must not
                # end the worker
                logger.exception("%s async handler error", self.label)
            self._fire_request_latch()


def handler_response(header: dict[str, Any] | None = None,
                     payload: bytes = b"", code: int = 0) -> TransportMessage:
    return TransportMessage(code=code, header=header or {}, payload=payload)
