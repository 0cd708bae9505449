"""The bulk data plane: large cross-host payloads on tuned sockets.

Counterpart of ``faabric_tpu/transport/bulk.py``, with its frames, port
and knobs, so that a host of one package exchanges bulk frames with a
host of the other. Each (sender host, receiver host) pair carries every
group's large payloads over a few striped connections, framed with the
point-to-point routing header, and the receiving ``BulkServer`` delivers
them straight into its broker's queues.

Striping: a client holds one CONTROL stripe (frames under
``BULK_THRESHOLD`` and unsequenced frames, whose FIFO order must hold
without sequence numbers) and ``BULK_STRIPES`` DATA stripes that large
sequenced frames round-robin across. Each stripe has its own socket, its
own lock and its own shm ring, so concurrent senders proceed in parallel;
the receiving broker's sequence numbers put one stream's frames back in
order, as they already merge the bulk and RPC planes.

A frame goes out as one vectored ``sendmsg`` (header and payload views,
no join), and the receiver reads the payload into one preallocated
buffer (``recv_into``). Sockets get 16 MiB buffers and TCP_NODELAY.

Same-machine peers skip TCP: each stripe announces a /dev/shm ring
(``transport/shm.py``) over its connection, the server attaches it and
ACKs (or NACKs, and the stripe stays on TCP), and frames are pushed into
it. A push that times out declares the ring dead: the stripe retires it
and sends on TCP. With a live control ring, data-channel frames of any
size ride it (the broker routes them here).

Wire codecs (``transport/codec.py``): a sequenced frame of at least
``CODEC_MIN_BYTES`` asks the governor for its link's codec. A coded
frame carries a codec byte and epochs in its header and its payload as
an XOR+zlib delta against a cached base, or as a full frame that
establishes one. Coded streams stay on one data stripe (a hash of the
stream key), so base and delta never reorder; shm rings never carry
coded frames. The receiver NACKs a frame it cannot decode on the same
connection, and the sender re-ships that sequence number as a full
frame. A reconnect resets both sides' caches (the receiver's lives with
its connection).

The reference's ``transport.bulk`` fault point, its spans, send-time
histograms, comm-matrix and perf-profile records and flight records
come with ``ROADMAP.md`` Queue 1 #7 and #9 part B.
"""

from __future__ import annotations

import ctypes
import errno
import os
import socket
import struct
import threading
import time

import numpy as np

from faabric_tpu_torch.telemetry import get_metrics
from faabric_tpu_torch.transport import shm
from faabric_tpu_torch.transport.codec import (
    CODEC_FULL,
    CODEC_LABELS,
    CODEC_MIN_BYTES,
    CODEC_RAW,
    FLAG_CACHE,
    FLAG_ESCAPE,
    CodedFrame,
    ReceiverDeltaCache,
    SenderDeltaCache,
    count_escape,
    get_wire_governor,
)
from faabric_tpu_torch.transport.common import (
    DEFAULT_SOCKET_TIMEOUT,
    host_is_local,
    resolve_host,
)
from faabric_tpu_torch.transport.message import tune_socket
from faabric_tpu_torch.util.logging import get_logger
from faabric_tpu_torch.util.network import is_local_ip, safe_create_connection

logger = get_logger(__name__)

_metrics = get_metrics()
_BULK_TX_FRAMES = {
    path: _metrics.counter("faabric_bulk_tx_frames_total",
                           "Bulk-plane frames sent", path=path)
    for path in ("tcp", "shm")
}
_BULK_TX_BYTES = {
    path: _metrics.counter("faabric_bulk_tx_bytes_total",
                           "Bulk-plane payload bytes sent", path=path)
    for path in ("tcp", "shm")
}
_BULK_RX_FRAMES = {
    path: _metrics.counter("faabric_bulk_rx_frames_total",
                           "Bulk-plane frames received", path=path)
    for path in ("tcp", "shm")
}
_BULK_RX_BYTES = {
    path: _metrics.counter("faabric_bulk_rx_bytes_total",
                           "Bulk-plane payload bytes received", path=path)
    for path in ("tcp", "shm")
}
_BULK_RECONNECTS = _metrics.counter(
    "faabric_bulk_reconnects_total",
    "Reconnect-and-resend recoveries after a stale/reset bulk connection")

BULK_PORT = 8014
# Below this the RPC plane wins (no extra connection), unless the peer
# is on this machine with a live shm ring: then the broker routes every
# data-channel frame here
BULK_THRESHOLD = 256 * 1024
# Sanity ceiling per frame: legitimate traffic is chunked far below it,
# so a bigger claim is a desynced or garbage stream
MAX_FRAME_BYTES = 1 << 30

# Data stripes per peer (the control stripe is extra); 0 is one
# connection carrying everything. Each stripe adds a sender lock and a
# server thread, which a small machine pays for in scheduling
BULK_STRIPES = max(0, int(os.environ.get(
    "BULK_STRIPES", str(max(1, min(4, (os.cpu_count() or 2) // 2))))))
# The control stripe's ring carries only sub-threshold frames
CTRL_RING_BYTES = 4 * (1 << 20)

# group_hi, group_lo (group ids are 128-bit), send_idx, recv_idx,
# channel, seq, nbytes (WIRE payload length), codec, flags, _rsvd,
# base_epoch, self_epoch, crc32 (of the coded wire bytes), raw_nbytes
# (decoded payload length; == nbytes for raw frames). The codec tail is
# zero for raw frames and for the SHM_ANNOUNCE/SHM_RETIRE sentinels.
_FRAME = struct.Struct("<QQiiiiqBBHIIIq")
_U64 = (1 << 64) - 1


def _pack_raw(group_hi: int, group_lo: int, send_idx: int, recv_idx: int,
              channel: int, seq: int, nbytes: int) -> bytes:
    """A raw (codec-less) frame header, also the shm sentinels' header."""
    return _FRAME.pack(group_hi, group_lo, send_idx, recv_idx, channel,
                       seq, nbytes, CODEC_RAW, 0, 0, 0, 0, 0, nbytes)


# Receiver → sender record on the same connection: "re-ship this seq as
# a full frame" (magic, group_hi, group_lo, send_idx, recv_idx, channel,
# seq). Otherwise that direction carries only the ring attach ACK.
_NACK = struct.Struct("<4sQQiiii")
_NACK_MAGIC = b"FNAK"

# Sentinel frame announcing a ring: nbytes carries the marker, seq the
# ring name's length, and the name follows. Real frames have nbytes >= 0.
SHM_ANNOUNCE = -2
# Sentinel retiring the announced ring (the client abandoned it): the
# server's drain finishes what is buffered and exits
SHM_RETIRE = -3


def _recv_exact_into(sock: socket.socket, view: memoryview) -> None:
    while len(view):
        n = sock.recv_into(view, len(view))
        if n == 0:
            raise ConnectionError("bulk peer closed mid-frame")
        view = view[n:]


def _sendmsg_all(sock: socket.socket, bufs: list) -> None:
    """Vectored send of the whole frame, looping on partial writes."""
    views = [b if isinstance(b, memoryview) else memoryview(b)
             for b in bufs]
    remaining = sum(len(v) for v in views)
    while True:
        sent = sock.sendmsg(views)
        remaining -= sent
        if remaining <= 0:
            return
        while sent:
            if sent >= len(views[0]):
                sent -= len(views[0])
                views.pop(0)
            else:
                views[0] = views[0][sent:]
                sent = 0


class BulkServer:
    """Accepts bulk connections for one broker (one logical host) and
    delivers their frames into its queues: a thread a connection, and a
    drain thread an announced ring."""

    # Drain batch scratch: every sub-threshold frame fits, a large frame
    # never does (it takes the exact-size path)
    BATCH_BUF_BYTES = BULK_THRESHOLD + _FRAME.size + 64
    BATCH_MAX_FRAMES = 64

    def __init__(self, broker, port_offset: int = 0) -> None:
        self.broker = broker
        self.port = BULK_PORT + port_offset
        self._listener: socket.socket | None = None
        self._lock = threading.Lock()
        self._threads: list[threading.Thread] = []
        self._conns: list[socket.socket] = []
        self._stopping = False
        # Each connection's receiver cache, so drop_codec_bases reaches
        # them all
        self._rx_codecs: list[ReceiverDeltaCache] = []
        # Names of rings with a live drain: a second announce of one
        # would put two consumers on an SPSC ring
        self._attached_rings: set[str] = set()

    def start(self) -> None:
        shm.gc_stale_rings()
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        # A port just released by a torn-down server may take a moment
        for attempt in range(10):
            try:
                s.bind(("0.0.0.0", self.port))
                break
            except OSError as e:
                if e.errno != errno.EADDRINUSE or attempt == 9:
                    s.close()
                    raise
                time.sleep(0.2)
        s.listen(64)
        self._listener = s
        t = threading.Thread(target=self._accept_loop,
                             name=f"bulk/accept@{self.port}", daemon=True)
        with self._lock:
            self._threads.append(t)
        t.start()
        logger.debug("Bulk server on :%d", self.port)

    def _accept_loop(self) -> None:
        listener = self._listener
        while not self._stopping:
            try:
                conn, _ = listener.accept()
                tune_socket(conn)
                conn.settimeout(None)
            except OSError:
                if self._stopping:
                    return
                continue  # one bad connection must not kill the acceptor
            t = threading.Thread(target=self._conn_loop, args=(conn,),
                                 name="bulk/conn", daemon=True)
            with self._lock:
                if self._stopping:
                    # Accepted while stop() ran: it has swept the list
                    conn.close()
                    return
                # Start under the lock, so stop() never joins a thread
                # that has not started; prune finished ones
                self._conns = [c for c in self._conns if c.fileno() >= 0]
                self._conns.append(conn)
                self._threads = [x for x in self._threads if x.is_alive()]
                self._threads.append(t)
                t.start()

    def _conn_loop(self, conn: socket.socket) -> None:
        drain_stop = threading.Event()
        drain_thread: threading.Thread | None = None
        rx_codec: ReceiverDeltaCache | None = None
        try:
            peer_ip = conn.getpeername()[0]
        except OSError:
            peer_ip = ""
        try:
            head = bytearray(_FRAME.size)
            head_view = memoryview(head)
            while True:
                _recv_exact_into(conn, head_view[:])
                (group_hi, group_lo, send_idx, recv_idx, channel, seq,
                 nbytes, codec, flags, _rsvd, base_epoch, self_epoch,
                 crc, raw_nbytes) = _FRAME.unpack(head)
                group_id = (group_hi << 64) | group_lo
                if nbytes == SHM_ANNOUNCE and 0 < seq <= 256:
                    name_raw = bytearray(seq)
                    _recv_exact_into(conn, memoryview(name_raw))
                    # Shared memory: only a peer on this machine may
                    # announce a ring
                    if drain_thread is None and is_local_ip(peer_ip):
                        drain_stop = threading.Event()
                        drain_thread = self._start_ring_drain(
                            name_raw.decode("utf-8", "replace"), drain_stop)
                    # The client pushes into the ring only after an ACK:
                    # a ring nothing drains would swallow frames
                    conn.sendall(b"\x01" if drain_thread is not None
                                 else b"\x00")
                    continue
                if nbytes == SHM_RETIRE:
                    if drain_thread is not None:
                        drain_stop.set()
                        drain_thread.join(timeout=5.0)
                        drain_thread = None
                    continue
                if not (0 <= nbytes <= MAX_FRAME_BYTES
                        and send_idx >= 0 and recv_idx >= 0
                        and channel >= 0
                        and codec in CODEC_LABELS
                        and 0 <= raw_nbytes <= MAX_FRAME_BYTES):
                    logger.warning(
                        "Dropping bulk connection: bad frame "
                        "(nbytes=%d send=%d recv=%d chan=%d codec=%d)",
                        nbytes, send_idx, recv_idx, channel, codec)
                    return
                payload = np.empty(nbytes, dtype=np.uint8)
                _recv_exact_into(conn, memoryview(payload).cast("B"))
                _BULK_RX_FRAMES["tcp"].inc()
                _BULK_RX_BYTES["tcp"].inc(nbytes)
                if codec != CODEC_RAW:
                    if rx_codec is None:
                        rx_codec = ReceiverDeltaCache()
                        with self._lock:
                            self._rx_codecs.append(rx_codec)
                    payload = rx_codec.decode(
                        (group_id, send_idx, recv_idx, channel), codec,
                        flags, base_epoch, self_epoch, crc, payload,
                        raw_nbytes)
                    if payload is None:
                        logger.warning(
                            "Undecodable %s frame (seq=%d base=%d); "
                            "NACKing for a full-frame escape",
                            CODEC_LABELS.get(codec, codec), seq,
                            base_epoch)
                        try:
                            conn.sendall(_NACK.pack(
                                _NACK_MAGIC, group_hi, group_lo,
                                send_idx, recv_idx, channel, seq))
                        except OSError:
                            pass  # the connection is dying: a redial heals
                        continue
                # The array is this frame's own (or a read-only base of
                # the codec cache); sub-threshold frames deliver as
                # bytes, as the RPC plane delivers them
                if payload.size < BULK_THRESHOLD:
                    payload = payload.tobytes()
                self.broker.deliver(group_id, send_idx, recv_idx,
                                    payload, seq, channel)
        except (ConnectionError, OSError):
            pass  # peer closed, or the server is stopping
        except Exception:  # noqa: BLE001 — one bad peer, not the server
            logger.exception("Bulk connection handler failed")
        finally:
            if rx_codec is not None:
                with self._lock:
                    try:
                        self._rx_codecs.remove(rx_codec)
                    except ValueError:
                        pass
            if drain_thread is not None:
                drain_stop.set()
                drain_thread.join(timeout=2.0)
            try:
                conn.close()
            except OSError:
                pass

    def _start_ring_drain(self, name: str,
                          stop: threading.Event) -> threading.Thread | None:
        with self._lock:
            if name in self._attached_rings:
                logger.warning("Refusing duplicate attach of live shm "
                               "ring %s", name)
                return None
            self._attached_rings.add(name)
        try:
            ring = shm.ShmRing.attach(name)
        except (OSError, ValueError, RuntimeError) as e:
            logger.warning("Cannot attach announced shm ring %s: %s",
                           name, e)
            with self._lock:
                self._attached_rings.discard(name)
            return None
        t = threading.Thread(target=self._ring_drain_loop,
                             args=(ring, stop),
                             name=f"bulk/shm-drain@{name[-12:]}", daemon=True)
        t.start()
        return t

    def _ring_drain_loop(self, ring, stop: threading.Event) -> None:
        """Pop frames (bulk header and payload as one ring frame) and
        deliver them; sleeps on the ring's futex when idle. Bursts of
        small frames drain a batch at a time into a reused scratch (their
        payloads leave it as bytes)."""
        scratch = np.empty(self.BATCH_BUF_BYTES, np.uint8)
        lens = (ctypes.c_uint64 * self.BATCH_MAX_FRAMES)()
        try:
            while True:
                n = ring.pop_batch(scratch, lens, self.BATCH_MAX_FRAMES)
                if n == 0:
                    # Empty, or a large frame: take it at its size
                    frame = ring.try_pop()
                    if frame is None:
                        if stop.is_set():
                            return  # producer gone and ring drained
                        ring.wait_data(20_000)
                        continue
                    if not self._deliver_ring_frame(ring, frame):
                        return
                    continue
                off = 0
                key = None
                pending: list = []
                for i in range(n):
                    ln = int(lens[i])
                    frame = scratch[off:off + ln]
                    off += ln
                    # Ring frames are raw by construction
                    (group_hi, group_lo, send_idx, recv_idx, channel,
                     seq, nbytes) = _FRAME.unpack_from(frame)[:7]
                    payload = frame[_FRAME.size:ln]
                    if nbytes != len(payload):
                        # Deliver the good frames before giving up, or
                        # their seqs leave a gap nothing heals
                        if pending:
                            self.broker.deliver_many(
                                key[0], key[1], key[2], pending, key[3])
                        logger.warning("Desynced shm ring %s; abandoning",
                                       ring.name)
                        return
                    _BULK_RX_FRAMES["shm"].inc()
                    _BULK_RX_BYTES["shm"].inc(nbytes)
                    data = (payload.tobytes() if nbytes < BULK_THRESHOLD
                            else payload.copy())
                    fkey = ((group_hi << 64) | group_lo, send_idx,
                            recv_idx, channel)
                    if fkey != key:
                        if pending:
                            self.broker.deliver_many(
                                key[0], key[1], key[2], pending, key[3])
                        key, pending = fkey, []
                    pending.append((seq, data))
                if pending:
                    self.broker.deliver_many(key[0], key[1], key[2],
                                             pending, key[3])
        except Exception:  # noqa: BLE001 — one bad ring, not the server
            logger.exception("Shm ring drain failed")
        finally:
            ring.close(unlink=True)  # the name is used once
            with self._lock:
                self._attached_rings.discard(ring.name)

    def _deliver_ring_frame(self, ring, frame) -> bool:
        """Deliver one popped frame; False on a desynced stream."""
        (group_hi, group_lo, send_idx, recv_idx, channel, seq,
         nbytes) = _FRAME.unpack_from(frame)[:7]
        payload = frame[_FRAME.size:]
        if nbytes != len(payload):
            logger.warning("Desynced shm ring %s; abandoning", ring.name)
            return False
        _BULK_RX_FRAMES["shm"].inc()
        _BULK_RX_BYTES["shm"].inc(nbytes)
        if nbytes < BULK_THRESHOLD:
            payload = payload.tobytes()
        self.broker.deliver((group_hi << 64) | group_lo, send_idx,
                            recv_idx, payload, seq, channel)
        return True

    def drop_codec_bases(self) -> None:
        """Forget every receiver-side codec base: the next delta of each
        stream NACKs and heals with a full frame."""
        with self._lock:
            caches = list(self._rx_codecs)
        for c in caches:
            c.drop_bases()

    def stop(self) -> None:
        self._stopping = True
        listener, self._listener = self._listener, None
        if listener is not None:
            # shutdown() wakes the thread blocked in accept()
            try:
                listener.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            listener.close()
        with self._lock:
            conns, self._conns = self._conns, []
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            c.close()
        with self._lock:
            threads, self._threads = self._threads, []
        for t in threads:
            t.join(timeout=2.0)


class _Stripe:
    """One striped connection to the destination's BulkServer: its own
    tuned socket, lock and optional shm ring. Sends on one stripe are
    serialised (frames must not interleave on a stream); sends on
    different stripes run concurrently. The stripe lock guards the
    connection and the stripe's state; ``codec_tx`` has its own lock,
    taken after it."""

    __slots__ = ("host", "tag", "ring_bytes", "sock", "ring",
                 "ring_refused", "lock", "shm_frames", "tcp_frames",
                 "codec_tx", "nack_buf", "nack_thread", "coded_frames",
                 "escape_frames", "wire_bytes", "raw_bytes")

    def __init__(self, host: str, idx: int, ring_bytes: int) -> None:
        self.host = host
        self.tag = f"{host}-s{idx}"
        self.ring_bytes = ring_bytes
        self.sock: socket.socket | None = None
        self.ring = None
        # A zero ring budget refuses rings up front, so that
        # small_frames_ok's unlocked check caches the verdict
        self.ring_refused = ring_bytes <= 0
        self.lock = threading.Lock()
        # Frames that rode the ring and the socket; coded frames and
        # their full-frame escapes; payload bytes on the wire and before
        # coding (equal for raw frames)
        self.shm_frames = 0
        self.tcp_frames = 0
        self.codec_tx: SenderDeltaCache | None = None
        self.nack_buf = bytearray()
        self.nack_thread: threading.Thread | None = None
        self.coded_frames = 0
        self.escape_frames = 0
        self.wire_bytes = 0
        self.raw_bytes = 0

    # -- connection management (caller holds self.lock) -----------------
    def _dial_locked(self) -> socket.socket:
        ip, port = resolve_host(self.host, BULK_PORT)
        s = safe_create_connection((ip, port),
                                   timeout=DEFAULT_SOCKET_TIMEOUT)
        try:
            tune_socket(s)
            s.settimeout(None)
            self._maybe_announce_ring_locked(s, ip)
        except BaseException:
            s.close()
            raise
        return s

    def _maybe_announce_ring_locked(self, sock: socket.socket,
                                    ip: str) -> None:
        if self.ring_refused or self.ring_bytes <= 0 \
                or not is_local_ip(ip) or not shm.shm_available():
            return
        try:
            ring = shm.ShmRing.create(self.tag, self.ring_bytes)
        except (OSError, ValueError, RuntimeError) as e:
            logger.warning("Shm ring setup for %s failed (%s); "
                           "staying on TCP", self.tag, e)
            self.ring_refused = True
            return
        name = ring.name.encode()
        try:
            sock.sendall(_pack_raw(0, 0, 0, 0, 0, len(name),
                                   SHM_ANNOUNCE) + name)
        except OSError:
            # This process lives on, so the stale-ring sweep would
            # never take the file: unlink it now
            ring.close(unlink=True)
            raise
        try:
            sock.settimeout(5.0)
            ack = sock.recv(1)
        except OSError:
            ack = b""
        finally:
            sock.settimeout(None)
        if ack == b"\x01":
            self.ring = ring
        else:
            logger.warning("Bulk server did not ack shm ring for %s; "
                           "staying on TCP", self.tag)
            # A late ACK may mean a drain exists: retire it
            try:
                sock.sendall(_pack_raw(0, 0, 0, 0, 0, 0, SHM_RETIRE))
            except OSError:
                pass
            ring.close(unlink=True)
            self.ring_refused = True

    def ensure_connected(self) -> None:
        """Dial (and announce the ring) without sending a frame."""
        with self.lock:
            if self.sock is None:
                self.sock = self._dial_locked()

    # -- the coded-stream send path --------------------------------------
    def send_coded(self, mode: str, group_id: int, send_idx: int,
                   recv_idx: int, seq: int, channel: int,
                   parts: list) -> None:
        """Send one coded frame. ``parts`` are the ordered uint8 segments
        of the payload; the cache copies them only when the frame
        becomes a base. Encode runs under the stripe lock, which
        serialises it with the NACK heals, so base and delta order is
        the wire order."""
        key = (group_id, send_idx, recv_idx, channel)
        gh, gl = (group_id >> 64) & _U64, group_id & _U64
        with self.lock:
            if self.codec_tx is None:
                self.codec_tx = SenderDeltaCache()
            try:
                if self.sock is None:
                    self.sock = self._dial_locked()
                self._ensure_nack_reader_locked()
                self._process_nacks_locked()
                frame = self.codec_tx.encode(key, parts, seq, mode)
                self._send_coded_frame_locked(gh, gl, send_idx, recv_idx,
                                              channel, seq, frame)
            except OSError:
                # The receiver's cache died with the connection: resend
                # FULL on a reset cache over a fresh one
                self._reset_locked()
                count_escape("reconnect")
                self.sock = self._dial_locked()
                self._ensure_nack_reader_locked()
                frame = self.codec_tx.encode(key, parts, seq, mode)
                try:
                    self._send_coded_frame_locked(
                        gh, gl, send_idx, recv_idx, channel, seq, frame)
                    _BULK_RECONNECTS.inc()
                except BaseException:
                    self._reset_locked()
                    raise

    def _send_coded_frame_locked(self, gh: int, gl: int, send_idx: int,
                                 recv_idx: int, channel: int, seq: int,
                                 frame: CodedFrame) -> None:
        wire = frame.wire
        head = _FRAME.pack(gh, gl, send_idx, recv_idx, channel, seq,
                           wire.nbytes, frame.codec, frame.flags, 0,
                           frame.base_epoch, frame.self_epoch, frame.crc,
                           frame.raw_nbytes)
        _sendmsg_all(self.sock, [head, wire])
        self.coded_frames += 1
        self.tcp_frames += 1
        self.wire_bytes += wire.nbytes
        self.raw_bytes += frame.raw_nbytes
        if frame.flags & FLAG_ESCAPE:
            self.escape_frames += 1
        _BULK_TX_FRAMES["tcp"].inc()
        _BULK_TX_BYTES["tcp"].inc(wire.nbytes)

    def _ensure_nack_reader_locked(self) -> None:
        """One reader a live connection drains the NACK channel, so a
        NACK heals even if the sender never touches this stripe again.
        After dial time it is the socket's only reader."""
        t = self.nack_thread
        if t is not None and t.is_alive():
            return
        t = threading.Thread(target=self._nack_reader, args=(self.sock,),
                             name=f"bulk/nack-reader@{self.tag}", daemon=True)
        self.nack_thread = t
        t.start()

    def _nack_reader(self, sock: socket.socket) -> None:
        try:
            while True:
                chunk = sock.recv(4096)
                if not chunk:
                    break  # the peer closed
                with self.lock:
                    if self.sock is not sock:
                        return  # a stale reader after a reconnect
                    self.nack_buf += chunk
                    try:
                        self._process_nacks_locked()
                    except OSError:
                        # A heal failed mid-write: no later frame may
                        # splice onto the torn one
                        self._reset_locked()
                        return
        except OSError:
            pass  # closed under us (reset or stop)
        # The reader learns first that the peer died: reset, so that the
        # next send redials and ships a full frame
        with self.lock:
            if self.sock is sock:
                self._reset_locked()

    def _process_nacks_locked(self) -> None:
        """Re-ship each buffered NACK's seq as a FULL frame."""
        if self.codec_tx is None:
            return
        while len(self.nack_buf) >= _NACK.size:
            (magic, n_gh, n_gl, n_send, n_recv, n_chan,
             n_seq) = _NACK.unpack_from(self.nack_buf)
            if magic != _NACK_MAGIC:
                # Resync by one byte: a late attach ACK is a legitimate
                # stray, and NACKs behind it still count
                del self.nack_buf[:1]
                continue
            del self.nack_buf[:_NACK.size]
            self._heal_nack_locked(n_gh, n_gl, n_send, n_recv, n_chan,
                                   n_seq)

    def _heal_nack_locked(self, gh: int, gl: int, send_idx: int,
                          recv_idx: int, channel: int, seq: int) -> None:
        key = ((gh << 64) | gl, send_idx, recv_idx, channel)
        got = self.codec_tx.take_for_resend(key, seq)
        if got is None:
            # The resend window no longer holds this seq: the stream
            # heals on its next full frame, this seq's recv times out
            count_escape("lost_payload")
            logger.warning("NACK for seq %d on %s names an evicted "
                           "payload; stream heals, this seq is lost",
                           seq, self.tag)
            return
        count_escape("nack")
        base, epoch = got
        frame = CodedFrame(CODEC_FULL, FLAG_CACHE | FLAG_ESCAPE, 0,
                           epoch, 0, base, base.nbytes)
        self._send_coded_frame_locked(gh, gl, send_idx, recv_idx,
                                      channel, seq, frame)

    # -- the per-frame send path -----------------------------------------
    def send_frame(self, head: bytes, views: list, nbytes: int) -> None:
        """``head`` is b"" when the caller joined the header into
        views[0] (tiny frames)."""
        bufs = [head, *views] if head else views
        with self.lock:
            if self.sock is None:
                self.sock = self._dial_locked()
            ring = self.ring
            if ring is not None and nbytes + _FRAME.size + 8 <= ring.capacity:
                # A push timeout means the drain never started or died:
                # the ring is dead, and the frame goes on TCP (retrying
                # would stall every send under the stripe lock). The
                # first push gets a short leash
                pushed = ring.push(
                    bufs, timeout=2.0 if self.shm_frames == 0 else 5.0,
                    nbytes=nbytes + _FRAME.size)
                if pushed:
                    self.shm_frames += 1
                    self.wire_bytes += nbytes
                    self.raw_bytes += nbytes
                    _BULK_TX_FRAMES["shm"].inc()
                    _BULK_TX_BYTES["shm"].inc(nbytes)
                    return
                logger.warning("Shm ring for %s stalled; abandoning ring, "
                               "staying on TCP", self.tag)
                # The drain finishes the buffered frames first; their
                # seqs precede this one's, so order holds
                try:
                    self.sock.sendall(_pack_raw(0, 0, 0, 0, 0, 0, SHM_RETIRE))
                except OSError:
                    pass
                ring.close(unlink=True)
                self.ring = None
                self.ring_refused = True
            try:
                _sendmsg_all(self.sock, bufs)
            except OSError:
                # One reconnect and resend: the usual cause is a stale
                # keep-alive connection the peer closed. A frame that
                # fully landed before the error arrives twice, and the
                # receiver drops the duplicate seq
                self._reset_locked()
                try:
                    self.sock = self._dial_locked()
                    _sendmsg_all(self.sock, bufs)
                    _BULK_RECONNECTS.inc()
                except BaseException:
                    # A half-written frame must not stay on a kept socket
                    self._reset_locked()
                    raise
            self.tcp_frames += 1
            self.wire_bytes += nbytes
            self.raw_bytes += nbytes
            _BULK_TX_FRAMES["tcp"].inc()
            _BULK_TX_BYTES["tcp"].inc(nbytes)

    def _reset_locked(self) -> None:
        if self.sock is not None:
            try:
                self.sock.close()
            except OSError:
                pass
            self.sock = None
        if self.ring is not None:
            # The ring rides the connection: a redial announces a new one
            self.ring.close(unlink=True)
            self.ring = None
        # So does the codec state: the receiver's cache died with it
        if self.codec_tx is not None:
            self.codec_tx.reset()
        self.nack_buf.clear()

    def close(self) -> None:
        with self.lock:
            self._reset_locked()


class BulkClient:
    """Striped connections to one destination host's BulkServer.

    Stripe 0 (CONTROL) carries frames under ``BULK_THRESHOLD`` and
    unsequenced frames; large sequenced frames round-robin across the
    DATA stripes. When the destination is this machine, each stripe
    pushes its frames into a shm ring and keeps TCP for frames too large
    for it. ``SHM_RING_BYTES`` (default 32 MiB) is the budget a peer,
    split evenly over the data stripes (a power of two each, 1 MiB at
    least); the control ring takes at most 4 MiB on top. ``SHM_BULK=0``
    disables the rings."""

    def __init__(self, host: str) -> None:
        self.host = host
        self._lock = threading.Lock()
        self._stripes: dict[int, _Stripe] = {}
        self._rr = 0
        self._local: bool | None = None

    def _stripe(self, idx: int) -> _Stripe:
        with self._lock:
            s = self._stripes.get(idx)
            if s is None:
                total = int(os.environ.get("SHM_RING_BYTES",
                                           shm.DEFAULT_RING_BYTES))
                if total <= 0:
                    # No ring budget: no rings, the TCP path stays
                    ring_bytes = 0
                else:
                    if idx == 0 and BULK_STRIPES > 0:
                        per = min(CTRL_RING_BYTES, total)
                    else:
                        per = max(1 << 20, total // max(1, BULK_STRIPES))
                    ring_bytes = 1 << (per.bit_length() - 1)
                s = _Stripe(self.host, idx, ring_bytes)
                self._stripes[idx] = s
            return s

    def _pick(self, nbytes: int, seq: int) -> _Stripe:
        # Unlocked fast path: a dict read of add-only entries, the
        # locked _stripe() on a miss
        if BULK_STRIPES == 0 or nbytes < BULK_THRESHOLD or seq < 0:
            s = self._stripes.get(0)
            return s if s is not None else self._stripe(0)
        # A race on the counter only spreads load
        self._rr = rr = (self._rr + 1) % BULK_STRIPES
        s = self._stripes.get(1 + rr)
        return s if s is not None else self._stripe(1 + rr)

    def small_frames_ok(self) -> bool:
        """Whether sub-threshold frames should come here: the control
        stripe has (or can set up) a live shm ring. Dials on first use;
        an OSError reaches the broker, which marks the plane down."""
        s = self._stripes.get(0)
        if s is not None:
            if s.ring is not None:
                return True
            if s.ring_refused:
                return False
        s = self._stripe(0)
        s.ensure_connected()
        return s.ring is not None

    def is_local(self) -> bool:
        """Whether the destination is this machine (the link class the
        governor keeps raw)."""
        local = self._local
        if local is None:
            local = self._local = host_is_local(self.host)
        return local

    def _pin_idx(self, group_id: int, send_idx: int, recv_idx: int,
                 channel: int) -> int:
        """The one data stripe of a coded stream: base and delta frames
        must share a FIFO connection."""
        if BULK_STRIPES == 0:
            return 0
        mix = (group_id ^ (send_idx * 1000003) ^ (recv_idx * 8191)
               ^ (channel * 127))
        return 1 + (mix % BULK_STRIPES)

    # -- observability -----------------------------------------------------
    def _sum(self, attr: str) -> int:
        with self._lock:
            return sum(getattr(s, attr) for s in self._stripes.values())

    @property
    def shm_frames(self) -> int:
        return self._sum("shm_frames")

    @property
    def tcp_frames(self) -> int:
        return self._sum("tcp_frames")

    @property
    def coded_frames(self) -> int:
        return self._sum("coded_frames")

    @property
    def escape_frames(self) -> int:
        return self._sum("escape_frames")

    @property
    def wire_bytes(self) -> int:
        return self._sum("wire_bytes")

    @property
    def raw_bytes(self) -> int:
        return self._sum("raw_bytes")

    def stripe_frames(self) -> dict[int, tuple[int, int]]:
        """Stripe index → (frames on TCP, frames on its ring); 0 is the
        control stripe."""
        with self._lock:
            return {i: (s.tcp_frames, s.shm_frames)
                    for i, s in sorted(self._stripes.items())}

    def rings(self) -> list:
        with self._lock:
            return [s.ring for s in self._stripes.values()
                    if s.ring is not None]

    def stripes(self) -> list:
        with self._lock:
            return list(self._stripes.values())

    # -----------------------------------------------------------------------
    def send(self, group_id: int, send_idx: int, recv_idx: int,
             bufs, seq: int, channel: int) -> None:
        """``bufs``: bytes-like buffers forming one frame payload, sent
        scatter-gather from the caller's memory. Returns once the frame
        is in the socket or the ring, so the buffers may change after."""
        views = [memoryview(b).cast("B") if not isinstance(b, memoryview)
                 else b.cast("B") for b in bufs]
        nbytes = sum(len(v) for v in views)
        if seq >= 0 and nbytes >= CODEC_MIN_BYTES:
            # Only sequenced frames may be coded (a heal re-ships a seq);
            # a live ring beats any codec
            mode = get_wire_governor().bulk_codec(
                self.host, self.is_local(), send_idx, recv_idx, nbytes)
            if mode != "raw":
                stripe = self._stripe(self._pin_idx(
                    group_id, send_idx, recv_idx, channel))
                if stripe.ring is None:
                    parts = [np.frombuffer(v, dtype=np.uint8)
                             for v in views]
                    stripe.send_coded(mode, group_id, send_idx,
                                      recv_idx, seq, channel, parts)
                    return
        head = _pack_raw((group_id >> 64) & _U64, group_id & _U64,
                         send_idx, recv_idx, channel, seq, nbytes)
        if nbytes < 4096:
            # One joined buffer is cheaper than three pointer conversions
            views = [memoryview(b"".join((head, *views)))]
            head = b""
        self._pick(nbytes, seq).send_frame(head, views, nbytes)

    def close(self) -> None:
        with self._lock:
            stripes, self._stripes = list(self._stripes.values()), {}
        for s in stripes:
            s.close()
