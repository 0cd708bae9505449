"""A minimal RESP2 server: an in-process stand-in for Redis.

Counterpart of ``faabric_tpu/redis/miniserver.py``. It serves the
commands the port's client uses (strings and ranges, counters, expiry,
sets, lists with BLPOP, pipelines, and the client's compare-and-delete
EVAL script), one thread per connection, each command under one store
lock (Redis runs one command at a time: the same atomicity). A type
mismatch answers WRONGTYPE, and garbage input closes its connection
without hurting the others. Tests and single-host runs use it for
``STATE_MODE=redis``; a deployment points the same client at a real
Redis (reference: the ``redis`` service of faabric's deployments).
"""

from __future__ import annotations

import socket
import threading
import time
from typing import Optional


def _now() -> float:
    return time.monotonic()


class _Store:
    """Keyspace with passive expiry. Values: bytes (string), set, list."""

    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.data: dict[bytes, object] = {}
        self.expiry: dict[bytes, float] = {}
        # Signalled on every list push so BLPOP waiters re-check
        self.push_cond = threading.Condition(self.lock)

    def _expired(self, key: bytes) -> bool:
        exp = self.expiry.get(key)
        if exp is not None and _now() >= exp:
            self.data.pop(key, None)
            self.expiry.pop(key, None)
            return True
        return False

    def get(self, key: bytes):
        if self._expired(key):
            return None
        return self.data.get(key)

    def set(self, key: bytes, value) -> None:
        self.data[key] = value
        self.expiry.pop(key, None)


class MiniRedisServer:
    """``start()`` binds and serves on a background thread;
    ``stop()`` tears down the listener and live connections."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0) -> None:
        self.host = host
        self.port = port
        self.store = _Store()
        self._listener: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        # Live connections only — entries are pruned as handlers exit,
        # so a long-running service doesn't grow per connection accepted
        self._conns_lock = threading.Lock()
        self._conns: dict[socket.socket, threading.Thread] = {}
        self._stop = threading.Event()

    # -- lifecycle ------------------------------------------------------
    def start(self) -> None:
        s = socket.socket()
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((self.host, self.port))
        s.listen(64)
        self.port = s.getsockname()[1]
        self._listener = s
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="redis/accept", daemon=True)
        self._accept_thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._listener is not None:
            # The shutdown wakes the accept thread; a close alone leaves
            # it blocked in accept()
            try:
                self._listener.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._listener.close()
            except OSError:
                pass
        # Wake any BLPOP waiters so their threads observe _stop
        with self.store.push_cond:
            self.store.push_cond.notify_all()
        with self._conns_lock:
            live = list(self._conns.items())
        for c, _ in live:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        for _, t in live:
            t.join(timeout=5.0)
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5.0)

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 name="redis/conn", daemon=True)
            with self._conns_lock:
                self._conns[conn] = t
            t.start()

    # -- RESP parsing ---------------------------------------------------
    def _serve_conn(self, conn: socket.socket) -> None:
        # bytearray accumulation + recv_into for bulk payloads (bytes +=
        # would be O(n^2) on multi-MiB SETRANGE bodies)
        buf = bytearray()

        def read_more() -> bool:
            try:
                chunk = conn.recv(65536)
            except OSError:
                return False
            if not chunk:
                return False
            buf.extend(chunk)
            return True

        def read_line() -> Optional[bytes]:
            while True:
                idx = buf.find(b"\r\n")
                if idx >= 0:
                    line = bytes(buf[:idx])
                    del buf[:idx + 2]
                    return line
                if not read_more():
                    return None

        def read_exact(n: int) -> Optional[bytes]:
            if len(buf) >= n:
                out = bytes(buf[:n])
                del buf[:n]
                return out
            out = bytearray(n)
            got = len(buf)
            out[:got] = buf
            buf.clear()
            mv = memoryview(out)
            while got < n:
                try:
                    k = conn.recv_into(mv[got:])
                except OSError:
                    return None
                if not k:
                    return None
                got += k
            return bytes(out)

        try:
            while not self._stop.is_set():
                line = read_line()
                if line is None:
                    return
                if not line.startswith(b"*"):
                    conn.sendall(b"-ERR protocol: expected array\r\n")
                    return
                try:
                    n_args = int(line[1:])
                except ValueError:
                    conn.sendall(b"-ERR protocol: bad array length\r\n")
                    return
                if n_args <= 0 or n_args > 1024 * 1024:
                    conn.sendall(b"-ERR protocol: bad arity\r\n")
                    return
                args: list[bytes] = []
                ok = True
                for _ in range(n_args):
                    hdr = read_line()
                    if hdr is None or not hdr.startswith(b"$"):
                        ok = False
                        break
                    try:
                        ln = int(hdr[1:])
                    except ValueError:
                        ok = False
                        break
                    # Bulk length is client-supplied and read_exact
                    # preallocates it — cap before a bogus $1099511627776
                    # header turns into a TiB allocation
                    if ln < 0 or ln > 1 << 30:
                        conn.sendall(b"-ERR protocol: bulk too large\r\n")
                        return
                    body = read_exact(ln)
                    if body is None or read_exact(2) is None:
                        ok = False
                        break
                    args.append(body)
                if not ok:
                    return
                try:
                    reply = self._dispatch(args)
                except _Error as e:
                    reply = b"-ERR " + str(e).encode() + b"\r\n"
                except Exception as e:  # noqa: BLE001 — contain per-command
                    reply = b"-ERR internal: " + repr(e).encode()[:120] \
                        + b"\r\n"
                try:
                    conn.sendall(reply)
                except OSError:
                    return
        finally:
            try:
                conn.close()
            except OSError:
                pass
            with self._conns_lock:
                self._conns.pop(conn, None)

    # -- encoding helpers ----------------------------------------------
    @staticmethod
    def _bulk(v: Optional[bytes]) -> bytes:
        if v is None:
            return b"$-1\r\n"
        return b"$%d\r\n%s\r\n" % (len(v), v)

    @staticmethod
    def _int(n: int) -> bytes:
        return b":%d\r\n" % n

    @staticmethod
    def _arr(items: list[Optional[bytes]]) -> bytes:
        return b"*%d\r\n" % len(items) + b"".join(
            MiniRedisServer._bulk(i) for i in items)

    # -- command dispatch ----------------------------------------------
    def _dispatch(self, args: list[bytes]) -> bytes:
        cmd = args[0].upper().decode(errors="replace")
        handler = getattr(self, "_cmd_" + cmd.lower(), None)
        if handler is None:
            raise _Error(f"unknown command '{cmd}'")
        st = self.store
        if cmd == "BLPOP":  # manages the lock itself (waits on the cond)
            return handler(args[1:])
        with st.lock:
            return handler(args[1:])

    # All handlers run under the store lock (except BLPOP).
    def _cmd_ping(self, a):
        return b"+PONG\r\n"

    def _cmd_eval(self, a):
        """Only the framework's delifeq script (client.DELIFEQ_LUA) —
        recognized by source text and applied atomically under the
        command lock, matching what a real Redis does server-side."""
        from faabric_tpu_torch.redis.client import RedisClient

        script = a[0].decode(errors="replace")
        if script != RedisClient.DELIFEQ_LUA or int(a[1]) != 1:
            raise _Error("unsupported EVAL script (miniserver runs only "
                         "the framework's delifeq)")
        key, expected = a[2], a[3]
        v = self._get_str(key)
        if v is not None and bytes(v) == expected:
            self.store.data.pop(key, None)
            self.store.expiry.pop(key, None)
            return self._int(1)
        return self._int(0)

    def _cmd_flushall(self, a):
        self.store.data.clear()
        self.store.expiry.clear()
        return b"+OK\r\n"

    def _get_str(self, key: bytes) -> Optional[bytearray]:
        v = self.store.get(key)
        if v is None:
            return None
        if not isinstance(v, bytearray):
            raise _Error("WRONGTYPE not a string")
        return v

    def _cmd_get(self, a):
        v = self._get_str(a[0])
        return self._bulk(bytes(v) if v is not None else None)

    def _cmd_set(self, a):
        key, value, rest = a[0], a[1], [x.upper() for x in a[2:]]
        nx = b"NX" in rest
        px_ms = None
        if b"PX" in rest:
            px_ms = int(rest[rest.index(b"PX") + 1])
        if nx and self.store.get(key) is not None:
            return self._bulk(None)
        self.store.set(key, bytearray(value))
        if px_ms is not None:
            self.store.expiry[key] = _now() + px_ms / 1000.0
        return b"+OK\r\n"

    def _cmd_setnx(self, a):
        if self.store.get(a[0]) is not None:
            return self._int(0)
        self.store.set(a[0], bytearray(a[1]))
        return self._int(1)

    def _cmd_strlen(self, a):
        v = self._get_str(a[0])
        return self._int(len(v) if v is not None else 0)

    def _cmd_append(self, a):
        v = self._get_str(a[0])
        if v is None:
            v = bytearray()
            self.store.set(a[0], v)
        v.extend(a[1])
        return self._int(len(v))

    def _cmd_getrange(self, a):
        v = self._get_str(a[0]) or bytearray()
        start, end = int(a[1]), int(a[2])
        n = len(v)
        if start < 0:
            start += n
        if end < 0:
            end += n
        return self._bulk(bytes(v[max(0, start):end + 1]))

    def _cmd_setrange(self, a):
        key, off, data = a[0], int(a[1]), a[2]
        v = self._get_str(key)
        if v is None:
            v = bytearray()
            self.store.set(key, v)
        if len(v) < off + len(data):
            v.extend(b"\x00" * (off + len(data) - len(v)))
        v[off:off + len(data)] = data
        return self._int(len(v))

    def _cmd_del(self, a):
        n = 0
        for key in a:
            if self.store.data.pop(key, None) is not None:
                n += 1
            self.store.expiry.pop(key, None)
        return self._int(n)

    def _cmd_exists(self, a):
        return self._int(sum(1 for k in a if self.store.get(k) is not None))

    def _cmd_expire(self, a):
        if self.store.get(a[0]) is None:
            return self._int(0)
        self.store.expiry[a[0]] = _now() + int(a[1])
        return self._int(1)

    def _counter(self, key: bytes, delta: int) -> bytes:
        v = self._get_str(key)
        cur = int(bytes(v)) if v else 0
        cur += delta
        self.store.set(key, bytearray(str(cur).encode()))
        return self._int(cur)

    def _cmd_incr(self, a):
        return self._counter(a[0], 1)

    def _cmd_decr(self, a):
        return self._counter(a[0], -1)

    def _cmd_incrby(self, a):
        return self._counter(a[0], int(a[1]))

    def _cmd_keys(self, a):
        import fnmatch

        pat = a[0].decode(errors="replace")
        live = [k for k in list(self.store.data)
                if not self.store._expired(k)]
        return self._arr(sorted(
            k for k in live if fnmatch.fnmatchcase(
                k.decode(errors="replace"), pat)))

    # -- sets -----------------------------------------------------------
    def _get_set(self, key: bytes) -> Optional[set]:
        v = self.store.get(key)
        if v is None:
            return None
        if not isinstance(v, set):
            raise _Error("WRONGTYPE not a set")
        return v

    def _cmd_sadd(self, a):
        s = self._get_set(a[0])
        if s is None:
            s = set()
            self.store.set(a[0], s)
        n = 0
        for m in a[1:]:
            if m not in s:
                s.add(bytes(m))
                n += 1
        return self._int(n)

    def _cmd_srem(self, a):
        s = self._get_set(a[0]) or set()
        n = 0
        for m in a[1:]:
            if m in s:
                s.discard(m)
                n += 1
        return self._int(n)

    def _cmd_smembers(self, a):
        return self._arr(sorted(self._get_set(a[0]) or set()))

    def _cmd_sismember(self, a):
        return self._int(int(a[1] in (self._get_set(a[0]) or set())))

    def _cmd_scard(self, a):
        return self._int(len(self._get_set(a[0]) or set()))

    def _cmd_srandmember(self, a):
        s = self._get_set(a[0])
        return self._bulk(next(iter(s)) if s else None)

    # -- lists ----------------------------------------------------------
    def _get_list(self, key: bytes) -> Optional[list]:
        v = self.store.get(key)
        if v is None:
            return None
        if not isinstance(v, list):
            raise _Error("WRONGTYPE not a list")
        return v

    def _push(self, key: bytes, values: list[bytes], left: bool) -> bytes:
        lst = self._get_list(key)
        if lst is None:
            lst = []
            self.store.set(key, lst)
        for v in values:
            if left:
                lst.insert(0, bytes(v))
            else:
                lst.append(bytes(v))
        self.store.push_cond.notify_all()
        return self._int(len(lst))

    def _cmd_rpush(self, a):
        return self._push(a[0], a[1:], left=False)

    def _cmd_lpush(self, a):
        return self._push(a[0], a[1:], left=True)

    def _cmd_lpop(self, a):
        lst = self._get_list(a[0])
        return self._bulk(lst.pop(0) if lst else None)

    def _cmd_rpop(self, a):
        lst = self._get_list(a[0])
        return self._bulk(lst.pop() if lst else None)

    def _cmd_llen(self, a):
        lst = self._get_list(a[0])
        return self._int(len(lst) if lst else 0)

    def _cmd_lrange(self, a):
        lst = self._get_list(a[0]) or []
        start, stop = int(a[1]), int(a[2])
        n = len(lst)
        if start < 0:
            start += n
        if stop < 0:
            stop += n
        return self._arr(lst[max(0, start):stop + 1])

    def _cmd_blpop(self, a):
        """Blocking pop; a = [key, timeout_s]. Runs outside the dispatch
        lock — takes it via the condition."""
        key, timeout_s = a[0], float(a[1])
        deadline = None if timeout_s == 0 else _now() + timeout_s
        st = self.store
        with st.push_cond:
            while not self._stop.is_set():
                lst = self._get_list(key)
                if lst:
                    return self._arr([key, lst.pop(0)])
                remaining = None if deadline is None else deadline - _now()
                if remaining is not None and remaining <= 0:
                    return b"*-1\r\n"
                st.push_cond.wait(
                    timeout=min(0.5, remaining) if remaining else 0.5)
            return b"*-1\r\n"


class _Error(Exception):
    pass
