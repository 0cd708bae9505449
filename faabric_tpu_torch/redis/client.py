"""A RESP2 Redis client over a plain socket.

Counterpart of ``faabric_tpu/redis/client.py`` (reference
include/faabric/redis/Redis.h:81-228, src/redis/Redis.cpp): per-thread
clients of the state server (``get_redis``, reference
``Redis::getState``), string, range, counter, set and list commands, pipelined
range writes, the blocking dequeue and the compare-and-delete script.
It speaks the wire protocol itself, to a real Redis server or to the
port's :mod:`faabric_tpu_torch.redis.miniserver`.
"""

from __future__ import annotations

import socket
import threading
from typing import Optional


class RedisError(RuntimeError):
    """Server-side error reply (RESP '-' line)."""


class RedisConnectionError(ConnectionError):
    pass


def _encode_command(*args) -> bytes:
    """RESP array of bulk strings; str/int args are utf-8 encoded."""
    out = [b"*%d\r\n" % len(args)]
    for a in args:
        if isinstance(a, bytes):
            b = a
        elif isinstance(a, memoryview):
            b = bytes(a)
        else:
            b = str(a).encode()
        out.append(b"$%d\r\n" % len(b))
        out.append(b)
        out.append(b"\r\n")
    return b"".join(out)


class RedisClient:
    """One TCP connection; NOT thread-safe — use :func:`get_redis` for a
    per-thread instance (the reference keeps per-thread hiredis contexts
    for the same reason)."""

    def __init__(self, host: str, port: int, timeout: float = 30.0) -> None:
        self.host = host
        self.port = port
        self.timeout = timeout
        self._sock: Optional[socket.socket] = None
        self._buf = bytearray()

    # -- connection ----------------------------------------------------
    def _connect(self) -> socket.socket:
        if self._sock is None:
            try:
                from faabric_tpu_torch.util.network import safe_create_connection

                s = safe_create_connection((self.host, self.port),
                                           timeout=self.timeout)
            except OSError as e:
                raise RedisConnectionError(
                    f"Cannot reach redis at {self.host}:{self.port}: {e}"
                ) from e
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._sock = s
            self._buf = bytearray()
        return self._sock

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None
                self._buf = bytearray()

    # -- RESP parsing (bytearray accumulation + recv_into for bulk
    # payloads — naive `bytes += chunk` would be O(n^2) on the
    # multi-hundred-MiB state pulls this backend exists for) -----------
    def _read_line(self) -> bytes:
        sock = self._connect()
        buf = self._buf
        while True:
            idx = buf.find(b"\r\n")
            if idx >= 0:
                line = bytes(buf[:idx])
                del buf[:idx + 2]
                return line
            chunk = sock.recv(65536)
            if not chunk:
                self.close()
                raise RedisConnectionError("redis connection closed")
            buf.extend(chunk)

    def _read_exact(self, n: int) -> bytes:
        buf = self._buf
        if len(buf) >= n:
            out = bytes(buf[:n])
            del buf[:n]
            return out
        sock = self._connect()
        out = bytearray(n)
        got = len(buf)
        out[:got] = buf
        buf.clear()
        mv = memoryview(out)
        while got < n:
            k = sock.recv_into(mv[got:])
            if not k:
                self.close()
                raise RedisConnectionError("redis connection closed")
            got += k
        return bytes(out)

    def _read_reply(self):
        reply = self._read_reply_any()
        if isinstance(reply, RedisError):
            raise reply
        return reply

    def _read_reply_any(self):
        """Parse one reply, returning errors as RedisError VALUES — the
        whole reply (including every element of an array that embeds an
        error) is always consumed, so the stream stays in sync; only the
        top level raises."""
        line = self._read_line()
        kind, rest = line[:1], line[1:]
        if kind == b"+":
            return rest
        if kind == b"-":
            return RedisError(rest.decode(errors="replace"))
        if kind == b":":
            return int(rest)
        if kind == b"$":
            n = int(rest)
            if n < 0:
                return None
            data = self._read_exact(n)
            self._read_exact(2)  # trailing \r\n
            return data
        if kind == b"*":
            n = int(rest)
            if n < 0:
                return None
            items = [self._read_reply_any() for _ in range(n)]
            for it in items:
                if isinstance(it, RedisError):
                    return it  # array fully drained; surface the error
            return items
        self.close()  # unparseable stream — cannot stay in sync
        raise RedisError(f"Bad RESP type byte {kind!r}")

    # -- command execution ---------------------------------------------
    # Any socket-level failure mid-exchange (send fails, recv times out)
    # leaves the reply stream desynced — a late reply would be consumed
    # as the answer to the NEXT command, silently corrupting reads. Drop
    # the connection on those; a server '-ERR' reply is a complete,
    # in-sync reply and keeps the connection.
    def execute(self, *args):
        try:
            self._connect().sendall(_encode_command(*args))
            return self._read_reply()
        except (OSError, RedisConnectionError):
            self.close()
            raise

    def pipeline(self, commands: list[tuple]) -> list:
        """Send N commands in one write, read N replies (the reference
        pipelines its setRange writes, Redis.cpp setRangePipeline). All
        N replies are drained even when some are errors — the stream
        stays in sync — then the first error is raised."""
        if not commands:
            return []
        payload = b"".join(_encode_command(*c) for c in commands)
        replies: list = []
        try:
            self._connect().sendall(payload)
            for _ in commands:
                replies.append(self._read_reply_any())
        except (OSError, RedisConnectionError):
            self.close()
            raise
        for r in replies:
            if isinstance(r, RedisError):
                raise r
        return replies

    # -- string / KV ----------------------------------------------------
    def ping(self) -> bool:
        return self.execute("PING") == b"PONG"

    def get(self, key) -> Optional[bytes]:
        return self.execute("GET", key)

    def set(self, key, value) -> None:
        self.execute("SET", key, value)

    def setnx(self, key, value) -> bool:
        return bool(self.execute("SETNX", key, value))

    def set_nx_px(self, key, value, px_ms: int) -> bool:
        return self.execute("SET", key, value, "NX", "PX", px_ms) is not None

    def getrange(self, key, start: int, end: int) -> bytes:
        return self.execute("GETRANGE", key, start, end) or b""

    def setrange(self, key, offset: int, value) -> int:
        return self.execute("SETRANGE", key, offset, value)

    def setrange_pipeline(self, key, writes: list[tuple[int, bytes]]) -> None:
        self.pipeline([("SETRANGE", key, off, data) for off, data in writes])

    def strlen(self, key) -> int:
        return self.execute("STRLEN", key)

    def append(self, key, value) -> int:
        return self.execute("APPEND", key, value)

    def delete(self, *keys) -> int:
        return self.execute("DEL", *keys)

    def exists(self, key) -> bool:
        return bool(self.execute("EXISTS", key))

    def expire(self, key, seconds: int) -> bool:
        return bool(self.execute("EXPIRE", key, seconds))

    def incr(self, key) -> int:
        return self.execute("INCR", key)

    def decr(self, key) -> int:
        return self.execute("DECR", key)

    def incrby(self, key, n: int) -> int:
        return self.execute("INCRBY", key, n)

    def keys(self, pattern: str = "*") -> list[bytes]:
        return self.execute("KEYS", pattern) or []

    def flushall(self) -> None:
        self.execute("FLUSHALL")

    # -- sets (reference: master registry / scheduler sets) --------------
    def sadd(self, key, *members) -> int:
        return self.execute("SADD", key, *members)

    def srem(self, key, *members) -> int:
        return self.execute("SREM", key, *members)

    def smembers(self, key) -> set[bytes]:
        return set(self.execute("SMEMBERS", key) or [])

    def sismember(self, key, member) -> bool:
        return bool(self.execute("SISMEMBER", key, member))

    def scard(self, key) -> int:
        return self.execute("SCARD", key)

    def srandmember(self, key) -> Optional[bytes]:
        return self.execute("SRANDMEMBER", key)

    # -- lists (reference: result queues, appends) ----------------------
    def rpush(self, key, *values) -> int:
        return self.execute("RPUSH", key, *values)

    def lpush(self, key, *values) -> int:
        return self.execute("LPUSH", key, *values)

    def lpop(self, key) -> Optional[bytes]:
        return self.execute("LPOP", key)

    def rpop(self, key) -> Optional[bytes]:
        return self.execute("RPOP", key)

    def llen(self, key) -> int:
        return self.execute("LLEN", key)

    def lrange(self, key, start: int, stop: int) -> list[bytes]:
        return self.execute("LRANGE", key, start, stop) or []

    def blpop(self, key, timeout_s: float = 0) -> Optional[bytes]:
        """Blocking dequeue (reference dequeueBytes). Returns the value
        (without the key echo), or None on timeout. ``timeout_s=0`` means
        block forever (Redis semantics) — the socket timeout is lifted
        for the call so the client blocks with the server."""
        prev = self.timeout
        # The socket must outlast the server-side block
        self.timeout = (timeout_s + 5.0) if timeout_s else None
        if self._sock is not None:
            self._sock.settimeout(self.timeout)
        try:
            reply = self.execute("BLPOP", key, timeout_s)
        finally:
            self.timeout = prev
            if self._sock is not None:
                self._sock.settimeout(prev)
        if reply is None:
            return None
        return reply[1]

    # -- compare-and-delete (reference delifeq Lua script) --------------
    DELIFEQ_LUA = ("if redis.call('get', KEYS[1]) == ARGV[1] then "
                   "return redis.call('del', KEYS[1]) else return 0 end")

    def del_if_eq(self, key, expected) -> bool:
        """Atomically delete ``key`` iff its value equals ``expected`` —
        the reference's delifeq Lua script (Redis.h delifeqSha), sent via
        EVAL so a real Redis runs it server-side; the miniserver
        recognizes this exact script and applies it under its command
        lock. Atomicity matters across lock-TTL expiry: a GET+DEL pair
        could delete a NEW holder's token that slipped in between."""
        return bool(self.execute("EVAL", self.DELIFEQ_LUA, 1, key, expected))


_tls = threading.local()


def get_redis() -> RedisClient:
    """This thread's client of the state server (reference
    Redis::getState), one per (host, port) the config has named."""
    from faabric_tpu_torch.util.config import get_system_config

    conf = get_system_config()
    key = (conf.redis_state_host, conf.redis_port)
    cache = getattr(_tls, "clients", None)
    if cache is None:
        cache = _tls.clients = {}
    cli = cache.get(key)
    if cli is None:
        cli = cache[key] = RedisClient(*key)
    return cli


def clear_thread_clients() -> None:
    cache = getattr(_tls, "clients", None)
    if cache:
        for cli in cache.values():
            cli.close()
        cache.clear()
