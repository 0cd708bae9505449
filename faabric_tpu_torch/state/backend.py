"""Pluggable state authorities: where a key's authoritative bytes live.

Counterpart of ``faabric_tpu/state/backend.py`` (reference
src/state/InMemoryStateKeyValue.cpp, RedisStateKeyValue.cpp), selected
by ``STATE_MODE``:

- ``inmemory`` (default): one master host per key, elected through the
  planner. The master's process memory is the authority
  (:class:`MasterMemoryAuthority`); every other host reaches it over the
  StateServer RPC (:class:`RemoteAuthority`).
- ``file`` (alias ``shm``): the authority is an mmap'd file under
  ``STATE_DIR`` that every process of the machine maps
  (:class:`SharedFileAuthority`): value bytes in ``<user>__<key>.bin``,
  appends as length-prefixed records in ``.append``, the global lock a
  flock on ``.lock``. The layout is the reference's, so a port process
  and a reference process share a key through one ``STATE_DIR``.
- ``redis``: a Redis server is the authority (:class:`RedisAuthority`):
  value bytes in the string key ``fstate:<user>/<key>`` (GETRANGE and
  SETRANGE, grown on create), appends in the list ``...:append``, the
  global lock a SET-NX-PX token on ``...:lock`` with a TTL, released by
  a compare-and-delete. Tests and single-host runs use the port's
  ``MiniRedisServer``; ``REDIS_STATE_HOST`` and ``REDIS_PORT`` point it
  at a real Redis.

``StateKeyValue`` keeps the chunked pull, dirty push and append
protocol and hands every authority interaction to one of these.
"""

from __future__ import annotations

import fcntl
import mmap
import os
import struct
import threading
import time
import uuid
from typing import Optional

_APPEND_REC = struct.Struct("<I")


class StaleStateEpoch(RuntimeError):
    """A state RPC carried an epoch older than the receiver's: the
    sender's placement is stale (a failover happened). Clients re-resolve
    through the planner and retry; a fenced-out ex-master stops acking.
    The message carries the class name, so it survives the transport's
    error channel (clients match the text of the RpcError)."""


class StateAuthority:
    """Accessor of the authoritative store of one user/key."""

    #: True when the authoritative bytes live in this process (the
    #: StateServer serves them to other hosts)
    local = False

    def pull_chunk(self, offset: int, length: int) -> bytes:
        raise NotImplementedError

    def push_chunk(self, offset: int, data: bytes) -> None:
        raise NotImplementedError

    def push_chunks(self, writes: list[tuple[int, bytes]]) -> None:
        """A batch of chunk pushes."""
        for offset, data in writes:
            self.push_chunk(offset, data)

    def append(self, data: bytes) -> None:
        raise NotImplementedError

    def get_appended(self, n_values: int) -> list[bytes]:
        raise NotImplementedError

    def clear_appended(self) -> None:
        raise NotImplementedError

    def lock(self) -> None:
        raise NotImplementedError

    def unlock(self) -> None:
        raise NotImplementedError


class MasterMemoryAuthority(StateAuthority):
    """This process holds the key (inmemory mode, master side). The value
    bytes stay in the StateKeyValue's image; the authority owns the
    append log and the global value lock."""

    local = True

    # Concurrency contract: the append log mutates under _lock;
    # _value_lock is the datum clients contend on, never a guard
    GUARDS = {
        "_appended": "_lock",
    }

    # Under the client socket timeout, so a contended lock surfaces as
    # an RPC error on the requester and not as an orphaned server thread
    LOCK_ACQUIRE_TIMEOUT = 30.0

    def __init__(self, user: str, key: str) -> None:
        self.user = user
        self.key = key
        self._lock = threading.Lock()
        self._appended: list[bytes] = []
        self._value_lock = threading.Lock()

    def pull_chunk(self, offset: int, length: int) -> bytes:
        raise RuntimeError("local authority: data lives in the KV image")

    def push_chunk(self, offset: int, data: bytes) -> None:
        raise RuntimeError("local authority: data lives in the KV image")

    def append(self, data: bytes) -> None:
        with self._lock:
            self._appended.append(bytes(data))

    def all_appended(self) -> list[bytes]:
        """Every appended value: the source of a backup's full sync."""
        with self._lock:
            return list(self._appended)

    def seed_appended(self, values: list[bytes]) -> None:
        """Replace the append log (replica promotion)."""
        with self._lock:
            self._appended[:] = [bytes(v) for v in values]

    def get_appended(self, n_values: int) -> list[bytes]:
        with self._lock:
            if len(self._appended) < n_values:
                raise ValueError(
                    f"Only {len(self._appended)} appended values")
            return list(self._appended[:n_values])

    def clear_appended(self) -> None:
        with self._lock:
            self._appended.clear()

    def lock(self) -> None:
        if not self._value_lock.acquire(timeout=self.LOCK_ACQUIRE_TIMEOUT):
            raise TimeoutError(
                f"Timed out acquiring global lock on {self.user}/{self.key}")

    def unlock(self) -> None:
        self._value_lock.release()


class RemoteAuthority(StateAuthority):
    """The key's master lives on another host (inmemory mode): every op
    is an RPC to its StateServer."""

    def __init__(self, user: str, key: str, master_host: str,
                 client_factory, epoch: int = 0) -> None:
        self.user = user
        self.key = key
        self.master_host = master_host
        self._client_factory = client_factory
        # Fencing epoch stamped on every RPC; 0 is unfenced. The owning
        # StateKeyValue raises it when it re-resolves after a failover.
        self.epoch = epoch

    def _client(self):
        if self._client_factory is None:
            raise RuntimeError(
                f"No state client for non-master access to "
                f"{self.user}/{self.key}")
        return self._client_factory(self.master_host)

    def pull_chunk(self, offset: int, length: int) -> bytes:
        return self._client().pull_chunk(self.user, self.key, offset,
                                         length, epoch=self.epoch)

    def push_chunk(self, offset: int, data: bytes) -> None:
        self._client().push_chunk(self.user, self.key, offset, data,
                                  epoch=self.epoch)

    def append(self, data: bytes) -> None:
        self._client().append(self.user, self.key, data, epoch=self.epoch)

    def get_appended(self, n_values: int) -> list[bytes]:
        return self._client().pull_appended(self.user, self.key, n_values,
                                            epoch=self.epoch)

    def clear_appended(self) -> None:
        self._client().clear_appended(self.user, self.key,
                                      epoch=self.epoch)

    # Lock and unlock use connections of their own: the cached client
    # serialises its socket, so a blocked lock request would hold the
    # holder's unlock behind it
    def lock(self) -> None:
        self._oneshot("lock")

    def unlock(self) -> None:
        self._oneshot("unlock")

    def _oneshot(self, op: str) -> None:
        from faabric_tpu_torch.state.remote import StateClient

        client = StateClient(self.master_host)
        try:
            getattr(client, op)(self.user, self.key, epoch=self.epoch)
        finally:
            client.close()


def _file_stem(user: str, key: str) -> str:
    return f"{user}__{key}".replace("/", "_")


class SharedFileAuthority(StateAuthority):
    """The authority is an mmap'd file that every process of the machine
    opens (``file``/``shm`` mode)."""

    local = False  # nothing for the StateServer to serve

    # Concurrency contract. Not listed: _lock_fd, which lock()/unlock()
    # change outside _iolock on purpose (the flock hand-off serialises
    # them, and _iolock there would stall readers behind a contended
    # lock's poll loop)
    GUARDS = {
        "_mm": "_iolock",
    }

    # As MasterMemoryAuthority's: a contended lock raises, it does not
    # wedge the worker
    LOCK_ACQUIRE_TIMEOUT = 30.0

    def __init__(self, user: str, key: str, size: int,
                 state_dir: str) -> None:
        self.user = user
        self.key = key
        os.makedirs(state_dir, exist_ok=True)
        stem = os.path.join(state_dir, _file_stem(user, key))
        self._path = stem + ".bin"
        self._append_path = stem + ".append"
        self._lock_path = stem + ".lock"
        self._iolock = threading.Lock()
        self._lock_fd: Optional[int] = None

        # Create or open at the requested size (the first creator sizes
        # it)
        fd = os.open(self._path, os.O_RDWR | os.O_CREAT, 0o644)
        try:
            cur = os.fstat(fd).st_size
            if cur < size:
                os.ftruncate(fd, size)
            self.size = max(cur, size)
            self._mm = mmap.mmap(fd, self.size) if self.size else None
        finally:
            os.close(fd)

    @staticmethod
    def existing_size(user: str, key: str, state_dir: str) -> int:
        try:
            return os.stat(os.path.join(
                state_dir, _file_stem(user, key) + ".bin")).st_size
        except OSError:
            return 0

    def pull_chunk(self, offset: int, length: int) -> bytes:
        with self._iolock:
            return bytes(self._mm[offset:offset + length])

    def push_chunk(self, offset: int, data: bytes) -> None:
        if offset + len(data) > self.size:
            raise ValueError("Pushed chunk out of bounds")
        with self._iolock:
            self._mm[offset:offset + len(data)] = bytes(data)

    def append(self, data: bytes) -> None:
        with self._iolock, open(self._append_path, "ab") as f:
            fcntl.flock(f, fcntl.LOCK_EX)
            try:
                f.write(_APPEND_REC.pack(len(data)))
                f.write(data)
                f.flush()  # the record is whole before the lock drops
            finally:
                fcntl.flock(f, fcntl.LOCK_UN)

    def get_appended(self, n_values: int) -> list[bytes]:
        out: list[bytes] = []
        try:
            with self._iolock, open(self._append_path, "rb") as f:
                # Shared lock against appends and truncates in flight
                fcntl.flock(f, fcntl.LOCK_SH)
                try:
                    while len(out) < n_values:
                        head = f.read(_APPEND_REC.size)
                        if len(head) < _APPEND_REC.size:
                            break
                        (n,) = _APPEND_REC.unpack(head)
                        body = f.read(n)
                        if len(body) < n:
                            raise ValueError(
                                f"Torn append record in {self._append_path}")
                        out.append(body)
                finally:
                    fcntl.flock(f, fcntl.LOCK_UN)
        except FileNotFoundError:
            pass
        if len(out) < n_values:
            raise ValueError(f"Only {len(out)} appended values")
        return out

    def clear_appended(self) -> None:
        with self._iolock:
            try:
                with open(self._append_path, "r+b") as f:
                    fcntl.flock(f, fcntl.LOCK_EX)
                    try:
                        f.truncate(0)
                    finally:
                        fcntl.flock(f, fcntl.LOCK_UN)
            except OSError:
                pass

    def lock(self) -> None:
        fd = os.open(self._lock_path, os.O_RDWR | os.O_CREAT, 0o644)
        deadline = time.monotonic() + self.LOCK_ACQUIRE_TIMEOUT
        while True:
            try:
                fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
                break
            except OSError:
                if time.monotonic() >= deadline:
                    os.close(fd)
                    raise TimeoutError(
                        f"Timed out acquiring global lock on "
                        f"{self.user}/{self.key}")
                time.sleep(0.01)
        self._lock_fd = fd

    def unlock(self) -> None:
        fd, self._lock_fd = self._lock_fd, None
        if fd is None:
            raise RuntimeError("unlock without lock")
        fcntl.flock(fd, fcntl.LOCK_UN)
        os.close(fd)

    def delete_files(self) -> None:
        for p in (self._path, self._append_path, self._lock_path):
            try:
                os.unlink(p)
            except OSError:
                pass


class RedisAuthority(StateAuthority):
    """The authority is a Redis server (``redis`` mode): value bytes in a
    string key (GETRANGE/SETRANGE — the reference's pull/push mapping,
    src/state/RedisStateKeyValue.cpp), appends in a list key, the global
    lock a SET-NX-PX token key with TTL (so a crashed holder cannot wedge
    the cluster). Speaks RESP through :mod:`faabric_tpu_torch.redis`, to
    a real Redis or the in-repo MiniRedisServer. The key layout is the
    reference's, so both packages share a key over one server."""

    local = False

    LOCK_ACQUIRE_TIMEOUT = 30.0
    LOCK_TTL_MS = 60_000

    def __init__(self, user: str, key: str, size: int) -> None:
        self.user = user
        self.key = key
        self._key = f"fstate:{user}/{key}".encode()
        self._append_key = self._key + b":append"
        self._lock_key = self._key + b":lock"
        # Token is thread-local: authorities are shared across threads
        # through the cached StateKeyValue, and a TTL expiry means two
        # threads can hold (what they think is) the lock concurrently —
        # a shared token slot would let one thread's unlock delete the
        # other's live lock
        self._lock_tls = threading.local()

        cli = self._cli()
        cur = cli.strlen(self._key)
        if size > cur:
            # Grow to the requested size (zero-fill, first creator sizes)
            cli.setrange(self._key, size - 1, b"\x00")
            cur = size
        elif size <= 0 and cur <= 0:
            raise ValueError(
                f"State key {user}/{key} does not exist in redis yet; "
                "creation needs an explicit size")
        self.size = cur

    @staticmethod
    def _cli():
        from faabric_tpu_torch.redis import get_redis

        return get_redis()

    def pull_chunk(self, offset: int, length: int) -> bytes:
        return self._cli().getrange(self._key, offset, offset + length - 1)

    def push_chunk(self, offset: int, data: bytes) -> None:
        if offset + len(data) > self.size:
            raise ValueError("Pushed chunk out of bounds")
        self._cli().setrange(self._key, offset, data)

    def push_chunks(self, writes: list[tuple[int, bytes]]) -> None:
        """Pipelined multi-chunk push, one round-trip (reference
        setRangePipeline); kv.push_partial sends all dirty chunks here."""
        for offset, data in writes:
            if offset + len(data) > self.size:
                raise ValueError("Pushed chunk out of bounds")
        self._cli().setrange_pipeline(self._key, writes)

    def append(self, data: bytes) -> None:
        self._cli().rpush(self._append_key, data)

    def get_appended(self, n_values: int) -> list[bytes]:
        if n_values <= 0:
            return []  # LRANGE 0 -1 would mean "whole list"
        vals = self._cli().lrange(self._append_key, 0, n_values - 1)
        if len(vals) < n_values:
            raise ValueError(f"Only {len(vals)} appended values")
        return vals

    def clear_appended(self) -> None:
        self._cli().delete(self._append_key)

    def lock(self) -> None:
        token = uuid.uuid4().bytes
        cli = self._cli()
        deadline = time.monotonic() + self.LOCK_ACQUIRE_TIMEOUT
        while not cli.set_nx_px(self._lock_key, token, self.LOCK_TTL_MS):
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"Timed out acquiring global lock on "
                    f"{self.user}/{self.key}")
            time.sleep(0.01)
        self._lock_tls.token = token

    def unlock(self) -> None:
        token = getattr(self._lock_tls, "token", None)
        self._lock_tls.token = None
        if token is None:
            raise RuntimeError("unlock without lock")
        self._cli().del_if_eq(self._lock_key, token)

    def delete_keys(self) -> None:
        self._cli().delete(self._key, self._append_key, self._lock_key)
