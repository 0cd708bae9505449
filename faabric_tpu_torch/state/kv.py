"""Distributed state key-value.

Counterpart of ``faabric_tpu/state/kv.py`` (reference
include/faabric/state/StateKeyValue.h:105-226,
src/state/InMemoryStateKeyValue.cpp:90-260). One master host per key;
every other host holds a local image with lazy **chunked pulls** (a
pulled mask), a **dirty-chunk mask** whose partial push sends only the
dirty chunks, appends, and a global lock hosted by the master. Where
the authoritative bytes live is a pluggable
:mod:`faabric_tpu_torch.state.backend`.

Replication: a master forwards every write to the key's backup host
before it acks (``_replicate_writes``, ``_replicate_append``), ops carry
the key's fencing epoch, a failed remote op re-resolves the placement
through the planner and retries, and a freshly elected backup gets the
whole image (``full_sync_backup``).

Remote pulls and pushes travel in ranges of up to ``RANGE_BYTES``: the
missing (or dirty) chunks of a run go in one frame, so a value of
hundreds of MB takes tens of RPCs and each frame stays far inside the
transport's cap.

The device view: ``get_device_array`` gives the value as a tensor on a
device (the KV's, ``cuda`` unless the KV was made for the CPU), cached
per (dtype, device) until the host image changes; each refresh is one
counted host-to-device copy (``h2d.state``). ``set_from_device`` writes
a tensor's bytes back into the image as one counted device-to-host copy
(``d2h.state``).

Not ported: the reference's fault points (``state.*``) and its
telemetry (access ledger, comm matrix, spans, flight records;
``ROADMAP.md`` Queue 1 #7 part B and #9 part B).
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from faabric_tpu_torch.device_plane.copies import D2H, H2D, count_copy
from faabric_tpu_torch.state.backend import (
    MasterMemoryAuthority,
    RemoteAuthority,
    StaleStateEpoch,
    StateAuthority,
)
from faabric_tpu_torch.util.logging import get_logger
from faabric_tpu_torch.util.retry import RetryPolicy

logger = get_logger(__name__)

STATE_CHUNK_SIZE = 4096

# Bytes of one remote pull, push or backup forward: whole chunks
RANGE_BYTES = 4 << 20
_RANGE_CHUNKS = RANGE_BYTES // STATE_CHUNK_SIZE

# Bounded client-side retry after a failover: one re-resolve through
# the planner per attempt
_PLACEMENT_RETRY = RetryPolicy(max_attempts=3, backoff=0.05)


def n_chunks(size: int) -> int:
    return max(1, (size + STATE_CHUNK_SIZE - 1) // STATE_CHUNK_SIZE)


def _runs(chunks: list[int]) -> list[tuple[int, int]]:
    """Sorted chunk indices -> [first, last) runs of consecutive chunks,
    each at most ``_RANGE_CHUNKS`` long."""
    runs: list[tuple[int, int]] = []
    for c in chunks:
        if runs and runs[-1][1] == c and c - runs[-1][0] < _RANGE_CHUNKS:
            runs[-1] = (runs[-1][0], c + 1)
        else:
            runs.append((c, c + 1))
    return runs


def _torch_dtype(dtype) -> torch.dtype:
    if dtype is None:
        return torch.uint8
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, dtype=np.dtype(dtype))).dtype


class StateKeyValue:
    # Concurrency contract (the reference's, for tools/concheck.py): the
    # image and every mask and cache derived from it mutate under the
    # one RLock. Not listed: epoch (a monotone int), backup_host (a
    # whole-string swap) and _stale (a one-way latch).
    GUARDS = {
        "_data": "_lock",
        "_pulled": "_lock",
        "_ever_pulled": "_lock",
        "_dirty": "_lock",
        "_n_dirty": "_lock",
        "_version": "_lock",
        "_device_cache": "_lock",
    }

    def __init__(self, user: str, key: str, size: int,
                 is_master: bool, master_host: str,
                 client_factory=None,
                 authority: Optional[StateAuthority] = None,
                 local_host: str = "", backup_host: str = "",
                 epoch: int = 0, resolver=None, device=None) -> None:
        self.user = user
        self.key = key
        self.size = size
        self.master_host = master_host
        self.full_key = f"{user}/{key}"
        self.local_host = local_host or "local"
        # Where a master forwards acked writes, the fencing epoch, and
        # the planner re-claim that gives (master, backup, epoch)
        self.backup_host = backup_host
        self.epoch = epoch
        self._resolver = resolver
        self._stale = False
        self._client_factory = client_factory
        # The device view's default device (None: the card)
        self.device = device

        if authority is None:
            authority = (MasterMemoryAuthority(user, key) if is_master
                         else RemoteAuthority(user, key, master_host,
                                              client_factory, epoch=epoch))
        self.authority = authority
        # "Master": the authoritative bytes are this process's image
        self.is_master = authority.local

        self._lock = threading.RLock()
        self._data = np.zeros(size, dtype=np.uint8)
        # Device views keyed by (dtype, device), dropped whenever the
        # host image changes
        self._version = 0
        self._device_cache: dict = {}
        chunks = n_chunks(size)
        # A local authority's image is the value: every chunk "pulled"
        self._pulled = np.full(chunks, self.is_master, dtype=bool)
        # Chunks pulled at least once (pull() resets _pulled only)
        self._ever_pulled = np.full(chunks, self.is_master, dtype=bool)
        self._dirty = np.zeros(chunks, dtype=bool)
        self._n_dirty = 0

    # ------------------------------------------------------------------
    def _chunk_range(self, offset: int, length: int) -> tuple[int, int]:
        first = offset // STATE_CHUNK_SIZE
        last = (offset + max(1, length) - 1) // STATE_CHUNK_SIZE
        return first, last + 1

    def _chunk_bytes(self, first: int, last: int) -> tuple[int, int]:
        """Byte range [lo, hi) of chunks [first, last)."""
        return (first * STATE_CHUNK_SIZE,
                min(self.size, last * STATE_CHUNK_SIZE))

    # ------------------------------------------------------------------
    # Epoch fencing and replication
    # ------------------------------------------------------------------
    def check_epoch(self, req_epoch: int) -> None:
        """Master-side fence on every served op: reject requests older
        than our epoch, adopt newer ones (the planner re-blessed this
        host), reject everything once this master was fenced out."""
        if self._stale:
            raise StaleStateEpoch(
                f"StaleStateEpoch: {self.full_key} master at "
                f"{self.local_host} has been fenced out (a failover "
                "promoted its backup)")
        if not req_epoch:
            return
        if req_epoch < self.epoch:
            raise StaleStateEpoch(
                f"StaleStateEpoch: op at epoch {req_epoch} rejected by "
                f"{self.full_key} master (epoch {self.epoch})")
        if req_epoch > self.epoch:
            self.epoch = req_epoch

    def mark_stale(self) -> None:
        """One-way latch: this process's mastership of the key has been
        superseded."""
        self._stale = True

    def adopt_placement(self, backup: str, epoch: int) -> None:
        """Master-side placement refresh after a promotion."""
        self.backup_host = backup
        if epoch > self.epoch:
            self.epoch = epoch

    def load_image(self, data: bytes, appended: list[bytes]) -> None:
        """Seed a freshly promoted master from its replica: the image is
        the set of acknowledged writes."""
        with self._lock:
            self._data[:len(data)] = np.frombuffer(data, np.uint8)
            self._pulled[:] = True
            self._ever_pulled[:] = True
            self._dirty[:] = False
            self._n_dirty = 0
            self._bump_version_locked()
        if hasattr(self.authority, "seed_appended"):
            self.authority.seed_appended(appended)

    def _has_backup(self) -> bool:
        return bool(self.is_master and self.backup_host
                    and self._client_factory is not None)

    def _remote_retry(self, fn):
        """Run one remote-authority op; when it fails, re-resolve the
        placement through the planner and retry (bounded). A
        StaleStateEpoch arrives as an RpcError carrying the class name,
        so any failure re-resolves."""
        attempt = 0
        while True:
            try:
                return fn()
            except Exception:  # noqa: BLE001 — rethrown unless rebound
                attempt += 1
                if (attempt >= _PLACEMENT_RETRY.max_attempts
                        or not self._reresolve_placement()):
                    raise
                _PLACEMENT_RETRY.sleep(attempt - 1)

    def _reresolve_placement(self) -> bool:
        """Non-master side: claim through the planner again; True when
        the placement changed (worth retrying the op)."""
        if self.is_master or self._resolver is None:
            return False
        try:
            master, backup, epoch = self._resolver()
        except Exception:  # noqa: BLE001 — planner unreachable
            return False
        auth = self.authority
        changed = (master != self.master_host
                   or epoch > getattr(auth, "epoch", 0))
        if not changed or master == self.local_host:
            # Mastership landing on this host cannot convert a remote
            # image in place: the original failure surfaces
            return False
        logger.info("State %s re-resolved: master %s -> %s (epoch %d)",
                    self.full_key, self.master_host, master, epoch)
        self.master_host = master
        self.backup_host = backup
        if epoch > self.epoch:
            self.epoch = epoch
        if isinstance(auth, RemoteAuthority):
            auth.master_host = master
            auth.epoch = epoch
        return True

    def _replicate_writes(self, writes: list[tuple[int, bytes]]) -> None:
        """Forward chunk writes to the backup before the mutation is
        acked: an acked write exists on two hosts, or the ack never
        happened."""
        if not writes or not self._has_backup():
            return
        try:
            self._client_factory(self.backup_host).replicate_chunks(
                self.user, self.key, self.epoch, self.size, writes)
        except Exception as e:  # noqa: BLE001
            self._replication_failed(e)

    def _replicate_append(self, values: list[bytes],
                          replace: bool = False) -> None:
        if (not values and not replace) or not self._has_backup():
            return
        try:
            self._client_factory(self.backup_host).replicate_append(
                self.user, self.key, self.epoch, self.size, values,
                replace=replace)
        except Exception as e:  # noqa: BLE001
            self._replication_failed(e)

    def _replication_failed(self, err: Exception) -> None:
        """A backup forward failed. StaleStateEpoch means this master was
        fenced out (a failover promoted its backup): it never acks
        again. Otherwise re-resolve: a newly elected backup gets a full
        sync (which covers the failed bytes), the same unreachable
        backup propagates the failure, and no eligible backup left runs
        unreplicated."""
        if (isinstance(err, StaleStateEpoch)
                or "StaleStateEpoch" in str(err)):
            self._stale = True
            raise StaleStateEpoch(
                f"StaleStateEpoch: {self.full_key} master at "
                f"{self.local_host} was fenced out during failover"
            ) from err
        old_backup = self.backup_host
        if not self._reresolve_master_placement():
            if self._stale:
                raise StaleStateEpoch(
                    f"StaleStateEpoch: {self.full_key} master at "
                    f"{self.local_host} was fenced out during failover"
                ) from err
            raise err
        if self.backup_host and self.backup_host != old_backup:
            self.full_sync_backup()
        elif self.backup_host:
            raise err
        else:
            logger.warning("State %s runs unreplicated at %s",
                           self.full_key, self.local_host)

    def _reresolve_master_placement(self) -> bool:
        """Master side: claim through the planner again after a failed
        forward; False when unresolvable or when the planner says this
        host is no longer the master (fenced)."""
        if self._resolver is None:
            return False
        try:
            master, backup, epoch = self._resolver()
        except Exception:  # noqa: BLE001 — planner unreachable
            return False
        if master != self.local_host:
            self._stale = True
            return False
        self.backup_host = backup
        if epoch > self.epoch:
            self.epoch = epoch
        return True

    def full_sync_backup(self) -> None:
        """Stream the whole image and the append log to the current
        backup (a fresh backup after a failover); byte-exact, the append
        log included (replaced, not added to)."""
        backup = self.backup_host
        if not self._has_backup():
            return
        client = self._client_factory(backup)
        for lo in range(0, self.size, RANGE_BYTES):
            hi = min(self.size, lo + RANGE_BYTES)
            with self._lock:
                data = self._data[lo:hi].tobytes()
            client.replicate_chunks(self.user, self.key, self.epoch,
                                    self.size, [(lo, data)])
        appended = (self.authority.all_appended()
                    if hasattr(self.authority, "all_appended") else [])
        client.replicate_append(self.user, self.key, self.epoch,
                                self.size, appended, replace=True)

    def _dirty_runs(self) -> list[tuple[int, int]]:
        with self._lock:
            return _runs([int(c) for c in np.where(self._dirty)[0]])

    def _flush_replication(self) -> None:
        """Master-local write path (set or set_chunk, then push_full or
        push_partial): forward the dirty chunks to the backup before
        they are acked and cleared."""
        if not self._has_backup():
            return
        for first, last in self._dirty_runs():
            lo, hi = self._chunk_bytes(first, last)
            with self._lock:
                data = self._data[lo:hi].tobytes()
            self._replicate_writes([(lo, data)])

    def _ensure_pulled(self, offset: int, length: int) -> int:
        """Pull the chunks covering the range that are not pulled yet,
        one RPC a run; returns how many chunks travelled."""
        if self.is_master:
            return 0
        first, last = self._chunk_range(offset, length)
        with self._lock:
            missing = [c for c in range(first, min(last, self._pulled.size))
                       if not self._pulled[c]]
        for run_first, run_last in _runs(missing):
            lo, hi = self._chunk_bytes(run_first, run_last)
            data = self._remote_retry(
                lambda lo=lo, hi=hi: self.authority.pull_chunk(lo, hi - lo))
            with self._lock:
                self._data[lo:lo + len(data)] = np.frombuffer(data, np.uint8)
                self._pulled[run_first:run_last] = True
                self._ever_pulled[run_first:run_last] = True
                self._bump_version_locked()
        return len(missing)

    # ------------------------------------------------------------------
    # Reads
    # ------------------------------------------------------------------
    def get(self) -> bytes:
        self._ensure_pulled(0, self.size)
        with self._lock:
            return self._data.tobytes()

    def get_array(self) -> np.ndarray:
        self._ensure_pulled(0, self.size)
        with self._lock:
            return self._data.copy()

    def get_chunk(self, offset: int, length: int) -> bytes:
        if offset + length > self.size:
            raise ValueError(
                f"Chunk [{offset}, {offset + length}) out of bounds "
                f"(size {self.size})")
        self._ensure_pulled(offset, length)
        with self._lock:
            return self._data[offset:offset + length].tobytes()

    # ------------------------------------------------------------------
    # Writes
    # ------------------------------------------------------------------
    def set(self, data) -> None:
        """The whole value: ``size`` bytes (any buffer)."""
        src = np.frombuffer(data, np.uint8)
        if src.size != self.size:
            raise ValueError(f"set() needs {self.size} bytes, got {src.size}")
        with self._lock:
            self._data[:] = src
            self._pulled[:] = True
            self._dirty[:] = True
            self._n_dirty = int(self._dirty.size)
            self._bump_version_locked()

    def set_chunk(self, offset: int, data: bytes) -> None:
        if offset + len(data) > self.size:
            raise ValueError("Chunk write out of bounds")
        first, last = self._chunk_range(offset, len(data))
        with self._lock:
            self._data[offset:offset + len(data)] = np.frombuffer(data,
                                                                  np.uint8)
            self._n_dirty += int((~self._dirty[first:last]).sum())
            self._dirty[first:last] = True
            self._pulled[first:last] = True
            self._bump_version_locked()

    # ------------------------------------------------------------------
    # Push and pull (non-master <-> master)
    # ------------------------------------------------------------------
    def _ack_master_writes(self) -> None:
        """A master's push: forward the dirty chunks to the backup
        before clearing them; returning is the ack."""
        self._flush_replication()
        with self._lock:
            self._dirty[:] = False
            self._n_dirty = 0

    def push_full(self) -> None:
        """Push the whole value to the authority (in ranges)."""
        if self.is_master:
            self._ack_master_writes()
            return
        self._ensure_pulled(0, self.size)
        for lo in range(0, self.size, RANGE_BYTES):
            hi = min(self.size, lo + RANGE_BYTES)
            with self._lock:
                data = self._data[lo:hi].tobytes()
            self._remote_retry(
                lambda lo=lo, d=data: self.authority.push_chunk(lo, d))
        with self._lock:
            self._dirty[:] = False
            self._n_dirty = 0

    def push_partial(self) -> None:
        """Push only the dirty chunks (reference pushPartial), a run of
        them a frame."""
        if self.is_master:
            self._ack_master_writes()
            return
        for first, last in self._dirty_runs():
            lo, hi = self._chunk_bytes(first, last)
            with self._lock:
                data = self._data[lo:hi].tobytes()
            self._remote_retry(
                lambda lo=lo, d=data: self.authority.push_chunks([(lo, d)]))
            with self._lock:
                self._dirty[first:last] = False
                self._n_dirty = int(self._dirty.sum())

    def pull(self) -> None:
        """Re-pull the whole value from the master."""
        if self.is_master:
            return
        with self._lock:
            self._pulled[:] = False
        self._ensure_pulled(0, self.size)

    def n_dirty_chunks(self) -> int:
        with self._lock:
            return int(self._dirty.sum())

    # ------------------------------------------------------------------
    # Appends (reference append/getAppended/clearAppended)
    # ------------------------------------------------------------------
    def append(self, data: bytes) -> None:
        if self.is_master:
            self.authority.append(data)
            # Forward before returning: returning is the ack
            self._replicate_append([bytes(data)])
        else:
            self._remote_retry(lambda: self.authority.append(data))

    def get_appended(self, n_values: int) -> list[bytes]:
        return self.authority.get_appended(n_values)

    def clear_appended(self) -> None:
        self.authority.clear_appended()
        if self.is_master:
            # Keep the replica's log byte-exact (replaced by the empty one)
            self._replicate_append([], replace=True)

    # ------------------------------------------------------------------
    # Locks (hosted by the authority)
    # ------------------------------------------------------------------
    def lock_global(self) -> None:
        self.authority.lock()

    def unlock_global(self) -> None:
        self.authority.unlock()

    # ------------------------------------------------------------------
    # Device view: the host image stays authoritative; a device holds a
    # cached tensor that is refreshed when the image changes
    # ------------------------------------------------------------------
    def get_device_array(self, dtype=None, device=None) -> torch.Tensor:
        """The value as a flat tensor on ``device`` (the KV's device by
        default, which is the card unless the KV was made for the CPU),
        viewed as ``dtype`` (a torch or numpy dtype; bytes when None).
        Cached per (dtype, device) until the host image changes, so a
        step that reads unchanged state copies nothing; a refresh is one
        counted host-to-device copy. The cached tensor is shared: write
        through :meth:`set_from_device`, not into it."""
        from faabric_tpu_torch.util.device import resolve_device

        dev = resolve_device(self.device if device is None else device)
        tdtype = _torch_dtype(dtype)
        self._ensure_pulled(0, self.size)
        key = (tdtype, dev)
        with self._lock:
            version = self._version
            cached = self._device_cache.get(key)
            if cached is not None and cached[0] == version:
                return cached[1]
            host = torch.from_numpy(self._data.copy())
        out = host.view(tdtype).to(dev)
        count_copy(H2D, self.size, "state")
        with self._lock:
            if self._version == version:
                self._device_cache[key] = (version, out)
        return out

    def set_from_device(self, tensor: torch.Tensor) -> None:
        """Write a tensor's bytes into the host image (one counted
        device-to-host copy); push_partial or push_full then carries
        them to the authority."""
        flat = tensor.detach().contiguous().reshape(-1)
        nbytes = flat.numel() * flat.element_size()
        if nbytes != self.size:
            raise ValueError(
                f"device value is {nbytes} bytes, KV holds {self.size}")
        host = flat.view(torch.uint8).cpu()
        count_copy(D2H, nbytes, "state")
        self.set(host.numpy())

    def _bump_version_locked(self) -> None:
        self._version += 1
        self._device_cache.clear()

    # -- master-side entry points of the StateServer ---------------------
    def server_pull_chunk(self, offset: int, length: int) -> bytes:
        with self._lock:
            return self._data[offset:offset + length].tobytes()

    def server_push_chunk(self, offset: int, data: bytes) -> None:
        first, last = self._chunk_range(offset, len(data))
        with self._lock:
            if offset + len(data) > self.size:
                raise ValueError("Pushed chunk out of bounds")
            self._data[offset:offset + len(data)] = np.frombuffer(data,
                                                                  np.uint8)
            self._pulled[first:last] = True
            self._bump_version_locked()
        # The backup forward precedes the RPC response (the ack): raising
        # here means the client never sees success
        self._replicate_writes([(offset, bytes(data))])

    def server_append(self, data: bytes) -> None:
        self.authority.append(data)
        self._replicate_append([bytes(data)])
