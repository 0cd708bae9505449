"""Passive per-key replicas: the backup side of the replicated write
path.

Counterpart of ``faabric_tpu/state/replica.py``, whole. A master
forwards every acknowledged mutation (dirty chunks, appends) to its
planner-placed backup host before it acks; the backup applies them into
a :class:`StateReplica`: a byte image, an append log and the epoch they
were forwarded under. No read is served from a replica: it exists to be
promoted into a master (``State.promote_replica``) with exactly the
acknowledged writes.

A forward whose epoch is older than the replica's comes from a
fenced-out ex-master and raises :class:`StaleStateEpoch`, which keeps
that master from acking.
"""

from __future__ import annotations

import threading

import numpy as np

from faabric_tpu_torch.state.backend import StaleStateEpoch


class StateReplica:
    # Concurrency contract: image, append log, size and epoch mutate
    # together under one lock (a forward applies atomically against
    # the fence check)
    GUARDS = {
        "_data": "_lock",
        "_appended": "_lock",
        "_epoch": "_lock",
        "_size": "_lock",
    }

    def __init__(self, user: str, key: str, size: int,
                 epoch: int = 0) -> None:
        self.user = user
        self.key = key
        self.full_key = f"{user}/{key}"
        self._lock = threading.Lock()
        self._size = size
        self._data = np.zeros(size, dtype=np.uint8)
        self._appended: list[bytes] = []
        self._epoch = epoch

    @property
    def epoch(self) -> int:
        with self._lock:
            return self._epoch

    @property
    def size(self) -> int:
        with self._lock:
            return self._size

    def _fence_locked(self, epoch: int, size: int) -> None:
        if epoch < self._epoch:
            raise StaleStateEpoch(
                f"StaleStateEpoch: replicate of {self.full_key} at epoch "
                f"{epoch} rejected (replica at epoch {self._epoch})")
        self._epoch = epoch
        if size > self._size:
            grown = np.zeros(size, dtype=np.uint8)
            grown[:self._size] = self._data
            self._data = grown
            self._size = size

    def apply_chunks(self, epoch: int, size: int,
                     writes: list[tuple[int, bytes]]) -> None:
        with self._lock:
            self._fence_locked(epoch, size)
            for offset, data in writes:
                if offset + len(data) > self._size:
                    raise ValueError(
                        f"Replicated chunk [{offset}, "
                        f"{offset + len(data)}) out of bounds "
                        f"(size {self._size})")
                self._data[offset:offset + len(data)] = np.frombuffer(
                    data, np.uint8)

    def apply_append(self, epoch: int, size: int, values: list[bytes],
                     replace: bool = False) -> None:
        """Forwarded appends; ``replace=True`` swaps the whole log (the
        full sync after a failover: byte-exact, not additive)."""
        with self._lock:
            self._fence_locked(epoch, size)
            if replace:
                self._appended[:] = [bytes(v) for v in values]
            else:
                self._appended.extend(bytes(v) for v in values)

    def snapshot(self) -> tuple[bytes, list[bytes], int]:
        """(image, appended values, epoch): the promotion payload."""
        with self._lock:
            return (self._data.tobytes(), list(self._appended),
                    self._epoch)
