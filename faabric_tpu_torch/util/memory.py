"""Shared memory for MPI windows.

Counterpart of ``SharedBuffer`` in ``faabric_tpu/util/memory.py``
(:65-132), the one part of that module the port needs: a region that
every co-located rank maps, backed by ``multiprocessing.shared_memory``.
"""

from __future__ import annotations

import atexit
import threading
from multiprocessing import shared_memory
from typing import Optional

import numpy as np

PAGE_SIZE = 4096


def page_align_up(size: int) -> int:
    return -(-int(size) // PAGE_SIZE) * PAGE_SIZE


class SharedBuffer:
    """A shared memory region (the MAP_SHARED analog) as a uint8
    array."""

    def __init__(self, size: int, name: Optional[str] = None,
                 create: bool = True) -> None:
        self._shm = shared_memory.SharedMemory(name=name, create=create,
                                               size=page_align_up(size))
        self.name = self._shm.name
        self.array = np.frombuffer(self._shm.buf, dtype=np.uint8)
        self._closed = False

    def close(self, unlink: bool = False) -> None:
        """Idempotent, and never raises for views a caller still holds:
        a mapping they pin goes to a graveyard that later close() calls
        (and exit) drain once the views die. ``unlink`` removes the name
        at once either way (POSIX allows unlink while mapped)."""
        _drain_shm_graveyard()
        if self._closed:
            return
        self._closed = True
        self.array = None  # our own view
        if unlink:
            try:
                self._shm.unlink()
            except FileNotFoundError:  # pragma: no cover
                pass
        try:
            self._shm.close()
        except BufferError:
            with _SHM_GRAVEYARD_LOCK:
                _SHM_GRAVEYARD.append(self._shm)
        self._shm = None


# Mappings whose close() found live views, kept referenced so their
# __del__ cannot fire early, retried as the views die
_SHM_GRAVEYARD: list = []
_SHM_GRAVEYARD_LOCK = threading.Lock()


def _drain_shm_graveyard() -> None:
    with _SHM_GRAVEYARD_LOCK:
        kept = []
        for shm in _SHM_GRAVEYARD:
            try:
                shm.close()
            except BufferError:
                kept.append(shm)
        _SHM_GRAVEYARD[:] = kept


atexit.register(_drain_shm_graveyard)
