"""Cached per-host RPC clients with one lifecycle.

Counterpart of ``faabric_tpu/transport/client_pool.py``: the planner's
host → client cache for dispatch and result pushes, with one close and
reset path.
"""

from __future__ import annotations

import threading
from typing import Callable, Generic, TypeVar

T = TypeVar("T")


class ClientPool(Generic[T]):
    # The host → client map is shared by every dispatching thread;
    # close() runs outside the lock, since it waits on socket teardown

    def __init__(self, factory: Callable[[str], T]) -> None:
        self._factory = factory
        self._clients: dict[str, T] = {}
        self._lock = threading.Lock()

    def get(self, host: str) -> T:
        with self._lock:
            client = self._clients.get(host)
            if client is None:
                client = self._clients[host] = self._factory(host)
            return client

    def drop(self, host: str) -> None:
        with self._lock:
            client = self._clients.pop(host, None)
        if client is not None:
            client.close()

    def close_all(self) -> None:
        with self._lock:
            clients = list(self._clients.values())
            self._clients.clear()
        for c in clients:
            c.close()
