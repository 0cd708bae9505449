"""Cache of scheduling decisions for repeated fork-join shapes.

Counterpart of ``faabric_tpu/batch_scheduler/decision_cache.py``
(reference include/faabric/batch-scheduler/DecisionCache.h:14-33): keyed
by (user, function, batch type, tenant, message count), so a runtime
that forks the same N-wide batch again reuses its host placement. The
reference's planner consults it for THREADS batches, which the port's
planner does not serve yet; a policy reset clears it.
"""

from __future__ import annotations

import threading
from typing import Optional

from faabric_tpu_torch.proto import BatchExecuteRequest


class CachedDecision:
    """A cached placement. The group id is not reused across forks: each
    app gets a fresh one, so its point-to-point state can be dropped per
    app; only the hosts are recycled."""

    def __init__(self, hosts: list[str], group_id: int = 0) -> None:
        self._hosts = hosts
        self._group_id = group_id

    @property
    def hosts(self) -> list[str]:
        return list(self._hosts)

    @property
    def group_id(self) -> int:
        return self._group_id


class DecisionCache:
    def __init__(self) -> None:
        self._cache: dict[str, CachedDecision] = {}
        self._lock = threading.Lock()

    @staticmethod
    def _key(req: BatchExecuteRequest) -> str:
        # Type and subtype belong to the signature: a THREADS fork and a
        # FUNCTIONS call of one function schedule differently, and the
        # compact policy reads subtype as a tenant id
        return (f"{req.user}/{req.function}:{req.type}:{req.subtype}:"
                f"{req.n_messages()}")

    def get_cached_decision(self, req: BatchExecuteRequest
                            ) -> Optional[CachedDecision]:
        with self._lock:
            return self._cache.get(self._key(req))

    def add_cached_decision(self, req: BatchExecuteRequest, hosts: list[str],
                            group_id: int) -> None:
        if len(hosts) != req.n_messages():
            raise ValueError(
                f"Cached hosts ({len(hosts)}) != messages "
                f"({req.n_messages()})")
        with self._lock:
            self._cache[self._key(req)] = CachedDecision(hosts, group_id)

    def clear(self) -> None:
        with self._lock:
            self._cache.clear()


_cache: Optional[DecisionCache] = None
_cache_lock = threading.Lock()


def get_decision_cache() -> DecisionCache:
    global _cache
    if _cache is None:
        with _cache_lock:
            if _cache is None:
                _cache = DecisionCache()
    return _cache
