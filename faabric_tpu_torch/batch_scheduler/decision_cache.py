"""Cache of scheduling decisions for repeated fork-join shapes.

Counterpart of ``faabric_tpu/batch_scheduler/decision_cache.py``
(reference include/faabric/batch-scheduler/DecisionCache.h:14-33): keyed
by (user, function, batch type, tenant, message count), so a runtime
that forks the same N-wide batch again reuses its host placement. The
planner consults it for NEW THREADS decisions and fills it from the
policy's (``planner/planner.py::_decision_from_cache_locked``); a
policy reset clears it. Every lookup the planner makes is counted as a
hit or a miss (``faabric_decision_cache_{hits,misses}_total``).
"""

from __future__ import annotations

import threading
from typing import Optional

from faabric_tpu_torch.proto import BatchExecuteRequest
from faabric_tpu_torch.telemetry import get_metrics

_metrics = get_metrics()
_HITS = _metrics.counter(
    "faabric_decision_cache_hits_total",
    "Scheduling decisions served from the decision cache (policy run "
    "skipped)")
_MISSES = _metrics.counter(
    "faabric_decision_cache_misses_total",
    "Decision-cache lookups that fell through to the policy (absent "
    "signature or stale capacity)")


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
    # Concurrency contract (analysis/concheck.py): map + counters under the
    # cache's own leaf lock.
    GUARDS = {"_cache": "_lock", "_hits": "_lock", "_misses": "_lock"}

    def __init__(self) -> None:
        self._cache: dict[str, CachedDecision] = {}
        self._lock = threading.Lock()
        self._hits = 0
        self._misses = 0

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

    def record_outcome(self, hit: bool) -> None:
        """Count one lookup's outcome (an entry whose hosts lost their
        slots counts as a miss: the policy ran)."""
        with self._lock:
            if hit:
                self._hits += 1
            else:
                self._misses += 1
        (_HITS if hit else _MISSES).inc()

    def stats(self) -> dict:
        """Entries and lookup outcomes, for the planner's health view."""
        with self._lock:
            total = self._hits + self._misses
            return {
                "entries": len(self._cache),
                "hits": self._hits,
                "misses": self._misses,
                "hitRate": round(self._hits / total, 4) if total else 0.0,
            }

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
