"""Admission control for the invocation ingress.

Counterpart of ``faabric_tpu/ingress/admission.py``. Every batchable
invocation passes a bounded admission queue before it may join a
planner scheduling tick. Two limits protect the planner:

- a global queue bound (``FAABRIC_INGRESS_QUEUE_MAX``, in messages):
  when the tick falls behind arrivals the queue absorbs the burst up to
  the bound and then sheds, and callers get a retry-after (HTTP 429 with
  ``Retry-After``) instead of an unbounded backlog;
- a per-source credit cap (``FAABRIC_INGRESS_SOURCE_CREDITS``): a source
  (the tenant on the REST surface, the submitting host on the RPC
  surface) holds at most this many queued messages, so that one runaway
  client cannot starve the others while global headroom remains.

Credits are taken at admission and released when the invocation leaves
the queue (scheduled, failed, or shed at its deadline). The retry hint
is an EWMA of the recent per-message drain time (fed back by the tick)
times the current depth, clamped to [0.05 s, 5 s]. The
``faabric_ingress_{admitted,shed}_total`` counters and the
``faabric_ingress_queue_depth`` gauge go to the port's registry, and
``stats()`` is the ``ingress`` block of the planner's ``/healthz``.
"""

from __future__ import annotations

import dataclasses
import threading

from faabric_tpu_torch.telemetry import get_metrics

_metrics = get_metrics()
_ADMITTED = _metrics.counter(
    "faabric_ingress_admitted_total",
    "Invocation messages admitted into the ingress queue or immediate "
    "path")
_SHED = _metrics.counter(
    "faabric_ingress_shed_total",
    "Invocation messages shed at admission (queue full or source over "
    "its credit cap)")
_DEPTH = _metrics.gauge(
    "faabric_ingress_queue_depth",
    "Messages currently holding admission credits (queued or being "
    "scheduled)")


@dataclasses.dataclass(frozen=True)
class AdmissionVerdict:
    admitted: bool
    retry_after: float = 0.0
    reason: str = ""


class IngressShedError(Exception):
    """Raised to a synchronous submitter whose invocation was shed.
    Carries the backlog-scaled retry hint the REST surface maps to
    ``429`` + ``Retry-After``."""

    def __init__(self, retry_after: float, reason: str = "overloaded"):
        super().__init__(f"invocation shed ({reason}); "
                         f"retry after {retry_after:.2f}s")
        self.retry_after = retry_after
        self.reason = reason


class AdmissionController:
    # Concurrency contract: all mutable accounting under one leaf lock;
    # try_admit and release are O(1) dict ops, and the lock is never
    # held across a blocking call
    GUARDS = {
        "_depth": "_lock",
        "_credits": "_lock",
        "_shed_total": "_lock",
        "_admitted_total": "_lock",
        "_drain_ewma_s": "_lock",
    }

    # retry_after clamp bounds (seconds)
    RETRY_AFTER_MIN = 0.05
    RETRY_AFTER_MAX = 5.0
    # drain-time EWMA seed before the first tick feedback arrives
    DEFAULT_DRAIN_S = 0.002

    def __init__(self, queue_max: int | None = None,
                 source_credits: int | None = None) -> None:
        from faabric_tpu_torch.util.config import get_system_config

        conf = get_system_config()
        self.queue_max = (queue_max if queue_max is not None
                          else conf.ingress_queue_max)
        self.source_credits = (source_credits if source_credits is not None
                               else conf.ingress_source_credits)
        self._lock = threading.Lock()
        self._depth = 0  # messages holding credits
        self._credits: dict[str, int] = {}  # source → messages held
        self._shed_total = 0
        self._admitted_total = 0
        self._drain_ewma_s = self.DEFAULT_DRAIN_S

    # ------------------------------------------------------------------
    def try_admit(self, source: str, n_msgs: int) -> AdmissionVerdict:
        """Take ``n_msgs`` credits for ``source``, or shed with a
        retry-after hint. All-or-nothing per request."""
        n_msgs = max(1, n_msgs)
        with self._lock:
            held = self._credits.get(source, 0)
            if self._depth + n_msgs > self.queue_max:
                reason = "admission queue full"
            elif held + n_msgs > self.source_credits:
                reason = f"source {source or '<anon>'} over credit cap"
            else:
                self._depth += n_msgs
                self._credits[source] = held + n_msgs
                self._admitted_total += n_msgs
                _ADMITTED.inc(n_msgs)
                _DEPTH.set(self._depth)
                return AdmissionVerdict(True)
            self._shed_total += n_msgs
            retry = min(self.RETRY_AFTER_MAX,
                        max(self.RETRY_AFTER_MIN,
                            self._depth * self._drain_ewma_s))
        _SHED.inc(n_msgs)
        return AdmissionVerdict(False, retry_after=retry, reason=reason)

    def release(self, source: str, n_msgs: int) -> None:
        """Return ``n_msgs`` credits (the invocation left the queue:
        scheduled, failed, or deadline-shed)."""
        n_msgs = max(1, n_msgs)
        with self._lock:
            self._depth = max(0, self._depth - n_msgs)
            held = self._credits.get(source, 0) - n_msgs
            if held > 0:
                self._credits[source] = held
            else:
                self._credits.pop(source, None)
            _DEPTH.set(self._depth)

    def note_drained(self, n_msgs: int, elapsed_s: float) -> None:
        """Tick-loop feedback: ``n_msgs`` resolved in ``elapsed_s`` —
        refreshes the per-message drain EWMA behind retry_after."""
        if n_msgs <= 0 or elapsed_s <= 0:
            return
        per_msg = elapsed_s / n_msgs
        with self._lock:
            self._drain_ewma_s = 0.8 * self._drain_ewma_s + 0.2 * per_msg

    def depth(self) -> int:
        """Current queue depth (messages holding credits) — the
        time-series ring's ingress-depth gauge."""
        with self._lock:
            return self._depth

    def shed_total(self) -> int:
        """Cumulative shed count (the ring stores the raw counter; the
        doctor differentiates to get a shed RATE trend)."""
        with self._lock:
            return self._shed_total

    # ------------------------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            return {
                "queueDepth": self._depth,
                "queueMax": self.queue_max,
                "sourceCredits": self.source_credits,
                "sourcesHolding": len(self._credits),
                "admittedTotal": self._admitted_total,
                "shedTotal": self._shed_total,
                "drainEwmaMs": round(self._drain_ewma_s * 1000.0, 4),
            }
