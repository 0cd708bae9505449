"""Retry policy and per-peer circuit breaker.

Counterpart of ``faabric_tpu/util/retry.py``: a ``RetryPolicy`` names
the RPC clients' attempt budget, exponential backoff with jitter and
breaker thresholds; a ``CircuitBreaker`` per peer opens after that many
consecutive failures, so later calls fail at once instead of paying
the connect timeout again.
"""

from __future__ import annotations

import os
import random
import threading
import time


class CircuitBreaker:
    """CLOSED → (threshold consecutive failures) → OPEN → (reset_after
    elapses) → HALF_OPEN → one trial call → CLOSED on success, OPEN on
    failure."""

    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"

    def __init__(self, threshold: int = 5, reset_after: float = 5.0,
                 clock=time.monotonic) -> None:
        if threshold < 1:
            raise ValueError("breaker threshold must be >= 1")
        self.threshold = threshold
        self.reset_after = reset_after
        self._clock = clock
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._trial_in_flight = False

    @property
    def state(self) -> str:
        with self._lock:
            self._maybe_half_open_locked()
            return self._state

    @property
    def failures(self) -> int:
        """Consecutive failures since the last success; unlike allow(),
        reading it never takes the half-open trial."""
        with self._lock:
            return self._failures

    def _maybe_half_open_locked(self) -> None:
        if (self._state == self.OPEN
                and self._clock() - self._opened_at >= self.reset_after):
            self._state = self.HALF_OPEN
            self._trial_in_flight = False

    def allow(self) -> bool:
        with self._lock:
            self._maybe_half_open_locked()
            if self._state == self.CLOSED:
                return True
            if self._state == self.HALF_OPEN and not self._trial_in_flight:
                self._trial_in_flight = True  # one trial at a time
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            self._state = self.CLOSED
            self._failures = 0
            self._trial_in_flight = False

    def record_failure(self) -> None:
        with self._lock:
            if self._state == self.HALF_OPEN:
                self._state = self.OPEN
                self._opened_at = self._clock()
                self._trial_in_flight = False
                return
            self._failures += 1
            if self._failures >= self.threshold:
                self._state = self.OPEN
                self._opened_at = self._clock()


class RetryPolicy:
    """Attempt budget, exponential backoff with jitter and breaker
    parameters, as one object."""

    def __init__(self, max_attempts: int = 2, backoff: float = 0.05,
                 multiplier: float = 2.0, max_backoff: float = 2.0,
                 jitter: float = 0.2, breaker_threshold: int = 5,
                 breaker_reset: float = 5.0,
                 rng: random.Random | None = None) -> None:
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        self.max_attempts = max_attempts
        self.backoff = backoff
        self.multiplier = multiplier
        self.max_backoff = max_backoff
        self.jitter = jitter
        self.breaker_threshold = breaker_threshold
        self.breaker_reset = breaker_reset
        self._rng = rng or random.Random()

    def delay(self, attempt: int) -> float:
        """Sleep before retry ``attempt + 1`` (0-based): exponential,
        capped, jittered by ±jitter."""
        base = min(self.backoff * (self.multiplier ** attempt),
                   self.max_backoff)
        if self.jitter <= 0:
            return base
        return base * (1.0 + self.jitter * (2.0 * self._rng.random() - 1.0))

    def sleep(self, attempt: int) -> None:
        d = self.delay(attempt)
        if d > 0:
            time.sleep(d)

    def schedule(self) -> list[float]:
        """The whole backoff schedule (max_attempts - 1 sleeps)."""
        return [self.delay(i) for i in range(self.max_attempts - 1)]

    def new_breaker(self) -> CircuitBreaker:
        return CircuitBreaker(threshold=self.breaker_threshold,
                              reset_after=self.breaker_reset)


def default_transport_retry_policy() -> RetryPolicy:
    """The RPC clients' policy, from the reference's environment
    variables and defaults."""
    def _f(name: str, default: float) -> float:
        try:
            return float(os.environ.get(name, default))
        except ValueError:
            return default

    return RetryPolicy(
        max_attempts=max(1, int(_f("TRANSPORT_RETRY_ATTEMPTS", 2))),
        backoff=_f("TRANSPORT_RETRY_BACKOFF", 0.05),
        breaker_threshold=max(1, int(_f("TRANSPORT_BREAKER_THRESHOLD", 6))),
        breaker_reset=_f("TRANSPORT_BREAKER_RESET", 5.0),
    )
