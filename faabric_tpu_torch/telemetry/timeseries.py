"""Continuous time-series ring: the doctor needs *trends*.

``/healthz`` answers "what is the ingress depth NOW"; nobody could
answer "has it been growing for the last minute" — the difference
between a burst the tick will drain and a capacity exhaustion in
progress. This module keeps a preallocated ring of sampled gauges per
process:

- every process samples its own resource gauges (RSS, CPU%, threads,
  fds, GC — ``telemetry/procstats.py``);
- the planner registers control-plane series on top (ingress depth,
  shed total, free-slot watermark, tick duration, result backlog,
  in-flight messages);
- workers add their executor count.

A :class:`TimeSeriesSampler` (``PeriodicBackgroundThread``) drives
``sample()`` every ``FAABRIC_TIMESERIES_INTERVAL_S`` seconds (default
1.0); the ring holds ``FAABRIC_TIMESERIES_RING`` points per series
(default 512 ≈ 8.5 minutes at 1 Hz). Snapshots ride ``GET_TELEMETRY``
(``timeseries`` block) and the planner merges every host's ring behind
``GET /timeseries``; worker HTTP endpoints serve their local ring on
the same path. Timestamps are wall-clock so hosts' series line up.

``FAABRIC_METRICS=0`` (or ``FAABRIC_TIMESERIES=0``) returns the shared
no-op ring: registrations and samples cost one no-op call.
"""

from __future__ import annotations

import math
import os
import threading
import time

from faabric_tpu_torch.telemetry.metrics import metrics_enabled
from faabric_tpu_torch.util.config import _env_float, _env_int
from faabric_tpu_torch.util.logging import get_logger
from faabric_tpu_torch.util.periodic import PeriodicBackgroundThread

logger = get_logger(__name__)

DEFAULT_RING = 512
DEFAULT_INTERVAL_S = 1.0


def timeseries_enabled() -> bool:
    return (metrics_enabled()
            and os.environ.get("FAABRIC_TIMESERIES", "1")
            not in ("0", "false", "off"))


class _NullTimeSeries:
    __slots__ = ()
    enabled = False

    def register(self, name: str, fn) -> None:
        pass

    def unregister(self, name: str, fn=None) -> None:
        pass

    def sample(self) -> None:
        pass

    def snapshot(self, last: int | None = None) -> dict:
        return {}

    def reset(self) -> None:
        pass


NULL_TIMESERIES = _NullTimeSeries()


class _Series:
    """One preallocated ring of (implicit-timestamp) float samples. The
    shared timestamp ring lives on the owner — every series samples on
    the same tick, so storing the clock once per tick keeps a 16-series
    ring at 16 floats per sample, not 32."""

    __slots__ = ("values", "fn")

    def __init__(self, capacity: int, fn) -> None:
        self.values = [math.nan] * capacity
        self.fn = fn


class TimeSeriesRing:
    """Named gauge samplers + their preallocated history rings."""

    # Concurrency contract (analysis/concheck.py): registration map, ring
    # cursor and the timestamp ring mutate under one leaf lock; sampler
    # callables run OUTSIDE it (a stuck gauge must not wedge snapshot
    # readers), writing each value with one locked slot store.
    GUARDS = {
        "_series": "_lock",
        "_ts": "_lock",
        "_cursor": "_lock",
    }

    enabled = True

    def __init__(self, capacity: int | None = None) -> None:
        self.capacity = max(8, capacity if capacity is not None else
                            _env_int("FAABRIC_TIMESERIES_RING",
                                     DEFAULT_RING))
        self._lock = threading.Lock()
        self._series: dict[str, _Series] = {}
        self._ts = [0.0] * self.capacity
        self._cursor = 0  # total samples taken (monotonic)

    # ------------------------------------------------------------------
    def register(self, name: str, fn) -> None:
        """Register (or replace) a gauge sampler: ``fn() -> float``.
        Replacement is deliberate — in-process multi-runtime tests
        re-register per-host series and the latest runtime wins."""
        with self._lock:
            s = self._series.get(name)
            if s is None:
                self._series[name] = _Series(self.capacity, fn)
            else:
                s.fn = fn

    def unregister(self, name: str, fn=None) -> None:
        """Remove a series. With ``fn`` given, remove ONLY if the live
        sampler is still that callable — a stopping owner must not kill
        the series a co-resident runtime re-registered over it."""
        with self._lock:
            s = self._series.get(name)
            if s is not None and (fn is None or s.fn is fn):
                del self._series[name]

    # ------------------------------------------------------------------
    def sample(self) -> None:
        """Take one sample of every registered series. Gauge callables
        run lock-free; a raising gauge records NaN for this tick and is
        kept (a transiently dead accessor must not lose its series)."""
        with self._lock:
            fns = [(name, s.fn) for name, s in self._series.items()]
        values: dict[str, float] = {}
        for name, fn in fns:
            try:
                values[name] = float(fn())
            except Exception:  # noqa: BLE001 — one bad gauge ≠ no ring
                values[name] = math.nan
        now = time.time()
        with self._lock:
            slot = self._cursor % self.capacity
            self._ts[slot] = now
            for name, v in values.items():
                s = self._series.get(name)
                if s is not None:
                    s.values[slot] = v
            self._cursor += 1

    # ------------------------------------------------------------------
    def snapshot(self, last: int | None = None) -> dict:
        """JSON-safe dump, oldest → newest: ``{"interval_hint_s", ...,
        "series": {name: [[wall_ts, value], ...]}}``. NaN samples (gauge
        failed, or the series registered mid-ring) are dropped per
        point."""
        with self._lock:
            cursor = self._cursor
            ts = list(self._ts)
            series = {name: list(s.values)
                      for name, s in self._series.items()}
        n = min(cursor, self.capacity)
        if last is not None:
            n = min(n, max(0, last))
        # Chronological slot order ending at the newest sample
        slots = [(cursor - n + i) % self.capacity for i in range(n)]
        out_series: dict[str, list] = {}
        for name, vals in series.items():
            pts = []
            for slot in slots:
                v = vals[slot]
                if not math.isnan(v):
                    pts.append([round(ts[slot], 3), v])
            out_series[name] = pts
        return {
            "capacity": self.capacity,
            "samples_taken": cursor,
            "interval_hint_s": _env_float("FAABRIC_TIMESERIES_INTERVAL_S",
                                          DEFAULT_INTERVAL_S),
            "series": out_series,
        }

    def reset(self) -> None:
        with self._lock:
            self._series.clear()
            self._ts = [0.0] * self.capacity
            self._cursor = 0


class TimeSeriesSampler(PeriodicBackgroundThread):
    thread_name = "telemetry/sampler"

    def __init__(self, ring: TimeSeriesRing) -> None:
        super().__init__()
        self.ring = ring

    def do_work(self) -> None:
        self.ring.sample()


# ---------------------------------------------------------------------------
# Singletons + the shared sampler (refcounted: a planner server and
# worker runtimes can coexist in one test process; the sampler stops
# only when the LAST user stops)
# ---------------------------------------------------------------------------

_ring: TimeSeriesRing | None = None
_sampler: TimeSeriesSampler | None = None
_sampler_users = 0
_singleton_lock = threading.Lock()


def get_timeseries() -> TimeSeriesRing | _NullTimeSeries:
    if not timeseries_enabled():
        return NULL_TIMESERIES
    global _ring
    if _ring is None:
        with _singleton_lock:
            if _ring is None:
                ring = TimeSeriesRing()
                _register_process_series(ring)
                _ring = ring
    return _ring


def _register_process_series(ring: TimeSeriesRing) -> None:
    """Every host samples its own process resources (
    satellite): the collector feeds both the Prometheus gauges and
    this ring."""
    from faabric_tpu_torch.telemetry.procstats import get_proc_stats

    stats = get_proc_stats()
    if not stats.enabled:
        return

    def series(key: str):
        return lambda: stats.refresh().get(key, math.nan)

    # One refresh() per tick would be ideal; refresh() throttles itself
    # (min interval), so per-series calls within one sample() tick cost
    # one /proc read for the first and cached dict hits for the rest.
    for key, name in (("rss_bytes", "proc_rss_bytes"),
                      ("cpu_percent", "proc_cpu_percent"),
                      ("threads", "proc_threads"),
                      ("open_fds", "proc_open_fds"),
                      ("gc_collections", "proc_gc_collections")):
        ring.register(name, series(key))


def start_sampler() -> None:
    """Start (or share) the per-process sampler thread. Pair every call
    with ``stop_sampler()`` — server/runtime start/stop cycles must not
    leak the thread (the dist leak gate enforces it)."""
    if not timeseries_enabled():
        return
    ring = get_timeseries()
    global _sampler, _sampler_users
    with _singleton_lock:
        # The whole refcount+thread transition happens under the lock:
        # a stop (1→0) releasing before its join racing a start (0→1)
        # would otherwise kill the thread the new owner believes it
        # just started. start() is one cheap thread spawn; stop()'s
        # join is bounded (5 s).
        _sampler_users += 1
        if _sampler is None:
            _sampler = TimeSeriesSampler(ring)
        _sampler.start(max(0.01,
                           _env_float("FAABRIC_TIMESERIES_INTERVAL_S",
                                      DEFAULT_INTERVAL_S)))


def stop_sampler() -> None:
    global _sampler_users
    with _singleton_lock:
        _sampler_users = max(0, _sampler_users - 1)
        if _sampler_users > 0 or _sampler is None:
            return
        _sampler.stop()  # concheck: ok(blocking-under-lock) — bounded
        # 5 s join, and the lock IS the start/stop serialization (see
        # start_sampler)


def reset_timeseries() -> None:
    """Test hook: stop any sampler and drop the ring singleton."""
    global _ring, _sampler, _sampler_users
    with _singleton_lock:
        sampler = _sampler
        _sampler = None
        _sampler_users = 0
        _ring = None
    if sampler is not None:
        sampler.stop()
