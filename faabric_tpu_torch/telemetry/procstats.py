"""Per-process resource collector: ``/proc/self``-
fed RSS/CPU/thread/fd/GC gauges on every host's ``/metrics``.

Until this PR not even the planner reported its own RSS — a leaking
control plane was invisible to the very scrape surface built to watch
the cluster. The collector reads ``/proc/self/status`` (VmRSS),
``/proc/self/stat`` (utime+stime → CPU%% between refreshes),
``/proc/self/fd`` (open descriptors), ``threading.active_count`` and
``gc`` counters, publishes them as ``faabric_process_*`` gauges in the
local metrics registry (so they ride GET_TELEMETRY to the planner's
merged ``/metrics`` with a ``host`` label), and returns the same values
as a dict for the time-series ring.

``refresh()`` throttles to one ``/proc`` read per
``MIN_REFRESH_S`` (0.2 s): the ring samples several series per tick and
must not pay five reads for one instant. Non-Linux / unreadable
``/proc`` degrades to the Python-visible subset (threads, GC) — never
raises.
"""

from __future__ import annotations

import gc
import os
import threading
import time

from faabric_tpu_torch.telemetry.metrics import get_metrics, metrics_enabled

_CLK_TCK = os.sysconf("SC_CLK_TCK") if hasattr(os, "sysconf") else 100


class _NullProcStats:
    __slots__ = ()
    enabled = False

    def refresh(self) -> dict:
        return {}


NULL_PROC_STATS = _NullProcStats()


class ProcStats:
    MIN_REFRESH_S = 0.2

    # Concurrency contract (analysis/concheck.py): the throttle clock, the
    # cached sample and the CPU baseline mutate under one leaf lock;
    # the /proc reads run outside it.
    GUARDS = {
        "_last_refresh": "_lock",
        "_last_values": "_lock",
        "_cpu_baseline": "_lock",
    }

    enabled = True

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._last_refresh = 0.0
        self._last_values: dict = {}
        # (monotonic_ts, cpu_seconds) of the previous refresh
        self._cpu_baseline: tuple[float, float] | None = None
        metrics = get_metrics()
        self._g_rss = metrics.gauge(
            "faabric_process_rss_bytes", "Resident set size of this process")
        self._g_cpu = metrics.gauge(
            "faabric_process_cpu_percent",
            "CPU utilisation of this process between collector refreshes "
            "(100 = one full core)")
        self._g_threads = metrics.gauge(
            "faabric_process_threads", "Live Python threads")
        self._g_fds = metrics.gauge(
            "faabric_process_open_fds", "Open file descriptors")
        self._g_gc = metrics.gauge(
            "faabric_process_gc_collections",
            "Cumulative garbage collections across all generations")

    # -- raw reads ------------------------------------------------------
    @staticmethod
    def _read_rss_bytes() -> float | None:
        try:
            with open("/proc/self/status") as f:
                for line in f:
                    if line.startswith("VmRSS:"):
                        return float(line.split()[1]) * 1024.0
        except (OSError, ValueError, IndexError):
            return None
        return None

    @staticmethod
    def _read_cpu_seconds() -> float | None:
        try:
            with open("/proc/self/stat") as f:
                fields = f.read().rsplit(")", 1)[-1].split()
            # utime/stime are fields 14/15 of the full line; after the
            # comm tail split they sit at offsets 11/12
            return (float(fields[11]) + float(fields[12])) / _CLK_TCK
        except (OSError, ValueError, IndexError):
            return None

    @staticmethod
    def _read_fd_count() -> float | None:
        try:
            return float(len(os.listdir("/proc/self/fd")))
        except OSError:
            return None

    # ------------------------------------------------------------------
    def refresh(self) -> dict:
        """Read, publish and return the current gauges (throttled;
        repeat calls inside MIN_REFRESH_S return the cached dict)."""
        now = time.monotonic()
        with self._lock:
            if (now - self._last_refresh < self.MIN_REFRESH_S
                    and self._last_values):
                return self._last_values
            self._last_refresh = now
            baseline = self._cpu_baseline
        values: dict = {}
        rss = self._read_rss_bytes()
        if rss is not None:
            values["rss_bytes"] = rss
            self._g_rss.set(rss)
        cpu_s = self._read_cpu_seconds()
        if cpu_s is not None:
            if baseline is not None and now > baseline[0]:
                pct = 100.0 * (cpu_s - baseline[1]) / (now - baseline[0])
                values["cpu_percent"] = round(max(0.0, pct), 2)
                self._g_cpu.set(values["cpu_percent"])
            with self._lock:
                self._cpu_baseline = (now, cpu_s)
        values["threads"] = float(threading.active_count())
        self._g_threads.set(values["threads"])
        fds = self._read_fd_count()
        if fds is not None:
            values["open_fds"] = fds
            self._g_fds.set(fds)
        try:
            collections = float(sum(s.get("collections", 0)
                                    for s in gc.get_stats()))
        except Exception:  # noqa: BLE001 — stats shape is interpreter-owned
            collections = 0.0
        values["gc_collections"] = collections
        self._g_gc.set(collections)
        with self._lock:
            self._last_values = values
        return values


_stats: ProcStats | None = None
_lock = threading.Lock()


def get_proc_stats() -> ProcStats | _NullProcStats:
    if not metrics_enabled():
        return NULL_PROC_STATS
    global _stats
    if _stats is None:
        with _lock:
            if _stats is None:
                _stats = ProcStats()
    return _stats


def reset_proc_stats() -> None:
    global _stats
    with _lock:
        _stats = None
