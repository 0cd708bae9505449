"""Process-wide registry of labelled counters.

The part of ``faabric_tpu/telemetry/metrics.py`` that the device plane,
its copy accounting and the data planes (``transport/{bulk,shm,codec}.py``,
the RPC plane's point-to-point messages) need: monotonic counters keyed
by name and label set, and a JSON-safe snapshot. Gauges, histograms, the
Prometheus exposition, spans, the comm matrix and the collective
profiler are not ported (``ROADMAP.md`` Queue 1 #7 part B).
"""

from __future__ import annotations

import threading


class Counter:
    __slots__ = ("labels", "_lock", "value")

    def __init__(self, labels: dict[str, str]) -> None:
        self.labels = labels
        self._lock = threading.Lock()
        self.value = 0.0

    def inc(self, value: float = 1.0) -> None:
        if value < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self.value += value


class MetricsRegistry:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        # name → (help, {sorted label items: Counter})
        self._families: dict[str, tuple[str, dict[tuple, Counter]]] = {}

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        """The counter of ``name`` with ``labels``, created on first use."""
        labels = {k: str(v) for k, v in labels.items()}
        key = tuple(sorted(labels.items()))
        with self._lock:
            _help, series = self._families.setdefault(name, (help, {}))
            handle = series.get(key)
            if handle is None:
                handle = series[key] = Counter(labels)
            return handle

    def snapshot(self) -> dict:
        """``{name: {"help": ..., "series": [{"labels", "value"}]}}``."""
        with self._lock:
            families = [(name, help_, list(series.values()))
                        for name, (help_, series) in self._families.items()]
        out = {}
        for name, help_, series in families:
            rows = []
            for c in series:
                with c._lock:
                    rows.append({"labels": dict(c.labels), "value": c.value})
            out[name] = {"help": help_, "series": rows}
        return out


_registry = MetricsRegistry()


def get_metrics() -> MetricsRegistry:
    return _registry
