"""Process-wide metrics registry: counters, gauges, fixed-bucket histograms.

Design points (HiCCL-style phase accounting needs cheap always-on
counters; EQuARX-style reports need histograms):

- **Lock-sharded**: every series (one metric name + one label set) owns
  its own ``threading.Lock``; the registry-level lock is taken only when
  a handle is *created*. Hot paths hold module-level handles, so steady
  state is one uncontended per-series lock per update.
- **Near-zero cost when disabled** (``FAABRIC_METRICS=0``): handle
  creation returns a single shared no-op object, so every ``inc``/
  ``observe`` is one attribute call on a singleton — no allocation, no
  locking, no branching in the caller.
- **Typed handles**: ``Counter`` (monotonic), ``Gauge`` (set/inc/dec)
  and ``Histogram`` (fixed upper bounds, cumulative render). Re-asking
  for a name with a different type raises — a registry that silently
  aliases types produces unparseable exposition output.

Export surfaces: ``render_prometheus`` (text exposition format, served
by the planner's ``GET /metrics``), ``snapshot`` (JSON-safe dict that
rides the GET_TELEMETRY RPC from workers to the planner), and
``render_snapshots`` (merges many hosts' snapshots under a ``host``
label).
"""

from __future__ import annotations

import math
import os
import threading
from typing import Optional

# Default latency buckets (seconds) — spans RPC dispatch (~100 µs) to a
# wedged collective (~10 s); same shape as the prometheus client default.
DEFAULT_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

_enabled = os.environ.get("FAABRIC_METRICS", "1") not in ("0", "false", "off")


def metrics_enabled() -> bool:
    return _enabled


def set_metrics_enabled(on: bool) -> None:
    """Test hook; production processes decide at boot via FAABRIC_METRICS.
    Handles already held by callers keep their behaviour — only handles
    created after the flip observe the new state."""
    global _enabled
    _enabled = on


class _NullMetric:
    """Shared no-op handle returned while metrics are disabled."""

    __slots__ = ()

    def inc(self, value: float = 1.0) -> None:
        pass

    def dec(self, value: float = 1.0) -> None:
        pass

    def set(self, value: float) -> None:
        pass

    def observe(self, value: float) -> None:
        pass


NULL_METRIC = _NullMetric()


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


class Gauge:
    __slots__ = ("labels", "_lock", "value")

    def __init__(self, labels: dict[str, str]) -> None:
        self.labels = labels
        self._lock = threading.Lock()
        self.value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self.value = float(value)

    def inc(self, value: float = 1.0) -> None:
        with self._lock:
            self.value += value

    def dec(self, value: float = 1.0) -> None:
        with self._lock:
            self.value -= value


class Histogram:
    __slots__ = ("labels", "buckets", "_lock", "counts", "sum", "count")

    def __init__(self, labels: dict[str, str],
                 buckets: tuple[float, ...]) -> None:
        self.labels = labels
        self.buckets = buckets  # finite upper bounds, ascending
        self._lock = threading.Lock()
        self.counts = [0] * len(buckets)  # per-bucket (non-cumulative)
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        # Bisect outside the lock: buckets are immutable
        lo, hi = 0, len(self.buckets)
        while lo < hi:
            mid = (lo + hi) // 2
            if value <= self.buckets[mid]:
                hi = mid
            else:
                lo = mid + 1
        with self._lock:
            if lo < len(self.counts):
                self.counts[lo] += 1
            self.sum += value
            self.count += 1


class _Family:
    __slots__ = ("name", "type", "help", "buckets", "series")

    def __init__(self, name: str, mtype: str, help_: str,
                 buckets: Optional[tuple[float, ...]]) -> None:
        self.name = name
        self.type = mtype
        self.help = help_
        self.buckets = buckets
        # label-tuple → handle
        self.series: dict[tuple, object] = {}


class MetricsRegistry:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._families: dict[str, _Family] = {}

    # -- handle creation ------------------------------------------------
    def counter(self, name: str, help: str = "", **labels: str):
        return self._get(name, "counter", help, None, labels)

    def gauge(self, name: str, help: str = "", **labels: str):
        return self._get(name, "gauge", help, None, labels)

    def histogram(self, name: str, help: str = "",
                  buckets: tuple[float, ...] = DEFAULT_BUCKETS,
                  **labels: str):
        return self._get(name, "histogram", help, tuple(buckets), labels)

    def _get(self, name: str, mtype: str, help_: str,
             buckets: Optional[tuple[float, ...]], labels: dict):
        if not _enabled:
            return NULL_METRIC
        labels = {k: str(v) for k, v in labels.items()}
        key = tuple(sorted(labels.items()))
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = _Family(name, mtype, help_, buckets)
                self._families[name] = fam
            elif fam.type != mtype:
                raise ValueError(
                    f"metric {name} already registered as {fam.type}")
            handle = fam.series.get(key)
            if handle is None:
                if mtype == "counter":
                    handle = Counter(labels)
                elif mtype == "gauge":
                    handle = Gauge(labels)
                else:
                    handle = Histogram(labels, fam.buckets or DEFAULT_BUCKETS)
                fam.series[key] = handle
            return handle

    # -- export ---------------------------------------------------------
    def snapshot(self) -> dict:
        """JSON-safe dump: the wire form workers ship to the planner."""
        out: dict = {}
        with self._lock:
            families = [(f.name, f.type, f.help, list(f.series.values()))
                        for f in self._families.values()]
        for name, mtype, help_, series in families:
            rows = []
            for s in series:
                with s._lock:
                    if mtype == "histogram":
                        rows.append({
                            "labels": dict(s.labels),
                            "sum": s.sum, "count": s.count,
                            "buckets": [[b, c] for b, c in
                                        zip(s.buckets, s.counts)],
                        })
                    else:
                        rows.append({"labels": dict(s.labels),
                                     "value": s.value})
            out[name] = {"type": mtype, "help": help_, "series": rows}
        return out

    def render_prometheus(self, extra_labels: dict[str, str] | None = None
                          ) -> str:
        return render_snapshots({None: self.snapshot()},
                                extra_labels=extra_labels)

    def reset(self) -> None:
        with self._lock:
            self._families.clear()


def _fmt(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if float(v).is_integer():
        return str(int(v))
    return repr(float(v))


def _escape(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"')


def _label_str(labels: dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape(v)}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def render_snapshots(snapshots: dict, extra_labels: dict | None = None
                     ) -> str:
    """Prometheus text exposition from one or more ``snapshot()`` dumps.

    ``snapshots`` maps a host label value (or None for no host label) to
    a snapshot; every series of host ``h`` is rendered with ``host="h"``
    added, which is how the planner merges all workers' local registries
    into one scrape page."""
    # Merge family metadata across hosts (HELP/TYPE must appear once)
    merged: dict[str, dict] = {}
    for host, snap in snapshots.items():
        for name, fam in (snap or {}).items():
            m = merged.setdefault(name, {"type": fam.get("type", "counter"),
                                         "help": fam.get("help", ""),
                                         "rows": []})
            for row in fam.get("series", []):
                labels = dict(row.get("labels", {}))
                if host is not None:
                    labels["host"] = str(host)
                if extra_labels:
                    labels.update(extra_labels)
                m["rows"].append((labels, row))
    lines: list[str] = []
    for name in sorted(merged):
        fam = merged[name]
        if fam["help"]:
            lines.append(f"# HELP {name} {fam['help']}")
        lines.append(f"# TYPE {name} {fam['type']}")
        for labels, row in fam["rows"]:
            if fam["type"] == "histogram":
                cum = 0
                for le, c in row.get("buckets", []):
                    cum += c
                    bl = dict(labels)
                    bl["le"] = _fmt(le)
                    lines.append(f"{name}_bucket{_label_str(bl)} {cum}")
                bl = dict(labels)
                bl["le"] = "+Inf"
                lines.append(
                    f"{name}_bucket{_label_str(bl)} {row.get('count', 0)}")
                lines.append(
                    f"{name}_sum{_label_str(labels)} {row.get('sum', 0.0)}")
                lines.append(
                    f"{name}_count{_label_str(labels)} {row.get('count', 0)}")
            else:
                lines.append(
                    f"{name}{_label_str(labels)} {row.get('value', 0.0)}")
    return "\n".join(lines) + "\n"


def snapshot_delta(before: dict, after: dict) -> dict:
    """Flat ``{"name{labels}": delta}`` of counter increments and
    histogram sum/count growth between two snapshots — what bench.py
    writes per section so rounds get per-phase traffic trajectories."""
    out: dict[str, float] = {}

    def _index(snap):
        idx = {}
        for name, fam in (snap or {}).items():
            for row in fam.get("series", []):
                key = name + _label_str(row.get("labels", {}))
                idx[key] = (fam.get("type"), row)
        return idx

    b, a = _index(before), _index(after)
    for key, (mtype, row) in a.items():
        prev = b.get(key, (mtype, None))[1]
        if mtype == "histogram":
            ds = row.get("sum", 0.0) - (prev.get("sum", 0.0) if prev else 0.0)
            dc = row.get("count", 0) - (prev.get("count", 0) if prev else 0)
            if dc:
                out[key + "_sum"] = round(ds, 6)
                out[key + "_count"] = dc
        else:
            dv = row.get("value", 0.0) - (prev.get("value", 0.0)
                                          if prev else 0.0)
            if dv:
                out[key] = round(dv, 6)
    return out


_registry: MetricsRegistry | None = None
_registry_lock = threading.Lock()


def get_metrics() -> MetricsRegistry:
    global _registry
    if _registry is None:
        with _registry_lock:
            if _registry is None:
                _registry = MetricsRegistry()
    return _registry
