"""Per-link communication matrix: who sends how much to whom, over what.

Every REMOTE send is attributed to a ``(src rank, dst rank, plane)``
cell — plane ∈ {``ptp`` (shared RPC plane), ``bulk-tcp`` (dedicated
tuned-socket data plane), ``shm`` (same-machine ring), ``device`` (the
compiled device collective plane: each rank's contribution attributed
to its mesh ring-neighbour — XLA owns the actual schedule, the row
records that the payload entered the device plane and NOT the host
planes)} — counting messages, payload bytes and a small send-latency
histogram. Same-host in-process queue delivery is deliberately NOT
counted: it is the 6 GiB/s hot path and carries no wire to attribute.

Adaptive wire codecs: cells additionally key on the wire
``codec`` (``raw`` / ``delta`` / ``delta-full`` / ``zlib``) and account
BOTH ``bytes`` (what crossed the wire) and ``bytes_raw`` (the pre-codec
payload), so compression shows up as a per-link ratio instead of
silently under-reporting traffic — and the governor's per-link decision
is asserted straight off the rows (``codec=`` in the dist tests).

This is the data HiCCL-style collective tuning needs before any
optimization: the 0.62-vs-6.01 GiB/s allreduce gap stops being a single
mystery number once each (src, dst, plane) link reports its own
bytes/latency and the bench's attribution report ranks the suspects.

Cardinality guard: ranks ≥ ``FAABRIC_COMMMATRIX_MAX_RANKS`` (default 64)
collapse into one ``other`` bucket per direction, so a 256-rank world
yields at most (N+1)² × 3 series instead of 196k — ``/metrics`` stays
kilobytes.

Export: ``snapshot()`` is the JSON-safe wire form riding GET_TELEMETRY;
``families()`` renders the same cells in the metrics-registry snapshot
schema so the planner can merge them into the Prometheus ``/metrics``
page (labels ``src``, ``dst``, ``plane`` + the per-host ``host`` label).
"""

from __future__ import annotations

import os
import threading

from faabric_tpu_torch.telemetry.metrics import metrics_enabled

PLANES = ("ptp", "bulk-tcp", "shm", "device")

# Send-latency buckets (seconds): sub-ms ring pushes to multi-second
# wedged sockets. Coarser than DEFAULT_BUCKETS — per-link histograms
# multiply by rank-pair cardinality.
LATENCY_BUCKETS = (0.0001, 0.001, 0.01, 0.1, 1.0, 10.0)

DEFAULT_MAX_RANKS = 64
OTHER = "other"


class _Cell:
    __slots__ = ("messages", "bytes", "bytes_raw", "lat_sum", "lat_count",
                 "lat_counts", "_lock")

    def __init__(self) -> None:
        self.messages = 0
        self.bytes = 0       # WIRE bytes: what actually crossed the link
        self.bytes_raw = 0   # pre-codec payload bytes (== bytes for raw)
        self.lat_sum = 0.0
        self.lat_count = 0
        self.lat_counts = [0] * len(LATENCY_BUCKETS)
        self._lock = threading.Lock()

    def add(self, nbytes: int, seconds: float | None,
            raw_bytes: int | None = None) -> None:
        with self._lock:
            self.messages += 1
            self.bytes += nbytes
            self.bytes_raw += nbytes if raw_bytes is None else raw_bytes
            if seconds is not None:
                self.lat_sum += seconds
                self.lat_count += 1
                for i, ub in enumerate(LATENCY_BUCKETS):
                    if seconds <= ub:
                        self.lat_counts[i] += 1
                        break


class _NullCommMatrix:
    """Shared no-op returned while metrics are disabled."""

    __slots__ = ()

    def record(self, src, dst, plane, nbytes, seconds=None,
               raw_bytes=None, codec="raw") -> None:
        pass

    def snapshot(self) -> dict:
        return {}

    def families(self) -> dict:
        return {}

    def reset(self) -> None:
        pass


NULL_COMM_MATRIX = _NullCommMatrix()


class CommMatrix:
    def __init__(self, max_ranks: int | None = None) -> None:
        if max_ranks is None:
            try:
                max_ranks = int(os.environ.get(
                    "FAABRIC_COMMMATRIX_MAX_RANKS", DEFAULT_MAX_RANKS))
            except ValueError:
                # Malformed knob degrades to the default; the matrix is
                # created lazily from send hot paths and must not raise
                max_ranks = DEFAULT_MAX_RANKS
        self.max_ranks = max_ranks
        self._lock = threading.Lock()
        # (src_label, dst_label, plane) → _Cell; cell creation takes the
        # registry lock, updates take only the cell's own
        self._cells: dict[tuple, _Cell] = {}
        # Raw (src, dst, plane) → _Cell fast path: chunk-pipelined
        # collectives record one row per 4 MiB frame, so the per-record
        # cost must be one dict hit + one cell add, not two label
        # conversions. Only in-range ranks are cached (the `other`
        # bucket's raw key space is unbounded).
        self._fast: dict[tuple, _Cell] = {}

    def _rank_label(self, rank) -> str:
        try:
            r = int(rank)
        except (TypeError, ValueError):
            return OTHER
        return str(r) if 0 <= r < self.max_ranks else OTHER

    def record(self, src, dst, plane: str, nbytes: int,
               seconds: float | None = None,
               raw_bytes: int | None = None, codec: str = "raw") -> None:
        """``nbytes`` is what crossed the WIRE; ``raw_bytes`` the
        pre-codec payload size (compression must never make the matrix
        under-report traffic — both are accounted). ``codec`` keys the
        cell, so one link's raw and delta frames land in separate rows
        and the governor's per-link decision is directly observable."""
        raw = (src, dst, plane, codec)
        cell = self._fast.get(raw)
        if cell is None:
            labels = (self._rank_label(src), self._rank_label(dst), plane,
                      codec)
            with self._lock:
                cell = self._cells.setdefault(labels, _Cell())
                if labels[0] is not OTHER and labels[1] is not OTHER:
                    self._fast[raw] = cell
        cell.add(int(nbytes), seconds, raw_bytes)

    # -- export ---------------------------------------------------------
    def snapshot(self) -> dict:
        """JSON-safe wire form: ``{"max_ranks", "cells": [...]}`` with one
        row per live (src, dst, plane)."""
        with self._lock:
            items = list(self._cells.items())
        cells = []
        for (src, dst, plane, codec), c in items:
            with c._lock:
                cells.append({
                    "src": src, "dst": dst, "plane": plane,
                    "codec": codec,
                    "messages": c.messages, "bytes": c.bytes,
                    "bytes_raw": c.bytes_raw,
                    "lat_sum": round(c.lat_sum, 9),
                    "lat_count": c.lat_count,
                    "lat_buckets": [[b, n] for b, n in
                                    zip(LATENCY_BUCKETS, c.lat_counts)],
                })
        cells.sort(key=lambda r: -r["bytes"])
        return {"max_ranks": self.max_ranks, "cells": cells}

    def families(self) -> dict:
        """The same cells in the metrics-registry ``snapshot()`` schema,
        mergeable by ``render_snapshots`` into Prometheus exposition."""
        return families_from_cells(self.snapshot().get("cells", []))

    def reset(self) -> None:
        with self._lock:
            self._cells.clear()
            self._fast.clear()


def families_from_cells(cells: list[dict]) -> dict:
    """Registry-schema families from a snapshot's cell rows (used both
    process-locally and planner-side on scraped worker snapshots)."""
    msgs, byts, raws, lat = [], [], [], []
    for c in cells:
        labels = {"src": c["src"], "dst": c["dst"], "plane": c["plane"],
                  "codec": c.get("codec", "raw")}
        msgs.append({"labels": labels, "value": c["messages"]})
        byts.append({"labels": labels, "value": c["bytes"]})
        raws.append({"labels": labels,
                     "value": c.get("bytes_raw", c["bytes"])})
        lat.append({"labels": labels, "sum": c.get("lat_sum", 0.0),
                    "count": c.get("lat_count", 0),
                    "buckets": c.get("lat_buckets", [])})
    if not cells:
        return {}
    return {
        "faabric_comm_messages_total": {
            "type": "counter",
            "help": "Remote messages sent per (src, dst, plane, codec) "
                    "link",
            "series": msgs},
        "faabric_comm_bytes_total": {
            "type": "counter",
            "help": "Remote WIRE bytes sent per (src, dst, plane, codec) "
                    "link",
            "series": byts},
        "faabric_comm_raw_bytes_total": {
            "type": "counter",
            "help": "Pre-codec payload bytes per (src, dst, plane, "
                    "codec) link — compression never under-reports "
                    "traffic",
            "series": raws},
        "faabric_comm_send_seconds": {
            "type": "histogram",
            "help": "Per-message send latency per (src, dst, plane, "
                    "codec) link",
            "series": lat},
    }


def merge_cell_rows(per_host: dict[str, list[dict]]) -> list[dict]:
    """Merge hosts' cell rows for the JSON ``/commmatrix`` totals view:
    same (src, dst, plane) across hosts sums (each host only reports its
    own outbound sends, so summing never double-counts)."""
    merged: dict[tuple, dict] = {}
    for _host, cells in per_host.items():
        for c in cells:
            codec = c.get("codec", "raw")
            key = (c["src"], c["dst"], c["plane"], codec)
            m = merged.get(key)
            if m is None:
                merged[key] = {"src": c["src"], "dst": c["dst"],
                               "plane": c["plane"], "codec": codec,
                               "messages": 0, "bytes": 0, "bytes_raw": 0,
                               "lat_sum": 0.0, "lat_count": 0}
                m = merged[key]
            m["messages"] += c.get("messages", 0)
            m["bytes"] += c.get("bytes", 0)
            m["bytes_raw"] += c.get("bytes_raw", c.get("bytes", 0))
            m["lat_sum"] += c.get("lat_sum", 0.0)
            m["lat_count"] += c.get("lat_count", 0)
    out = list(merged.values())
    out.sort(key=lambda r: -r["bytes"])
    return out


_matrix: CommMatrix | None = None
_matrix_lock = threading.Lock()


def get_comm_matrix() -> CommMatrix | _NullCommMatrix:
    if not metrics_enabled():
        return NULL_COMM_MATRIX
    global _matrix
    if _matrix is None:
        with _matrix_lock:
            if _matrix is None:
                _matrix = CommMatrix()
    return _matrix
