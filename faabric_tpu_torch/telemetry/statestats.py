"""Per-key state & snapshot access ledger + cluster state map
(counterpart of ``faabric_tpu/telemetry/statestats.py``).

``state/`` and ``snapshot/`` would otherwise be dark: without a
ledger, any rework of them into a sharded KV would start from folklore
about hot keys, pull amplification and master skew. This module is the
measurement layer such work starts from, with the same estimator
shapes as the perf profile:

- :class:`StateStatsStore` — per-key ledger of every state op this
  process performed (get/set/get_chunk/set_chunk/pull/push_full/
  push_partial/append/lock_global): op counts, bytes, chunk counts,
  dirty-chunk ratio and latency (:class:`DecayedStat` log-bucket
  quantiles), pull amplification (total vs first-time chunk pulls),
  global-lock wait/stall accounting, plus store-level snapshot
  lifecycle estimators (dirty pages, diff encode/apply sizes and ms,
  restore latency). Cardinality-capped like the comm matrix: keys past
  ``FAABRIC_STATE_MAX_KEYS`` collapse into ``other``.
- Prometheus families ``faabric_state_*`` / ``faabric_snapshot_*``
  (per-op totals — per-KEY detail rides the telemetry block, not label
  cardinality) and ``/timeseries`` gauges: ``state_resident_bytes``,
  ``state_dirty_chunks``, ``snapshot_registry_bytes``.
- :func:`aggregate_statemap` — the pure merge behind the planner's
  ``GET /statemap`` and ``python -m faabric_tpu.runner.statemap``:
  per-key master host, size, access/byte totals by origin host,
  hot-key ranking, per-host mastership byte totals and the cluster
  locality ratio (local vs remote reads). Each host reports only its
  OWN accesses (the comm-matrix outbound convention), so the merge
  attributes origin without any server-side requester tracking.

Knobs: ``FAABRIC_STATE_STATS`` (``0`` disables the ledger even with
metrics on — callers then hold the shared no-op store),
``FAABRIC_STATE_MAX_KEYS`` (cardinality cap, default 256),
``FAABRIC_STATE_HALF_LIFE_S`` (estimator decay, default 120),
``FAABRIC_STATE_LOCK_STALL_MS`` (global-lock wait above this flight-
records a contention stall, default 100).
"""

from __future__ import annotations

import os
import threading
import time

from faabric_tpu_torch.telemetry.metrics import get_metrics, metrics_enabled
from faabric_tpu_torch.telemetry.perfprofile import DecayedStat
from faabric_tpu_torch.util.config import _env_float, _env_int

OTHER = "other"

DEFAULT_MAX_KEYS = 256
DEFAULT_HALF_LIFE_S = 120.0
DEFAULT_LOCK_STALL_MS = 100.0

# Every op the ledger accounts; fixed upfront so the Prometheus
# counter handles are pre-built (record() is on the state hot path)
STATE_OPS = ("get", "set", "get_chunk", "set_chunk", "pull", "push_full",
             "push_partial", "append", "lock_global", "replicate")

# Snapshot lifecycle events folded into store-level estimators
SNAPSHOT_EVENTS = ("diff", "device_diff", "apply", "restore", "push")


def lock_stall_threshold_s() -> float:
    return _env_float("FAABRIC_STATE_LOCK_STALL_MS",
                      DEFAULT_LOCK_STALL_MS) / 1e3


class _KeyEntry:
    """Ledger for one state key. Updates take only this entry's lock
    (the comm-matrix per-cell discipline)."""

    __slots__ = ("ops", "bytes", "chunks", "lat", "dirty_ratio",
                 "local_reads", "remote_reads",
                 "pull_chunks_total", "pull_chunks_fresh",
                 "lock_waits", "lock_stalls", "lock_wait",
                 "master", "size", "is_master", "dirty_outstanding",
                 "backup", "epoch", "replication_lag",
                 "_lock")

    def __init__(self, half_life: float) -> None:
        self.ops: dict[str, int] = {}
        self.bytes: dict[str, int] = {}
        self.chunks: dict[str, int] = {}
        self.lat: dict[str, DecayedStat] = {}
        self.dirty_ratio = DecayedStat(half_life)
        self.local_reads = 0
        self.remote_reads = 0
        self.pull_chunks_total = 0
        self.pull_chunks_fresh = 0
        self.lock_waits = 0
        self.lock_stalls = 0
        self.lock_wait = DecayedStat(half_life)
        self.master = ""
        self.size = 0
        self.is_master = False
        self.dirty_outstanding = 0
        # Replication plane: the key's backup host, its
        # fencing epoch, and bytes acked-but-not-yet-on-the-backup
        self.backup = ""
        self.epoch = 0
        self.replication_lag = 0
        self._lock = threading.Lock()

    def add(self, op: str, nbytes: int, chunks: int, dirty_chunks: int,
            seconds: float | None, remote: bool, fresh_chunks: int | None,
            half_life: float) -> None:
        with self._lock:
            self.ops[op] = self.ops.get(op, 0) + 1
            if nbytes:
                self.bytes[op] = self.bytes.get(op, 0) + int(nbytes)
            if chunks:
                self.chunks[op] = self.chunks.get(op, 0) + int(chunks)
                if op in ("push_partial", "push_full"):
                    self.dirty_ratio.observe(
                        min(1.0, dirty_chunks / chunks))
            if op in ("get", "get_chunk", "pull"):
                if remote:
                    self.remote_reads += 1
                else:
                    self.local_reads += 1
            if op == "pull":
                self.pull_chunks_total += int(chunks)
                self.pull_chunks_fresh += int(
                    chunks if fresh_chunks is None else fresh_chunks)
            if seconds is not None and seconds > 0:
                st = self.lat.get(op)
                if st is None:
                    st = self.lat[op] = DecayedStat(half_life)
                st.observe(seconds)

    def row(self, key: str) -> dict:
        with self._lock:
            lat = {op: {"p50_ms": round(st.quantile(0.50) * 1e3, 4),
                        "p90_ms": round(st.quantile(0.90) * 1e3, 4),
                        "mean_ms": round(st.mean * 1e3, 4)}
                   for op, st in self.lat.items() if st.n}
            return {
                "key": key,
                "master": self.master,
                "backup": self.backup,
                "epoch": self.epoch,
                "replication_lag": self.replication_lag,
                "size": self.size,
                "is_master": self.is_master,
                "ops": dict(self.ops),
                "bytes": dict(self.bytes),
                "chunks": dict(self.chunks),
                "ops_total": sum(self.ops.values()),
                "bytes_total": sum(self.bytes.values()),
                "dirty_ratio": (round(self.dirty_ratio.ewma, 4)
                                if self.dirty_ratio.n else None),
                "dirty_outstanding": self.dirty_outstanding,
                "local_reads": self.local_reads,
                "remote_reads": self.remote_reads,
                "pull_chunks_total": self.pull_chunks_total,
                "pull_chunks_fresh": self.pull_chunks_fresh,
                "lock_waits": self.lock_waits,
                "lock_stalls": self.lock_stalls,
                "lock_wait_p90_ms": (
                    round(self.lock_wait.quantile(0.90) * 1e3, 4)
                    if self.lock_wait.n else None),
                "lat": lat,
            }


class _NullStateStats:
    """Shared no-op ledger while metrics / the state plane is off.
    Signatures mirror :class:`StateStatsStore` exactly — a metrics-off
    TypeError would kill a state hot path."""

    __slots__ = ()
    enabled = False

    def note_key(self, full_key, master="", size=0,
                 is_master=False, backup=None, epoch=None) -> None:
        pass

    def record(self, full_key, op, nbytes=0, chunks=0, dirty_chunks=0,
               seconds=None, remote=False, fresh_chunks=None) -> None:
        pass

    def lock_wait(self, full_key, seconds, stalled=False) -> None:
        pass

    def set_dirty_outstanding(self, full_key, n) -> None:
        pass

    def set_replication_lag(self, full_key, nbytes) -> None:
        pass

    def snapshot_event(self, kind, nbytes=0, pages=0, regions=0,
                       seconds=None) -> None:
        pass

    def set_registry_bytes(self, nbytes) -> None:
        pass

    def snapshot(self) -> dict:
        return {}

    def cardinality(self) -> int:
        return 0


NULL_STATE_STATS = _NullStateStats()


class StateStatsStore:
    """Per-key access ledger of THIS process's state traffic plus
    store-level snapshot lifecycle estimators. Keys are the full
    ``user/key`` names; the reporting host is implicit (the planner
    tags rows when aggregating, the comm-matrix/perf convention)."""

    # Concurrency contract (tools/concheck.py): the key registry
    # mutates under _lock; per-key stats under the entry's own lock.
    # NOT listed: _fast — the record-hot-path cache, WRITTEN only
    # under _lock but deliberately read lock-free (GIL-atomic
    # dict.get; a racing reader at worst misses and takes the locked
    # slow path) — the exact PerfProfileStore._fast discipline.
    GUARDS = {
        "_entries": "_lock",
        "_snap": "_lock",
        "_registry_bytes": "_lock",
    }

    enabled = True

    def __init__(self, half_life: float | None = None,
                 max_keys: int | None = None) -> None:
        self.half_life = (half_life if half_life is not None else
                          _env_float("FAABRIC_STATE_HALF_LIFE_S",
                                     DEFAULT_HALF_LIFE_S))
        self.max_keys = (max_keys if max_keys is not None else
                         _env_int("FAABRIC_STATE_MAX_KEYS",
                                  DEFAULT_MAX_KEYS))
        self._lock = threading.Lock()
        self._entries: dict[str, _KeyEntry] = {}
        # key → entry, read lock-free on the record hot path
        self._fast: dict[str, _KeyEntry] = {}
        # snapshot-lifecycle estimators: kind → {events, bytes, pages,
        # regions, lat DecayedStat}
        self._snap: dict[str, dict] = {}
        self._registry_bytes = 0
        metrics = get_metrics()
        self._op_counters = {
            op: metrics.counter(
                "faabric_state_ops_total",
                "State ops performed by this process, by op kind",
                op=op)
            for op in STATE_OPS}
        self._byte_counters = {
            op: metrics.counter(
                "faabric_state_bytes_total",
                "State bytes moved by this process, by op kind",
                op=op)
            for op in STATE_OPS}
        self._lock_stall_counter = metrics.counter(
            "faabric_state_lock_stalls_total",
            "Global-lock waits above FAABRIC_STATE_LOCK_STALL_MS")
        self._snap_event_counters = {
            kind: metrics.counter(
                "faabric_snapshot_events_total",
                "Snapshot lifecycle events, by kind", kind=kind)
            for kind in SNAPSHOT_EVENTS}
        self._snap_byte_counters = {
            kind: metrics.counter(
                "faabric_snapshot_bytes_total",
                "Snapshot diff/apply/push bytes, by kind", kind=kind)
            for kind in SNAPSHOT_EVENTS}
        self._dirty_page_counter = metrics.counter(
            "faabric_snapshot_dirty_pages_total",
            "Dirty pages evaluated across snapshot diffs")
        self._register_gauges()

    # -- hot path -------------------------------------------------------
    def _entry(self, full_key: str) -> _KeyEntry:
        entry = self._fast.get(full_key)
        if entry is not None:
            return entry
        with self._lock:
            # Exact key first: a capped store must keep feeding keys
            # that already own an entry
            entry = self._entries.get(full_key)
            if entry is None:
                key = full_key
                if len(self._entries) >= self.max_keys:
                    key = OTHER
                entry = self._entries.get(key)
                if entry is None:
                    entry = self._entries[key] = _KeyEntry(self.half_life)
            if len(self._fast) >= 8 * self.max_keys:
                # Backstop mirroring the cap: churning key names must
                # not grow the lock-free cache without bound
                self._fast.clear()
            self._fast[full_key] = entry
        return entry

    def note_key(self, full_key: str, master: str = "", size: int = 0,
                 is_master: bool = False, backup: str | None = None,
                 epoch: int | None = None) -> None:
        """Identity facts stamped at KV creation (master host, declared
        size) — the statemap's placement columns. ``backup``/``epoch``
        use None as "unchanged": "" and 0 are real values (no backup,
        unfenced) a failover re-resolve must be able to write."""
        entry = self._entry(full_key)
        with entry._lock:
            if master:
                entry.master = master
            if size:
                entry.size = int(size)
            entry.is_master = entry.is_master or is_master
            if backup is not None:
                entry.backup = backup
            if epoch is not None:
                entry.epoch = max(entry.epoch, int(epoch))

    def record(self, full_key: str, op: str, nbytes: int = 0,
               chunks: int = 0, dirty_chunks: int = 0,
               seconds: float | None = None, remote: bool = False,
               fresh_chunks: int | None = None) -> None:
        entry = self._entry(full_key)
        entry.add(op, nbytes, chunks, dirty_chunks, seconds, remote,
                  fresh_chunks, self.half_life)
        c = self._op_counters.get(op)
        if c is not None:
            c.inc()
            if nbytes:
                self._byte_counters[op].inc(int(nbytes))

    def lock_wait(self, full_key: str, seconds: float,
                  stalled: bool = False) -> None:
        entry = self._entry(full_key)
        with entry._lock:
            entry.lock_waits += 1
            entry.lock_wait.observe(max(0.0, seconds))
            if stalled:
                entry.lock_stalls += 1
        if stalled:
            self._lock_stall_counter.inc()

    def set_dirty_outstanding(self, full_key: str, n: int) -> None:
        entry = self._entry(full_key)
        with entry._lock:
            entry.dirty_outstanding = int(n)

    def set_replication_lag(self, full_key: str, nbytes: int) -> None:
        """Bytes acked to clients but not yet applied on the backup
        (0 in steady state; == size right after a promotion until
        anti-entropy lands; == size permanently while unreplicated)."""
        entry = self._entry(full_key)
        with entry._lock:
            entry.replication_lag = int(nbytes)

    # -- snapshot lifecycle ---------------------------------------------
    def snapshot_event(self, kind: str, nbytes: int = 0, pages: int = 0,
                       regions: int = 0,
                       seconds: float | None = None) -> None:
        with self._lock:
            s = self._snap.get(kind)
            if s is None:
                s = self._snap[kind] = {
                    "events": 0, "bytes": 0, "pages": 0, "regions": 0,
                    "lat": DecayedStat(self.half_life)}
            s["events"] += 1
            s["bytes"] += int(nbytes)
            s["pages"] += int(pages)
            s["regions"] += int(regions)
            if seconds is not None and seconds > 0:
                s["lat"].observe(seconds)
        c = self._snap_event_counters.get(kind)
        if c is not None:
            c.inc()
            if nbytes:
                self._snap_byte_counters[kind].inc(int(nbytes))
        if pages:
            self._dirty_page_counter.inc(int(pages))

    def set_registry_bytes(self, nbytes: int) -> None:
        with self._lock:
            self._registry_bytes = int(nbytes)

    # -- gauges ---------------------------------------------------------
    def _register_gauges(self) -> None:
        try:
            from faabric_tpu_torch.telemetry.timeseries import get_timeseries

            ts = get_timeseries()
            ts.register("state_resident_bytes", self._resident_bytes)
            ts.register("state_dirty_chunks", self._dirty_chunks)
            ts.register("snapshot_registry_bytes",
                        self._snapshot_registry_bytes)
        except Exception:  # noqa: BLE001 — gauges are best-effort
            pass

    def _resident_bytes(self) -> float:
        with self._lock:
            entries = list(self._entries.values())
        return float(sum(e.size for e in entries if e.is_master))

    def _dirty_chunks(self) -> float:
        with self._lock:
            entries = list(self._entries.values())
        return float(sum(e.dirty_outstanding for e in entries))

    def _snapshot_registry_bytes(self) -> float:
        with self._lock:
            return float(self._registry_bytes)

    # -- export ---------------------------------------------------------
    def cardinality(self) -> int:
        with self._lock:
            return len(self._entries)

    def snapshot(self) -> dict:
        """JSON-safe wire form riding GET_TELEMETRY's ``statestats``
        block."""
        with self._lock:
            items = list(self._entries.items())
            snap = {kind: {"events": s["events"], "bytes": s["bytes"],
                           "pages": s["pages"], "regions": s["regions"],
                           "p50_ms": round(
                               s["lat"].quantile(0.50) * 1e3, 4),
                           "p90_ms": round(
                               s["lat"].quantile(0.90) * 1e3, 4)}
                    for kind, s in self._snap.items()}
            registry_bytes = self._registry_bytes
        rows = [e.row(k) for k, e in items]
        rows.sort(key=lambda r: -(r["bytes_total"] or 0))
        return {"keys": rows, "snapshots": snap,
                "registry_bytes": registry_bytes,
                "max_keys": self.max_keys}

    def reset(self) -> None:
        with self._lock:
            self._entries.clear()
            self._fast.clear()
            self._snap.clear()
            self._registry_bytes = 0


# ---------------------------------------------------------------------------
# Cluster state map (pure merge — planner /statemap + runner CLI + doctor)
# ---------------------------------------------------------------------------

def aggregate_statemap(tel: dict) -> dict:
    """The cluster state map from a ``collect_telemetry()`` result.

    Each host's ledger reports only its OWN accesses, so per-origin
    attribution is the merge itself: host A's row for key K *is* the
    (K, origin=A) cell. The master column comes from the row whose
    reporter holds mastership (``is_master``), falling back to any
    reported master field."""
    keys: dict[str, dict] = {}
    hosts: dict[str, dict] = {}
    snap_events: dict[str, dict] = {}
    registry_bytes: dict[str, int] = {}
    for host, t in (tel or {}).items():
        block = (t or {}).get("statestats") or {}
        h = hosts.setdefault(host, {
            "mastered_keys": 0, "mastered_bytes": 0,
            "origin_ops": 0, "origin_bytes": 0})
        if block.get("registry_bytes"):
            registry_bytes[host] = int(block["registry_bytes"])
        for kind, s in (block.get("snapshots") or {}).items():
            agg = snap_events.setdefault(
                kind, {"events": 0, "bytes": 0, "pages": 0})
            agg["events"] += s.get("events", 0)
            agg["bytes"] += s.get("bytes", 0)
            agg["pages"] += s.get("pages", 0)
        for row in block.get("keys") or []:
            key = row.get("key") or OTHER
            agg = keys.setdefault(key, {
                "key": key, "master": "", "backup": "", "epoch": 0,
                "replication_lag": 0, "size": 0,
                "ops_total": 0, "bytes_total": 0,
                "local_reads": 0, "remote_reads": 0,
                "pull_chunks_total": 0, "pull_chunks_fresh": 0,
                "lock_waits": 0, "lock_stalls": 0,
                "by_origin": {},
            })
            if row.get("is_master") and host != OTHER:
                agg["master"] = host
                # Backup/lag are master-authored facts: only the master
                # forwards, so only its row can say where and how far
                # behind (other hosts' rows carry stale claim-time data)
                if row.get("backup") is not None:
                    agg["backup"] = row["backup"]
                agg["replication_lag"] = row.get("replication_lag") or 0
            elif not agg["master"] and row.get("master"):
                agg["master"] = row["master"]
                if not agg["backup"]:
                    agg["backup"] = row.get("backup") or ""
            agg["epoch"] = max(agg["epoch"], row.get("epoch") or 0)
            agg["size"] = max(agg["size"], row.get("size") or 0)
            agg["ops_total"] += row.get("ops_total") or 0
            agg["bytes_total"] += row.get("bytes_total") or 0
            agg["local_reads"] += row.get("local_reads") or 0
            agg["remote_reads"] += row.get("remote_reads") or 0
            agg["pull_chunks_total"] += row.get("pull_chunks_total") or 0
            agg["pull_chunks_fresh"] += row.get("pull_chunks_fresh") or 0
            agg["lock_waits"] += row.get("lock_waits") or 0
            agg["lock_stalls"] += row.get("lock_stalls") or 0
            agg["by_origin"][host] = {
                "ops": row.get("ops_total") or 0,
                "bytes": row.get("bytes_total") or 0,
            }
            h["origin_ops"] += row.get("ops_total") or 0
            h["origin_bytes"] += row.get("bytes_total") or 0
    for agg in keys.values():
        fresh = agg["pull_chunks_fresh"]
        agg["pull_amplification"] = (
            round(agg["pull_chunks_total"] / fresh, 3) if fresh else None)
        reads = agg["local_reads"] + agg["remote_reads"]
        agg["locality"] = (round(agg["local_reads"] / reads, 4)
                           if reads else None)
        master = agg["master"]
        if master in hosts:
            hosts[master]["mastered_keys"] += 1
            hosts[master]["mastered_bytes"] += agg["size"]
    ranked = sorted(keys.values(),
                    key=lambda r: (-r["bytes_total"], -r["ops_total"],
                                   r["key"]))
    for i, r in enumerate(ranked):
        r["rank"] = i + 1
    local = sum(r["local_reads"] for r in ranked)
    remote = sum(r["remote_reads"] for r in ranked)
    return {
        "generated_at": time.time(),
        "keys": ranked,
        "hosts": hosts,
        "snapshots": snap_events,
        "registry_bytes": registry_bytes,
        "locality_ratio": (round(local / (local + remote), 4)
                           if local + remote else None),
    }


def merge_placement(doc: dict, placement: dict) -> dict:
    """Overlay the planner's authoritative (master, backup, epoch) table
    onto an aggregated statemap. Host ledgers only know placements as of
    their last claim; the planner's journal is the source of truth right
    after a failover, so its values win. Keys the planner tracks but no
    ledger reported yet (e.g. promoted before any post-failover access)
    gain a zero-traffic row rather than being dropped."""
    if not placement:
        return doc
    by_key = {r["key"]: r for r in (doc.get("keys") or [])}
    for full, p in placement.items():
        row = by_key.get(full)
        if row is None:
            row = {
                "key": full, "master": "", "backup": "", "epoch": 0,
                "replication_lag": 0, "size": 0,
                "ops_total": 0, "bytes_total": 0,
                "local_reads": 0, "remote_reads": 0,
                "pull_chunks_total": 0, "pull_chunks_fresh": 0,
                "lock_waits": 0, "lock_stalls": 0,
                "by_origin": {}, "pull_amplification": None,
                "locality": None, "rank": len(by_key) + 1,
            }
            by_key[full] = row
            doc.setdefault("keys", []).append(row)
        row["master"] = p.get("master") or row["master"]
        row["backup"] = p.get("backup", row["backup"])
        row["epoch"] = max(row.get("epoch") or 0,
                           int(p.get("epoch") or 0))
    return doc


def render_statemap(doc: dict, top: int = 20) -> str:
    """Terminal table of a :func:`aggregate_statemap` document — the
    ``python -m faabric_tpu.runner.statemap`` surface."""
    keys = (doc or {}).get("keys") or []
    hosts = (doc or {}).get("hosts") or {}
    lines = [f"{'#':>3} {'key':<28} {'master':<12} {'backup':<12} "
             f"{'ep':>3} {'lag':>9} {'size':>10} "
             f"{'ops':>8} {'bytes':>12} {'local%':>7} {'pull amp':>8} "
             f"{'lock waits':>10}",
             "-" * 126]
    for r in keys[:top]:
        loc = r.get("locality")
        amp = r.get("pull_amplification")
        lines.append(
            f"{r.get('rank', 0):>3} {r.get('key', '')[:28]:<28} "
            f"{(r.get('master') or '?')[:12]:<12} "
            f"{(r.get('backup') or '-')[:12]:<12} "
            f"{r.get('epoch', 0):>3} "
            f"{r.get('replication_lag', 0):>9} "
            f"{r.get('size', 0):>10} {r.get('ops_total', 0):>8} "
            f"{r.get('bytes_total', 0):>12} "
            f"{(f'{loc * 100:.0f}%' if loc is not None else '-'):>7} "
            f"{(f'{amp:.1f}x' if amp else '-'):>8} "
            f"{r.get('lock_waits', 0):>10}")
    if len(keys) > top:
        lines.append(f"  ... {len(keys) - top} more key(s)")
    lines.append("")
    lines.append(f"{'host':<16} {'mastered keys':>13} "
                 f"{'mastered bytes':>14} {'origin bytes':>13}")
    lines.append("-" * 60)
    for host in sorted(hosts):
        h = hosts[host]
        lines.append(f"{host[:16]:<16} {h.get('mastered_keys', 0):>13} "
                     f"{h.get('mastered_bytes', 0):>14} "
                     f"{h.get('origin_bytes', 0):>13}")
    ratio = (doc or {}).get("locality_ratio")
    lines.append("")
    lines.append("cluster locality ratio: "
                 + (f"{ratio * 100:.1f}% local reads"
                    if ratio is not None else "no reads recorded"))
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Singletons
# ---------------------------------------------------------------------------

def _plane_enabled() -> bool:
    return (metrics_enabled()
            and os.environ.get("FAABRIC_STATE_STATS", "1")
            not in ("0", "false", "off"))


_store: StateStatsStore | None = None
_singleton_lock = threading.Lock()


def get_state_stats() -> StateStatsStore | _NullStateStats:
    if not _plane_enabled():
        return NULL_STATE_STATS
    global _store
    if _store is None:
        with _singleton_lock:
            if _store is None:
                _store = StateStatsStore()
    return _store


def statestats_telemetry_block() -> dict:
    """The ``statestats`` block riding GET_TELEMETRY (and the planner's
    own entry): this process's per-key ledger."""
    store = get_state_stats()
    if not store.enabled:
        return {}
    return store.snapshot()


def reset_state_stats() -> None:
    """Test hook: drop the singleton so the next use re-reads env."""
    global _store
    with _singleton_lock:
        if _store is not None:
            try:
                from faabric_tpu_torch.telemetry.timeseries import get_timeseries

                ts = get_timeseries()
                ts.unregister("state_resident_bytes",
                              _store._resident_bytes)
                ts.unregister("state_dirty_chunks", _store._dirty_chunks)
                ts.unregister("snapshot_registry_bytes",
                              _store._snapshot_registry_bytes)
            except Exception:  # noqa: BLE001 — teardown is best-effort
                pass
        _store = None
