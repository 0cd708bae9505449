"""Rolling performance profiles: the layer that turns telemetry into
answers.

Counterpart of ``faabric_tpu/telemetry/perfprofile.py``. Telemetry
produces raw signals — metrics, cross-host spans, the per-link
comm matrix, the flight recorder — but every consumer that needed an
*interpretation* re-derived it ad hoc: the wire-codec governor windowed
the comm matrix for link bandwidth, and the schedule compiler (GC3
arXiv:2201.11840 selects schedules from measured per-link profiles)
had nothing to read at all. This module is the feedback store they
share:

- :class:`PerfProfileStore` — per-(dst-host, plane, codec, size-class)
  bandwidth/latency estimators (decayed streaming quantiles + EWMA,
  bounded cardinality like the comm matrix), fed from the bulk client,
  the shared RPC plane and the device plane. Each host profiles its OWN
  outbound links (same convention as the comm matrix); the planner's
  ``GET /perf`` tags rows with their source host and merges cluster-
  wide. Profiles persist to ``FAABRIC_PERF_PROFILE_DIR`` and re-seed
  the store at boot, so a restarted process starts from measured link
  speeds instead of the assume-slow default.
- :class:`CollectiveProfiler` — per-(world, collective, round) phase
  fold-in from the MPI and device planes: every rank records its round
  ENTRY timestamp (wall-anchored, the tracer convention) plus per-phase
  durations (intra/leader/redistribute, compile/execute) and a total.
  :func:`critical_path` decomposes which rank/phase bounded each round;
  :func:`find_stragglers` flags ranks consistently ARRIVING late
  (entry-skew, not totals — in a synchronous collective the straggler
  inflates *everyone's* total, so totals cannot identify it; the late
  arrival can). Detections emit ``faabric_straggler_*`` metrics, flight
  records and trace instant events.
- Pure merge/analysis helpers (:func:`merge_link_rows`,
  :func:`merge_collective_series`, :func:`aggregate_perf`) shared by
  the planner's ``/perf`` aggregation and the cluster doctor
  (``python -m faabric_tpu_torch.runner.doctor``), which also runs them on
  dumped files — post-mortem diagnosis needs no live cluster.

Knobs: ``FAABRIC_PERF_PROFILE`` (``0`` disables both stores even with
metrics on), ``FAABRIC_PERF_HALF_LIFE_S`` (estimator decay half-life,
default 120), ``FAABRIC_PERF_MAX_LINKS`` (cardinality cap, default 512;
overflow collapses into an ``other`` destination), ``FAABRIC_PERF_DIR``
alias ``FAABRIC_PERF_PROFILE_DIR`` (persistence directory; unset → no
persistence), ``FAABRIC_PERF_PERSIST_S`` (throttle, default 30),
``FAABRIC_PERF_ROUNDS`` (per-collective round window, default 32),
``FAABRIC_STRAGGLER_FACTOR`` (entry-skew threshold as a fraction of the
median round total, default 0.25), ``FAABRIC_STRAGGLER_MIN_ROUNDS``
(consecutive evidence floor, default 3).
"""

from __future__ import annotations

import json
import math
import os
import threading
import time

from faabric_tpu_torch.telemetry.metrics import get_metrics, metrics_enabled
from faabric_tpu_torch.util.config import _env_float, _env_int

# -- estimator geometry -------------------------------------------------
# Quantile buckets: geometric grid with 2 buckets per octave, spanning
# ~1e-9 .. ~5e9 (covers ns latencies through multi-GiB/s rates).
_BUCKET_HALF_OCTAVES = 128
_BUCKET_OFFSET = 64  # bucket of value 1.0
_DECAY_TICK_S = 5.0  # lazy-decay granularity

# Frames below this feed only the LATENCY estimator: a 2 KiB frame's
# wall time is dispatch overhead, not the wire, and folding it into the
# bandwidth EWMA would drag a 10 GiB/s link toward zero.
BW_MIN_BYTES = 32 * 1024

DEFAULT_HALF_LIFE_S = 120.0
DEFAULT_MAX_LINKS = 512
DEFAULT_ROUND_WINDOW = 32
DEFAULT_STRAGGLER_FACTOR = 0.25
DEFAULT_STRAGGLER_MIN_ROUNDS = 3
# Entry skew below this never flags: scheduler jitter on a loaded box
STRAGGLER_MIN_SKEW_S = 0.002

OTHER = "other"


def perf_dir() -> str:
    """The persistence directory (empty string → persistence off)."""
    return (os.environ.get("FAABRIC_PERF_PROFILE_DIR")
            or os.environ.get("FAABRIC_PERF_DIR") or "")


def size_class(nbytes: int) -> str:
    """Power-of-4 payload class label (the comm-matrix-style cardinality
    trade: 4× resolution keeps a 64 KiB .. 1 GiB span in ~8 classes)."""
    n = max(1, int(nbytes))
    k = (n.bit_length() - 1) // 2
    lo = 1 << (2 * k)
    if lo >= (1 << 30):
        return f"{lo >> 30}GiB"
    if lo >= (1 << 20):
        return f"{lo >> 20}MiB"
    if lo >= (1 << 10):
        return f"{lo >> 10}KiB"
    return f"{lo}B"


def class_floor(label: str) -> int:
    """Inverse of :func:`size_class`: the class's lower bound in bytes
    (0 for anything unparseable)."""
    for suffix, mult in (("GiB", 1 << 30), ("MiB", 1 << 20),
                         ("KiB", 1 << 10), ("B", 1)):
        head = label[:-len(suffix)] if label.endswith(suffix) else ""
        if head.isdigit():
            return int(head) * mult
    return 0


class DecayedStat:
    """Exponentially-decayed streaming estimator: EWMA, decayed mean and
    log-bucket quantiles. NOT thread-safe — the owner serializes (the
    per-link entry holds one lock over its stats)."""

    __slots__ = ("half_life", "ewma", "wsum", "vsum", "counts", "last",
                 "n", "_t_decay")

    def __init__(self, half_life: float) -> None:
        self.half_life = max(1.0, half_life)
        self.ewma = 0.0
        self.wsum = 0.0   # decayed sample weight
        self.vsum = 0.0   # decayed weighted value sum
        self.counts = [0.0] * _BUCKET_HALF_OCTAVES
        self.last = 0.0
        self.n = 0        # raw (undecayed) sample count
        self._t_decay = time.monotonic()

    def _bucket(self, value: float) -> int:
        if value <= 0:
            return 0
        b = int(math.log2(value) * 2.0) + _BUCKET_OFFSET
        return min(max(b, 0), _BUCKET_HALF_OCTAVES - 1)

    def _decay(self, now: float) -> None:
        dt = now - self._t_decay
        if dt < _DECAY_TICK_S:
            return
        f = 0.5 ** (dt / self.half_life)
        self.wsum *= f
        self.vsum *= f
        self.counts = [c * f for c in self.counts]
        self._t_decay = now

    def observe(self, value: float, weight: float = 1.0,
                now: float | None = None) -> None:
        if now is None:
            now = time.monotonic()
        self._decay(now)
        self.n += 1
        self.last = value
        # EWMA warms fast (first samples dominate) then settles at 0.2
        alpha = max(0.2, 1.0 / self.n)
        self.ewma += alpha * (value - self.ewma)
        self.wsum += weight
        self.vsum += weight * value
        self.counts[self._bucket(value)] += weight

    def seed(self, value: float, weight: float = 1.0) -> None:
        """Adopt a persisted estimate as if freshly observed (restart
        seeding): the value is real measurement, just from a previous
        incarnation."""
        self.observe(value, weight)

    @property
    def mean(self) -> float:
        return self.vsum / self.wsum if self.wsum > 0 else 0.0

    @property
    def weight(self) -> float:
        return self.wsum

    def quantile(self, q: float) -> float:
        total = sum(self.counts)
        if total <= 0:
            return 0.0
        target = total * min(max(q, 0.0), 1.0)
        acc = 0.0
        for i, c in enumerate(self.counts):
            acc += c
            if acc >= target:
                # geometric bucket midpoint
                return 2.0 ** ((i - _BUCKET_OFFSET) / 2.0 + 0.25)
        return 2.0 ** ((_BUCKET_HALF_OCTAVES - 1 - _BUCKET_OFFSET) / 2.0)


class _LinkEntry:
    """Estimators for one (dst, plane, codec, size-class) link cell.
    Updates take only this entry's lock (comm-matrix discipline)."""

    __slots__ = ("bw", "lat", "bytes", "lat_sum", "messages", "last_wall",
                 "seeded", "_lock")

    def __init__(self, half_life: float) -> None:
        self.bw = DecayedStat(half_life)     # GiB/s per frame
        self.lat = DecayedStat(half_life)    # seconds per frame
        self.bytes = 0.0                     # decay-free totals ride the
        self.lat_sum = 0.0                   # comm matrix; these back
        self.messages = 0                    # the gibs_avg cross-check
        self.last_wall = 0.0
        self.seeded = False
        self._lock = threading.Lock()

    def add(self, nbytes: int, seconds: float | None) -> None:
        with self._lock:
            self.messages += 1
            self.bytes += nbytes
            self.last_wall = time.time()
            if seconds is not None and seconds > 0:
                self.lat.observe(seconds)
                self.lat_sum += seconds
                if nbytes >= BW_MIN_BYTES:
                    self.bw.observe((nbytes / seconds) / (1 << 30))

    def row(self, dst: str, plane: str, codec: str, klass: str) -> dict:
        with self._lock:
            gibs_avg = ((self.bytes / self.lat_sum) / (1 << 30)
                        if self.lat_sum > 0 else None)
            return {
                "dst": dst, "plane": plane, "codec": codec,
                "size_class": klass,
                "messages": self.messages,
                "bytes": int(self.bytes),
                "gibs_ewma": round(self.bw.ewma, 4) if self.bw.n else None,
                "gibs_avg": round(gibs_avg, 4) if gibs_avg else None,
                "gibs_p10": round(self.bw.quantile(0.10), 4),
                "gibs_p50": round(self.bw.quantile(0.50), 4),
                "gibs_p90": round(self.bw.quantile(0.90), 4),
                "lat_p50_ms": round(self.lat.quantile(0.50) * 1e3, 4),
                "lat_p90_ms": round(self.lat.quantile(0.90) * 1e3, 4),
                "weight": round(self.bw.weight, 3),
                "age_s": round(max(0.0, time.time() - self.last_wall), 1)
                if self.last_wall else None,
                "seeded": self.seeded,
            }


class _NullPerfStore:
    """Shared no-op store while metrics / the profile plane is off."""

    __slots__ = ()
    enabled = False

    def observe(self, dst, plane, nbytes, seconds=None,
                codec="raw") -> None:
        pass

    def link_gibs(self, dst, plane=None, min_bytes: int = 0,
                  codec=None):
        # Signature mirrors PerfProfileStore.link_gibs exactly: the
        # schedule selector passes min_bytes, and a metrics-off
        # TypeError here would kill rank 0 before its selection
        # broadcast and hang the world
        return None

    def snapshot(self) -> dict:
        return {}

    def persist(self) -> None:
        pass

    def cardinality(self) -> int:
        return 0


NULL_PERF_STORE = _NullPerfStore()


class PerfProfileStore:
    """Rolling per-link performance profile of THIS process's outbound
    traffic. Keys are (dst host, plane, codec, size-class); the source
    host is implicit (the planner adds it when aggregating, exactly like
    the comm matrix's per-host outbound convention)."""

    # Concurrency contract (analysis/concheck.py): registry structures
    # mutate under _lock; per-entry stats under the entry's own lock.
    # NOT listed: _fast — the send-hot-path cache, WRITTEN only under
    # _lock but deliberately read lock-free (GIL-atomic dict.get; a
    # racing reader at worst misses and takes the locked slow path) —
    # the exact CommMatrix._fast discipline.
    GUARDS = {
        "_entries": "_lock",
        "_last_persist": "_lock",
    }

    enabled = True

    def __init__(self, half_life: float | None = None,
                 max_links: int | None = None,
                 label: str | None = None) -> None:
        self.half_life = (half_life if half_life is not None else
                          _env_float("FAABRIC_PERF_HALF_LIFE_S",
                                     DEFAULT_HALF_LIFE_S))
        self.max_links = (max_links if max_links is not None else
                          _env_int("FAABRIC_PERF_MAX_LINKS",
                                   DEFAULT_MAX_LINKS))
        self._label = label
        self._lock = threading.Lock()
        self._entries: dict[tuple, _LinkEntry] = {}
        # Raw (dst, plane, codec, class-index) → entry, read lock-free
        # on the send hot path (one dict hit + one entry add)
        self._fast: dict[tuple, _LinkEntry] = {}
        self._last_persist = 0.0
        self._load_seed()

    # -- hot path -------------------------------------------------------
    def observe(self, dst, plane: str, nbytes: int,
                seconds: float | None = None, codec: str = "raw") -> None:
        klass = size_class(nbytes)
        raw = (dst, plane, codec, klass)
        entry = self._fast.get(raw)
        if entry is None:
            with self._lock:
                # Exact key first: an entry that already exists (e.g.
                # boot-seeded from a persisted profile, which fills
                # _entries but not _fast) must keep receiving live
                # updates even when the store sits at its cap
                entry = self._entries.get(raw)
                if entry is None:
                    key = raw
                    if len(self._entries) >= self.max_links:
                        key = (OTHER, plane, codec, klass)
                    entry = self._entries.get(key)
                    if entry is None:
                        entry = self._entries[key] = _LinkEntry(
                            self.half_life)
                if len(self._fast) >= 8 * self.max_links:
                    # Cardinality backstop mirroring the cap on
                    # _entries: churning destination labels must not
                    # grow the lock-free cache without bound
                    self._fast.clear()
                self._fast[raw] = entry
        entry.add(int(nbytes), seconds)

    # -- queries --------------------------------------------------------
    def link_gibs(self, dst, plane: str | None = None,
                  min_bytes: int = 0,
                  codec: str | None = None) -> float | None:
        """Best current bandwidth estimate toward ``dst`` (max EWMA over
        codecs/size classes with real evidence), or None when the link
        is unmeasured — the governor's assume-slow default then holds.

        ``min_bytes`` drops evidence from size classes below the floor:
        small frames' wall time is dispatch overhead, which reads as a
        falsely slow link — the governor asks for big-frame evidence
        only, so a link carrying nothing but compact delta frames
        reports None (→ fallback) instead of locking itself into
        compression on an underestimate.

        ``codec`` restricts the evidence to one wire codec's rows —
        how the governor's tuned-threshold derivation reads the delta
        path's own measured wire rate."""
        with self._lock:
            items = list(self._entries.items())
        best = None
        for (d, p, c, klass), e in items:
            if d != dst or (plane is not None and p != plane):
                continue
            if codec is not None and c != codec:
                continue
            if min_bytes and class_floor(klass) < min_bytes:
                continue
            with e._lock:
                if e.bw.n == 0 or e.bw.weight < 0.5:
                    continue
                gibs = e.bw.ewma
            if best is None or gibs > best:
                best = gibs
        return best

    def cardinality(self) -> int:
        with self._lock:
            return len(self._entries)

    def snapshot(self) -> dict:
        """JSON-safe wire form riding GET_TELEMETRY's ``perf`` block.
        Opportunistically persists (throttled) — the scrape cadence is
        the natural checkpoint clock."""
        with self._lock:
            items = list(self._entries.items())
        rows = [e.row(d, p, c, k) for (d, p, c, k), e in items]
        rows.sort(key=lambda r: -(r["bytes"] or 0))
        self._maybe_persist()
        return {"links": rows, "half_life_s": self.half_life,
                "max_links": self.max_links}

    # -- persistence ----------------------------------------------------
    def _file_label(self) -> str:
        label = self._label
        if label is None:
            try:
                from faabric_tpu_torch.telemetry.tracer import get_tracer

                label = get_tracer().process_label
            except Exception:  # noqa: BLE001 — label is cosmetic
                label = f"pid-{os.getpid()}"
        return "".join(c if c.isalnum() or c in "-_." else "_"
                       for c in label)

    def _path(self) -> str | None:
        directory = perf_dir()
        if not directory:
            return None
        return os.path.join(directory, f"perf-{self._file_label()}.json")

    def persist(self) -> str | None:
        """Write the current profile (atomic; never raises — a failed
        checkpoint must not take down a send path or a scrape)."""
        path = self._path()
        if path is None:
            return None
        body = {"saved_at": time.time(), "label": self._file_label(),
                "links": self.snapshot_rows_for_persist()}
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(body, f)
            os.replace(tmp, path)
            return path
        except OSError:
            return None

    def snapshot_rows_for_persist(self) -> list[dict]:
        with self._lock:
            items = list(self._entries.items())
        return [e.row(d, p, c, k) for (d, p, c, k), e in items]

    def _maybe_persist(self) -> None:
        if not perf_dir():
            return
        now = time.monotonic()
        interval = _env_float("FAABRIC_PERF_PERSIST_S", 30.0)
        with self._lock:
            if now - self._last_persist < interval:
                return
            self._last_persist = now
        self.persist()

    def _load_seed(self) -> None:
        """Seed estimators from this label's persisted profile: a
        restarted sender starts from measured link speeds (the governor
        keeps its verdicts across restarts) instead of assume-slow."""
        path = self._path()
        if path is None or not os.path.exists(path):
            return
        try:
            with open(path) as f:
                body = json.load(f)
        except (OSError, json.JSONDecodeError):
            return
        for row in body.get("links", []):
            dst, plane = row.get("dst"), row.get("plane")
            codec = row.get("codec", "raw")
            klass = row.get("size_class", "0B")
            if not dst or not plane:
                continue
            with self._lock:
                if len(self._entries) >= self.max_links:
                    return
                key = (dst, plane, codec, klass)
                entry = self._entries.get(key)
                if entry is None:
                    entry = self._entries[key] = _LinkEntry(self.half_life)
            gibs = row.get("gibs_ewma")
            with entry._lock:
                entry.seeded = True
                if isinstance(gibs, (int, float)) and gibs > 0:
                    entry.bw.seed(float(gibs))
                lat = row.get("lat_p50_ms")
                if isinstance(lat, (int, float)) and lat > 0:
                    entry.lat.seed(float(lat) / 1e3)

    def reset(self) -> None:
        with self._lock:
            self._entries.clear()
            self._fast.clear()


# ---------------------------------------------------------------------------
# Collective critical path + straggler detection
# ---------------------------------------------------------------------------

# Phases whose values are absolute wall timestamps, not durations —
# excluded from duration decomposition, used for arrival-skew analysis
TS_PHASES = ("enter_ts",)


class _Series:
    """Rounds of one (world, collective): round idx → rank → phase map.
    Mutated under the owning profiler's lock (record is a few dict ops;
    a shared lock beats per-series locks' creation churn)."""

    __slots__ = ("rounds", "rank_round", "completed", "flagged")

    def __init__(self) -> None:
        self.rounds: dict[int, dict[int, dict[str, float]]] = {}
        self.rank_round: dict[int, int] = {}
        self.completed = 0
        self.flagged: set[int] = set()  # ranks currently flagged


class _NullCollectiveProfiler:
    __slots__ = ()
    enabled = False

    def record_phase(self, world, collective, rank, phase, value,
                     nbytes=0) -> None:
        pass

    def snapshot(self) -> dict:
        return {}

    def detect(self) -> list:
        return []


NULL_COLLECTIVE_PROFILER = _NullCollectiveProfiler()


class CollectiveProfiler:
    """Per-(world, collective, round) phase fold-in + straggler watch.

    ``record_phase(world, collective, rank, phase, value)``: durations
    for named phases (``intra``/``leader``/``redistribute``/``compile``/
    ``execute``), the absolute wall entry stamp as ``enter_ts``, and
    ``total`` — which closes the rank's round and advances its round
    counter. Rounds align across ranks (and, after the planner merge,
    across hosts) because collectives are bulk-synchronous per world:
    every rank's Nth call is the same logical round."""

    GUARDS = {
        "_series": "_lock",
    }

    enabled = True

    def __init__(self, window: int | None = None,
                 factor: float | None = None,
                 min_rounds: int | None = None,
                 max_series: int = 64) -> None:
        self.window = (window if window is not None else
                       _env_int("FAABRIC_PERF_ROUNDS",
                                DEFAULT_ROUND_WINDOW))
        self.factor = (factor if factor is not None else
                       _env_float("FAABRIC_STRAGGLER_FACTOR",
                                  DEFAULT_STRAGGLER_FACTOR))
        self.min_rounds = (min_rounds if min_rounds is not None else
                           _env_int("FAABRIC_STRAGGLER_MIN_ROUNDS",
                                    DEFAULT_STRAGGLER_MIN_ROUNDS))
        self.max_series = max_series
        self._lock = threading.Lock()
        self._series: dict[tuple, _Series] = {}

    def record_phase(self, world, collective: str, rank: int, phase: str,
                     value: float, nbytes: int = 0) -> None:
        key = (world, collective)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                if len(self._series) >= self.max_series:
                    return  # cardinality cap: drop, never grow unbounded
                s = self._series[key] = _Series()
            idx = s.rank_round.get(rank, 0)
            rd = s.rounds.get(idx)
            if rd is None:
                rd = s.rounds[idx] = {}
            phases = rd.get(rank)
            if phases is None:
                phases = rd[rank] = {}
            if phase in TS_PHASES:
                phases[phase] = value  # absolute stamp, last write wins
            else:
                phases[phase] = phases.get(phase, 0.0) + value
            if phase == "total":
                s.rank_round[rank] = idx + 1
                s.completed += 1
                run_detect = s.completed % 16 == 0
                # Prune beyond the window (min over ranks so a lagging
                # rank's round is never dropped under it)
                floor = min(s.rank_round.values()) - self.window
                for old in [i for i in s.rounds if i < floor]:
                    del s.rounds[old]
            else:
                run_detect = False
        if run_detect:
            self._detect_series(world, collective)

    # -- analysis -------------------------------------------------------
    def _detect_series(self, world, collective: str) -> None:
        key = (world, collective)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                return
            rounds = {i: {r: dict(p) for r, p in rd.items()}
                      for i, rd in s.rounds.items()}
            already = set(s.flagged)
        found = find_stragglers(rounds, factor=self.factor,
                                min_rounds=self.min_rounds)
        fresh = {r: st for r, st in found.items() if r not in already}
        with self._lock:
            s = self._series.get(key)
            if s is not None:
                s.flagged = set(found)
        if not fresh:
            return
        from faabric_tpu_torch.telemetry.flight import flight_record
        from faabric_tpu_torch.telemetry.tracer import instant

        metrics = get_metrics()
        for rank, st in fresh.items():
            metrics.counter(
                "faabric_straggler_detected_total",
                "Ranks newly flagged as consistently late arrivers",
                world=world, collective=collective, rank=rank).inc()
            metrics.gauge(
                "faabric_straggler_skew_seconds",
                "Last detected median entry skew of a flagged rank",
                world=world, collective=collective,
                rank=rank).set(st["median_skew_s"])
            flight_record("straggler", world=world, collective=collective,
                          rank=rank, skew_s=round(st["median_skew_s"], 6),
                          rounds=st["rounds_flagged"])
            instant("perf", "straggler", world=world,
                    collective=collective, rank=rank,
                    skew_ms=round(st["median_skew_s"] * 1e3, 3))

    def detect(self) -> list[dict]:
        """Run detection over every series; returns the current flags
        (also refreshes metrics/flight on fresh detections)."""
        with self._lock:
            keys = list(self._series)
        for world, collective in keys:
            self._detect_series(world, collective)
        out = []
        with self._lock:
            for (world, collective), s in self._series.items():
                for rank in sorted(s.flagged):
                    out.append({"world": world, "collective": collective,
                                "rank": rank})
        return out

    def snapshot(self) -> list[dict]:
        """JSON-safe series dump (round maps keyed by stringified ints
        for the wire) + per-series critical path and straggler flags."""
        self.detect()
        with self._lock:
            items = [((w, c), {i: {r: dict(p) for r, p in rd.items()}
                               for i, rd in s.rounds.items()},
                      sorted(s.flagged), s.completed)
                     for (w, c), s in self._series.items()]
        out = []
        for (world, collective), rounds, flagged, completed in items:
            out.append({
                "world": world,
                "collective": collective,
                "completed": completed,
                "rounds": {str(i): {str(r): {k: round(v, 6)
                                             for k, v in p.items()}
                                    for r, p in rd.items()}
                           for i, rd in rounds.items()},
                "stragglers": flagged,
                "critical_path": critical_path(rounds),
            })
        return out

    def reset(self) -> None:
        with self._lock:
            self._series.clear()


# ---------------------------------------------------------------------------
# Pure analysis + merge helpers (planner aggregation and the doctor)
# ---------------------------------------------------------------------------

def _round_items(rounds: dict) -> list[tuple[int, dict[int, dict]]]:
    """Normalize a rounds map whose keys may be ints (in-process) or
    strings (JSON round-trip) into sorted (idx, {rank: phases})."""
    out = []
    for i, rd in rounds.items():
        ranks = {int(r): p for r, p in rd.items()}
        out.append((int(i), ranks))
    out.sort()
    return out


def _median(values: list[float]) -> float:
    vs = sorted(values)
    n = len(vs)
    if n == 0:
        return 0.0
    mid = n // 2
    return vs[mid] if n % 2 else 0.5 * (vs[mid - 1] + vs[mid])


def find_stragglers(rounds: dict, factor: float = DEFAULT_STRAGGLER_FACTOR,
                    min_rounds: int = DEFAULT_STRAGGLER_MIN_ROUNDS,
                    min_skew_s: float = STRAGGLER_MIN_SKEW_S) -> dict:
    """Ranks that consistently ARRIVE late of their own accord.

    The signal is the **inter-round idle gap**: ``enter(k) −
    (enter(k−1) + total(k−1))`` — how long the rank sat OUTSIDE the
    collective between rounds — compared to the round's median gap. A
    rank is flagged when its gap excess beats ``max(min_skew_s,
    factor × median round total)`` in ≥ ``min_rounds`` round pairs AND
    at least half the pairs it appears in.

    Why the gap and not raw entry stamps or totals:

    - *totals* cannot identify a straggler — a synchronous collective's
      late arriver inflates every rank's total equally;
    - *raw entry skew* has two failure modes: cross-host wall-clock
      offset reads as a whole host arriving "late", and the straggler's
      lateness ECHOES through the data-dependency structure (a ring
      successor stuck waiting inside round k−1 also *enters* round k
      late, through no fault of its own).

    The gap dodges both: it subtracts two stamps taken on the SAME
    rank's clock (host offsets cancel exactly — ``total`` is a
    duration), and an echo victim's delay is spent *inside* the
    previous collective, so its idle gap stays ~zero while the true
    straggler's pre-collective dawdling is exactly the gap.

    Returns ``{rank: {"rounds_flagged", "rounds_seen",
    "median_skew_s"}}`` (``median_skew_s`` = median excess idle gap)."""
    items = _round_items(rounds)
    by_idx = dict(items)
    seen: dict[int, int] = {}
    flagged: dict[int, int] = {}
    skews: dict[int, list[float]] = {}
    for idx, ranks in items:
        prev = by_idx.get(idx - 1)
        if prev is None:
            continue  # first round (or a pruned gap): no pair
        gaps = {}
        for r, p in ranks.items():
            pp = prev.get(r)
            if ("enter_ts" in p and pp is not None
                    and "enter_ts" in pp and pp.get("total")):
                gaps[r] = p["enter_ts"] - (pp["enter_ts"] + pp["total"])
        if len(gaps) < 2:
            continue
        med_gap = _median(list(gaps.values()))
        totals = [p.get("total", 0.0) for p in ranks.values()
                  if p.get("total")]
        threshold = max(min_skew_s,
                        factor * _median(totals) if totals else 0.0)
        for r, g in gaps.items():
            seen[r] = seen.get(r, 0) + 1
            skew = g - med_gap
            skews.setdefault(r, []).append(skew)
            if skew > threshold:
                flagged[r] = flagged.get(r, 0) + 1
    out = {}
    for r, n_flag in flagged.items():
        if n_flag >= min_rounds and n_flag * 2 >= seen.get(r, 0):
            out[r] = {"rounds_flagged": n_flag,
                      "rounds_seen": seen.get(r, 0),
                      "median_skew_s": _median(skews.get(r, [0.0]))}
    return out


def critical_path(rounds: dict) -> dict:
    """Which rank/phase bounded the rounds: per round the rank with the
    largest total is the bound; its phase durations decompose the round.
    Returns aggregate counts plus the dominant (rank, phase)."""
    items = _round_items(rounds)
    bound_counts: dict[int, int] = {}
    phase_time: dict[str, float] = {}
    analyzed = 0
    for _idx, ranks in items:
        totals = {r: p.get("total") for r, p in ranks.items()
                  if p.get("total")}
        if not totals:
            continue
        analyzed += 1
        bound = max(totals, key=lambda r: totals[r])
        bound_counts[bound] = bound_counts.get(bound, 0) + 1
        for phase, v in ranks[bound].items():
            if phase in TS_PHASES or phase == "total":
                continue
            phase_time[phase] = phase_time.get(phase, 0.0) + v
    total_phase = sum(phase_time.values())
    shares = ({p: round(v / total_phase, 4)
               for p, v in sorted(phase_time.items(),
                                  key=lambda kv: -kv[1])}
              if total_phase > 0 else {})
    dominant_rank = (max(bound_counts, key=lambda r: bound_counts[r])
                     if bound_counts else None)
    dominant_phase = next(iter(shares), None)
    return {"rounds_analyzed": analyzed,
            "bound_counts": {str(r): c for r, c in
                             sorted(bound_counts.items())},
            "phase_shares": shares,
            "dominant_rank": dominant_rank,
            "dominant_phase": dominant_phase}


def merge_link_rows(per_host: dict[str, list[dict]]) -> list[dict]:
    """Tag each host's outbound profile rows with their source host —
    the cluster-wide (src, dst, plane, codec, size-class) link table.
    Hosts only report their own outbound links, so this is a pure
    union, never a sum."""
    out = []
    for host, rows in per_host.items():
        for r in rows or []:
            out.append({"src": host, **r})
    out.sort(key=lambda r: -(r.get("bytes") or 0))
    return out


def merge_collective_series(per_host: dict[str, list[dict]]) -> list[dict]:
    """Union hosts' (world, collective) series: each host recorded its
    own ranks' phases, and rounds align by index (collectives are
    bulk-synchronous), so merging is a per-round rank-map union. The
    merged series re-runs critical-path and straggler analysis — this
    is where a dist world's cross-host comparison becomes possible."""
    merged: dict[tuple, dict] = {}
    for host, series in per_host.items():
        for s in series or []:
            key = (s.get("world"), s.get("collective"))
            m = merged.get(key)
            if m is None:
                m = merged[key] = {"world": s.get("world"),
                                   "collective": s.get("collective"),
                                   "completed": 0, "rounds": {},
                                   "rank_hosts": {},
                                   "stragglers_local": set()}
            m["completed"] += s.get("completed", 0)
            m["stragglers_local"].update(s.get("stragglers") or [])
            for idx, ranks in (s.get("rounds") or {}).items():
                rd = m["rounds"].setdefault(str(idx), {})
                for r, phases in ranks.items():
                    rd.setdefault(str(r), {}).update(phases)
                    # Provenance IS placement: the host whose series
                    # carried this rank's phases executed that rank
                    m["rank_hosts"][str(r)] = host
    out = []
    for m in merged.values():
        rounds = m["rounds"]
        stragglers = find_stragglers(rounds)
        out.append({
            "world": m["world"], "collective": m["collective"],
            "completed": m["completed"],
            "rounds": rounds,
            "rank_hosts": m["rank_hosts"],
            "critical_path": critical_path(rounds),
            "stragglers": {str(r): st for r, st in stragglers.items()},
            "stragglers_local": sorted(m["stragglers_local"]),
        })
    out.sort(key=lambda s: -(s.get("completed") or 0))
    return out


def aggregate_perf(tel: dict) -> dict:
    """The cluster-wide ``GET /perf`` document from a
    ``collect_telemetry()`` result: per-host profile blocks merged into
    one link table + merged collective series with cross-host straggler
    analysis."""
    link_rows: dict[str, list[dict]] = {}
    coll: dict[str, list[dict]] = {}
    for host, t in tel.items():
        perf = (t or {}).get("perf") or {}
        link_rows[host] = (perf.get("links") or {}).get("links") or []
        coll[host] = perf.get("collectives") or []
    collectives = merge_collective_series(coll)
    stragglers = []
    for s in collectives:
        for rank, st in (s.get("stragglers") or {}).items():
            stragglers.append({"world": s["world"],
                               "collective": s["collective"],
                               "rank": int(rank),
                               "host": (s.get("rank_hosts") or {}).get(
                                   str(rank)), **st})
    stragglers.sort(key=lambda s: -s.get("median_skew_s", 0.0))
    return {
        "generated_at": time.time(),
        "links": merge_link_rows(link_rows),
        "collectives": collectives,
        "stragglers": stragglers,
        "hosts": sorted(link_rows),
    }


def persist_cluster(doc: dict) -> str | None:
    """Checkpoint the aggregated cluster view (atomic, best-effort) so
    the doctor — and the next planner incarnation — can read the last
    known cluster profile without a live scrape."""
    directory = perf_dir()
    if not directory:
        return None
    path = os.path.join(directory, "perf-cluster.json")
    try:
        os.makedirs(directory, exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
        return path
    except OSError:
        return None


# ---------------------------------------------------------------------------
# Singletons
# ---------------------------------------------------------------------------

def _plane_enabled() -> bool:
    return (metrics_enabled()
            and os.environ.get("FAABRIC_PERF_PROFILE", "1")
            not in ("0", "false", "off"))


_store: PerfProfileStore | None = None
_profiler: CollectiveProfiler | None = None
_singleton_lock = threading.Lock()


def get_perf_store() -> PerfProfileStore | _NullPerfStore:
    if not _plane_enabled():
        return NULL_PERF_STORE
    global _store
    if _store is None:
        with _singleton_lock:
            if _store is None:
                _store = PerfProfileStore()
    return _store


def get_collective_profiler() -> CollectiveProfiler | _NullCollectiveProfiler:
    if not _plane_enabled():
        return NULL_COLLECTIVE_PROFILER
    global _profiler
    if _profiler is None:
        with _singleton_lock:
            if _profiler is None:
                _profiler = CollectiveProfiler()
    return _profiler


def perf_telemetry_block() -> dict:
    """The ``perf`` block riding GET_TELEMETRY (and the planner's own
    entry): this process's link profiles + collective series."""
    store = get_perf_store()
    profiler = get_collective_profiler()
    if not store.enabled and not profiler.enabled:
        return {}
    return {"links": store.snapshot(),
            "collectives": profiler.snapshot()}


def reset_perf_profile() -> None:
    """Test hook: drop both singletons so the next use re-reads env."""
    global _store, _profiler
    with _singleton_lock:
        _store = None
        _profiler = None
