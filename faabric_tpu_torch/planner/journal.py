"""The planner's write-ahead journal.

Counterpart of ``faabric_tpu/planner/journal.py``, with the same file
format to the byte: a journal directory written by either package is
read by the other. The planner's host registry, in-flight decisions,
results and state masters live in its memory; every durable mutation
appends a record here, so that a restarted planner replays itself back
to the state before the crash (a torn final record is tolerated) and
then reconciles with the hosts that register again
(``planner.py::_reconcile_after_restart``).

On-disk layout (``FAABRIC_PLANNER_JOURNAL_DIR``):

- ``planner.journal``: a 16-byte header (the ``FTPJRNL1`` magic and an
  8-byte random generation id), then length-prefixed records::

      [u32 payload_len][u32 crc32(payload)][payload: JSON]

  Each payload is ``{"k": kind, "ts": wall_seconds, ...fields}``.

  Two durability classes:

  * ``append_durable``: scheduling-class mutations (``app_update``,
    host membership, state masters, freeze, reset), encoded and written
    inline in one ``os.write``. The record is in the kernel before the
    call returns, so a SIGKILL of the planner cannot lose a decision it
    already acted on.
  * ``append``: the hot path (``result`` records), buffered and drained
    by a writer thread every fsync interval; the append itself is a
    lock and a list push. A crash loses at most one drain interval of
    results, and each of those is still in some worker's recent-results
    window (``planner/client.py``), which the rejoin after a restart
    re-delivers through the confirmed ``FLUSH_RESULTS`` call.

  A durable append drains the buffer first, so the file's order is the
  mutation order. fsync is batched on
  ``FAABRIC_PLANNER_JOURNAL_FSYNC_INTERVAL``: it protects against a
  crash of the machine, not of the process.

- ``planner.snapshot.json``: the compaction target, the whole planner
  state and the journal's ``(generation, offset)`` at snapshot time.
  Replay loads the snapshot, then applies the journal's records from
  ``offset`` when the generations match (a crash between the two
  compaction renames) or from the top of the fresh journal when they
  do not. Compaction writes the snapshot tmp+fsync+rename first, then
  swaps in a fresh-generation journal the same way.

Torn tail: a crash mid-append leaves a record whose length prefix,
payload or CRC does not check out at EOF. Replay stops at the last
valid record, and reopening for append truncates the torn bytes. A CRC
mismatch anywhere is treated the same way: records after a corrupt one
cannot be reached (lengths chain), so replay takes the longest valid
prefix.

With ``FAABRIC_PLANNER_JOURNAL_DIR`` unset, ``open_planner_journal()``
returns the shared ``NULL_JOURNAL``, whose ``enabled`` is False; call
sites gate on that bool.
"""

from __future__ import annotations

import json
import os
import struct
import threading
import time
import zlib
from typing import Any, Optional

from faabric_tpu_torch.telemetry import get_metrics
from faabric_tpu_torch.util.logging import get_logger

logger = get_logger(__name__)

MAGIC = b"FTPJRNL1"
GENERATION_BYTES = 8
HEADER_LEN = len(MAGIC) + GENERATION_BYTES  # 16
_REC_HDR = struct.Struct("<II")  # payload length, crc32(payload)
# A single record larger than this is rejected as corrupt rather than
# attempted: a garbage length prefix must not trigger a giant read
MAX_RECORD_BYTES = 64 << 20

JOURNAL_FILE = "planner.journal"
SNAPSHOT_FILE = "planner.snapshot.json"

_metrics = get_metrics()
_APPENDS = _metrics.counter(
    "faabric_planner_journal_appends_total",
    "Records appended to the planner write-ahead journal")
_APPEND_BYTES = _metrics.counter(
    "faabric_planner_journal_bytes_total",
    "Bytes appended to the planner write-ahead journal")
_FSYNCS = _metrics.counter(
    "faabric_planner_journal_fsyncs_total",
    "Batched fsyncs of the planner journal")
_COMPACTIONS = _metrics.counter(
    "faabric_planner_journal_compactions_total",
    "Snapshot compactions of the planner journal")
_GROUP_COMMITS = _metrics.counter(
    "faabric_planner_journal_group_commits_total",
    "Group-commit records appended (one per scheduling tick that "
    "journaled)")
_GROUP_SUBRECORDS = _metrics.counter(
    "faabric_planner_journal_group_subrecords_total",
    "Scheduling-class records coalesced inside group commits")
_REPLAYED = _metrics.counter(
    "faabric_planner_journal_replayed_records_total",
    "Journal records applied during planner restart replay")
_SIZE = _metrics.gauge(
    "faabric_planner_journal_size_bytes",
    "Current on-disk size of the planner journal file")


class JournalCorrupt(Exception):
    """A structurally invalid journal (bad magic/header) — distinct from
    a torn tail, which replay tolerates silently."""


# ---------------------------------------------------------------------------
# Record codec (module-level so tests and journaldump share it)
# ---------------------------------------------------------------------------
def encode_record(kind: str, fields: dict[str, Any],
                  ts: float | None = None) -> bytes:
    """One wire record: length + CRC header and the JSON payload in a
    single buffer (appended with one ``os.write``)."""
    payload = json.dumps(
        {"k": kind, "ts": time.time() if ts is None else ts, **fields},
        separators=(",", ":"), default=str).encode()
    return _REC_HDR.pack(len(payload), zlib.crc32(payload)) + payload


def decode_records(data: bytes, offset: int = 0
                   ) -> tuple[list[dict[str, Any]], int, bool]:
    """Decode records from ``data[offset:]``.

    Returns ``(records, valid_end, torn)``: the longest valid prefix of
    records, the byte offset just past the last valid record, and
    whether trailing bytes were rejected (short header, short payload,
    CRC mismatch, or undecodable JSON — all treated as a torn tail)."""
    records: list[dict[str, Any]] = []
    pos = offset
    end = len(data)
    while pos < end:
        if end - pos < _REC_HDR.size:
            return records, pos, True
        length, crc = _REC_HDR.unpack_from(data, pos)
        body_start = pos + _REC_HDR.size
        if length > MAX_RECORD_BYTES or body_start + length > end:
            return records, pos, True
        payload = data[body_start:body_start + length]
        if zlib.crc32(payload) != crc:
            return records, pos, True
        try:
            rec = json.loads(payload)
        except ValueError:
            return records, pos, True
        records.append(rec)
        pos = body_start + length
    return records, pos, False


# ---------------------------------------------------------------------------
class NullJournal:
    """Shared no-op stand-in while journaling is disabled. Call sites
    gate on ``enabled`` so the disabled path allocates nothing."""

    __slots__ = ()
    enabled = False
    since_compact = 0
    compact_records = 0

    def append(self, kind: str, fields: dict[str, Any]) -> None:
        pass

    def append_durable(self, kind: str, fields: dict[str, Any]) -> None:
        pass

    def append_group(self, records) -> None:
        pass

    def flush(self) -> None:
        pass

    def compact(self, state: dict[str, Any]) -> None:
        pass

    def replay(self) -> tuple[None, list, dict]:
        return None, [], {"enabled": False}

    def stats(self) -> dict[str, Any]:
        return {"enabled": False}

    def close(self) -> None:
        pass


NULL_JOURNAL = NullJournal()


class PlannerJournal:
    """Append-only, fsync-batched journal over one directory.

    Thread-safe; the planner calls ``append`` under its own lock so the
    journal order IS the state-mutation order, but the internal lock
    keeps the file consistent for out-of-band callers (healthz stats,
    tests)."""

    enabled = True
    DRAIN_BACKPRESSURE = 1024

    def __init__(self, directory: str, fsync_interval: float = 0.05,
                 compact_records: int = 20000) -> None:
        self.directory = directory
        self.fsync_interval = max(0.0, fsync_interval)
        self.compact_records = max(1, compact_records)
        self._lock = threading.RLock()
        os.makedirs(directory, exist_ok=True)
        self._journal_path = os.path.join(directory, JOURNAL_FILE)
        self._snapshot_path = os.path.join(directory, SNAPSHOT_FILE)

        self._fd = os.open(self._journal_path,
                           os.O_RDWR | os.O_CREAT, 0o644)
        data = self._read_all()
        if not data:
            self._generation = os.urandom(GENERATION_BYTES)
            os.write(self._fd, MAGIC + self._generation)
            self._size = HEADER_LEN
            self.records = 0
        else:
            if len(data) < HEADER_LEN or data[:len(MAGIC)] != MAGIC:
                raise JournalCorrupt(
                    f"{self._journal_path}: bad magic/header")
            self._generation = data[len(MAGIC):HEADER_LEN]
            recs, valid_end, torn = decode_records(data, HEADER_LEN)
            if torn:
                logger.warning(
                    "Journal %s has a torn tail: truncating %d byte(s) "
                    "after %d valid record(s)", self._journal_path,
                    len(data) - valid_end, len(recs))
                os.ftruncate(self._fd, valid_end)
            os.lseek(self._fd, valid_end, os.SEEK_SET)
            self._size = valid_end
            self.records = len(recs)
        self.since_compact = self.records
        self.compactions = 0
        self._dirty = False
        self._last_fsync = time.monotonic()
        self._last_append = 0.0
        # Write-behind buffer for hot-path (result) records: (kind,
        # fields, ts) tuples encoded and written by the drain thread.
        # Callers hand over fields dicts they never mutate afterwards.
        self._buffer: list[tuple[str, dict, float]] = []
        self._drain_wake = threading.Event()
        self._drain_stop = False
        self._drain_thread: threading.Thread | None = None
        _SIZE.set(self._size)

    # ------------------------------------------------------------------
    def _read_all(self) -> bytes:
        os.lseek(self._fd, 0, os.SEEK_SET)
        chunks = []
        while True:
            chunk = os.read(self._fd, 1 << 20)
            if not chunk:
                return b"".join(chunks)
            chunks.append(chunk)

    @property
    def generation(self) -> str:
        return self._generation.hex()

    @property
    def size_bytes(self) -> int:
        return self._size

    # ------------------------------------------------------------------
    def append(self, kind: str, fields) -> None:
        """Hot-path append: push onto the write-behind buffer (a lock +
        list push) and let the drain thread encode + write within one
        fsync interval. ``fields`` is a dict — or a zero-arg callable
        returning one, evaluated at drain time so even the dict build
        (e.g. ``Message.to_dict``) stays off the hot path; either way
        the underlying data must not mutate after hand-over. Loss
        window on SIGKILL: one drain interval — acceptable ONLY for
        records something upstream re-delivers (results: the workers'
        recent-window flush); everything else goes through
        ``append_durable``."""
        with self._lock:
            self._buffer.append((kind, fields, time.time()))
            self.records += 1
            self.since_compact += 1
            if self._drain_thread is None or not self._drain_thread.is_alive():
                self._start_drain_thread_locked()
            backpressure = len(self._buffer) >= self.DRAIN_BACKPRESSURE
        if backpressure:
            # Normally the drain's interval timer does the work — waking
            # it per append would context-switch every result and
            # serialize the "batched" writes. Only a large backlog
            # forces an early drain.
            self._drain_wake.set()
        _APPENDS.inc()

    def append_durable(self, kind: str, fields: dict[str, Any]) -> None:
        """Scheduling-class append: encoded and written inline — the
        record reaches the kernel (survives a process kill) before this
        returns. Drains the buffer first so file order is mutation
        order. fsync stays batched."""
        buf = encode_record(kind, fields)
        with self._lock:
            self._drain_buffer_locked()
            self._write_locked(buf)
            self.records += 1
            self.since_compact += 1
        _APPENDS.inc()
        _APPEND_BYTES.inc(len(buf))
        _SIZE.set(self._size)

    def append_group(self, records: list[tuple[str, dict]]) -> None:
        """Group commit: coalesce one scheduling tick's worth
        of scheduling-class records into ONE journal record —

            {"k": "group", "n": N, "recs": [{"k": kind, ...}, ...]}

        — written with a single ``os.write`` inside one fsync boundary.
        The record-level CRC makes the group atomic on replay: a torn
        group tail drops the WHOLE tick (no partial application), which
        is safe because every sub-record describes state the planner
        only acts on after this call returns. Durability class matches
        ``append_durable`` (in the kernel before the planner dispatches;
        a machine crash can lose at most one fsync interval)."""
        if not records:
            return
        ts = time.time()
        subs = [{"k": kind, "ts": ts, **fields} for kind, fields in records]
        buf = encode_record("group", {"n": len(subs), "recs": subs}, ts=ts)
        with self._lock:
            self._drain_buffer_locked()
            self._write_locked(buf)
            self.records += 1
            # Compaction pressure tracks the coalesced content, not the
            # on-disk record count — a group of 500 app_updates is 500
            # records' worth of replay work
            self.since_compact += len(subs)
        _APPENDS.inc()
        _GROUP_COMMITS.inc()
        _GROUP_SUBRECORDS.inc(len(subs))
        _APPEND_BYTES.inc(len(buf))
        _SIZE.set(self._size)

    def _write_locked(self, buf: bytes) -> None:
        if self._fd < 0:
            # Closed (clean shutdown) — a late append must not blow up
            # the caller; the record is dropped with a trace
            logger.warning("Journal %s is closed; dropping %d byte(s)",
                           self._journal_path, len(buf))
            return
        os.write(self._fd, buf)
        self._size += len(buf)
        self._dirty = True
        self._last_append = time.monotonic()
        if self._last_append - self._last_fsync >= self.fsync_interval:
            self._fsync_locked()

    def _drain_buffer_locked(self) -> None:
        if not self._buffer:
            return
        batch, self._buffer = self._buffer, []
        parts = []
        for kind, fields, ts in batch:
            try:
                parts.append(encode_record(
                    kind, fields() if callable(fields) else fields, ts=ts))
            except Exception:  # noqa: BLE001 — one unencodable record
                # must not sink the whole batch
                logger.exception("Dropping unencodable journal record %r",
                                 kind)
        buf = b"".join(parts)
        if not buf:
            return
        try:
            self._write_locked(buf)
        except OSError:
            # Transient write failure (ENOSPC, EIO): put the batch back
            # so nothing is lost — the next drain/durable append retries
            self._buffer[:0] = batch
            raise
        _APPEND_BYTES.inc(len(buf))
        _SIZE.set(self._size)

    def _start_drain_thread_locked(self) -> None:
        self._drain_stop = False
        t = threading.Thread(target=self._drain_loop,
                             name="planner/journal-drain", daemon=True)
        self._drain_thread = t
        t.start()

    def _drain_loop(self) -> None:
        interval = max(0.005, self.fsync_interval or 0.05)
        while True:
            self._drain_wake.wait(interval)
            self._drain_wake.clear()
            try:
                with self._lock:
                    if self._fd < 0:
                        return
                    self._drain_buffer_locked()
                    if self._dirty and (time.monotonic() - self._last_fsync
                                        >= self.fsync_interval):
                        self._fsync_locked()
                    if self._drain_stop and not self._buffer:
                        return
            except Exception:  # noqa: BLE001 — the drain thread must
                # outlive transient fs errors; the failed batch was
                # re-queued and retries next interval
                logger.exception("Journal drain failed; retrying")

    def _fsync_locked(self) -> None:
        try:
            os.fsync(self._fd)
        except OSError:  # pragma: no cover — e.g. fs without fsync
            pass
        self._dirty = False
        self._last_fsync = time.monotonic()
        _FSYNCS.inc()

    def flush(self) -> None:
        with self._lock:
            self._drain_buffer_locked()
            if self._dirty:
                self._fsync_locked()

    # ------------------------------------------------------------------
    def compact(self, state: dict[str, Any]) -> None:
        """Fold the journal into a snapshot of ``state``.

        Crash-safe ordering: (1) snapshot written tmp+fsync+rename,
        stamped with the CURRENT journal (generation, offset) — a crash
        here replays snapshot + the same journal tail, idempotently;
        (2) a fresh-generation journal replaces the old one the same
        way — after which the stale snapshot offset no longer matches
        and replay starts from the fresh journal's top."""
        with self._lock:
            self._drain_buffer_locked()
            self._fsync_locked()
            body = {
                "version": 1,
                "ts": time.time(),
                "journal_generation": self.generation,
                "journal_offset": self._size,
                "records_folded": self.records,
                "state": state,
            }
            tmp = self._snapshot_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(body, f, default=str)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._snapshot_path)

            new_gen = os.urandom(GENERATION_BYTES)
            jtmp = self._journal_path + ".tmp"
            nfd = os.open(jtmp, os.O_RDWR | os.O_CREAT | os.O_TRUNC, 0o644)
            os.write(nfd, MAGIC + new_gen)
            os.fsync(nfd)
            os.replace(jtmp, self._journal_path)
            os.close(self._fd)
            self._fd = nfd
            self._generation = new_gen
            self._size = HEADER_LEN
            self.records = 0
            self.since_compact = 0
            self.compactions += 1
            self._dirty = False
            self._last_fsync = time.monotonic()
        _COMPACTIONS.inc()
        _SIZE.set(self._size)
        logger.info("Journal compacted into %s (%d records folded)",
                    self._snapshot_path, body["records_folded"])

    # ------------------------------------------------------------------
    def replay(self) -> tuple[Optional[dict], list[dict], dict]:
        """Load ``(snapshot_state, records, meta)`` from disk.

        ``snapshot_state`` is the compacted state dict (or None),
        ``records`` the valid journal records to apply after it, and
        ``meta`` describes what happened (counts, torn tail, skipped
        offset) for healthz / flight records."""
        with self._lock:
            self.flush()
            snapshot, records, meta = load_journal_dir(self.directory)
        meta["records"] = len(records)
        _REPLAYED.inc(len(records))
        return snapshot, records, meta

    # ------------------------------------------------------------------
    def stats(self) -> dict[str, Any]:
        with self._lock:
            now = time.monotonic()
            return {
                "enabled": True,
                "directory": self.directory,
                "sizeBytes": self._size,
                "records": self.records,
                "bufferedRecords": len(self._buffer),
                "sinceCompactRecords": self.since_compact,
                "compactions": self.compactions,
                "generation": self.generation,
                "dirty": self._dirty,
                "lastFsyncAgeSeconds": round(now - self._last_fsync, 3),
                "fsyncIntervalSeconds": self.fsync_interval,
                "compactThresholdRecords": self.compact_records,
            }

    def close(self) -> None:
        with self._lock:
            if self._fd < 0:
                return
            self._drain_stop = True
            self._drain_buffer_locked()
            if self._dirty:
                self._fsync_locked()
            os.close(self._fd)
            self._fd = -1
        self._drain_wake.set()  # unblock the drain thread so it exits


# ---------------------------------------------------------------------------
def load_journal_dir(directory: str
                     ) -> tuple[Optional[dict], list[dict], dict]:
    """Read a journal directory without opening it for append (shared by
    ``PlannerJournal.replay`` and the journaldump CLI).

    Returns ``(snapshot_state, records, meta)``."""
    snapshot_path = os.path.join(directory, SNAPSHOT_FILE)
    journal_path = os.path.join(directory, JOURNAL_FILE)

    snapshot_state = None
    snap_gen, snap_offset = "", HEADER_LEN
    meta: dict[str, Any] = {"snapshot": False, "torn": False,
                            "skipped_bytes": 0}
    try:
        with open(snapshot_path) as f:
            snap = json.load(f)
        snapshot_state = snap.get("state") or {}
        snap_gen = snap.get("journal_generation", "")
        snap_offset = int(snap.get("journal_offset", HEADER_LEN))
        meta["snapshot"] = True
        meta["snapshot_ts"] = snap.get("ts")
        meta["records_folded"] = snap.get("records_folded", 0)
    except FileNotFoundError:
        pass
    except (OSError, ValueError) as e:
        # A corrupt snapshot plus an intact journal cannot be safely
        # combined (the journal tail assumes the snapshot's state) —
        # surface loudly, recover nothing from the snapshot
        logger.error("Journal snapshot %s unreadable: %s", snapshot_path, e)
        meta["snapshot_error"] = str(e)

    records: list[dict[str, Any]] = []
    try:
        with open(journal_path, "rb") as f:
            data = f.read()
    except FileNotFoundError:
        return snapshot_state, records, meta
    if not data:
        return snapshot_state, records, meta
    if len(data) < HEADER_LEN or data[:len(MAGIC)] != MAGIC:
        raise JournalCorrupt(f"{journal_path}: bad magic/header")
    generation = data[len(MAGIC):HEADER_LEN].hex()
    start = HEADER_LEN
    if snapshot_state is not None and snap_gen == generation:
        # Crash between the two compaction renames: the snapshot already
        # folds the journal up to its recorded offset
        start = min(max(snap_offset, HEADER_LEN), len(data))
        meta["skipped_bytes"] = start - HEADER_LEN
    records, valid_end, torn = decode_records(data, start)
    meta["torn"] = torn
    meta["torn_bytes"] = len(data) - valid_end if torn else 0
    meta["generation"] = generation
    return snapshot_state, records, meta


def open_planner_journal(directory: str | None = None
                         ) -> PlannerJournal | NullJournal:
    """The planner's journal per config: a real journal when
    ``FAABRIC_PLANNER_JOURNAL_DIR`` (or ``directory``) names a path,
    otherwise the shared no-op."""
    from faabric_tpu_torch.util.config import get_system_config

    conf = get_system_config()
    d = directory if directory is not None else conf.planner_journal_dir
    if not d:
        return NULL_JOURNAL
    return PlannerJournal(
        d, fsync_interval=conf.planner_journal_fsync_interval,
        compact_records=conf.planner_journal_compact_records)
