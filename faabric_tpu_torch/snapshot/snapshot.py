"""Snapshots with typed merge regions and diffs over dirty pages.

Counterpart of ``faabric_tpu/snapshot/snapshot.py`` (reference
include/faabric/util/snapshot.h:27-345, src/util/snapshot.cpp). A
snapshot is a byte image of executor memory plus **merge regions** that
say how concurrent writers reconcile: bytewise overwrite, arithmetic
merges (sum, product, subtract, max, min over int, long, float and
double values), XOR, or ignore.

Diffing walks the dirty pages (``util/dirty.py``) through the merge
regions: an arithmetic region emits elementwise deltas (a Sum region's
diff is ``updated - original``, so applying it adds the writer's
contribution), and bytewise gaps emit the changed byte ranges at the
128-byte chunks of the reference (snapshot.h:18-21), with the native
range scanner where it loads.

Images are host numpy buffers. A tensor on the card is diffed on the
card by ``snapshot/device_snapshot.py``, whose diffs queue onto a host
snapshot with the same offsets. Diffs, applied diffs and restores are
``diff``/``apply``/``restore`` events of the state ledger
(``telemetry/statestats.py``), as the reference's.
"""

from __future__ import annotations

import dataclasses
import enum
import threading
import time
from typing import Iterable, Optional

import numpy as np

from faabric_tpu_torch.telemetry.statestats import get_state_stats
from faabric_tpu_torch.util.dirty import PAGE_SIZE
from faabric_tpu_torch.util.logging import get_logger

logger = get_logger(__name__)

# Byte-chunk granularity for bytewise diffs (reference snapshot.h:18-21)
DIFF_CHUNK = 128


class SnapshotDataType(enum.IntEnum):
    RAW = 0
    BOOL = 1
    INT = 2
    LONG = 3
    FLOAT = 4
    DOUBLE = 5


_NP_TYPES = {
    SnapshotDataType.BOOL: np.dtype(np.uint8),
    SnapshotDataType.INT: np.dtype(np.int32),
    SnapshotDataType.LONG: np.dtype(np.int64),
    SnapshotDataType.FLOAT: np.dtype(np.float32),
    SnapshotDataType.DOUBLE: np.dtype(np.float64),
}


class SnapshotMergeOperation(enum.IntEnum):
    BYTEWISE = 0
    SUM = 1
    PRODUCT = 2
    SUBTRACT = 3
    MAX = 4
    MIN = 5
    IGNORE = 6
    XOR = 7


@dataclasses.dataclass(frozen=True)
class MergeRegion:
    offset: int
    length: int
    data_type: SnapshotDataType = SnapshotDataType.RAW
    operation: SnapshotMergeOperation = SnapshotMergeOperation.BYTEWISE

    @property
    def end(self) -> int:
        return self.offset + self.length

    def to_dict(self) -> dict:
        return {"offset": self.offset, "length": self.length,
                "data_type": int(self.data_type),
                "operation": int(self.operation)}

    @classmethod
    def from_dict(cls, d: dict) -> "MergeRegion":
        return cls(d["offset"], d["length"],
                   SnapshotDataType(d.get("data_type", 0)),
                   SnapshotMergeOperation(d.get("operation", 0)))


@dataclasses.dataclass
class SnapshotDiff:
    offset: int
    data: bytes
    data_type: SnapshotDataType = SnapshotDataType.RAW
    operation: SnapshotMergeOperation = SnapshotMergeOperation.BYTEWISE

    def to_dict(self) -> dict:
        # data rides the RPC binary tail, keyed by length
        return {"offset": self.offset, "length": len(self.data),
                "data_type": int(self.data_type),
                "operation": int(self.operation)}


class SnapshotData:
    def __init__(self, data: bytes | bytearray | np.ndarray | int,
                 max_size: int = 0) -> None:
        if isinstance(data, int):
            self._data = np.zeros(data, dtype=np.uint8)
        elif isinstance(data, np.ndarray):
            # One copy of the array's bytes in C order
            self._data = np.ascontiguousarray(data).reshape(-1).view(
                np.uint8).copy()
        else:
            self._data = np.frombuffer(data, dtype=np.uint8).copy()
        self.max_size = max(max_size, self._data.size)
        self._lock = threading.RLock()
        self._merge_regions: list[MergeRegion] = []
        self._queued_diffs: list[SnapshotDiff] = []

    # ------------------------------------------------------------------
    @property
    def size(self) -> int:
        return self._data.size

    @property
    def data(self) -> np.ndarray:
        return self._data

    def to_bytes(self) -> bytes:
        return self._data.tobytes()

    def resize(self, new_size: int) -> None:
        if new_size > self.max_size:
            raise ValueError(f"Snapshot resize {new_size} > max {self.max_size}")
        with self._lock:
            if new_size > self._data.size:
                self._data = np.concatenate(
                    [self._data,
                     np.zeros(new_size - self._data.size, np.uint8)])
            else:
                self._data = self._data[:new_size].copy()

    # ------------------------------------------------------------------
    # Merge regions
    # ------------------------------------------------------------------
    def add_merge_region(self, offset: int, length: int,
                         data_type: SnapshotDataType = SnapshotDataType.RAW,
                         operation: SnapshotMergeOperation =
                         SnapshotMergeOperation.BYTEWISE) -> None:
        if operation != SnapshotMergeOperation.BYTEWISE \
                and operation != SnapshotMergeOperation.IGNORE \
                and operation != SnapshotMergeOperation.XOR:
            width = _NP_TYPES[data_type].itemsize
            if length % width != 0:
                raise ValueError(
                    f"Merge region length {length} not a multiple of "
                    f"{data_type.name} width {width}")
        with self._lock:
            self._merge_regions.append(MergeRegion(offset, length,
                                                   data_type, operation))
            self._merge_regions.sort(key=lambda r: r.offset)

    def get_merge_regions(self) -> list[MergeRegion]:
        with self._lock:
            return list(self._merge_regions)

    def clear_merge_regions(self) -> None:
        with self._lock:
            self._merge_regions.clear()

    def fill_gaps_with_bytewise_regions(self) -> None:
        """Cover the whole image: unclaimed ranges become bytewise regions
        (reference fillGapsWithBytewiseRegions)."""
        with self._lock:
            regions = sorted(self._merge_regions, key=lambda r: r.offset)
            gaps: list[MergeRegion] = []
            cursor = 0
            for r in regions:
                if r.offset > cursor:
                    gaps.append(MergeRegion(cursor, r.offset - cursor))
                cursor = max(cursor, r.end)
            if cursor < self.size:
                gaps.append(MergeRegion(cursor, self.size - cursor))
            self._merge_regions.extend(gaps)
            self._merge_regions.sort(key=lambda r: r.offset)

    # ------------------------------------------------------------------
    # Diffing
    # ------------------------------------------------------------------
    def diff_with_dirty_regions(self, mem, dirty_pages: np.ndarray
                                ) -> list[SnapshotDiff]:
        """Diff updated memory against this snapshot over the dirty pages,
        honouring merge regions (reference diffWithDirtyRegions)."""
        stats = get_state_stats()
        t0 = time.perf_counter() if stats.enabled else 0.0
        cur = np.frombuffer(mem, dtype=np.uint8)
        diffs: list[SnapshotDiff] = []
        if not dirty_pages.any():
            return diffs

        # Dirty byte ranges from page flags, over the FULL current memory
        # (writes beyond the snapshot's size become extension diffs)
        dirty_ranges = _pages_to_ranges(dirty_pages, cur.size)

        with self._lock:
            regions = list(self._merge_regions)
        if not regions:
            regions = [MergeRegion(0, self.size)]

        # Memory grown past the snapshot: emit the dirty part of the
        # extension as raw bytewise data (reference diffWithDirtyRegions
        # emits the extended region explicitly)
        if cur.size > self.size:
            for start, end in dirty_ranges:
                lo = max(start, self.size)
                if lo < end:
                    diffs.append(SnapshotDiff(lo, cur[lo:end].tobytes()))

        # An arithmetic region's delta covers the whole region: it is
        # computed once, where the first dirty range meets the region,
        # not once for each of the (possibly thousands of) ranges
        arith_done: set[tuple[int, int]] = set()
        for start, end in dirty_ranges:
            end = min(end, self.size)
            for region in regions:
                lo = max(start, region.offset)
                hi = min(end, region.end)
                if lo >= hi:
                    continue
                op = region.operation
                if op == SnapshotMergeOperation.IGNORE:
                    continue
                if op == SnapshotMergeOperation.BYTEWISE:
                    diffs.extend(self._bytewise_diffs(cur, lo, hi))
                elif op == SnapshotMergeOperation.XOR:
                    old = self._data[lo:hi]
                    new = cur[lo:hi]
                    if not np.array_equal(old, new):
                        diffs.append(SnapshotDiff(
                            lo, np.bitwise_xor(old, new).tobytes(),
                            region.data_type, op))
                elif (region.offset, int(op)) not in arith_done:
                    # Arithmetic region: align to the region's value grid
                    # and emit an elementwise delta for the whole region
                    arith_done.add((region.offset, int(op)))
                    d = self._arith_diff(cur, region)
                    if d is not None:
                        diffs.append(d)
        if stats.enabled:
            stats.snapshot_event(
                "diff", nbytes=sum(len(d.data) for d in diffs),
                pages=int(dirty_pages.sum()), regions=len(regions),
                seconds=time.perf_counter() - t0)
        return diffs

    def _bytewise_diffs(self, cur: np.ndarray, lo: int, hi: int
                        ) -> Iterable[SnapshotDiff]:
        from faabric_tpu_torch.util.native import get_pagediff_lib

        old = np.ascontiguousarray(self._data[lo:hi])
        new = np.ascontiguousarray(cur[lo:hi])
        length = hi - lo
        lib = get_pagediff_lib()
        out = []
        if lib is not None:
            max_ranges = max(4, length // DIFF_CHUNK + 1)
            starts = np.zeros(max_ranges, dtype=np.uintp)
            lengths = np.zeros(max_ranges, dtype=np.uintp)
            n = lib.diff_ranges(old.ctypes.data, new.ctypes.data, length,
                                DIFF_CHUNK, starts.ctypes.data,
                                lengths.ctypes.data, max_ranges)
            for i in range(n):
                s, l = int(starts[i]), int(lengths[i])
                out.append(SnapshotDiff(lo + s, new[s:s + l].tobytes()))
            return out
        # numpy fallback: chunked compare
        n_chunks = (length + DIFF_CHUNK - 1) // DIFF_CHUNK
        run_start = None
        for c in range(n_chunks + 1):
            s = c * DIFF_CHUNK
            e = min(length, s + DIFF_CHUNK)
            differs = (c < n_chunks
                       and not np.array_equal(old[s:e], new[s:e]))
            if differs and run_start is None:
                run_start = s
            elif not differs and run_start is not None:
                out.append(SnapshotDiff(lo + run_start,
                                        new[run_start:s].tobytes()))
                run_start = None
        return out

    def _arith_diff(self, cur: np.ndarray,
                    region: MergeRegion) -> Optional[SnapshotDiff]:
        dtype = _NP_TYPES[region.data_type]
        lo, hi = region.offset, min(region.end, cur.size, self.size)
        old = self._data[lo:hi].view(dtype)
        new = cur[lo:hi].view(dtype)
        if np.array_equal(old, new):
            return None
        op = region.operation
        if op == SnapshotMergeOperation.SUM:
            delta = new - old
        elif op == SnapshotMergeOperation.SUBTRACT:
            delta = old - new
        elif op == SnapshotMergeOperation.PRODUCT:
            with np.errstate(divide="ignore", invalid="ignore"):
                delta = np.where(old != 0, new / old, new).astype(dtype)
        elif op in (SnapshotMergeOperation.MAX, SnapshotMergeOperation.MIN):
            delta = new
        else:
            raise ValueError(f"Unsupported arithmetic op {op}")
        return SnapshotDiff(lo, np.ascontiguousarray(delta).tobytes(),
                            region.data_type, op)

    # ------------------------------------------------------------------
    # Applying / queueing
    # ------------------------------------------------------------------
    def apply_diff(self, diff: SnapshotDiff) -> None:
        with self._lock:
            lo = diff.offset
            hi = lo + len(diff.data)
            if hi > self._data.size:
                # Extension diffs (memory grown mid-batch) may exceed the
                # declared max; growth wins over a stale bound
                self.max_size = max(self.max_size, hi)
                self.resize(hi)
            op = diff.operation
            if op == SnapshotMergeOperation.BYTEWISE:
                self._data[lo:hi] = np.frombuffer(diff.data, np.uint8)
                return
            if op == SnapshotMergeOperation.XOR:
                self._data[lo:hi] = np.bitwise_xor(
                    self._data[lo:hi], np.frombuffer(diff.data, np.uint8))
                return
            dtype = _NP_TYPES[diff.data_type]
            target = self._data[lo:hi].view(dtype)
            value = np.frombuffer(diff.data, dtype)
            if op == SnapshotMergeOperation.SUM:
                target += value
            elif op == SnapshotMergeOperation.SUBTRACT:
                target -= value
            elif op == SnapshotMergeOperation.PRODUCT:
                np.multiply(target, value, out=target,
                            casting="unsafe")
            elif op == SnapshotMergeOperation.MAX:
                np.maximum(target, value, out=target)
            elif op == SnapshotMergeOperation.MIN:
                np.minimum(target, value, out=target)
            else:
                raise ValueError(f"Unsupported diff op {op}")

    def queue_diffs(self, diffs: Iterable[SnapshotDiff]) -> None:
        with self._lock:
            self._queued_diffs.extend(diffs)

    def queued_diff_count(self) -> int:
        with self._lock:
            return len(self._queued_diffs)

    def write_queued_diffs(self) -> int:
        """Apply (and drain) queued diffs; returns how many applied
        (reference writeQueuedDiffs)."""
        stats = get_state_stats()
        t0 = time.perf_counter() if stats.enabled else 0.0
        with self._lock:
            diffs = self._queued_diffs
            self._queued_diffs = []
        for d in diffs:
            self.apply_diff(d)
        if stats.enabled and diffs:
            stats.snapshot_event(
                "apply", nbytes=sum(len(d.data) for d in diffs),
                regions=len(diffs), seconds=time.perf_counter() - t0)
        return len(diffs)

    # ------------------------------------------------------------------
    def map_to_memory(self, mem) -> None:
        """Restore: copy the snapshot image into executor memory
        (reference mapToMemory — there MAP_PRIVATE; here a copy)."""
        stats = get_state_stats()
        t0 = time.perf_counter() if stats.enabled else 0.0
        dst = np.frombuffer(mem, dtype=np.uint8)
        if dst.size < self.size:
            raise ValueError(
                f"Target memory {dst.size} smaller than snapshot {self.size}")
        dst[:self.size] = self._data
        dst[self.size:] = 0
        if stats.enabled:
            stats.snapshot_event("restore", nbytes=self.size,
                                 seconds=time.perf_counter() - t0)


def _pages_to_ranges(flags: np.ndarray, limit: int) -> list[tuple[int, int]]:
    """Collapse page flags into contiguous byte ranges (one numpy pass)."""
    edges = np.flatnonzero(np.diff(np.concatenate(
        ([False], np.asarray(flags, dtype=bool), [False]))))
    return [(int(a) * PAGE_SIZE, min(int(b) * PAGE_SIZE, limit))
            for a, b in zip(edges[::2], edges[1::2])]
