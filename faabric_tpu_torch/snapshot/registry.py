"""Snapshot registry: key -> SnapshotData, one a host.

Counterpart of ``faabric_tpu/snapshot/registry.py`` (reference
include/faabric/snapshot/SnapshotRegistry.h:13-44). Every change of
the table sets the state ledger's residency gauge (the bytes of the
registered images).
"""

from __future__ import annotations

import threading
from typing import Optional

from faabric_tpu_torch.snapshot.snapshot import SnapshotData
from faabric_tpu_torch.telemetry.statestats import get_state_stats


class SnapshotRegistry:
    # Concurrency contract: one lock covers the table
    GUARDS = {
        "_snapshots": "_lock",
    }

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._snapshots: dict[str, SnapshotData] = {}

    def register_snapshot(self, key: str, snap: SnapshotData) -> None:
        if not key:
            raise ValueError("Empty snapshot key")
        with self._lock:
            self._snapshots[key] = snap
        self._note_residency()

    def get_snapshot(self, key: str) -> SnapshotData:
        with self._lock:
            snap = self._snapshots.get(key)
        if snap is None:
            raise KeyError(f"No snapshot registered for key {key}")
        return snap

    def try_get_snapshot(self, key: str) -> Optional[SnapshotData]:
        with self._lock:
            return self._snapshots.get(key)

    def snapshot_exists(self, key: str) -> bool:
        with self._lock:
            return key in self._snapshots

    def delete_snapshot(self, key: str) -> None:
        with self._lock:
            self._snapshots.pop(key, None)
        self._note_residency()

    def get_snapshot_count(self) -> int:
        with self._lock:
            return len(self._snapshots)

    def resident_bytes(self) -> int:
        """Total bytes of the registered snapshot images."""
        with self._lock:
            snaps = list(self._snapshots.values())
        return sum(s.size for s in snaps)

    def clear(self) -> None:
        with self._lock:
            self._snapshots.clear()
        self._note_residency()

    def _note_residency(self) -> None:
        stats = get_state_stats()
        if stats.enabled:
            stats.set_registry_bytes(self.resident_bytes())
