"""Snapshots: typed merge regions, dirty diffs, the registry and the RPC
(reference src/snapshot and src/util/snapshot.cpp).

Counterpart of ``faabric_tpu/snapshot/``, with the same exports.
"""

from faabric_tpu_torch.snapshot.snapshot import (
    DIFF_CHUNK,
    MergeRegion,
    SnapshotData,
    SnapshotDataType,
    SnapshotDiff,
    SnapshotMergeOperation,
)
from faabric_tpu_torch.snapshot.device_snapshot import (
    DEVICE_PAGE_SIZE,
    DeviceSnapshot,
)
from faabric_tpu_torch.snapshot.registry import SnapshotRegistry
from faabric_tpu_torch.snapshot.remote import (
    SnapshotCalls,
    SnapshotClient,
    SnapshotServer,
    clear_mock_snapshot_requests,
    get_mock_thread_results,
    get_snapshot_diff_pushes,
    get_snapshot_pushes,
)

__all__ = [
    "DEVICE_PAGE_SIZE",
    "DIFF_CHUNK",
    "DeviceSnapshot",
    "MergeRegion",
    "SnapshotCalls",
    "SnapshotClient",
    "SnapshotData",
    "SnapshotDataType",
    "SnapshotDiff",
    "SnapshotMergeOperation",
    "SnapshotRegistry",
    "SnapshotServer",
    "clear_mock_snapshot_requests",
    "get_mock_thread_results",
    "get_snapshot_diff_pushes",
    "get_snapshot_pushes",
]
