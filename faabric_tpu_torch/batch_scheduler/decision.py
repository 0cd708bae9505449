"""Scheduling decisions.

Counterpart of ``faabric_tpu/batch_scheduler/decision.py``
(``SchedulingDecision`` :23): a set of parallel per-message vectors
(host, message id, app idx, group idx, MPI port) with a per-message
**device id**, the card of the chosen host a gang-scheduled rank is
pinned to. An MPI world reads each rank's device from it through the
point-to-point mappings. The sentinel decisions (``NOT_ENOUGH_SLOTS``,
``MUST_FREEZE``, ``DO_NOT_MIGRATE``) carry a policy's verdict instead of
a placement, and ``to_dict``/``from_dict`` are the wire form.
"""

from __future__ import annotations

import dataclasses
from typing import Any

# Sentinel app/group ids (reference BatchScheduler.h:8-19)
DO_NOT_MIGRATE = -98
NOT_ENOUGH_SLOTS = -99
MUST_FREEZE = -97


@dataclasses.dataclass
class SchedulingDecision:
    app_id: int
    group_id: int = 0

    hosts: list[str] = dataclasses.field(default_factory=list)
    message_ids: list[int] = dataclasses.field(default_factory=list)
    app_idxs: list[int] = dataclasses.field(default_factory=list)
    group_idxs: list[int] = dataclasses.field(default_factory=list)
    mpi_ports: list[int] = dataclasses.field(default_factory=list)
    device_ids: list[int] = dataclasses.field(default_factory=list)

    # ------------------------------------------------------------------
    @property
    def n_messages(self) -> int:
        return len(self.hosts)

    def is_single_host(self) -> bool:
        return len(set(self.hosts)) <= 1

    def clone(self) -> "SchedulingDecision":
        """Independent snapshot of the placement vectors. The planner
        keeps mutating ITS copy as results land (remove_message), so
        anything handed to a caller must be detached first."""
        return SchedulingDecision(
            app_id=self.app_id, group_id=self.group_id,
            hosts=list(self.hosts), message_ids=list(self.message_ids),
            app_idxs=list(self.app_idxs), group_idxs=list(self.group_idxs),
            mpi_ports=list(self.mpi_ports),
            device_ids=list(self.device_ids))

    def unique_hosts(self) -> list[str]:
        seen: dict[str, None] = {}
        for h in self.hosts:
            seen.setdefault(h)
        return list(seen)

    def add_message(self, host: str, message_id: int, app_idx: int,
                    group_idx: int, mpi_port: int = 0, device_id: int = -1) -> None:
        self.hosts.append(host)
        self.message_ids.append(message_id)
        self.app_idxs.append(app_idx)
        self.group_idxs.append(group_idx)
        self.mpi_ports.append(mpi_port)
        self.device_ids.append(device_id)

    def add_message_in_position(self, idx: int, host: str, message_id: int,
                                app_idx: int, group_idx: int,
                                mpi_port: int = 0, device_id: int = -1) -> None:
        """Place a message at a fixed index, growing with empty slots as
        needed (reference SchedulingDecision.h addMessageInPosition)."""
        while self.n_messages <= idx:
            self.add_message("", 0, 0, 0, 0, -1)
        self.hosts[idx] = host
        self.message_ids[idx] = message_id
        self.app_idxs[idx] = app_idx
        self.group_idxs[idx] = group_idx
        self.mpi_ports[idx] = mpi_port
        self.device_ids[idx] = device_id

    def remove_message(self, message_id: int) -> None:
        try:
            i = self.message_ids.index(message_id)
        except ValueError:
            return
        for vec in (self.hosts, self.message_ids, self.app_idxs,
                    self.group_idxs, self.mpi_ports, self.device_ids):
            del vec[i]

    def host_for_idx(self, group_idx: int) -> str:
        i = self.group_idxs.index(group_idx)
        return self.hosts[i]

    def host_freq_count(self) -> dict[str, int]:
        freq: dict[str, int] = {}
        for h in self.hosts:
            freq[h] = freq.get(h, 0) + 1
        return freq

    def topology(self):
        """The placement's Topology (mpi/topology.py): group idx (the
        MPI rank of gang-scheduled worlds) → host, with the device ids.
        Bin-pack scores locality on it."""
        from faabric_tpu_torch.mpi.topology import Topology

        return Topology.from_decision(self)

    # ------------------------------------------------------------------
    def to_dict(self) -> dict[str, Any]:
        # Hand-rolled (parallel-vector copies): dataclasses.asdict
        # deep-copies recursively and this rides every CALL_BATCH response
        return {
            "app_id": self.app_id,
            "group_id": self.group_id,
            "hosts": list(self.hosts),
            "message_ids": list(self.message_ids),
            "app_idxs": list(self.app_idxs),
            "group_idxs": list(self.group_idxs),
            "mpi_ports": list(self.mpi_ports),
            "device_ids": list(self.device_ids),
        }

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "SchedulingDecision":
        out = cls(app_id=d.get("app_id", 0), group_id=d.get("group_id", 0))
        out.hosts = list(d.get("hosts", []))
        out.message_ids = list(d.get("message_ids", []))
        out.app_idxs = list(d.get("app_idxs", []))
        out.group_idxs = list(d.get("group_idxs", []))
        out.mpi_ports = list(d.get("mpi_ports", []))
        out.device_ids = list(d.get("device_ids", []))
        return out

    @classmethod
    def from_point_to_point_mappings(cls, mappings: "Any") -> "SchedulingDecision":
        """Rebuild a decision from distributed PTP mappings (reference
        SchedulingDecision::fromPointToPointMappings)."""
        out = cls(app_id=mappings.app_id, group_id=mappings.group_id)
        for m in mappings.mappings:
            out.add_message(m.host, m.message_id, m.app_idx, m.group_idx,
                            m.mpi_port,
                            m.device_ids[0] if m.device_ids else -1)
        return out


def do_not_migrate_decision() -> SchedulingDecision:
    return SchedulingDecision(DO_NOT_MIGRATE, DO_NOT_MIGRATE)


def not_enough_slots_decision() -> SchedulingDecision:
    return SchedulingDecision(NOT_ENOUGH_SLOTS, NOT_ENOUGH_SLOTS)


def must_freeze_decision() -> SchedulingDecision:
    return SchedulingDecision(MUST_FREEZE, MUST_FREEZE)


def is_sentinel_decision(decision: SchedulingDecision) -> bool:
    return decision.app_id in (DO_NOT_MIGRATE, NOT_ENOUGH_SLOTS, MUST_FREEZE)
