"""Scheduling decisions.

Counterpart of ``faabric_tpu/batch_scheduler/decision.py``
(``SchedulingDecision`` :23): a set of parallel per-message vectors
(host, message id, app idx, group idx, MPI port) with a per-message
**device id**, the card of the chosen host a gang-scheduled rank is
pinned to. An MPI world reads each rank's device from it through the
point-to-point mappings.
"""

from __future__ import annotations

import dataclasses


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

    @property
    def n_messages(self) -> int:
        return len(self.hosts)

    def add_message(self, host: str, message_id: int, app_idx: int,
                    group_idx: int, mpi_port: int = 0,
                    device_id: int = -1) -> None:
        self.hosts.append(host)
        self.message_ids.append(message_id)
        self.app_idxs.append(app_idx)
        self.group_idxs.append(group_idx)
        self.mpi_ports.append(mpi_port)
        self.device_ids.append(device_id)

    def unique_hosts(self) -> list[str]:
        return list(dict.fromkeys(self.hosts))

    def topology(self):
        """The placement's Topology (mpi/topology.py): group idx (the MPI
        rank of gang-scheduled worlds) → host, with the device ids."""
        from faabric_tpu_torch.mpi.topology import Topology

        return Topology.from_decision(self)
