"""MPI semantics over the point-to-point broker (single host)."""

from faabric_tpu_torch.mpi.schedule import (
    Schedule,
    ScheduleCache,
    ScheduleError,
    ScheduleVerificationError,
    verify_schedule,
)
from faabric_tpu_torch.mpi.topology import Topology
from faabric_tpu_torch.mpi.types import (
    MpiMessageType,
    MpiOp,
    MpiStatus,
    UserOp,
    apply_op,
)
from faabric_tpu_torch.mpi.world import MAIN_RANK, MpiWorld, MpiWorldAborted

__all__ = [
    "MAIN_RANK",
    "MpiMessageType",
    "MpiOp",
    "MpiStatus",
    "MpiWorld",
    "MpiWorldAborted",
    "Schedule",
    "ScheduleCache",
    "ScheduleError",
    "ScheduleVerificationError",
    "Topology",
    "UserOp",
    "apply_op",
    "verify_schedule",
]
