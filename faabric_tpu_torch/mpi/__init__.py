"""MPI semantics over the point-to-point broker (reference src/mpi).

Exports what ``faabric_tpu/mpi/__init__.py`` exports. The int8 link of
the leader ring is ``mpi/quant.py``, which ``MpiWorld.allreduce_quant``
selects."""

from faabric_tpu_torch.mpi.types import (
    MpiDataType,
    MpiMessageType,
    MpiOp,
    MpiStatus,
    UserOp,
    apply_op,
    mpi_dtype_for,
    np_dtype_for,
)
from faabric_tpu_torch.mpi.schedule import (
    Schedule,
    ScheduleCache,
    ScheduleError,
    ScheduleVerificationError,
    verify_schedule,
)
from faabric_tpu_torch.mpi.topology import Topology
from faabric_tpu_torch.mpi.window import MpiWindow
from faabric_tpu_torch.mpi.world import MAIN_RANK, MpiWorld, MpiWorldAborted
from faabric_tpu_torch.mpi.registry import (
    MpiContext,
    MpiWorldRegistry,
    get_mpi_context,
)

__all__ = [
    "MAIN_RANK",
    "MpiContext",
    "MpiDataType",
    "MpiMessageType",
    "MpiOp",
    "MpiStatus",
    "MpiWindow",
    "MpiWorld",
    "MpiWorldAborted",
    "MpiWorldRegistry",
    "Schedule",
    "ScheduleCache",
    "ScheduleError",
    "ScheduleVerificationError",
    "Topology",
    "verify_schedule",
    "UserOp",
    "apply_op",
    "get_mpi_context",
    "mpi_dtype_for",
    "np_dtype_for",
]
