from faabric_tpu_torch.transport.point_to_point import (
    GroupAbortedError,
    PointToPointBroker,
)

__all__ = ["GroupAbortedError", "PointToPointBroker"]
