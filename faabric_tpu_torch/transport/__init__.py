from faabric_tpu_torch.transport.client import MessageEndpointClient, RpcError
from faabric_tpu_torch.transport.common import (
    FUNCTION_CALL_ASYNC_PORT,
    FUNCTION_CALL_SYNC_PORT,
    MPI_BASE_PORT,
    PLANNER_ASYNC_PORT,
    PLANNER_SYNC_PORT,
    POINT_TO_POINT_ASYNC_PORT,
    POINT_TO_POINT_SYNC_PORT,
    SNAPSHOT_ASYNC_PORT,
    SNAPSHOT_SYNC_PORT,
    STATE_ASYNC_PORT,
    STATE_SYNC_PORT,
    clear_host_aliases,
    register_host_alias,
    unregister_host_alias,
    resolve_host,
)
from faabric_tpu_torch.transport.message import (
    MessageResponseCode,
    TransportMessage,
)
from faabric_tpu_torch.transport.point_to_point import (
    POINT_TO_POINT_MAIN_IDX,
    GroupAbortedError,
    PointToPointBroker,
    PointToPointGroup,
    mappings_from_decision,
)
from faabric_tpu_torch.transport.ptp_remote import (
    PointToPointClient,
    PointToPointServer,
    send_mappings_from_decision,
)
from faabric_tpu_torch.transport.server import MessageEndpointServer

__all__ = [
    "FUNCTION_CALL_ASYNC_PORT",
    "FUNCTION_CALL_SYNC_PORT",
    "GroupAbortedError",
    "MPI_BASE_PORT",
    "MessageEndpointClient",
    "MessageEndpointServer",
    "MessageResponseCode",
    "PLANNER_ASYNC_PORT",
    "PLANNER_SYNC_PORT",
    "POINT_TO_POINT_ASYNC_PORT",
    "POINT_TO_POINT_MAIN_IDX",
    "POINT_TO_POINT_SYNC_PORT",
    "PointToPointBroker",
    "PointToPointClient",
    "PointToPointGroup",
    "PointToPointServer",
    "RpcError",
    "SNAPSHOT_ASYNC_PORT",
    "SNAPSHOT_SYNC_PORT",
    "STATE_ASYNC_PORT",
    "STATE_SYNC_PORT",
    "TransportMessage",
    "clear_host_aliases",
    "mappings_from_decision",
    "register_host_alias",
    "unregister_host_alias",
    "resolve_host",
    "send_mappings_from_decision",
]
