"""The planner's REST endpoint and the workers' HTTP endpoint.

Counterpart of ``faabric_tpu/endpoint/`` (reference src/endpoint and
PlannerEndpointHandler).
"""

from faabric_tpu_torch.endpoint.http_server import (
    HttpMessageType,
    PlannerHttpEndpoint,
)
from faabric_tpu_torch.endpoint.worker_endpoint import WorkerHttpEndpoint

__all__ = ["HttpMessageType", "PlannerHttpEndpoint", "WorkerHttpEndpoint"]
