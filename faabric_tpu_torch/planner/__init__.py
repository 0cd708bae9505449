"""Cluster control plane (reference src/planner)."""

from faabric_tpu_torch.planner.planner import Planner, PlannerHost, get_planner
from faabric_tpu_torch.planner.server import PlannerCalls, PlannerServer
from faabric_tpu_torch.planner.client import (
    PlannerClient,
    clear_mock_planner_calls,
    get_mock_batch_calls,
    get_mock_set_results,
)

__all__ = [
    "Planner",
    "PlannerCalls",
    "PlannerClient",
    "PlannerHost",
    "PlannerServer",
    "clear_mock_planner_calls",
    "get_mock_batch_calls",
    "get_mock_set_results",
    "get_planner",
]
