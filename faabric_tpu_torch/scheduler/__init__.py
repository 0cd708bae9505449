"""Per-host scheduler and function-call RPC (reference src/scheduler)."""

from faabric_tpu_torch.scheduler.function_call import (
    FunctionCallClient,
    FunctionCalls,
    FunctionCallServer,
    clear_mock_requests,
    get_batch_requests,
    get_message_results,
)
from faabric_tpu_torch.scheduler.scheduler import Scheduler

__all__ = [
    "FunctionCallClient",
    "FunctionCallServer",
    "FunctionCalls",
    "Scheduler",
    "clear_mock_requests",
    "get_batch_requests",
    "get_message_results",
]
