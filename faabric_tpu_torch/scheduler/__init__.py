"""Per-host scheduler, function-call RPC and chaining (reference
src/scheduler)."""

from faabric_tpu_torch.scheduler.chain import await_chained, chain_function
from faabric_tpu_torch.scheduler.function_call import (
    FunctionCallClient,
    FunctionCalls,
    FunctionCallServer,
    clear_mock_requests,
    get_batch_requests,
    get_flush_calls,
    get_message_results,
)
from faabric_tpu_torch.scheduler.scheduler import Scheduler

__all__ = [
    "FunctionCallClient",
    "FunctionCallServer",
    "FunctionCalls",
    "Scheduler",
    "await_chained",
    "chain_function",
    "clear_mock_requests",
    "get_batch_requests",
    "get_flush_calls",
    "get_message_results",
]
