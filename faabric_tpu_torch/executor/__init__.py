"""Pluggable executor engine (reference src/executor)."""

from faabric_tpu_torch.executor.context import ExecutorContext
from faabric_tpu_torch.executor.executor import Executor, ExecutorTask
from faabric_tpu_torch.executor.factory import (
    ExecutorFactory,
    get_executor_factory,
    set_executor_factory,
)
from faabric_tpu_torch.executor.torch_executor import (
    GuestContext,
    TorchExecutor,
    TorchExecutorFactory,
    clear_registered_functions,
    register_function,
)

__all__ = [
    "Executor",
    "ExecutorContext",
    "ExecutorFactory",
    "ExecutorTask",
    "GuestContext",
    "TorchExecutor",
    "TorchExecutorFactory",
    "clear_registered_functions",
    "get_executor_factory",
    "register_function",
    "set_executor_factory",
]
