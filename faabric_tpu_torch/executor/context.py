"""Thread-local execution context.

Counterpart of ``faabric_tpu/executor/context.py`` (reference
include/faabric/executor/ExecutorContext.h:168-207): guest code running
on an executor thread looks up its executor, batch and message index.
"""

from __future__ import annotations

import threading
from typing import TYPE_CHECKING

from faabric_tpu_torch.proto import BatchExecuteRequest, Message

if TYPE_CHECKING:  # pragma: no cover
    from faabric_tpu_torch.executor.executor import Executor

_tls = threading.local()


class ExecutorContext:
    def __init__(self, executor: "Executor", req: BatchExecuteRequest,
                 msg_idx: int) -> None:
        self.executor = executor
        self.req = req
        self.msg_idx = msg_idx

    @property
    def msg(self) -> Message:
        return self.req.messages[self.msg_idx]

    @staticmethod
    def set(executor: "Executor", req: BatchExecuteRequest,
            msg_idx: int) -> None:
        _tls.context = ExecutorContext(executor, req, msg_idx)

    @staticmethod
    def unset() -> None:
        _tls.context = None

    @staticmethod
    def get() -> "ExecutorContext":
        ctx = getattr(_tls, "context", None)
        if ctx is None:
            raise RuntimeError("No executor context set on this thread")
        return ctx
