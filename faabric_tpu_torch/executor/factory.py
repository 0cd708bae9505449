"""Pluggable executor factory.

Counterpart of ``faabric_tpu/executor/factory.py`` (reference
include/faabric/executor/ExecutorFactory.h:215-227): the runtime that
embeds the framework subclasses ``ExecutorFactory``, and each host's
scheduler creates executors through the registered factory.
"""

from __future__ import annotations

import threading
from typing import TYPE_CHECKING, Optional

from faabric_tpu_torch.proto import Message

if TYPE_CHECKING:  # pragma: no cover
    from faabric_tpu_torch.executor.executor import Executor


class ExecutorFactory:
    def create_executor(self, msg: Message) -> "Executor":
        raise NotImplementedError

    def flush_host(self) -> None:
        """Hook run when the host is flushed (reference flushHost)."""


_factory: Optional[ExecutorFactory] = None
_factory_lock = threading.Lock()


def set_executor_factory(factory: Optional[ExecutorFactory]) -> None:
    global _factory
    with _factory_lock:
        _factory = factory


def get_executor_factory() -> ExecutorFactory:
    with _factory_lock:
        if _factory is None:
            raise RuntimeError("No executor factory registered")
        return _factory
