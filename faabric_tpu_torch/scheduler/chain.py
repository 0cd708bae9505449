"""Function chaining: guests invoking further functions.

Counterpart of ``faabric_tpu/scheduler/chain.py`` (reference chained
calls: Faasm's chainedCall through PlannerClient::callFunctions with the
parent's app id, and util/ExecGraph's logChainedFunction). A chained
call is a SCALE_CHANGE of the running app; the child's message id is
recorded on the parent, so that ``util/exec_graph.py`` rebuilds the
call tree from the planner's results.
"""

from __future__ import annotations

from faabric_tpu_torch.batch_scheduler.decision import is_sentinel_decision
from faabric_tpu_torch.executor.context import ExecutorContext
from faabric_tpu_torch.proto import (
    BatchExecuteRequest,
    Message,
    message_factory,
)
from faabric_tpu_torch.util.exec_graph import log_chained_function
from faabric_tpu_torch.util.logging import get_logger

logger = get_logger(__name__)


def chain_function(function: str, input_data: bytes = b"",
                   user: str = "") -> int:
    """Invoke ``function`` as a chained call of the task running on this
    thread; returns the child's message id (``await_chained`` takes
    it). A decision that placed nothing raises at once."""
    ctx = ExecutorContext.get()
    parent = ctx.msg
    executor = ctx.executor
    user = user or parent.user

    req = BatchExecuteRequest(app_id=parent.app_id, user=user,
                              function=function)
    child = message_factory(user, function)
    child.app_id = parent.app_id
    child.input_data = input_data
    child.record_exec_graph = parent.record_exec_graph
    req.messages = [child]

    decision = executor.scheduler.planner_client.call_functions(req)
    if is_sentinel_decision(decision):
        raise RuntimeError(f"Chained call {function} could not be scheduled "
                           f"(decision {decision.app_id})")
    log_chained_function(parent, child.id)
    executor.add_chained_message(child)
    logger.debug("Chained %s/%s (%d) from parent %d", child.user,
                 child.function, child.id, parent.id)
    return child.id


def await_chained(msg_id: int, timeout: float | None = None) -> Message:
    """Block on a chained call's result (the guest's awaitChainedCall)."""
    ctx = ExecutorContext.get()
    return ctx.executor.scheduler.planner_client.get_message_result(
        ctx.msg.app_id, msg_id, timeout=timeout)
