"""Function-call RPC between the planner and the worker hosts.

Counterpart of ``faabric_tpu/scheduler/function_call.py`` (reference
src/scheduler/FunctionCallServer.cpp, ports 8005/8006, and
FunctionCallClient.cpp). Async plane: EXECUTE_FUNCTIONS (the
planner's dispatch to a host's scheduler) and SET_MESSAGE_RESULT (the
planner pushing a result to a host that waits for it). Sync plane:
FLUSH (the host drops its executors and runs the factory's
``flush_host``). In mock mode the client records its calls instead of
sending them. The reference's telemetry call (GET_TELEMETRY, with
``Planner.collect_telemetry``) and its pipelined dispatch
(EXECUTE_BATCHES) are not ported (``ROADMAP.md`` Queue 1 #7 part D and
#9 part D).
"""

from __future__ import annotations

import enum
import threading
from typing import TYPE_CHECKING

from faabric_tpu_torch.proto import (
    BatchExecuteRequest,
    Message,
    ber_from_wire,
    ber_to_wire,
    messages_from_wire,
    messages_to_wire,
)
from faabric_tpu_torch.transport.client import MessageEndpointClient
from faabric_tpu_torch.transport.common import (
    FUNCTION_CALL_ASYNC_PORT,
    FUNCTION_CALL_SYNC_PORT,
    get_host_alias_offset,
)
from faabric_tpu_torch.transport.message import TransportMessage
from faabric_tpu_torch.transport.server import (
    MessageEndpointServer,
    handler_response,
)
from faabric_tpu_torch.util.config import get_system_config
from faabric_tpu_torch.util.testing import is_mock_mode

if TYPE_CHECKING:  # pragma: no cover
    from faabric_tpu_torch.scheduler.scheduler import Scheduler


class FunctionCalls(enum.IntEnum):
    NO_FUNCTION_CALL = 0
    EXECUTE_FUNCTIONS = 1
    FLUSH = 2
    SET_MESSAGE_RESULT = 3


# ---------------------------------------------------------------------------
# Mock recording (reference getBatchRequests/getMessageResults)
# ---------------------------------------------------------------------------
_mock_lock = threading.Lock()
_batch_messages: list[tuple[str, BatchExecuteRequest]] = []
_message_results: list[tuple[str, Message]] = []
_flush_calls: list[str] = []


def get_batch_requests() -> list[tuple[str, BatchExecuteRequest]]:
    with _mock_lock:
        return list(_batch_messages)


def get_message_results() -> list[tuple[str, Message]]:
    with _mock_lock:
        return list(_message_results)


def get_flush_calls() -> list[str]:
    with _mock_lock:
        return list(_flush_calls)


def clear_mock_requests() -> None:
    with _mock_lock:
        _batch_messages.clear()
        _message_results.clear()
        _flush_calls.clear()


# ---------------------------------------------------------------------------

class FunctionCallClient(MessageEndpointClient):
    def __init__(self, host: str) -> None:
        super().__init__(host, FUNCTION_CALL_ASYNC_PORT,
                         FUNCTION_CALL_SYNC_PORT)

    def execute_functions(self, req: BatchExecuteRequest) -> None:
        if is_mock_mode():
            with _mock_lock:
                _batch_messages.append((self.host, req))
            return
        header, tail = ber_to_wire(req)
        self.async_send(int(FunctionCalls.EXECUTE_FUNCTIONS), header, tail)

    def set_message_result(self, msg: Message) -> None:
        if is_mock_mode():
            with _mock_lock:
                _message_results.append((self.host, msg))
            return
        dicts, tail = messages_to_wire([msg])
        self.async_send(int(FunctionCalls.SET_MESSAGE_RESULT),
                        {"msg": dicts[0]}, tail)

    def send_flush(self) -> None:
        if is_mock_mode():
            with _mock_lock:
                _flush_calls.append(self.host)
            return
        self.sync_send(int(FunctionCalls.FLUSH))


class FunctionCallServer(MessageEndpointServer):
    def __init__(self, scheduler: "Scheduler") -> None:
        offset = get_host_alias_offset(scheduler.host)
        super().__init__(
            FUNCTION_CALL_ASYNC_PORT + offset,
            FUNCTION_CALL_SYNC_PORT + offset,
            label=f"function-server-{scheduler.host}",
            n_threads=get_system_config().function_server_threads,
        )
        self.scheduler = scheduler

    def do_async_recv(self, msg: TransportMessage) -> None:
        if msg.code == int(FunctionCalls.EXECUTE_FUNCTIONS):
            self.scheduler.execute_batch(
                ber_from_wire(msg.header, msg.payload))
        elif msg.code == int(FunctionCalls.SET_MESSAGE_RESULT):
            result = messages_from_wire([msg.header["msg"]], msg.payload)[0]
            self.scheduler.planner_client.set_message_result_locally(result)
        else:
            raise ValueError(f"Unknown async function call {msg.code}")

    def do_sync_recv(self, msg: TransportMessage) -> TransportMessage:
        if msg.code == int(FunctionCalls.FLUSH):
            self.scheduler.flush()
            return handler_response()
        raise ValueError(f"Unknown sync function call {msg.code}")
