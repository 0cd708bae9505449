"""Function-call RPC between the planner and the worker hosts.

Counterpart of ``faabric_tpu/scheduler/function_call.py`` (reference
src/scheduler/FunctionCallServer.cpp, ports 8005/8006, and
FunctionCallClient.cpp). Async plane: EXECUTE_FUNCTIONS (the
planner's dispatch to a host's scheduler) and SET_MESSAGE_RESULT (the
planner pushing a result to a host that waits for it). Sync plane:
FLUSH (the host drops its executors and runs the factory's
``flush_host``) and GET_TELEMETRY (the host's telemetry blocks, which
``Planner.collect_telemetry`` scrapes for the planner's REST
endpoint). EXECUTE_BATCHES (:52, :100-120) is the planner's pipelined
dispatch: every sub-batch of a scheduling tick bound for one host in
one async call, which the server unpacks and hands to the scheduler in
order, going on past a sub-batch that raises (:193-210). In mock mode
the client records its calls instead of sending them.
"""

from __future__ import annotations

import enum
import json
import threading
from typing import TYPE_CHECKING

from faabric_tpu_torch.proto import (
    BatchExecuteRequest,
    Message,
    ber_from_wire,
    ber_to_wire,
    bers_from_wire,
    bers_to_wire,
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
from faabric_tpu_torch.util.logging import get_logger
from faabric_tpu_torch.util.testing import is_mock_mode

if TYPE_CHECKING:  # pragma: no cover
    from faabric_tpu_torch.scheduler.scheduler import Scheduler

logger = get_logger(__name__)


class FunctionCalls(enum.IntEnum):
    NO_FUNCTION_CALL = 0
    EXECUTE_FUNCTIONS = 1
    FLUSH = 2
    SET_MESSAGE_RESULT = 3
    GET_TELEMETRY = 4
    # The pipelined dispatch: a tick's sub-batches for one host
    EXECUTE_BATCHES = 5


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

    def execute_functions_many(self,
                               reqs: list[BatchExecuteRequest]) -> None:
        """Every sub-batch bound for this host in one async call: the
        headers ride a ``bers`` list with each request's tail length,
        and the tails follow one another in the payload."""
        if not reqs:
            return
        if len(reqs) == 1:
            self.execute_functions(reqs[0])
            return
        if is_mock_mode():
            with _mock_lock:
                for req in reqs:
                    _batch_messages.append((self.host, req))
            return
        header, tail = bers_to_wire(reqs)
        self.async_send(int(FunctionCalls.EXECUTE_BATCHES), header, tail)

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

    def get_telemetry(self, include_trace: bool = False,
                      blocks: tuple[str, ...] | None = None) -> dict:
        """This host's telemetry blocks (and its trace buffer when asked):
        what the planner merges behind its REST endpoint. ``blocks``
        narrows the answer to the named blocks (a trend poll asks for
        ``("timeseries",)`` alone)."""
        if is_mock_mode():
            return {"metrics": {}, "trace": []}
        header: dict = {"trace": bool(include_trace)}
        if blocks is not None:
            header["blocks"] = list(blocks)
        resp = self.sync_send(int(FunctionCalls.GET_TELEMETRY), header,
                              idempotent=True)
        return json.loads(resp.payload.decode()) if resp.payload else {}


def telemetry_builders() -> dict:
    """Block name → a function that builds that block of this process's
    telemetry. Blocks are built lazily, so that a narrowed request pays
    only for what it names."""
    from faabric_tpu_torch.device_plane.plane import device_planes_summary
    from faabric_tpu_torch.telemetry import (
        get_comm_matrix,
        get_lifecycle_stats,
        get_metrics,
        get_timeseries,
        perf_telemetry_block,
        profile_telemetry_block,
        statestats_telemetry_block,
    )

    return {
        "metrics": lambda: get_metrics().snapshot(),
        "commmatrix": lambda: get_comm_matrix().snapshot(),
        # rolling link profiles and collective phase series (GET /perf)
        "perf": perf_telemetry_block,
        "lifecycle": lambda: get_lifecycle_stats().snapshot(),
        "timeseries": lambda: get_timeseries().snapshot(),
        # live device planes' summaries (GET /topology)
        "device_planes": device_planes_summary,
        # per-key state ledger and snapshot stats (GET /statemap)
        "statestats": statestats_telemetry_block,
        # the stack sampler's trie and GIL gauge (GET /profile)
        "profile": profile_telemetry_block,
    }


def local_telemetry(include_trace: bool = False,
                    blocks=None) -> dict:
    """This process's telemetry blocks (``blocks`` None builds every
    one), with its trace events when asked; the process gauges are
    refreshed first."""
    from faabric_tpu_torch.telemetry import get_proc_stats, trace_events

    get_proc_stats().refresh()
    body = {name: build() for name, build in telemetry_builders().items()
            if blocks is None or name in blocks}
    if include_trace:
        body["trace"] = trace_events()
    return body


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
        elif msg.code == int(FunctionCalls.EXECUTE_BATCHES):
            # Each sub-batch in arrival order. One that raises must not
            # drop the rest of the frame: the planner recorded them all
            # as dispatched, and nothing else would run them
            for req in bers_from_wire(msg.header, msg.payload):
                try:
                    self.scheduler.execute_batch(req)
                except Exception:  # noqa: BLE001
                    logger.exception("Sub-batch of app %d failed; going on "
                                     "with the rest of the frame",
                                     req.app_id)
        elif msg.code == int(FunctionCalls.SET_MESSAGE_RESULT):
            result = messages_from_wire([msg.header["msg"]], msg.payload)[0]
            self.scheduler.planner_client.set_message_result_locally(result)
        else:
            raise ValueError(f"Unknown async function call {msg.code}")

    def do_sync_recv(self, msg: TransportMessage) -> TransportMessage:
        if msg.code == int(FunctionCalls.FLUSH):
            self.scheduler.flush()
            return handler_response()
        if msg.code == int(FunctionCalls.GET_TELEMETRY):
            body = local_telemetry(bool(msg.header.get("trace")),
                                   msg.header.get("blocks"))
            # In the payload: a full trace buffer is bulk data
            return handler_response(payload=json.dumps(body).encode())
        raise ValueError(f"Unknown sync function call {msg.code}")
