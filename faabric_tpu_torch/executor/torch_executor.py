"""Executor for PyTorch guest functions.

Counterpart of ``faabric_tpu/executor/jax_executor.py``: guest functions
are Python callables registered under (user, function); the planner
gang-schedules their messages, and each runs on an executor thread with
its message, its group and the device the planner pinned its rank to in
hand::

    @register_function("demo", "serve")
    def serve(ctx):
        dev = ctx.device                  # the planner's device, as torch
        ...
        return b"result bytes"            # → msg.output_data

    runtime = WorkerRuntime(..., factory=TorchExecutorFactory())

Return conventions: ``bytes`` → output_data and SUCCESS; ``int`` →
return value; ``None`` → SUCCESS. A guest that raises, or an unknown
function, reports FAILED with the error text in output_data.

``TorchExecutorFactory(device=None)`` runs guests on CUDA; without a
card it raises. ``device="cpu"`` runs every rank on the CPU (the tests
do), and ``GuestContext.device_id`` still carries the planner's
numbering. ``GuestContext.mpi_world()`` creates (rank 0) or joins the
gang's MPI world, and ``GuestContext.state()`` gives the host's state KV
(``faabric_tpu_torch/state/``).
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

import torch

from faabric_tpu_torch.executor.executor import Executor
from faabric_tpu_torch.executor.factory import ExecutorFactory
from faabric_tpu_torch.proto import ReturnValue
from faabric_tpu_torch.util.device import resolve_device
from faabric_tpu_torch.util.logging import get_logger

logger = get_logger(__name__)

_registry: dict[tuple[str, str], Callable] = {}
_registry_lock = threading.Lock()


def register_function(user: str, name: str, fn: Optional[Callable] = None):
    """Register ``fn`` as guest function (user, name); usable as a
    decorator."""
    def _do(f: Callable) -> Callable:
        with _registry_lock:
            _registry[(user, name)] = f
        return f

    if fn is not None:
        return _do(fn)
    return _do


def clear_registered_functions() -> None:
    with _registry_lock:
        _registry.clear()


class GuestContext:
    """What a guest function sees: its message and batch, its host's
    point-to-point broker, and the device the planner pinned it to."""

    # How long device_id waits for the group's mappings to arrive
    MAPPINGS_WAIT_SECONDS = 5.0

    def __init__(self, executor: "TorchExecutor", msg, req) -> None:
        self.executor = executor
        self.message = msg
        self.request = req

    @property
    def broker(self):
        sched = self.executor.scheduler
        return None if sched is None else sched.ptp_broker

    @property
    def device_id(self) -> int:
        """The planner's device id for this rank (-1 for a message that
        has no group). Raises ``TimeoutError`` when the group's mappings
        do not arrive in time."""
        broker = self.broker
        if broker is None or not self.message.group_id:
            return -1
        broker.wait_for_mappings(self.message.group_id,
                                 self.MAPPINGS_WAIT_SECONDS)
        return broker.get_device_for_idx(self.message.group_id,
                                         self.message.group_idx)

    @property
    def device(self) -> torch.device:
        """The rank's device on the factory's device type: ``cuda:<id>``
        for the planner's id, or the CPU when the factory runs on it. An
        id that this host does not have raises; there is no fallback."""
        if self.executor.device_type == "cpu":
            return torch.device("cpu")
        did = self.device_id
        n = torch.cuda.device_count()
        if not 0 <= did < n:
            raise RuntimeError(
                f"{self.message.user}/{self.message.function} rank "
                f"{self.message.group_idx} is pinned to device {did}, but "
                f"this host has {n} CUDA device(s)")
        return torch.device("cuda", did)

    def mpi_world(self):
        """Create this gang's MPI world (rank 0 of a world that does not
        exist yet: it chains the other ranks through the planner) or join
        it (every other rank): the reference's MPI_Init flow
        (``faabric_tpu/executor/jax_executor.py:107-124``). The world's
        rank of this guest is ``message.mpi_rank``."""
        from faabric_tpu_torch.mpi import get_mpi_context

        ctx = get_mpi_context()
        msg = self.message
        if msg.mpi_rank == 0 and not msg.is_mpi:
            msg.is_mpi = True
            if not msg.mpi_world_id:
                msg.mpi_world_id = msg.app_id
            if not msg.mpi_world_size:
                msg.mpi_world_size = self.request.n_messages()
            world = ctx.create_world(msg)
        else:
            world = ctx.join_world(msg)
        world.refresh_rank_hosts()
        return world

    def state(self):
        """The host's ``State`` (the key-value store shared across the
        cluster; ``faabric_tpu/executor/jax_executor.py:126-129``)."""
        sched = self.executor.scheduler
        return None if sched is None else sched.state


class TorchExecutor(Executor):
    """Runs registered guest callables."""

    def __init__(self, msg, device_type: str) -> None:
        super().__init__(msg)
        self.device_type = device_type

    def execute_task(self, thread_pool_idx: int, msg_idx: int, req) -> int:
        msg = req.messages[msg_idx]
        with _registry_lock:
            fn = _registry.get((msg.user, msg.function))
        if fn is None:
            msg.output_data = (
                f"no registered function {msg.user}/{msg.function}".encode())
            return int(ReturnValue.FAILED)
        try:
            result = fn(GuestContext(self, msg, req))
        except Exception as e:  # noqa: BLE001 — the guest's failure is its
            # result
            logger.exception("Guest %s/%s failed", msg.user, msg.function)
            msg.output_data = repr(e).encode()[:512]
            return int(ReturnValue.FAILED)
        if isinstance(result, bytes):
            msg.output_data = result
            return int(ReturnValue.SUCCESS)
        if isinstance(result, int):
            return result
        return int(ReturnValue.SUCCESS)


class TorchExecutorFactory(ExecutorFactory):
    """Executors whose guests run on ``device``'s type: CUDA by default,
    which raises without a card; the CPU only when asked for."""

    def __init__(self, device=None) -> None:
        self.device_type = resolve_device(device).type

    def create_executor(self, msg) -> TorchExecutor:
        return TorchExecutor(msg, self.device_type)
