"""Worker runtime assembly.

Counterpart of ``faabric_tpu/runner/runtime.py`` (reference
src/runner/FaabricMain.cpp:19-108): ``WorkerRuntime`` boots one worker
host. It starts the function-call server, the scheduler and the
point-to-point server, and registers the host with the planner (with a
keep-alive), and the host's state KV (``State``) with its
``StateServer``, which guests reach through ``GuestContext.state()``.
Instantiable per host identity, so several workers can run in one
process on aliased port ranges.

``n_devices`` is the number of devices the host registers. Left out, it
is ``torch.cuda.device_count()`` when the executor factory runs guests
on CUDA, and 0 otherwise. The planner pins each placement to one of
them, least loaded first, and a guest reads its device from
``GuestContext.device``; a guest reaches its MPI world through the
runtime's ``MpiWorldRegistry`` (``GuestContext.mpi_world``). The state
KV's device view defaults to the factory's device type. Not ported: the
snapshot server, the HTTP endpoint, the sampler and profiler, and the
multi-process device plane (``ROADMAP.md`` Queue 1 #7-9).
"""

from __future__ import annotations

from typing import Optional

import torch

from faabric_tpu_torch.executor.factory import (
    ExecutorFactory,
    get_executor_factory,
    set_executor_factory,
)
from faabric_tpu_torch.mpi.registry import MpiWorldRegistry
from faabric_tpu_torch.planner.client import PlannerClient
from faabric_tpu_torch.scheduler.function_call import FunctionCallServer
from faabric_tpu_torch.scheduler.scheduler import Scheduler
from faabric_tpu_torch.state.remote import StateServer
from faabric_tpu_torch.state.state import State
from faabric_tpu_torch.transport.point_to_point import PointToPointBroker
from faabric_tpu_torch.transport.ptp_remote import PointToPointServer
from faabric_tpu_torch.util.config import get_system_config
from faabric_tpu_torch.util.logging import get_logger
from faabric_tpu_torch.util.network import LOCALHOST

logger = get_logger(__name__)


def _factory_device_type() -> str | None:
    """The registered factory's device type; None with no factory."""
    try:
        factory = get_executor_factory()
    except RuntimeError:
        return None
    return getattr(factory, "device_type", None)


def _default_n_devices() -> int:
    """The registered factory's CUDA device count; 0 for a factory that
    runs guests elsewhere, or none."""
    if _factory_device_type() != "cuda":
        return 0
    return torch.cuda.device_count()


class WorkerRuntime:
    def __init__(self, host: str = LOCALHOST, slots: int | None = None,
                 n_devices: int | None = None,
                 factory: Optional[ExecutorFactory] = None,
                 planner_host: str | None = None) -> None:
        self.host = host
        # None sizes the host to the machine; an explicit 0 registers a
        # host that takes no work
        self.slots = (get_system_config().get_usable_cores() if slots is None
                      else slots)
        if factory is not None:
            set_executor_factory(factory)
        self.n_devices = (_default_n_devices() if n_devices is None
                          else n_devices)

        self.planner_client = PlannerClient(self.host, planner_host)
        self.scheduler = Scheduler(self.host, self.planner_client)
        self.function_server = FunctionCallServer(self.scheduler)
        self.ptp_broker = PointToPointBroker(self.host)
        self.scheduler.ptp_broker = self.ptp_broker
        self.ptp_server = PointToPointServer(self.ptp_broker)
        # MPI worlds (the reference's MpiWorldRegistry singleton; one per
        # runtime here, so several hosts can run in one process)
        self.mpi_registry = MpiWorldRegistry(self.ptp_broker,
                                             self.planner_client)
        self.scheduler.mpi_registry = self.mpi_registry
        # State KV (reference FaabricMain starts a StateServer)
        self.state = State(self.host, self.planner_client,
                           device=_factory_device_type())
        self.scheduler.state = self.state
        self.state_server = StateServer(self.state, self.host)
        self._started = False

    def start(self) -> None:
        if self._started:
            return
        self._started = True
        self.function_server.start()
        try:
            self.scheduler.start()
            self.ptp_server.start()
            self.state_server.start()
            self.planner_client.register_host(
                self.slots, self.n_devices, overwrite=True,
                start_keep_alive=True)
        except Exception:
            # A half-up worker must not keep its ports bound
            self._started = False
            self.planner_client.close()
            self.state_server.stop()
            self.ptp_server.stop()
            self.scheduler.shutdown()
            self.function_server.stop()
            raise
        logger.debug("Worker %s up (slots=%d devices=%d)", self.host,
                     self.slots, self.n_devices)

    def shutdown(self) -> None:
        if not self._started:
            return
        self._started = False
        self.planner_client.remove_host()
        self.scheduler.shutdown()
        self.ptp_server.stop()
        self.state_server.stop()
        self.function_server.stop()
        self.state.close_clients()
        self.mpi_registry.clear()
        self.ptp_broker.clear()
        self.planner_client.close()
        logger.debug("Worker %s down", self.host)
