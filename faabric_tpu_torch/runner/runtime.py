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
KV's device view defaults to the factory's device type. The host's
``SnapshotRegistry`` is set on the scheduler and the planner client, and
its ``SnapshotServer`` takes pushed snapshots, their diffs and remote
threads' results (into the scheduler's thread results).

Telemetry: the runtime labels the process's trace rows
(``worker-<host>``) and stamps its host as the fault identity (the
``src`` of host-pair rules); while it runs it holds a share of the
process's time-series sampler (with its executor count as a series)
and of the stack profiler. With ``WORKER_HTTP_PORT`` set, it serves the
worker's HTTP endpoint (``endpoint/worker_endpoint.py``: ``/healthz``,
``/metrics``, ``/timeseries``, ``/flight``, ``/profile``) on that port
while it runs.

``device_plane_size`` over 1 joins the multi-process device plane
(``parallel/distributed.py``) at ``start()``, once the host is
registered: the worker asks the planner for its place and joins with
``plane_devices`` (every visible card by default; ``["cpu"] * 4`` gives
four CPU entries). ``shutdown()`` leaves it, without waiting on a peer
that is gone.
"""

from __future__ import annotations

from typing import Optional

import os
import time

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
from faabric_tpu_torch.snapshot.registry import SnapshotRegistry
from faabric_tpu_torch.snapshot.remote import SnapshotServer
from faabric_tpu_torch.state.remote import StateServer
from faabric_tpu_torch.state.state import State
from faabric_tpu_torch.transport.point_to_point import PointToPointBroker
from faabric_tpu_torch.transport.ptp_remote import PointToPointServer
from faabric_tpu_torch.util.config import get_system_config
from faabric_tpu_torch.util.logging import get_logger
from faabric_tpu_torch.util.network import LOCALHOST

logger = get_logger(__name__)


def worker_http_port() -> int:
    """``WORKER_HTTP_PORT``: the worker endpoint's port (0, unset or
    malformed: no endpoint)."""
    raw = os.environ.get("WORKER_HTTP_PORT", "0")
    try:
        return int(raw)
    except ValueError:
        logger.warning("Ignoring malformed WORKER_HTTP_PORT=%r", raw)
        return 0


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
                 planner_host: str | None = None,
                 device_plane_size: int = 0,
                 plane_devices=None) -> None:
        self.host = host
        # Over 1: this worker is one of device_plane_size processes of
        # the device plane, contributing plane_devices
        self.device_plane_size = device_plane_size
        self.plane_devices = plane_devices
        # Host seconds of the last join (planner roster and rendezvous)
        # and of the last leave
        self.plane_join_s: float | None = None
        self.plane_leave_s: float | None = None
        # Traces of co-located workers merge on one timeline; the label
        # tells their rows apart
        from faabric_tpu_torch.faults import set_fault_identity
        from faabric_tpu_torch.telemetry import set_process_label

        set_process_label(f"worker-{self.host}")
        # Host-pair fault rules match src=<this host>
        set_fault_identity(self.host)
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
        # An abort that cannot cross a partitioned worker pair's link is
        # relayed through the planner's own links
        self.ptp_broker.planner_client = self.planner_client
        self.scheduler.ptp_broker = self.ptp_broker
        self.ptp_server = PointToPointServer(self.ptp_broker)
        # MPI worlds (the reference's MpiWorldRegistry singleton; one per
        # runtime here, so several hosts can run in one process)
        self.mpi_registry = MpiWorldRegistry(self.ptp_broker,
                                             self.planner_client)
        self.scheduler.mpi_registry = self.mpi_registry
        # Snapshots (reference FaabricMain starts a SnapshotServer)
        self.snapshot_registry = SnapshotRegistry()
        self.scheduler.snapshot_registry = self.snapshot_registry
        self.planner_client.snapshot_registry = self.snapshot_registry
        self.snapshot_server = SnapshotServer(self.snapshot_registry,
                                              self.host,
                                              scheduler=self.scheduler)
        # State KV (reference FaabricMain starts a StateServer)
        self.state = State(self.host, self.planner_client,
                           device=_factory_device_type())
        self.scheduler.state = self.state
        self.state_server = StateServer(self.state, self.host)
        self.http_endpoint = None
        http_port = worker_http_port()
        if http_port:
            from faabric_tpu_torch.endpoint import WorkerHttpEndpoint

            self.http_endpoint = WorkerHttpEndpoint(http_port, runtime=self)
        self._started = False

    def start(self) -> None:
        if self._started:
            return
        self._started = True
        self.function_server.start()
        try:
            self.scheduler.start()
            self.ptp_server.start()
            self.snapshot_server.start()
            self.state_server.start()
            if self.http_endpoint is not None:
                self.http_endpoint.start()
            self._start_sampling()
            self.planner_client.register_host(
                self.slots, self.n_devices, overwrite=True,
                start_keep_alive=True)
            if self.device_plane_size > 1:
                self._join_plane()
        except Exception:
            # A half-up worker must not keep its ports bound
            self._started = False
            self._stop_sampling()
            self.planner_client.close()
            if self.http_endpoint is not None:
                self.http_endpoint.stop()
            self.state_server.stop()
            self.snapshot_server.stop()
            self.ptp_server.stop()
            self.scheduler.shutdown()
            self.function_server.stop()
            raise
        logger.debug("Worker %s up (slots=%d devices=%d)", self.host,
                     self.slots, self.n_devices)

    def _join_plane(self) -> None:
        from faabric_tpu_torch.parallel.distributed import (
            join_device_plane,
            request_device_plane,
        )

        t0 = time.perf_counter()
        spec = request_device_plane(self.planner_client,
                                    self.device_plane_size)
        join_device_plane(spec, local_devices=self.plane_devices)
        self.plane_join_s = time.perf_counter() - t0

    def _start_sampling(self) -> None:
        """Take shares of the refcounted sampler (with this runtime's
        executor count as a series) and stack profiler."""
        from faabric_tpu_torch.telemetry import (
            get_timeseries,
            start_profiler,
            start_sampler,
        )

        self._executors_gauge = self.scheduler.get_executor_count
        get_timeseries().register("executors", self._executors_gauge)
        start_sampler()
        self._sampling = True
        start_profiler()
        self._profiling = True

    def _stop_sampling(self) -> None:
        """Release exactly the shares ``_start_sampling`` took."""
        from faabric_tpu_torch.telemetry import (
            get_timeseries,
            stop_profiler,
            stop_sampler,
        )

        if getattr(self, "_sampling", False):
            self._sampling = False
            stop_sampler()
        if getattr(self, "_profiling", False):
            self._profiling = False
            stop_profiler()
        # Only this runtime's registration (matched by function)
        get_timeseries().unregister("executors",
                                    getattr(self, "_executors_gauge", None))

    def shutdown(self) -> None:
        if not self._started:
            return
        self._started = False
        self._stop_sampling()
        self.planner_client.remove_host()
        if self.device_plane_size > 1:
            from faabric_tpu_torch.parallel.distributed import (
                leave_device_plane,
            )

            t0 = time.perf_counter()
            leave_device_plane()
            self.plane_leave_s = time.perf_counter() - t0
        if self.http_endpoint is not None:
            self.http_endpoint.stop()
        self.scheduler.shutdown()
        self.ptp_server.stop()
        self.snapshot_server.stop()
        self.state_server.stop()
        self.function_server.stop()
        self.state.close_clients()
        self.mpi_registry.clear()
        self.ptp_broker.clear()
        self.planner_client.close()
        logger.debug("Worker %s down", self.host)
