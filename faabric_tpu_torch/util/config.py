"""Environment-driven system configuration.

The fields of ``faabric_tpu/util/config.py``'s ``SystemConfig`` that the
port's control plane reads, under the same environment variables and
defaults. ``reset()`` reads them again.
"""

from __future__ import annotations

import dataclasses
import os
import threading


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


@dataclasses.dataclass
class SystemConfig:
    # State: inmemory | file (shm) | redis
    state_mode: str = "inmemory"
    state_dir: str = "/dev/shm/faabric_tpu_state"
    # Synchronous backups per in-memory state key: 1 gives every key a
    # planner-placed backup host, and a master forwards dirty chunks to
    # it before acking; 0 runs single masters with no epochs
    state_replicas: int = 1

    # Scheduling: bin-pack | compact | spot
    batch_scheduler_mode: str = "bin-pack"
    # Bin-pack gang-schedules MPI batches: fill one host with a world's
    # ranks before spilling
    gang_schedule_mpi: bool = True
    override_cpu_count: int = 0

    # Timeouts (seconds)
    global_message_timeout: float = 60.0
    bound_timeout: float = 30.0
    reaper_interval_secs: float = 30.0

    # RPC server worker threads per plane
    function_server_threads: int = 2
    point_to_point_server_threads: int = 8
    state_server_threads: int = 2
    snapshot_server_threads: int = 2

    # Dirty tracking over host images (util/dirty.py): hash | compare |
    # native | none | segv | uffd | softpte. The dataclass default is
    # "hash", the environment's "native", as in the reference
    dirty_tracking_mode: str = "hash"
    # THREADS batches whose snapshots declare merge regions promise their
    # writes stay inside them: trackers then baseline and compare only
    # those pages (writes outside the hints go undetected; opt-in)
    dirty_region_hints: bool = False

    # Planner: hosts expire when they miss keep-alives for this long
    # (workers re-register every half-timeout)
    planner_host: str = "localhost"
    planner_host_timeout: float = 30.0
    # Recovery: each app's requeue budget when a host dies or a dispatch
    # fails, and the base of the exponential requeue backoff
    planner_max_requeues: int = 3
    planner_requeue_backoff: float = 0.2

    # While a recv of a watched (MPI) group blocks, the expected sender's
    # host is probed every this many seconds; a refused connection aborts
    # the world
    mpi_abort_check_seconds: float = 2.0

    def reset(self) -> None:
        """Read every field from the environment again."""
        self.state_mode = os.environ.get("STATE_MODE", "inmemory")
        self.state_dir = os.environ.get("STATE_DIR",
                                        "/dev/shm/faabric_tpu_state")
        self.state_replicas = _env_int("FAABRIC_STATE_REPLICAS", 1)
        self.batch_scheduler_mode = os.environ.get("BATCH_SCHEDULER_MODE",
                                                   "bin-pack")
        self.gang_schedule_mpi = os.environ.get(
            "FAABRIC_GANG_SCHEDULE", "1").lower() not in ("0", "false", "off")
        self.override_cpu_count = _env_int("OVERRIDE_CPU_COUNT", 0)
        self.global_message_timeout = _env_int(
            "GLOBAL_MESSAGE_TIMEOUT", 60000) / 1000.0
        self.bound_timeout = _env_int("BOUND_TIMEOUT", 30000) / 1000.0
        self.reaper_interval_secs = _env_int("REAPER_INTERVAL_SECS", 30)
        self.function_server_threads = _env_int("FUNCTION_SERVER_THREADS", 2)
        self.point_to_point_server_threads = _env_int(
            "POINT_TO_POINT_SERVER_THREADS", 8)
        self.state_server_threads = _env_int("STATE_SERVER_THREADS", 2)
        self.snapshot_server_threads = _env_int("SNAPSHOT_SERVER_THREADS", 2)
        self.dirty_tracking_mode = os.environ.get("DIRTY_TRACKING_MODE",
                                                  "native")
        self.dirty_region_hints = os.environ.get(
            "DIRTY_REGION_HINTS", "0") in ("1", "true", "on")
        self.planner_host = os.environ.get("PLANNER_HOST", "localhost")
        self.planner_host_timeout = _env_float("PLANNER_HOST_TIMEOUT", 30.0)
        self.planner_max_requeues = _env_int("PLANNER_MAX_REQUEUES", 3)
        self.planner_requeue_backoff = _env_float(
            "PLANNER_REQUEUE_BACKOFF", 0.2)
        self.mpi_abort_check_seconds = _env_float(
            "MPI_ABORT_CHECK_SECONDS", 2.0)

    def get_usable_cores(self) -> int:
        if self.override_cpu_count > 0:
            return self.override_cpu_count
        return os.cpu_count() or 1


_conf: SystemConfig | None = None
_conf_lock = threading.Lock()


def get_system_config() -> SystemConfig:
    global _conf
    if _conf is None:
        with _conf_lock:
            if _conf is None:
                conf = SystemConfig()
                conf.reset()
                _conf = conf
    return _conf
