"""World registry and the per-message MPI context.

Counterpart of ``faabric_tpu/mpi/registry.py`` (reference
src/mpi/MpiWorldRegistry.cpp:13-75 and src/mpi/MpiContext.cpp:14-50):
rank 0 creates its world, chaining the other ranks through the planner;
every other rank joins from its dispatched message. One registry per
worker runtime (``Scheduler.mpi_registry``), so several hosts can run in
one process.
"""

from __future__ import annotations

import threading
from typing import Optional

from faabric_tpu_torch.mpi.world import MpiWorld
from faabric_tpu_torch.proto import (
    BatchExecuteRequest,
    Message,
    batch_exec_factory,
)
from faabric_tpu_torch.util.config import get_system_config
from faabric_tpu_torch.util.logging import get_logger

logger = get_logger(__name__)


class MpiWorldRegistry:
    """World creation, join and destroy race across executor threads;
    the id map is the shared state. Reserving an id under the lock is
    what makes a duplicate create fail instead of chaining the ranks
    twice.

    One divergence: a rank that joins on the creator's host while the
    creator still chains the ranks waits for the creator's world (the
    reference hands it a world object of its own). Co-located ranks
    must share one object, since the device plane's rendezvous lives
    in it."""

    def __init__(self, broker, planner_client=None) -> None:
        self.broker = broker
        self.planner_client = planner_client
        self._lock = threading.Condition()
        self._worlds: dict[int, Optional[MpiWorld]] = {}

    def create_world(self, msg: Message,
                     world_size: int | None = None) -> MpiWorld:
        """Rank 0 creates the world: it chains (size-1) messages through
        the planner, so every rank gets scheduled, a group, a device and
        an MPI port (reference MpiWorld::create :157-226)."""
        size = world_size or msg.mpi_world_size
        if size <= 0:
            raise ValueError(f"Invalid MPI world size {size}")
        world_id = msg.mpi_world_id
        with self._lock:
            if world_id in self._worlds:
                raise ValueError(f"World {world_id} already exists")
            self._worlds[world_id] = None  # the reservation

        try:
            if size > 1:
                if self.planner_client is None:
                    raise RuntimeError("No planner client to chain MPI ranks")
                req = BatchExecuteRequest(
                    app_id=msg.app_id, user=msg.user, function=msg.function)
                for rank in range(1, size):
                    chained = batch_exec_factory(msg.user, msg.function,
                                                 1).messages[0]
                    chained.app_id = msg.app_id
                    chained.app_idx = rank
                    chained.group_idx = rank
                    chained.is_mpi = True
                    chained.mpi_world_id = world_id
                    chained.mpi_world_size = size
                    chained.mpi_rank = rank
                    req.messages.append(chained)
                decision = self.planner_client.call_functions(req)
                group_id = decision.group_id or msg.group_id
            else:
                group_id = msg.group_id
            world = MpiWorld(self.broker, world_id, size, group_id,
                             user=msg.user, function=msg.function)
            world.record_exec_graph = msg.record_exec_graph
        except BaseException:
            with self._lock:
                if self._worlds.get(world_id) is None:
                    self._worlds.pop(world_id, None)
                self._lock.notify_all()
            raise
        with self._lock:
            if world_id not in self._worlds:
                # clear() swept the registry (worker teardown) while the
                # ranks were chained: do not resurrect the world
                world.close()
                raise RuntimeError(
                    f"Registry cleared while creating world {world_id}")
            self._worlds[world_id] = world
            self._lock.notify_all()
        logger.debug("Created MPI world %d (size=%d group=%d)", world_id,
                     size, group_id)
        return world

    def get_or_initialise_world(self, msg: Message) -> MpiWorld:
        """Ranks other than 0 join from their dispatched message
        (reference getOrInitialiseWorld :54-75; one world per host)."""
        wid = msg.mpi_world_id
        timeout = get_system_config().global_message_timeout
        with self._lock:
            # A create in progress on this host: wait for its world
            if not self._lock.wait_for(
                    lambda: self._worlds.get(wid, 0) is not None, timeout):
                raise TimeoutError(
                    f"MPI world {wid} still being created after {timeout} s")
            world = self._worlds.get(wid)
            if world is None:
                world = MpiWorld(self.broker, wid, msg.mpi_world_size,
                                 msg.group_id, user=msg.user,
                                 function=msg.function)
                world.record_exec_graph = msg.record_exec_graph
                self._worlds[wid] = world
            return world

    def get_world(self, world_id: int) -> MpiWorld:
        with self._lock:
            return self._worlds[world_id]

    def has_world(self, world_id: int) -> bool:
        with self._lock:
            return world_id in self._worlds

    def destroy_world(self, world_id: int) -> None:
        with self._lock:
            world = self._worlds.pop(world_id, None)
        if world is not None:
            world.close()
            self.broker.clear_group(world.group_id)

    def clear(self) -> None:
        with self._lock:
            worlds, self._worlds = dict(self._worlds), {}
            self._lock.notify_all()
        for w in worlds.values():
            if w is not None:  # None is an in-flight create's reservation
                w.close()


class MpiContext:
    """The MPI binding of one executing message (reference
    MpiContext.cpp:14-50)."""

    def __init__(self, registry: MpiWorldRegistry) -> None:
        self.registry = registry
        self.world_id = 0
        self.rank = -1
        self._world: Optional[MpiWorld] = None

    def create_world(self, msg: Message,
                     world_size: int | None = None) -> MpiWorld:
        if msg.mpi_rank != 0:
            raise ValueError("Only rank 0 creates the world")
        self._world = self.registry.create_world(msg, world_size)
        self.world_id = self._world.id
        self.rank = 0
        return self._world

    def join_world(self, msg: Message) -> MpiWorld:
        self._world = self.registry.get_or_initialise_world(msg)
        self.world_id = self._world.id
        self.rank = msg.mpi_rank
        return self._world

    @property
    def world(self) -> MpiWorld:
        if self._world is None:
            raise RuntimeError("MPI context not initialised")
        return self._world

    def is_mpi(self) -> bool:
        return self._world is not None


def get_mpi_context() -> MpiContext:
    """An MPI context for the task running on this executor thread, over
    its host's registry (the guest's entry point)."""
    from faabric_tpu_torch.executor.context import ExecutorContext

    scheduler = ExecutorContext.get().executor.scheduler
    registry = getattr(scheduler, "mpi_registry", None)
    if registry is None:
        raise RuntimeError("This host has no MPI registry")
    return MpiContext(registry)
