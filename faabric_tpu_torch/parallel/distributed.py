"""The device plane across worker processes.

Counterpart of ``faabric_tpu/parallel/distributed.py``. The JAX package
joins every worker process to one ``jax.distributed`` coordination
service, after which ``jax.devices()`` is the plane's global device set
and XLA's collectives cross the process boundary. PyTorch has no such
global device set, so the port forms it itself: every process opens one
``torch.distributed`` store and gloo group of its own (never the
process's default group), rendezvoused at the coordinator's address,
and allgathers its local devices. The result, each device with its
process index and, on CUDA, the card's UUID, is the plane's global
device table (:func:`global_devices`), the counterpart of
``jax.devices()`` after the join.

Formation is planner-coordinated, as in the reference
(``Planner.join_device_plane``): each worker asks the planner to join at
boot (:func:`request_device_plane`), the planner assigns process ids in
join order and claims the coordinator's port from the first joiner's
MPI pool. ``DevicePlaneSpec.coordinator_host`` is a logical host name,
dialled through the alias table, so clusters of aliased loopback ports
and real multi-host clusters use the same spec.

What rides the plane: the MPI world's device rung for worlds whose ranks
live in several processes (``device_plane/plane.py``) and the addressable
forms of ``DeviceCollectives`` (``parallel/collectives.py``), both through
``device_plane/xproc.py``. Their payload moves on the gloo group on the
CPU, and on the card through CUDA IPC windows; the group then carries
only handles and barriers.

``local_devices`` defaults to every visible card. A list such as
``["cpu"] * 4`` replaces the reference's ``force_cpu_virtual_devices``:
several entries may name one device, as the port's single-process plane
lets several ranks alias one device.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import socket
import threading
import time
from typing import Optional, Sequence

import torch

from faabric_tpu_torch.util.logging import get_logger

logger = get_logger(__name__)

# The whole plane must assemble within this (every process has to reach
# its join; stragglers hold everyone)
DEFAULT_INIT_TIMEOUT_S = 120.0
# A leaving process waits at most this long on a store whose peers may
# be gone
LEAVE_TIMEOUT_S = 5.0

_state_lock = threading.Lock()
_joined: Optional["_Plane"] = None
# The stores this process opened, by coordinator endpoint: a store
# outlives a leave, so that a worker that leaves and joins again (a
# runtime restart) meets its peers on the same store, and a window freed
# after the leave still reads its peers' counts
_stores: dict = {}

GUARDS = {"_joined": "_state_lock", "_stores": "_state_lock"}


@dataclasses.dataclass(frozen=True)
class DevicePlaneSpec:
    """Everything a worker needs to join the plane."""

    coordinator_host: str
    coordinator_port: int
    num_processes: int
    process_id: int

    def coordinator_address(self) -> str:
        ip, port = self._endpoint()
        return f"{ip}:{port}"

    def _endpoint(self) -> tuple[str, int]:
        from faabric_tpu_torch.transport.common import resolve_host

        return resolve_host(self.coordinator_host, self.coordinator_port)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "DevicePlaneSpec":
        return cls(coordinator_host=d["coordinator_host"],
                   coordinator_port=int(d["coordinator_port"]),
                   num_processes=int(d["num_processes"]),
                   process_id=int(d["process_id"]))


@dataclasses.dataclass(frozen=True)
class PlaneDevice:
    """One entry of the plane's global device table: a device of process
    ``process_index``, with its card's UUID on CUDA ("" on the CPU)."""

    process_index: int
    device: torch.device
    uuid: str = ""

    def to_dict(self) -> dict:
        return {"process_index": self.process_index, "type": self.device.type,
                "index": self.device.index, "uuid": self.uuid}

    @classmethod
    def from_dict(cls, d: dict) -> "PlaneDevice":
        dev = (torch.device("cpu") if d["type"] == "cpu"
               else torch.device(d["type"], d["index"]))
        return cls(int(d["process_index"]), dev, d["uuid"])


class _Plane:
    """The joined plane of this process: its spec, store, group and
    global device table (immutable once built)."""

    def __init__(self, spec: DevicePlaneSpec, store, generation: int,
                 group, local_ip: str, devices: tuple,
                 timeout_s: float) -> None:
        self.spec = spec
        self.store = store
        # Joins of this store so far, counted alike in every process:
        # the names of this join's groups start with it
        self.generation = generation
        self.group = group
        self.local_ip = local_ip
        self.devices = devices
        self.timeout_s = timeout_s

    def subgroup(self, name: str, members: Sequence[int]):
        """A gloo group of its own over the plane processes ``members``
        (sorted plane indices, this process among them), rendezvoused
        under ``name`` in the plane's store. Creating it is collective
        over ``members`` alone, in any order against other names."""
        from torch.distributed import PrefixStore

        from faabric_tpu_torch.device_plane.xproc import gloo_group

        members = list(members)
        return gloo_group(PrefixStore(f"g{self.generation}/{name}",
                                      self.store),
                          members.index(self.spec.process_id), len(members),
                          self.timeout_s, self.local_ip)


def _card_uuid(index: int) -> str:
    props = torch.cuda.get_device_properties(index)
    return str(getattr(props, "uuid", ""))


def _local_table(process_index: int,
                 local_devices: Optional[Sequence]) -> list[PlaneDevice]:
    if local_devices is None:
        from faabric_tpu_torch.util.device import resolve_device

        resolve_device("cuda")
        local_devices = [torch.device("cuda", i)
                         for i in range(torch.cuda.device_count())]
    out = []
    for d in local_devices:
        d = torch.device(d)
        if d.type == "cuda":
            if d.index is None:
                d = torch.device("cuda", torch.cuda.current_device())
            out.append(PlaneDevice(process_index, d, _card_uuid(d.index)))
        elif d.type == "cpu":
            out.append(PlaneDevice(process_index, torch.device("cpu")))
        else:
            raise ValueError(f"unsupported plane device {d}")
    return out


def _ip_towards(ip: str) -> str:
    """This machine's address on the route to ``ip`` (a UDP socket's
    name after ``connect``, which sends nothing): the interface the gloo
    group listens on."""
    if ip.startswith("127."):
        return ip
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.connect((ip, 9))
        return s.getsockname()[0]


def request_device_plane(planner_client, n_processes: int,
                         timeout: float = 60.0,
                         poll_interval: float = 0.2) -> DevicePlaneSpec:
    """Ask the planner to join the device plane, polling until the
    roster is full. Process ids are assigned in join order and stay
    stable across polls."""
    deadline = time.monotonic() + timeout
    while True:
        spec = planner_client.join_device_plane(n_processes)
        if spec is not None:
            return spec
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"device plane of {n_processes} never assembled within "
                f"{timeout}s (workers missing?)")
        time.sleep(poll_interval)


def join_device_plane(spec: DevicePlaneSpec,
                      local_devices: Optional[Sequence] = None,
                      init_timeout_s: float = DEFAULT_INIT_TIMEOUT_S) -> None:
    """Join the plane: open its store and gloo group at the coordinator's
    address and allgather the global device table. Idempotent for the
    same spec; raises for a different one while joined."""
    global _joined
    from torch.distributed import PrefixStore, TCPStore

    from faabric_tpu_torch.device_plane.xproc import (
        allgather_bytes,
        gloo_group,
    )

    ip, port = spec._endpoint()
    local_ip = _ip_towards(ip)
    # concheck: ok(blocking-under-lock) — joining is once per process and
    # must not race a second join; the rendezvous is bounded by
    # init_timeout_s, as jax.distributed.initialize under the reference's
    # lock is
    with _state_lock:
        if _joined is not None:
            if _joined.spec == spec:
                return
            raise RuntimeError(f"process already joined plane "
                               f"{_joined.spec}; cannot join {spec}")
        logger.info("Joining device plane: %s:%d as process %d/%d", ip, port,
                    spec.process_id, spec.num_processes)
        table = _local_table(spec.process_id, local_devices)
        timeout = datetime.timedelta(seconds=init_timeout_s)
        store = _stores.get((ip, port))
        if store is None:
            store = _stores[ip, port] = TCPStore(
                ip, port, spec.num_processes, spec.process_id == 0, timeout,
                wait_for_workers=False)
        store.set_timeout(timeout)
        # Every process's Nth join of the store is generation N
        generation = (store.add("joins", 1) - 1) // spec.num_processes + 1
        group = gloo_group(PrefixStore(f"g{generation}/plane", store),
                           spec.process_id, spec.num_processes,
                           init_timeout_s, local_ip)
        rows = allgather_bytes(group, json.dumps(
            [d.to_dict() for d in table]).encode())
        devices = tuple(PlaneDevice.from_dict(d)
                        for blob in rows for d in json.loads(blob))
        _joined = _Plane(spec, store, generation, group, local_ip, devices,
                         init_timeout_s)


def leave_device_plane() -> None:
    """Leave the plane (idempotent). The process's exchanges close
    first; nothing here waits on a peer for longer than
    ``LEAVE_TIMEOUT_S``, so a peer that is gone (killed) cannot hold the
    leave."""
    global _joined
    from faabric_tpu_torch.device_plane import xproc

    with _state_lock:
        plane, _joined = _joined, None
    if plane is None:
        return
    deadline = time.monotonic() + LEAVE_TIMEOUT_S
    store = plane.store
    try:
        store.set_timeout(datetime.timedelta(seconds=LEAVE_TIMEOUT_S))
    except Exception:  # noqa: BLE001 — the store's peer may be gone
        logger.debug("device plane store timeout not settable",
                     exc_info=True)
    xproc.close_all(wait_s=LEAVE_TIMEOUT_S)
    # The store lives in the first process: that process waits (boundedly)
    # for the others to be done with it before it may exit
    key = f"g{plane.generation}/left"
    try:
        left = store.add(key, 1)
        while (plane.spec.process_id == 0
               and left < plane.spec.num_processes
               and time.monotonic() < deadline):
            time.sleep(0.05)
            left = store.add(key, 0)
    except Exception:  # noqa: BLE001 — a peer holding the store is gone
        logger.debug("device plane store gone at leave", exc_info=True)


def current_plane() -> Optional[DevicePlaneSpec]:
    with _state_lock:
        return None if _joined is None else _joined.spec


def joined_plane() -> Optional[_Plane]:
    """The joined plane (spec, store, group, table), or None."""
    with _state_lock:
        return _joined


def process_index() -> int:
    """This process's index in the joined plane; 0 without one, as
    ``jax.process_index()`` is in a program of one controller."""
    plane = joined_plane()
    return 0 if plane is None else plane.spec.process_id


def global_devices() -> list[PlaneDevice]:
    """The plane's device table in process order; without a joined plane,
    this process's visible cards (the CPU where there is none)."""
    plane = joined_plane()
    if plane is not None:
        return list(plane.devices)
    if torch.cuda.is_available():
        return _local_table(0, None)
    return [PlaneDevice(0, torch.device("cpu"))]


def plane_summary() -> dict:
    """What this process sees of the plane."""
    plane = joined_plane()
    devices = global_devices()
    me = process_index()
    types = {d.device.type for d in devices if d.process_index == me}
    return {
        "process_index": me,
        "process_count": 1 if plane is None else plane.spec.num_processes,
        "global_devices": len(devices),
        "local_devices": sum(d.process_index == me for d in devices),
        "platform": "gpu" if types == {"cuda"} else "cpu",
    }
