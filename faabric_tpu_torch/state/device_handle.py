"""Device state handles: tensors on a device passed by reference.

Counterpart of ``faabric_tpu/state/device_handle.py``. Functions chained
over shared arrays would move every intermediate through the host state
KV (device -> host image -> device); for a tensor that never leaves the
card between steps both copies are waste. This is the zero-copy tier:

- ``push(world_id, rank, name, tensor)`` registers a live tensor under a
  compact, JSON-serialisable :class:`DeviceStateHandle` (world, rank,
  name, shape, dtype, device index, generation, uid). Nothing is
  copied: the registry holds the tensor itself.
- ``pull(handle)`` gives that same tensor back. Bytes reach the host
  only through ``pull_host``, one counted device-to-host copy
  (``d2h.state``); ``push_from_host`` is the one counted copy the other
  way (``h2d.state``).
- Handles ride chains of functions as plain dicts (``to_dict`` /
  ``from_dict``): about a hundred bytes of metadata, never the payload.

Numpy arrays and bytes are refused with :class:`DeviceHandleError`, as
the reference refuses host values: host bytes belong in the state KV.

A migrated rank never pulls a stale tensor: ``MpiWorld.prepare_migration``
calls :func:`invalidate_world`, which bumps the world's generation and
drops its handles; pulling one of them raises
:class:`StaleDeviceHandle`. After the new handshake the executor pushes
again, under the new generation.

The registry pins what it holds, up to ``FAABRIC_DEVICE_HANDLES_MAX``
(default 256) handles a process; a push past the cap raises (evicting
would make a valid handle stale). ``snapshot_of`` (on-device snapshot
diffs) comes with the snapshot slice (``ROADMAP.md`` Queue 1 #8 part A).
"""

from __future__ import annotations

import threading
from dataclasses import asdict, dataclass

import torch

from faabric_tpu_torch.device_plane.copies import D2H, H2D, count_copy
from faabric_tpu_torch.util.config import _env_int
from faabric_tpu_torch.util.logging import get_logger

logger = get_logger(__name__)

DEFAULT_MAX_HANDLES = 256


class StaleDeviceHandle(KeyError):
    """The handle's tensor is gone or from a generation before a
    migration: push again after the new handshake."""


class DeviceHandleError(ValueError):
    """The pushed value is not a tensor, or the registry is full."""


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


@dataclass(frozen=True)
class DeviceStateHandle:
    """By-reference name of one device tensor; serialisable, so chains
    pass the dict and never the payload. ``device_id`` is the tensor's
    device index (-1 on the CPU)."""

    world_id: int
    rank: int
    name: str
    shape: tuple
    dtype: str
    device_id: int
    gen: int
    uid: int

    def to_dict(self) -> dict:
        d = asdict(self)
        d["shape"] = list(self.shape)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "DeviceStateHandle":
        return cls(world_id=int(d["world_id"]), rank=int(d["rank"]),
                   name=str(d["name"]), shape=tuple(d["shape"]),
                   dtype=str(d["dtype"]), device_id=int(d["device_id"]),
                   gen=int(d["gen"]), uid=int(d["uid"]))

    @property
    def nbytes(self) -> int:
        n = 1
        for s in self.shape:
            n *= int(s)
        return n * getattr(torch, self.dtype).itemsize


class DeviceHandleRegistry:
    """The process's table of device handles."""

    # Concurrency contract: executor threads push and pull while
    # migrations invalidate; one lock covers the table (dict hits only,
    # no copy under the lock)
    GUARDS = {
        "_entries": "_lock",
        "_world_gen": "_lock",
        "_by_world": "_lock",
        "_next_uid": "_lock",
    }

    def __init__(self, max_handles: int | None = None) -> None:
        self.max_handles = (max_handles if max_handles is not None else
                            _env_int("FAABRIC_DEVICE_HANDLES_MAX",
                                     DEFAULT_MAX_HANDLES))
        self._lock = threading.Lock()
        self._entries: dict[int, tuple[DeviceStateHandle, torch.Tensor]] = {}
        self._by_world: dict[int, set[int]] = {}
        self._world_gen: dict[int, int] = {}
        self._next_uid = 1

    # ------------------------------------------------------------------
    def push(self, world_id: int, rank: int, name: str,
             tensor) -> DeviceStateHandle:
        """Register a tensor where it lives; nothing is copied."""
        if not isinstance(tensor, torch.Tensor):
            raise DeviceHandleError(
                f"push() needs a torch.Tensor, got {type(tensor).__name__} "
                "(host values belong in the state KV; push_from_host "
                "places one on a device first)")
        with self._lock:
            if len(self._entries) >= self.max_handles:
                raise DeviceHandleError(
                    f"device handle registry at capacity "
                    f"({self.max_handles}); drop handles or raise "
                    "FAABRIC_DEVICE_HANDLES_MAX")
            gen = self._world_gen.setdefault(world_id, 0)
            uid = self._next_uid
            self._next_uid += 1
            handle = DeviceStateHandle(
                world_id=int(world_id), rank=int(rank), name=str(name),
                shape=tuple(int(s) for s in tensor.shape),
                dtype=_dtype_name(tensor.dtype),
                device_id=int(tensor.get_device()), gen=gen, uid=uid)
            self._entries[uid] = (handle, tensor)
            self._by_world.setdefault(world_id, set()).add(uid)
        return handle

    def _resolve(self, handle) -> tuple[DeviceStateHandle, torch.Tensor]:
        if isinstance(handle, dict):
            handle = DeviceStateHandle.from_dict(handle)
        with self._lock:
            gen = self._world_gen.get(handle.world_id, 0)
            entry = self._entries.get(handle.uid)
        if handle.gen != gen or entry is None:
            raise StaleDeviceHandle(
                f"device handle {handle.uid} "
                f"({handle.world_id}/{handle.rank}/{handle.name}) is "
                f"stale: generation {handle.gen} vs {gen}; the rank "
                "migrated, so handshake again and push again")
        return entry

    def pull(self, handle) -> torch.Tensor:
        """The registered tensor itself: no copy."""
        return self._resolve(handle)[1]

    def pull_host(self, handle) -> torch.Tensor:
        """The tensor's value on the host: the one counted
        device-to-host copy."""
        tensor = self._resolve(handle)[1]
        out = tensor.detach().to("cpu", copy=True)
        count_copy(D2H, out.numel() * out.element_size(), "state")
        return out

    def push_from_host(self, world_id: int, rank: int, name: str,
                       host_arr, device) -> DeviceStateHandle:
        """A host value (numpy array or CPU tensor) entering the device
        tier: one counted host-to-device copy, then a push."""
        host = (host_arr if isinstance(host_arr, torch.Tensor)
                else torch.from_numpy(host_arr))
        tensor = host.to(device, copy=True)
        count_copy(H2D, tensor.numel() * tensor.element_size(), "state")
        return self.push(world_id, rank, name, tensor)

    def snapshot_of(self, handle):
        """On-device snapshot diffs of a handle's tensor."""
        raise NotImplementedError(
            "device snapshots (snapshot/device_snapshot.py) are not ported "
            "yet: they come with the snapshot slice, ROADMAP.md Queue 1 "
            "#8 part A")

    # ------------------------------------------------------------------
    def drop(self, handle) -> bool:
        if isinstance(handle, dict):
            handle = DeviceStateHandle.from_dict(handle)
        with self._lock:
            entry = self._entries.pop(handle.uid, None)
            if entry is not None:
                self._by_world.get(handle.world_id, set()).discard(
                    handle.uid)
        return entry is not None

    def invalidate_world(self, world_id: int) -> int:
        """Migration hook (``MpiWorld.prepare_migration``): bump the
        world's generation and drop its handles."""
        with self._lock:
            self._world_gen[world_id] = \
                self._world_gen.get(world_id, 0) + 1
            gen = self._world_gen[world_id]
            dropped = 0
            nbytes = 0
            for uid in self._by_world.pop(world_id, set()):
                entry = self._entries.pop(uid, None)
                if entry is not None:
                    dropped += 1
                    nbytes += entry[0].nbytes
        if dropped:
            logger.info(
                "Invalidated %d device state handle(s) (%d bytes) for "
                "world %s (generation %d)", dropped, nbytes, world_id, gen)
        return dropped

    def world_generation(self, world_id: int) -> int:
        with self._lock:
            return self._world_gen.get(world_id, 0)

    def summary(self) -> dict:
        with self._lock:
            handles = [h for h, _t in self._entries.values()]
            gens = dict(self._world_gen)
        return {"count": len(handles),
                "bytes": sum(h.nbytes for h in handles),
                "world_generations": gens,
                "handles": [h.to_dict() for h in handles]}

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._by_world.clear()
            self._world_gen.clear()


_registry: DeviceHandleRegistry | None = None
_registry_lock = threading.Lock()


def get_device_handle_registry() -> DeviceHandleRegistry:
    global _registry
    with _registry_lock:
        if _registry is None:
            _registry = DeviceHandleRegistry()
        return _registry


def invalidate_world(world_id: int) -> int:
    """The migration path's call: invalidate without making a registry
    nobody used."""
    with _registry_lock:
        reg = _registry
    if reg is None:
        return 0
    return reg.invalidate_world(world_id)


def reset_device_handles() -> None:
    """Test hook: drop the singleton."""
    global _registry
    with _registry_lock:
        _registry = None
