"""Device mesh: axis layout, shard specs and the gang-scheduling glue.

Counterpart of ``faabric_tpu/parallel/mesh.py``. The JAX package lays a
``jax.sharding.Mesh`` over distinct chips and lets XLA insert the
collectives. The port is one process driving a list of rank devices,
which may all be one device (the card's machine has one H100): a mesh
here is the rank grid over those devices, and a sharded value is a list
of per-rank tensors, each of its shard's own shape, on its rank's
device. Rank i takes the mesh coordinates JAX gives device i: the
devices are laid out as (dp, sp, pp, ep, tp) and tp then moves to axis 1,
so tp is the fastest-varying axis over the rank order.

    dp — data parallel (batch)           → gradient allreduce
    tp — tensor parallel (heads/hidden)  → activation collectives
    sp — sequence parallel (long ctx)    → ring attention / K/V gathers
    pp — pipeline parallel (stages)      → stage-to-stage shifts (pipeline.py)
    ep — expert parallel (MoE)           → expert outputs summed (models/moe.py)

Every movement of data between ranks goes through
``parallel/collectives.py::DeviceCollectives``; ``Mesh.collectives``
hands out one per group of ranks along the named axes.

Across the processes of a device plane (``parallel/distributed.py``) a
mesh is laid over the plane's global devices, as the reference's over
``jax.devices()``: ``build_mesh(global_devices(), MeshConfig(tp=2))``.
Each process holds only its own ranks (``local_ranks``); every per-rank
list, weights and activations alike, holds ``None`` for the others',
and ``rank_devices`` holds ``None`` there too. :meth:`Mesh.over` decides
per (mesh, axes), from the rank-to-process table that every process
holds alike, whether a call crosses processes:

- where every group along the axes lies in one process, each process
  runs the single-process collectives, autograd included, on its own
  groups, and makes no exchange;
- where some group spans processes, the call is one exchange round over
  every group at once (``collectives.py::cross_process``): every process
  gets every rank's deposit (of a permute, only the shards that land on
  its ranks), folds its own groups in rank order with the
  single-process code (so results are bitwise the single-process
  mesh's) and keeps its ranks' outputs. The call is one autograd node,
  whose backward is one more round, so both processes meet the same
  rounds in the same order as long as they run the same program over
  their ranks, as the port's sharded steps do. A design of one round
  per group would leave the order of independent groups' backward
  rounds to each process's autograd engine; one round per call leaves
  it nothing to order.

So a call names its collective rather than running code on a group's
collectives: ``mesh.over("tp", xs, "allreduce")``.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional, Sequence

import numpy as np
import torch

MESH_AXES = ("dp", "tp", "sp", "pp", "ep")


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Axis sizes; -1 on dp means 'absorb remaining devices'."""

    dp: int = -1
    tp: int = 1
    sp: int = 1
    pp: int = 1
    ep: int = 1

    def resolve(self, n_devices: int) -> dict[str, int]:
        fixed = self.tp * self.sp * self.pp * self.ep
        if n_devices % fixed != 0:
            raise ValueError(
                f"{n_devices} devices not divisible by tp*sp*pp*ep={fixed}")
        dp = self.dp if self.dp > 0 else n_devices // fixed
        if dp * fixed != n_devices:
            raise ValueError(
                f"dp*tp*sp*pp*ep={dp * fixed} != n_devices={n_devices}")
        return {"dp": dp, "tp": self.tp, "sp": self.sp, "pp": self.pp,
                "ep": self.ep}


class Mesh:
    """The (dp, tp, sp, pp, ep) grid of ranks over their devices.

    ``shape`` maps axis to size; ``ranks`` is the grid of rank numbers;
    ``devices`` the same grid of ``torch.device``s (as JAX's
    ``Mesh.devices``), ``rank_devices`` the devices in rank order. The
    entries may be the device plane's ``PlaneDevice``s: ``rank_process``
    then maps each rank to its process, ``local_ranks`` are this
    process's, and other processes' ranks have ``None`` for a device.
    """

    def __init__(self, rank_devices: Sequence, sizes: dict[str, int]) -> None:
        from faabric_tpu_torch.parallel.distributed import (
            PlaneDevice,
            process_index,
        )

        self.entries = list(rank_devices)
        plane = any(isinstance(d, PlaneDevice) for d in self.entries)
        self.rank_process = [d.process_index if isinstance(d, PlaneDevice)
                             else 0 for d in self.entries]
        self.process_index = process_index() if plane else 0
        self.local_ranks = [r for r, p in enumerate(self.rank_process)
                            if p == self.process_index]
        self.rank_devices = [
            torch.device(d.device if isinstance(d, PlaneDevice) else d)
            if p == self.process_index else None
            for d, p in zip(self.entries, self.rank_process)]
        self.size = len(self.rank_devices)
        # Ranks in other processes: per-rank lists hold None for them
        self.multiprocess = len(self.local_ranks) != self.size
        self.axis_names = MESH_AXES
        self.shape = {a: int(sizes[a]) for a in MESH_AXES}
        grid = np.arange(self.size).reshape(
            self.shape["dp"], self.shape["sp"], self.shape["pp"],
            self.shape["ep"], self.shape["tp"])
        # Present axes in canonical (dp, tp, sp, pp, ep) name order
        self.ranks = np.moveaxis(grid, 4, 1)
        self.devices = np.empty(self.ranks.shape, dtype=object)
        for idx, r in np.ndenumerate(self.ranks):
            self.devices[idx] = self.rank_devices[r]
        self._coords = {int(r): dict(zip(MESH_AXES, idx))
                        for idx, r in np.ndenumerate(self.ranks)}
        self._collectives: dict[tuple, list] = {}
        self._crosses: dict[tuple, bool] = {}
        self._lock = threading.Lock()

    def __repr__(self) -> str:
        devices = sorted({str(d) for d in self.rank_devices if d is not None})
        return f"Mesh({self.shape}, devices={devices})"

    @property
    def device(self) -> Optional[torch.device]:
        """This process's first rank's device (None where it holds no
        rank): where whole values are made and gathered."""
        return (self.rank_devices[self.local_ranks[0]] if self.local_ranks
                else None)

    def coords(self, rank: int) -> dict[str, int]:
        """Rank → its coordinate on every axis."""
        return dict(self._coords[rank])

    def index(self, rank: int, axis: str) -> int:
        return self._coords[rank][axis]

    def rank_at(self, **coords: int) -> int:
        """Coordinates (missing axes 0) → rank."""
        return int(self.ranks[tuple(coords.get(a, 0) for a in MESH_AXES)])

    def groups(self, axes: str | Sequence[str]) -> list[list[int]]:
        """The ranks that share every coordinate off ``axes``, one list a
        group, each ordered by its coordinates along ``axes`` (the first
        axis named the slowest)."""
        axes = _as_axes(axes)
        rest = [a for a in MESH_AXES if a not in axes]
        order = [MESH_AXES.index(a) for a in (*rest, *axes)]
        grid = np.transpose(self.ranks, order)
        n_rest = int(np.prod([self.shape[a] for a in rest], dtype=int))
        return [list(map(int, g)) for g in grid.reshape(n_rest, -1)]

    def crosses(self, axes: str | Sequence[str]) -> bool:
        """Whether some group along ``axes`` spans processes: the same
        answer in every process, made once per mesh and axes."""
        if not self.multiprocess:
            return False
        key = _as_axes(axes)
        with self._lock:
            out = self._crosses.get(key)
            if out is None:
                out = any(len({self.rank_process[r] for r in g}) > 1
                          for g in self.groups(key))
                self._crosses[key] = out
            return out

    def collectives(self, axes: str | Sequence[str]):
        """[(ranks, DeviceCollectives over them)] for every group along
        ``axes`` that lies in this process, made once per mesh."""
        from faabric_tpu_torch.parallel.collectives import DeviceCollectives

        key = _as_axes(axes)
        with self._lock:
            out = self._collectives.get(key)
            if out is None:
                local = set(self.local_ranks)
                out = [(g, DeviceCollectives([self.rank_devices[r]
                                              for r in g]))
                       for g in self.groups(key) if set(g) <= local]
                self._collectives[key] = out
            return out

    def over(self, axes: str | Sequence[str], xs: Sequence, kind: str,
             **kw) -> list:
        """The collective ``kind`` (a ``DeviceCollectives`` method, with
        its keyword arguments ``kw``) on every group along ``axes``; the
        outputs in rank order (``None`` for other processes' ranks).
        Where the groups are single ranks the inputs come back as they
        are: there is nothing to communicate. Where a group spans
        processes the call is one exchange round over every group (see
        the module)."""
        key = _as_axes(axes)
        if all(self.shape[a] == 1 for a in key):
            return list(xs)
        if self.crosses(key):
            from faabric_tpu_torch.parallel.collectives import cross_process

            return cross_process(self.rank_process, self.groups(key),
                                 list(xs), kind, **kw)
        out: list = [None] * self.size
        for ranks, coll in self.collectives(key):
            ys = getattr(coll, kind)([xs[r] for r in ranks], **kw)
            for r, y in zip(ranks, ys):
                out[r] = y
        return out


def _as_axes(axes) -> tuple[str, ...]:
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    for a in axes:
        if a not in MESH_AXES:
            raise ValueError(f"unknown mesh axis {a!r}: use one of {MESH_AXES}")
    return axes


def build_mesh(devices: Optional[Sequence] = None,
               config: MeshConfig | None = None) -> Mesh:
    """Lay a (dp, tp, sp, pp, ep) mesh over the rank devices, rank i on
    ``devices[i]`` (the devices may repeat). ``None`` means every CUDA
    card of this process."""
    if devices is None:
        from faabric_tpu_torch.util.device import resolve_device

        resolve_device("cuda")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    config = config or MeshConfig()
    return Mesh(devices, config.resolve(len(devices)))


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """How a value lies over a mesh: per dim, the axis (or axes, the
    first the slowest) its extent splits over, or None. Counterpart of a
    ``NamedSharding``; ``shard`` places a whole value as per-rank pieces
    and ``gather`` assembles them again."""

    mesh: Mesh
    spec: tuple

    def _dim_axes(self):
        return [() if s is None else _as_axes(s) for s in self.spec]

    def block_index(self, rank: int) -> tuple[int, ...]:
        """Which piece of each sharded dim ``rank`` holds."""
        c = self.mesh.coords(rank)
        idx = []
        for axes in self._dim_axes():
            i = 0
            for a in axes:
                i = i * self.mesh.shape[a] + c[a]
            idx.append(i)
        return tuple(idx)

    def parts(self) -> tuple[int, ...]:
        return tuple(int(np.prod([self.mesh.shape[a] for a in axes], dtype=int))
                     for axes in self._dim_axes())

    def replica_axes(self) -> tuple[str, ...]:
        """The axes the value is replicated over."""
        sharded = {a for axes in self._dim_axes() for a in axes}
        return tuple(a for a in MESH_AXES if a not in sharded)

    def replica_groups(self) -> list[list[int]]:
        """The ranks that hold the same piece, one list a piece."""
        return self.mesh.groups(self.replica_axes())

    def local_shape(self, shape) -> tuple[int, ...]:
        shape = tuple(shape)
        out = list(shape)
        for d, n in enumerate(self.parts()):
            if shape[d] % n:
                raise ValueError(f"dim {d} of {shape} does not split "
                                 f"into {n} over {self.spec[d]}")
            out[d] = shape[d] // n
        return tuple(out)

    def _slices(self, shape, rank: int):
        local = self.local_shape(shape)
        idx = self.block_index(rank)
        return tuple(slice(i * n, (i + 1) * n)
                     for i, n in zip(idx, local[:len(idx)]))

    def shard(self, x, dtype: torch.dtype | None = None) -> list:
        """A whole value (numpy array or tensor) → each rank's piece, a
        tensor of its own on the rank's device (``None`` for other
        processes' ranks). A pinned host tensor's pieces are copied
        without blocking."""
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.require(x, requirements=["C", "W"]))
        out = []
        for r, dev in enumerate(self.mesh.rank_devices):
            if dev is None:
                out.append(None)
                continue
            piece = x[self._slices(x.shape, r)]
            out.append(piece.to(dev, dtype=dtype, copy=True,
                                non_blocking=piece.is_pinned()))
        return out

    def gather(self, xs: Sequence, device=None) -> torch.Tensor:
        """Per-rank pieces → the whole value on ``device`` (this process's
        first rank's by default), each piece taken from the lowest rank
        that holds it. Across processes every process gets the whole
        value: the other processes' pieces come over one exchange
        round."""
        device = self.mesh.device if device is None else device
        if self.mesh.multiprocess:
            from faabric_tpu_torch.parallel.collectives import gather_every

            with torch.no_grad():
                xs = gather_every(self.mesh.rank_process, xs)
        parts = self.parts()
        full = tuple(n * p for n, p in zip(xs[0].shape, parts)) + tuple(
            xs[0].shape[len(parts):])
        out = torch.empty(full, dtype=xs[0].dtype, device=device)
        seen = set()
        for r, x in enumerate(xs):
            idx = self.block_index(r)
            if idx not in seen:
                seen.add(idx)
                out[self._slices(full, r)] = x.detach().to(device)
        return out


def named(mesh: Mesh, *spec) -> ShardSpec:
    return ShardSpec(mesh, tuple(spec))


def replicated(mesh: Mesh) -> ShardSpec:
    return ShardSpec(mesh, ())


def mesh_from_group(broker, group_id: int, ranks: Sequence[int],
                    config: MeshConfig | None = None,
                    device_type: str = "cuda") -> Mesh:
    """Build a mesh from a gang-scheduled group's device placement: rank
    i's planner-assigned device id (carried in the point-to-point
    mappings) becomes mesh position i."""
    from faabric_tpu_torch.parallel.collectives import local_devices_for_ids

    broker.wait_for_mappings(group_id)
    device_ids = [broker.get_device_for_idx(group_id, r) for r in ranks]
    return build_mesh(local_devices_for_ids(device_ids, device_type), config)
