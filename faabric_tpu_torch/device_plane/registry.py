"""Device registration and plane resolution for one MPI world.

Counterpart of ``faabric_tpu/device_plane/registry.py`` (:51-143). The
handshake:

1. every rank resolves its OWN device — the planner-assigned device
   carried in the PTP mappings by default, or an explicit override —
   and registers it with the world;
2. one host-path allgather moves each rank's row to every participant
   (the only wire exchange of the plane);
3. every participant runs the SAME deterministic validation over the
   full row set (``resolve_mesh``). The plane activates only when the
   verdict is clean; any violation raises :class:`MeshMismatch` and the
   world stays on the host ladder. Because the verdict is a pure
   function of data every rank holds, no rank can pick another rung.

A row is ``(rank, device type, device index, process index)``: the
reference's ``(rank, global device id, process index)`` with the device
split into PyTorch's type (0 cpu, 1 cuda) and index, so that a CPU
registration and ``cuda:0`` cannot be mistaken for one device. A
planner id resolves to ``cuda:{id % torch.cuda.device_count()}``.

Divergence from the reference: several ranks may register ONE device.
``jax.sharding.Mesh`` needs distinct devices, so the reference refuses
aliasing; PyTorch has no mesh, faabric's ranks are threads of one host,
and a host with one card has to carry all of them. A world whose local
ranks span several cards is refused instead: multi-card planes (peer
pointers for the ring kernel) wait for ``ROADMAP.md`` Queue 1 step 9.

Across processes: a row's process index is this process's index in the
joined device plane (``parallel/distributed.py``; 0 without one, as
``jax.process_index()`` is in a program of one controller). Ranks of
other processes are accepted only when a plane is joined, the world's
host split is its process split, and every remote rank's device is in
the plane's device table on the same card (the same UUID) as this
process's ranks: the plane moves bytes between processes on one card
(CUDA IPC) or on the CPU (gloo). Processes on different cards wait for
Queue 1 step 9 too.
"""

from __future__ import annotations

import numpy as np
import torch

from faabric_tpu_torch.util.device import resolve_device

ROW_FIELDS = 4
_TYPE_CODES = {"cpu": 0, "cuda": 1}
_TYPE_NAMES = {v: k for k, v in _TYPE_CODES.items()}


class DevicePlaneFallback(RuntimeError):
    """Route this collective (and, once raised from activation or a
    backend failure, every later one) back to the host ladder."""


class MeshMismatch(DevicePlaneFallback):
    """The registered rank→device set does not resolve to one plane."""


def registration_row(rank: int, device: torch.device | None) -> np.ndarray:
    """This rank's handshake row. ``device`` None (no resolvable
    device) still travels, so that every peer reaches the same
    MeshMismatch verdict instead of hanging the handshake."""
    from faabric_tpu_torch.parallel.distributed import process_index

    if device is None:
        return np.array([rank, -1, -1, -1], dtype=np.int64)
    return np.array([rank, _TYPE_CODES[device.type],
                     0 if device.index is None else device.index,
                     process_index()], dtype=np.int64)


def resolve_local_device(world, rank: int) -> torch.device | None:
    """Default registration: the planner-assigned device of ``rank``,
    wrapped modulo this process's card count. None when the placement
    carries no device; raises when it does and there is no card."""
    dev_id = world.device_for_rank(rank)
    if dev_id is None or dev_id < 0:
        return None
    resolve_device("cuda")
    return torch.device("cuda", dev_id % torch.cuda.device_count())


def _plane_table(table):
    """``{(process, type code, index): uuid}`` of the joined plane's
    devices (or of ``table``, a list of ``PlaneDevice``); None without a
    plane."""
    if table is None:
        from faabric_tpu_torch.parallel.distributed import joined_plane

        plane = joined_plane()
        if plane is None:
            return None
        table = plane.devices
    return {(d.process_index, _TYPE_CODES[d.device.type],
             0 if d.device.index is None else d.device.index): d.uuid
            for d in table}


def rank_processes(rows, size: int) -> list[int]:
    """Each rank's process index, in rank order, from rows that
    :func:`resolve_mesh` accepted."""
    rows = np.asarray(rows).reshape(-1, ROW_FIELDS)
    by_rank = {int(r): int(p) for r, _t, _i, p in rows.tolist()}
    return [by_rank[r] for r in range(size)]


def resolve_mesh(rows, size: int, local_ranks, process_index: int | None = None,
                 table=None) -> list[torch.device]:
    """Validate the allgathered registration rows and return each rank's
    device, in rank order (a remote rank's as its own process names
    it). Deterministic in its inputs; ``process_index`` and ``table``
    default to the joined plane's (0 and none without one)."""
    if process_index is None:
        from faabric_tpu_torch.parallel.distributed import (
            process_index as plane_index,
        )

        process_index = plane_index()
    rows = np.asarray(rows).reshape(-1, ROW_FIELDS)
    if rows.shape[0] != size:
        raise MeshMismatch(
            f"handshake returned {rows.shape[0]} rows for a "
            f"{size}-rank world")
    by_rank: dict[int, tuple[int, int, int]] = {}
    for r, type_code, index, pidx in rows.tolist():
        if r in by_rank:
            raise MeshMismatch(f"rank {r} registered twice")
        by_rank[int(r)] = (int(type_code), int(index), int(pidx))
    if sorted(by_rank) != list(range(size)):
        raise MeshMismatch(
            f"rank set {sorted(by_rank)[:8]}... is not 0..{size - 1}")
    missing = [r for r in range(size) if by_rank[r][1] < 0]
    if missing:
        raise MeshMismatch(f"ranks {missing[:8]} registered no device")

    local_ranks = set(local_ranks)
    uuids = None
    devices = []
    for r in range(size):
        type_code, index, pidx = by_rank[r]
        # The world's host split and the registrations' process split
        # must be the same partition
        if (pidx == process_index) != (r in local_ranks):
            raise MeshMismatch(
                f"rank {r}: host split (local={r in local_ranks}) "
                f"disagrees with device process split "
                f"(process {pidx} vs {process_index})")
        kind = _TYPE_NAMES.get(type_code)
        if pidx == process_index:
            count = {"cpu": 1, "cuda": torch.cuda.device_count()}.get(kind, 0)
            known = index < count
        else:
            if uuids is None:
                uuids = _plane_table(table)
            if uuids is None:
                raise MeshMismatch(
                    f"rank {r} is in another process (process {pidx}) and "
                    f"this process joined no device plane "
                    f"(parallel/distributed.py)")
            known = (pidx, type_code, index) in uuids
        if not known:
            raise MeshMismatch(
                f"rank {r}'s device ({type_code}, {index}) is not in this "
                f"backend's device set")
        devices.append(torch.device(kind) if kind == "cpu"
                       else torch.device(kind, index))
    local = sorted({devices[r] for r in local_ranks}, key=str)
    if len(local) > 1:
        raise MeshMismatch(
            f"local ranks span devices {list(map(str, local))}: "
            f"multi-card planes wait for ROADMAP.md Queue 1 step 9")
    remote = sorted(set(range(size)) - local_ranks)
    if remote and local:
        mine = local[0]
        if any(devices[r].type != mine.type for r in remote):
            raise MeshMismatch(
                f"ranks span devices {sorted({str(d) for d in devices})}: "
                f"a plane's processes share one device type")
        if mine.type == "cuda":
            card = _card_uuid(process_index, mine, uuids)
            other = [r for r in remote
                     if uuids[(by_rank[r][2], 1, devices[r].index)] != card]
            if other:
                raise MeshMismatch(
                    f"ranks {other[:8]} are on another card than this "
                    f"process's ranks: planes across cards wait for "
                    f"ROADMAP.md Queue 1 step 9")
    return devices


def _card_uuid(process_index: int, device: torch.device, uuids) -> str:
    """This process's card's UUID: its plane table entry, else the card's
    own."""
    uuid = uuids.get((process_index, 1, device.index))
    if uuid is None:
        from faabric_tpu_torch.parallel.distributed import _card_uuid as live

        uuid = live(device.index)
    return uuid
