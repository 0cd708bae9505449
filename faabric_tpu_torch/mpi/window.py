"""One-sided MPI: shared-memory windows.

Counterpart of ``faabric_tpu/mpi/window.py``, whole: the shared-window
flavour of MPI_Win_* (MPI_Win_allocate_shared, MPI_Win_shared_query).
One named shared-memory segment per window, mapped by every co-located
rank, with per-rank offsets. Put and get on any rank's share are memory
operations on the mapped segment, with no receiver involved;
MPI_Win_fence is the communicator's barrier. A window whose ranks span
hosts raises: the reference has no remote RMA either.
"""

from __future__ import annotations

import numpy as np

from faabric_tpu_torch.util.memory import SharedBuffer

# Window attribute keys (reference mpi.h MPI_WIN_BASE/SIZE/DISP_UNIT)
MPI_WIN_BASE = 1
MPI_WIN_SIZE = 2
MPI_WIN_DISP_UNIT = 3

_NAME_BYTES = 200


class MpiWindow:
    """One rank's handle on a shared window: the mapped segment and
    every rank's (offset, size). Made collectively by
    :func:`allocate_shared`."""

    def __init__(self, world, rank: int, shm: SharedBuffer,
                 sizes: list[int], created: bool) -> None:
        self.world = world
        self.rank = rank
        self._shm = shm
        self.sizes = sizes
        self.offsets = np.concatenate([[0], np.cumsum(sizes)])[:-1].tolist()
        self._created = created  # the creator unlinks on free
        self.freed = False

    def segment(self, rank: int | None = None) -> np.ndarray:
        """The writable byte view of ``rank``'s share (this rank's by
        default): MPI_Win_shared_query."""
        self._check_live()
        r = self.rank if rank is None else rank
        off = self.offsets[r]
        return self._shm.array[off:off + self.sizes[r]]

    def put(self, data, target_rank: int, target_disp: int = 0) -> None:
        """One-sided write into ``target_rank``'s share (MPI_Put)."""
        self._check_live()
        raw = np.asarray(data).reshape(-1).view(np.uint8)
        seg = self.segment(target_rank)
        if target_disp < 0 or target_disp + raw.size > seg.size:
            raise ValueError(
                f"MPI_Put of {raw.size} B at disp {target_disp} overruns "
                f"rank {target_rank}'s {seg.size} B window")
        seg[target_disp:target_disp + raw.size] = raw

    def get(self, target_rank: int, nbytes: int,
            target_disp: int = 0) -> np.ndarray:
        """One-sided read from ``target_rank``'s share (MPI_Get)."""
        self._check_live()
        seg = self.segment(target_rank)
        if target_disp < 0 or nbytes < 0 or target_disp + nbytes > seg.size:
            raise ValueError(
                f"MPI_Get of {nbytes} B at disp {target_disp} overruns "
                f"rank {target_rank}'s {seg.size} B window")
        return seg[target_disp:target_disp + nbytes].copy()

    def fence(self) -> None:
        """Active-target epoch boundary: every rank's earlier puts and
        gets are visible after it (a barrier over shared memory)."""
        self._check_live()
        self.world.barrier(self.rank)

    def get_attr(self, keyval: int):
        self._check_live()
        if keyval == MPI_WIN_BASE:
            return self.segment()
        if keyval == MPI_WIN_SIZE:
            return self.sizes[self.rank]
        if keyval == MPI_WIN_DISP_UNIT:
            return 1  # byte-addressed
        raise ValueError(f"Unknown window attribute {keyval}")

    def free(self) -> None:
        """Collective: barrier, then unmap (the creator unlinks)."""
        if self.freed:
            return
        self.world.barrier(self.rank)
        self.freed = True
        self._shm.close(unlink=self._created)

    def _check_live(self) -> None:
        if self.freed:
            raise RuntimeError("Window already freed")


def allocate_shared(world, rank: int, size: int) -> MpiWindow:
    """Collective window creation over ``world``, which must be
    host-local (from MPI_Comm_split_type(SHARED), say). Rank 0 creates
    the named segment sized to the sum of the contributions and
    broadcasts (name, sizes); everyone maps it."""
    hosts = {world.host_for_rank(r) for r in range(world.size)}
    if len(hosts) > 1:
        raise RuntimeError(
            "Shared windows need co-located ranks (split the world with "
            "MPI_Comm_split_type(MPI_COMM_TYPE_SHARED) first); ranks span "
            f"{sorted(hosts)}")

    gathered = world.gather(rank, 0, np.array([size], np.int64))
    if rank == 0:
        sizes = [int(x) for x in np.asarray(gathered).reshape(-1)]
        shm = SharedBuffer(max(1, sum(sizes)), create=True)
        name_b = shm.name.encode()
        if len(name_b) > _NAME_BYTES:
            raise RuntimeError(f"shm name too long: {shm.name}")
        meta = np.zeros(_NAME_BYTES + 8 * world.size, np.uint8)
        meta[0] = len(name_b)
        meta[1:1 + len(name_b)] = np.frombuffer(name_b, np.uint8)
        meta[_NAME_BYTES:] = np.array(sizes, np.int64).view(np.uint8)
        world.broadcast(0, rank, meta)
        return MpiWindow(world, rank, shm, sizes, created=True)

    meta = np.asarray(world.broadcast(0, rank, np.empty(0, np.uint8)))
    name = bytes(meta[1:1 + int(meta[0])]).decode()
    sizes = [int(x) for x in meta[_NAME_BYTES:].view(np.int64)]
    shm = SharedBuffer(max(1, sum(sizes)), name=name, create=False)
    return MpiWindow(world, rank, shm, sizes, created=False)
