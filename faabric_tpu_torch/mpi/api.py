"""Guest-facing MPI API.

Counterpart of ``faabric_tpu/mpi/api.py``, whole (reference: the MPI
subset of include/faabric/mpi/mpi.h and its native shim): every
``mpi_*`` function, ``MpiComm``, ``MpiRequest`` and the op constants.
``mpi_init()`` inside an executor task creates or joins the task's world
from its message; every later call uses the calling thread's (world,
rank). Buffers are numpy arrays or tensors: the world runs an eligible
allreduce, allgather or reduce_scatter of tensors on its device plane
and stages every other tensor payload to the host once.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np

from faabric_tpu_torch.mpi.types import MpiOp, MpiStatus, UserOp
from faabric_tpu_torch.mpi.world import MpiWorld

MPI_COMM_WORLD = "MPI_COMM_WORLD"
MPI_COMM_NULL = None
MPI_UNDEFINED = -1
MPI_SUCCESS = 0


class MpiComm:
    """A communicator handle: a (sub)world plus this thread's rank in it.
    ``MPI_COMM_WORLD`` (the string sentinel) resolves to the thread's
    bound world; handles from mpi_comm_split/dup/create pass as the
    ``comm`` argument of every call here."""

    __slots__ = ("world", "rank")

    def __init__(self, world: MpiWorld, rank: int) -> None:
        self.world = world
        self.rank = rank

    @property
    def size(self) -> int:
        return self.world.size

# Re-exported op constants (reference faabric_op_t singletons)
MPI_MAX = MpiOp.MAX
MPI_MIN = MpiOp.MIN
MPI_SUM = MpiOp.SUM
MPI_PROD = MpiOp.PROD
MPI_LAND = MpiOp.LAND
MPI_LOR = MpiOp.LOR
MPI_BAND = MpiOp.BAND
MPI_BOR = MpiOp.BOR
MPI_MAXLOC = MpiOp.MAXLOC
MPI_MINLOC = MpiOp.MINLOC

_tls = threading.local()


class MpiError(Exception):
    pass


class MpiRequest:
    """Async request handle tagged with its communicator's world — so
    MPI_Wait/Test (which take no comm in real MPI) always resolve
    against the world the isend/irecv ran on, never the thread's bound
    parent. Bare int ids (the world-level API) still work for
    MPI_COMM_WORLD callers."""

    __slots__ = ("world", "rank", "id")

    def __init__(self, world: MpiWorld, rank: int, rid: int) -> None:
        self.world = world
        self.rank = rank
        self.id = rid


def _bind(world: MpiWorld, rank: int) -> None:
    _tls.world = world
    _tls.rank = rank
    _tls.start_time = time.monotonic()
    _tls.finalized = False


def _current(comm=MPI_COMM_WORLD) -> tuple[MpiWorld, int]:
    if isinstance(comm, MpiComm):
        return comm.world, comm.rank
    if comm is MPI_COMM_NULL:
        raise MpiError("Communication on MPI_COMM_NULL")
    if comm != MPI_COMM_WORLD:
        raise MpiError(f"Not a communicator: {comm!r}")
    world = getattr(_tls, "world", None)
    if world is None:
        raise MpiError("MPI not initialised on this thread (call mpi_init)")
    return world, _tls.rank


def mpi_init(world_size: int | None = None, world_id: int | None = None) -> int:
    """MPI_Init: bind this thread to its task's world — rank 0 creates it
    (chaining the other ranks through the planner), others join."""
    from faabric_tpu_torch.mpi.registry import get_mpi_context

    ctx = get_mpi_context()
    from faabric_tpu_torch.executor.context import ExecutorContext

    msg = ExecutorContext.get().msg
    if msg.mpi_rank == 0 and not msg.is_mpi:
        msg.is_mpi = True
        if world_id is not None:
            msg.mpi_world_id = world_id
        if world_size is not None:
            msg.mpi_world_size = world_size
        world = ctx.create_world(msg)
    else:
        world = ctx.join_world(msg)
    world.refresh_rank_hosts()
    _bind(world, msg.mpi_rank)
    return MPI_SUCCESS


def mpi_initialized() -> bool:
    return getattr(_tls, "world", None) is not None


def mpi_finalize() -> int:
    _tls.world = None
    _tls.finalized = True
    return MPI_SUCCESS


def mpi_finalized() -> bool:
    return bool(getattr(_tls, "finalized", False))


# Thread-support levels (reference mpi.h MPI_THREAD_*)
MPI_THREAD_SINGLE = 0
MPI_THREAD_FUNNELED = 1
MPI_THREAD_SERIALIZED = 2
MPI_THREAD_MULTIPLE = 3


def mpi_init_thread(required: int = MPI_THREAD_SERIALIZED,
                    world_size: int | None = None,
                    world_id: int | None = None) -> int:
    """MPI_Init_thread: ranks here are one-thread-per-rank with TLS world
    binding, so the provided level is SERIALIZED."""
    mpi_init(world_size, world_id)
    return min(required, MPI_THREAD_SERIALIZED)


def mpi_query_thread() -> int:
    return MPI_THREAD_SERIALIZED


def mpi_get_version() -> tuple[int, int]:
    """The MPI standard version this subset tracks (as the reference's
    header does): 3.1."""
    return (3, 1)


def mpi_abort(comm=MPI_COMM_WORLD, errorcode: int = 1) -> None:
    raise MpiError(f"MPI_Abort with code {errorcode}")


# ---------------------------------------------------------------------------
# Introspection
# ---------------------------------------------------------------------------

def mpi_comm_rank(comm=MPI_COMM_WORLD) -> int:
    return _current(comm)[1]


def mpi_comm_size(comm=MPI_COMM_WORLD) -> int:
    return _current(comm)[0].size


def mpi_wtime() -> float:
    return time.monotonic()


def mpi_get_processor_name() -> str:
    world, rank = _current()
    return world.host_for_rank(rank)


def mpi_topology(comm=MPI_COMM_WORLD):
    """The communicator's Topology (mpi/topology.py): rank→host→
    leader/local-rank — the same structure the scheduler's gang-
    placement hook reads and the hierarchical collectives compose over.
    Guest code uses it to shard work by locality (e.g. one I/O rank per
    host via ``topo.is_leader(rank)``)."""
    world, _ = _current(comm)
    return world.topology()


# ---------------------------------------------------------------------------
# Point-to-point
# ---------------------------------------------------------------------------

def mpi_send(buf, dest: int, comm=MPI_COMM_WORLD) -> int:
    world, rank = _current(comm)
    world.send(rank, dest, buf)
    return MPI_SUCCESS


def mpi_rsend(buf, dest: int, comm=MPI_COMM_WORLD) -> int:
    """MPI_Rsend: ready-mode send — the 'receiver is already posted'
    contract adds nothing over the buffered channel, so it is a plain
    send (the reference shim throws; OpenMPI treats rsend == send on
    most transports too)."""
    return mpi_send(buf, dest, comm)


def mpi_recv(source: int, comm=MPI_COMM_WORLD
             ) -> tuple[np.ndarray, MpiStatus]:
    world, rank = _current(comm)
    return world.recv(source, rank)


def mpi_sendrecv(sendbuf, dest: int, source: int, comm=MPI_COMM_WORLD
                 ) -> tuple[np.ndarray, MpiStatus]:
    world, rank = _current(comm)
    return world.sendrecv(sendbuf, rank, dest, source, rank)


def mpi_isend(buf, dest: int, comm=MPI_COMM_WORLD) -> MpiRequest:
    world, rank = _current(comm)
    return MpiRequest(world, rank, world.isend(rank, dest, buf))


def mpi_irecv(source: int, comm=MPI_COMM_WORLD) -> MpiRequest:
    world, rank = _current(comm)
    return MpiRequest(world, rank, world.irecv(source, rank))


def _resolve_request(request, comm) -> tuple[MpiWorld, int, int]:
    if isinstance(request, MpiRequest):
        return request.world, request.rank, request.id
    world, rank = _current(comm)
    return world, rank, int(request)


def mpi_wait(request, comm=MPI_COMM_WORLD
             ) -> Optional[tuple[np.ndarray, MpiStatus]]:
    world, rank, rid = _resolve_request(request, comm)
    return world.await_async(rank, rid)


def mpi_waitall(requests: list, comm=MPI_COMM_WORLD
                ) -> list[Optional[tuple[np.ndarray, MpiStatus]]]:
    return [mpi_wait(r, comm) for r in requests]


def mpi_waitany(requests: list, comm=MPI_COMM_WORLD
                ) -> tuple[int, Optional[tuple[np.ndarray, MpiStatus]]]:
    """First completable request across possibly-mixed communicators."""
    resolved = [_resolve_request(r, comm) for r in requests]
    deadline = time.monotonic() + 60.0
    while True:
        live = 0
        for i, (world, rank, rid) in enumerate(resolved):
            try:
                ready = world.request_ready(rank, rid)
            except KeyError:
                continue  # completed by an earlier wait
            live += 1
            if ready:
                return i, world.await_async(rank, rid)
        if live == 0:
            return -1, None
        if time.monotonic() >= deadline:
            raise TimeoutError("MPI_Waitany timed out")
        time.sleep(0.0005)


def mpi_test(request, comm=MPI_COMM_WORLD
             ) -> tuple[bool, Optional[tuple]]:
    """MPI_Test: (flag, result). flag False → request still pending (the
    request stays live); True → completed, result as mpi_wait. Testing a
    handle that already completed is legal (MPI_REQUEST_NULL semantics)
    and reports (True, None)."""
    world, rank, rid = _resolve_request(request, comm)
    try:
        if not world.request_ready(rank, rid):
            return False, None
    except KeyError:
        return True, None  # completed by an earlier wait/test
    return True, world.await_async(rank, rid)


def mpi_request_free(request, comm=MPI_COMM_WORLD) -> int:
    """MPI_Request_free: drop the handle without waiting. Sends complete
    in their worker; a freed irecv's already-arrived message is consumed
    and discarded so it can't leak into a later unrelated recv."""
    world, rank, rid = _resolve_request(request, comm)
    world.request_free(rank, rid)
    return MPI_SUCCESS


class MpiContiguousType:
    """Derived datatype from MPI_Type_contiguous: ``count`` elements of a
    base type. mpi_type_size resolves it; commit/free are lifecycle
    no-ops (the reference shim logs and returns for these)."""

    __slots__ = ("base", "count", "committed")

    def __init__(self, base, count: int) -> None:
        self.base = base
        self.count = count
        self.committed = False


def mpi_type_contiguous(count: int, oldtype) -> MpiContiguousType:
    return MpiContiguousType(oldtype, count)


def mpi_type_commit(newtype: MpiContiguousType) -> int:
    newtype.committed = True
    return MPI_SUCCESS


def mpi_type_free(newtype: MpiContiguousType) -> int:
    newtype.committed = False
    return MPI_SUCCESS


def mpi_type_size(dtype) -> int:
    """MPI_Type_size over the framework's datatype enum, a numpy dtype,
    or a derived contiguous type."""
    from faabric_tpu_torch.mpi.types import MpiDataType, np_dtype_for

    if isinstance(dtype, MpiContiguousType):
        return dtype.count * mpi_type_size(dtype.base)
    if isinstance(dtype, (int, MpiDataType)):
        return int(np_dtype_for(MpiDataType(int(dtype))).itemsize)
    return int(np.dtype(dtype).itemsize)


def mpi_op_create(fn, commute: bool = True, name: str = "user_op") -> UserOp:
    """MPI_Op_create: a user reduction ``fn(a, b) -> array`` usable in
    reduce/allreduce/scan/reduce_scatter (the reference shim throws
    notImplemented for user ops; here they ride the same leader-tree
    collectives as the built-ins)."""
    return UserOp(fn, commute, name)


def mpi_op_free(op: UserOp) -> int:
    return MPI_SUCCESS


def mpi_alloc_mem(nbytes: int) -> np.ndarray:
    """MPI_Alloc_mem: a zeroed byte buffer rounded up to whole pages."""
    from faabric_tpu_torch.util.memory import page_align_up

    return np.zeros(page_align_up(nbytes), dtype=np.uint8)


def mpi_free_mem(buf) -> int:
    return MPI_SUCCESS  # numpy buffers are GC-owned


def mpi_reduce_scatter(sendbuf, op: MpiOp, comm=MPI_COMM_WORLD
                       ) -> np.ndarray:
    world, rank = _current(comm)
    return world.reduce_scatter(rank, sendbuf, op)


def mpi_probe(source: int, comm=MPI_COMM_WORLD) -> MpiStatus:
    world, rank = _current(comm)
    return world.probe(source, rank)


def mpi_iprobe(source: int, comm=MPI_COMM_WORLD) -> Optional[MpiStatus]:
    """Non-blocking: pending-message status or None (flag=false)."""
    world, rank = _current(comm)
    return world.iprobe(source, rank)


def mpi_get_count(status: MpiStatus) -> int:
    """MPI_Get_count: elements in the message the status describes."""
    return status.count


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

def mpi_barrier(comm=MPI_COMM_WORLD) -> int:
    world, rank = _current(comm)
    world.barrier(rank)
    return MPI_SUCCESS


def mpi_bcast(buf, root: int, comm=MPI_COMM_WORLD) -> np.ndarray:
    world, rank = _current(comm)
    return world.broadcast(root, rank,
                           buf if buf is not None else np.empty(0))


def mpi_scatter(sendbuf, recv_count: int, root: int,
                comm=MPI_COMM_WORLD) -> np.ndarray:
    world, rank = _current(comm)
    return world.scatter(root, rank,
                         sendbuf if sendbuf is not None else np.empty(0),
                         recv_count)


def mpi_gather(sendbuf, root: int, comm=MPI_COMM_WORLD
               ) -> Optional[np.ndarray]:
    world, rank = _current(comm)
    return world.gather(rank, root, sendbuf)


def mpi_gatherv(sendbuf, root: int, comm=MPI_COMM_WORLD
                ) -> Optional[tuple[np.ndarray, list[int]]]:
    """Root returns (concatenated values in rank order, per-rank counts)."""
    world, rank = _current(comm)
    return world.gatherv(rank, root, sendbuf)


def mpi_scatterv(sendbuf, counts, root: int, comm=MPI_COMM_WORLD
                 ) -> np.ndarray:
    world, rank = _current(comm)
    return world.scatterv(root, rank, sendbuf, counts)


def mpi_alltoallv(sendbuf, send_counts, comm=MPI_COMM_WORLD
                  ) -> tuple[np.ndarray, list[int]]:
    world, rank = _current(comm)
    return world.alltoallv(rank, sendbuf, list(send_counts))


def mpi_allgather(sendbuf, comm=MPI_COMM_WORLD) -> np.ndarray:
    world, rank = _current(comm)
    return world.allgather(rank, sendbuf)


def mpi_allgatherv(sendbuf, comm=MPI_COMM_WORLD
                   ) -> tuple[np.ndarray, list[int]]:
    """MPI_Allgatherv (the reference shim throws notImplemented):
    variable-count gather to root + two broadcasts. Every rank returns
    (concatenated values in rank order, per-rank counts)."""
    world, rank = _current(comm)
    res = world.gatherv(rank, 0, sendbuf)
    if rank == 0:
        data, counts = res
        counts_arr = np.asarray(counts, np.int64)
        world.broadcast(0, rank, counts_arr)
        world.broadcast(0, rank, data)
        return data, list(counts)
    counts_arr = np.asarray(world.broadcast(0, rank, np.empty(0, np.int64)))
    data = np.asarray(world.broadcast(0, rank, np.empty(0)))
    return data, [int(c) for c in counts_arr]


def mpi_reduce(sendbuf, op: MpiOp, root: int, comm=MPI_COMM_WORLD
               ) -> Optional[np.ndarray]:
    world, rank = _current(comm)
    return world.reduce(rank, root, sendbuf, op)


def mpi_allreduce(sendbuf, op: MpiOp, comm=MPI_COMM_WORLD) -> np.ndarray:
    world, rank = _current(comm)
    return world.allreduce(rank, sendbuf, op)


def mpi_scan(sendbuf, op: MpiOp, comm=MPI_COMM_WORLD) -> np.ndarray:
    world, rank = _current(comm)
    return world.scan(rank, sendbuf, op)


def mpi_alltoall(sendbuf, comm=MPI_COMM_WORLD) -> np.ndarray:
    world, rank = _current(comm)
    return world.alltoall(rank, sendbuf)


# ---------------------------------------------------------------------------
# Cartesian topology (reference MPI_Cart_*)
# ---------------------------------------------------------------------------

def mpi_cart_create(dims=None, comm=MPI_COMM_WORLD) -> tuple[int, ...]:
    """MPI_Cart_create with user dims (all-periodic); None keeps the
    default near-square 2-D factorisation."""
    world, _ = _current(comm)
    return world.cart_create(dims)


def mpi_cart_get(comm=MPI_COMM_WORLD) -> tuple[tuple[int, ...],
                                               tuple[int, ...]]:
    world, rank = _current(comm)
    return world.cart_dims(), world.cart_coords(rank)


def mpi_cart_rank(coords: tuple[int, int], comm=MPI_COMM_WORLD) -> int:
    world, _ = _current(comm)
    return world.cart_rank(coords)


def mpi_cart_shift(direction: int, disp: int, comm=MPI_COMM_WORLD
                   ) -> tuple[int, int]:
    world, rank = _current(comm)
    return world.cart_shift(rank, direction, disp)


# ---------------------------------------------------------------------------
# Communicator / group management (reference mpi.h MPI_Comm_split_type,
# MPI_Comm_dup, MPI_Comm_group/Group_incl/Comm_create_group, MPI_Comm_free)
# ---------------------------------------------------------------------------

def mpi_comm_split(color: int, key: int = 0,
                   comm=MPI_COMM_WORLD) -> Optional[MpiComm]:
    """Collective: ranks sharing ``color`` form a new communicator,
    ordered by (key, rank). ``MPI_UNDEFINED`` color → MPI_COMM_NULL."""
    world, rank = _current(comm)
    sub, new_rank = world.split(rank, color, key)
    if sub is None:
        return MPI_COMM_NULL
    return MpiComm(sub, new_rank)


def mpi_comm_dup(comm=MPI_COMM_WORLD) -> MpiComm:
    """Collective: same membership, isolated communication context."""
    world, rank = _current(comm)
    sub, new_rank = world.dup(rank)
    return MpiComm(sub, new_rank)


def mpi_comm_group(comm=MPI_COMM_WORLD) -> list[int]:
    """MPI_Comm_group: the group is simply the rank list (local op)."""
    world, _ = _current(comm)
    return list(range(world.size))


def mpi_group_incl(group: list[int], ranks: list[int]) -> list[int]:
    """MPI_Group_incl (local op)."""
    return [group[r] for r in ranks]


def mpi_comm_create_group(group: list[int], tag: int = 0,
                          comm=MPI_COMM_WORLD) -> Optional[MpiComm]:
    """Collective over ``group``'s members only (MPI_Comm_create_group)."""
    world, rank = _current(comm)
    sub, new_rank = world.create_group_comm(rank, list(group), tag)
    if sub is None:
        return MPI_COMM_NULL
    return MpiComm(sub, new_rank)


def mpi_comm_free(comm: MpiComm) -> int:
    """MPI_Comm_free — collective: barriers the sub-communicator so all
    in-flight traffic lands, then stops its send workers. The (tiny)
    per-host queue/mapping stubs stay until the app's groups clear at
    batch teardown: clearing them here would race co-located ranks still
    draining their last messages."""
    if isinstance(comm, MpiComm):
        comm.world.barrier(comm.rank)
        comm.world.close()
    return MPI_SUCCESS


MPI_COMM_TYPE_SHARED = 1


def mpi_comm_split_type(split_type: int = MPI_COMM_TYPE_SHARED,
                        key: int = 0, comm=MPI_COMM_WORLD) -> MpiComm:
    """MPI_Comm_split_type: MPI_COMM_TYPE_SHARED groups co-located
    (shared-memory) ranks — one subworld per host."""
    if split_type != MPI_COMM_TYPE_SHARED:
        raise MpiError(f"Unsupported split type {split_type}")
    world, rank = _current(comm)
    sub, new_rank = world.split_type_shared(rank, key)
    return MpiComm(sub, new_rank)


def mpi_comm_create(group: list[int], comm=MPI_COMM_WORLD
                    ) -> Optional[MpiComm]:
    """MPI_Comm_create — collective over ALL of ``comm`` (unlike
    mpi_comm_create_group): members form the new communicator in group
    order, everyone else gets MPI_COMM_NULL."""
    world, rank = _current(comm)
    in_group = rank in group
    color = 0 if in_group else MPI_UNDEFINED
    key = list(group).index(rank) if in_group else 0
    sub, new_rank = world.split(rank, color, key)
    if sub is None:
        return MPI_COMM_NULL
    return MpiComm(sub, new_rank)


# ---------------------------------------------------------------------------
# One-sided (shared windows — mpi/window.py; the reference shim stubs all
# of MPI_Win_*/Put/Get with notImplemented)
# ---------------------------------------------------------------------------

def mpi_win_allocate_shared(size: int, comm=MPI_COMM_WORLD):
    """MPI_Win_allocate_shared: collective over a host-local communicator
    (use mpi_comm_split_type(MPI_COMM_TYPE_SHARED) first on multi-host
    worlds). Returns (window, own byte segment view)."""
    from faabric_tpu_torch.mpi.window import allocate_shared

    world, rank = _current(comm)
    win = allocate_shared(world, rank, size)
    return win, win.segment()


def mpi_win_shared_query(win, rank: int) -> tuple[np.ndarray, int]:
    """(segment view, size) of another rank's share."""
    return win.segment(rank), win.sizes[rank]


def mpi_win_fence(win) -> int:
    win.fence()
    return MPI_SUCCESS


def mpi_put(data, target_rank: int, target_disp: int, win) -> int:
    win.put(data, target_rank, target_disp)
    return MPI_SUCCESS


def mpi_get(target_rank: int, nbytes: int, target_disp: int,
            win) -> np.ndarray:
    return win.get(target_rank, nbytes, target_disp)


def mpi_win_get_attr(win, keyval: int):
    return win.get_attr(keyval)


def mpi_win_free(win) -> int:
    win.free()
    return MPI_SUCCESS


def mpi_win_create(*_a, **_k):
    raise MpiError(
        "MPI_Win_create over caller-provided buffers cannot span "
        "processes; use mpi_win_allocate_shared (the reference stubs "
        "both with notImplemented)")


# ---------------------------------------------------------------------------
# Group management extras
# ---------------------------------------------------------------------------

def mpi_group_free(group) -> int:
    """MPI_Group_free: groups are plain rank lists (local objects)."""
    return MPI_SUCCESS


def mpi_dims_create(nnodes: int, ndims: int) -> list[int]:
    """MPI_Dims_create: balanced factorization of ``nnodes`` over
    ``ndims`` dimensions (descending, as the standard requires)."""
    if nnodes <= 0 or ndims <= 0:
        raise MpiError("dims_create needs positive nnodes/ndims")
    dims = [1] * ndims
    remaining = nnodes
    # Peel prime factors largest-first onto the smallest dimension
    factors = []
    f = 2
    while f * f <= remaining:
        while remaining % f == 0:
            factors.append(f)
            remaining //= f
        f += 1
    if remaining > 1:
        factors.append(remaining)
    for factor in sorted(factors, reverse=True):
        dims[dims.index(min(dims))] *= factor
    return sorted(dims, reverse=True)
