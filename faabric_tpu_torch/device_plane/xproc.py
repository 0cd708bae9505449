"""One round's exchange between the processes of a device plane.

Used by the MPI world's device rung when its ranks live in several
processes (``plane.py``) and by the addressable forms of
``DeviceCollectives`` (``parallel/collectives.py``). The reference has no
such module: its cross-process rounds are XLA collectives over one
``jax.distributed`` plane. The simplest design that is right: every
process gets every rank's deposit, and every process folds them in rank
order with the single-process code, so the results are bitwise those of
the single-process plane on the same inputs.

An :class:`Exchanger` serves one set of ranks spread over plane
processes (``rank_process[r]`` is rank r's process index) over a gloo
group of its own, made from the joined plane's store at the first round
(``parallel/distributed.py``).

- **CPU** — one gloo ``allgather`` of every process's deposits as bytes,
  padded to the largest process's share (a process may hold 3 ranks and
  another 1; gloo needs equal sizes).
- **CUDA** (processes on one card) — one device window per process,
  allocated with ``cudaMalloc`` (never the caching allocator, whose
  memory under ``expandable_segments`` has no IPC handle). Its
  ``cudaIpcGetMemHandle`` goes to the peers over the group and each peer
  maps it with ``cudaIpcOpenMemHandle``. A round copies the local
  deposits into the window (device to device), synchronizes the stream,
  passes a gloo barrier, reads the peers' windows in place, and
  synchronizes and passes a second barrier before any window is written
  again. A ring round instead writes each local shard straight into its
  destination, a local output or a peer's window, in one launch of the
  ring-permute kernel (``ops/ring_permute.py::ring_permute_to``), which
  a CUDA event pair times alone (:meth:`Exchanger.ring_kernel_ms`). A
  window grows by re-exchanging handles, and a peer unmaps a window
  before its owner frees it. The group carries handles and barriers,
  never payload: there is no host staging and no fallback to one, so a
  kernel or IPC error reaches every rank's caller.
"""

from __future__ import annotations

import contextlib
import datetime
import logging
import collections
import threading
import time
import weakref
from typing import Sequence

import torch

logger = logging.getLogger(__name__)

# Window slots start on this boundary, so the ring kernel's 16-byte body
# applies to every slot
SLOT_ALIGN = 256
# A round waits at most this long for its peers
ROUND_TIMEOUT_S = 300.0
# The ring kernel's times an exchanger keeps (the latest rounds')
RING_TIMES_KEPT = 64

# Live exchangers (closed when the process leaves the plane) and windows
# whose owner waits for its peers to unmap them before it frees
_live: "weakref.WeakSet[Exchanger]" = weakref.WeakSet()
_pending_free: list = []
_registry_lock = threading.Lock()
_named: dict = {}

GUARDS = {"_live": "_registry_lock", "_pending_free": "_registry_lock",
          "_named": "_registry_lock"}


def gloo_group(store, rank: int, size: int, timeout_s: float, ip: str):
    """A gloo process group of its own over ``store`` (never the
    process's default group), listening on ``ip``."""
    from torch.distributed import ProcessGroupGloo

    opts = ProcessGroupGloo._Options()
    opts._devices = [ProcessGroupGloo.create_device(hostname=ip)]
    opts._timeout = datetime.timedelta(seconds=timeout_s)
    return ProcessGroupGloo(store, rank, size, opts)


def _wait(work, timeout_s: float = ROUND_TIMEOUT_S) -> None:
    work.wait(datetime.timedelta(seconds=timeout_s))


def allgather_bytes(group, data: bytes) -> list[bytes]:
    """Every member's ``data``, in member order (lengths first, then the
    bytes padded to the longest)."""
    size = group.size()
    n = torch.tensor([len(data)], dtype=torch.int64)
    ns = [torch.empty(1, dtype=torch.int64) for _ in range(size)]
    _wait(group.allgather([ns], [n]))
    longest = max(1, max(int(x) for x in ns))
    buf = torch.zeros(longest, dtype=torch.uint8)
    if data:
        buf[:len(data)] = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    outs = [torch.empty_like(buf) for _ in range(size)]
    _wait(group.allgather([outs], [buf]))
    return [bytes(o[:int(k)].numpy()) for o, k in zip(outs, ns)]


class _CudaBytes:
    """A device byte range as ``__cuda_array_interface__`` (version 2: no
    stream semantics), which ``torch.as_tensor`` wraps without owning."""

    def __init__(self, ptr: int, nbytes: int) -> None:
        self.__cuda_array_interface__ = {
            "shape": (nbytes,), "typestr": "|u1", "data": (ptr, False),
            "version": 2}


def _device_bytes(ptr: int, nbytes: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_CudaBytes(ptr, nbytes), device=device)


def _round_up(n: int, k: int) -> int:
    return (n + k - 1) // k * k


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1).view(torch.uint8)


class Exchanger:
    """The cross-process exchange of one rank set (see the module)."""

    # Concurrency contract: rounds are serialized per exchanger (every
    # process must issue them in one order), and the group, the windows
    # and their mappings change only inside a round or at close
    GUARDS = {
        "_group": "_lock",
        "_own": "_lock",
        "_cap": "_lock",
        "_peers": "_lock",
        "_closed": "_lock",
        "_ring_ms": "_lock",
    }

    def __init__(self, name: str, rank_process: Sequence[int],
                 device: torch.device) -> None:
        from faabric_tpu_torch.parallel.distributed import joined_plane

        plane = joined_plane()
        if plane is None:
            raise RuntimeError("a cross-process exchange needs a joined "
                               "device plane (parallel/distributed.py)")
        self.name = name
        self.plane = plane
        self.rank_process = [int(p) for p in rank_process]
        self.n = len(self.rank_process)
        self.members = sorted(set(self.rank_process))
        self.me = self.members.index(plane.spec.process_id)
        # ranks of each member, in rank order; a rank's slot is its place
        self.ranks_of = [[r for r, p in enumerate(self.rank_process)
                          if p == m] for m in self.members]
        self.slot = {r: ranks.index(r) for ranks in self.ranks_of
                     for r in ranks}
        self.member_of = {r: self.members.index(p)
                          for r, p in enumerate(self.rank_process)}
        self.local_ranks = self.ranks_of[self.me]
        self.max_local = max(len(rs) for rs in self.ranks_of)
        self.device = torch.device(device)
        self._lock = threading.Lock()
        self._group = None
        self._own: int | None = None   # this process's window (a pointer)
        self._cap = 0
        self._peers: dict[int, int] = {}  # member → its mapped window
        self._closed = False
        # CUDA-event ms of the ring kernel's launches, latest last
        self._ring_ms: collections.deque = collections.deque(
            maxlen=RING_TIMES_KEPT)
        with _registry_lock:
            _live.add(self)

    # ------------------------------------------------------------------
    def _group_locked(self):
        if self._closed:
            raise RuntimeError(f"exchange {self.name} is closed")
        if self._group is None:
            self._group = self.plane.subgroup(self.name, self.members)
        return self._group

    def _barrier_locked(self) -> None:
        _wait(self._group_locked().barrier())

    def _ensure_window_locked(self, nbytes: int) -> int:
        """Every window holds at least ``max_local`` slots of ``nbytes``;
        returns the slot stride. Growing is collective (every process
        derives the same capacity from the same key)."""
        from faabric_tpu_torch.ops import _build

        stride = _round_up(nbytes, SLOT_ALIGN)
        need = stride * self.max_local
        if need <= self._cap:
            return stride
        k = _build.kernels()
        dev = self.device.index
        # Peers unmap a window before its owner frees it
        for ptr in self._peers.values():
            k.ipc_close(dev, ptr)
        self._peers.clear()
        self._barrier_locked()
        if self._own is not None:
            k.ipc_free(dev, self._own)
            self._own, self._cap = None, 0
        self._own = k.ipc_alloc(dev, need)
        self._cap = need
        handles = allgather_bytes(self._group_locked(),
                                  k.ipc_handle(dev, self._own))
        for m, h in enumerate(handles):
            if m != self.me:
                self._peers[m] = k.ipc_open(dev, h)
        return stride

    # ------------------------------------------------------------------
    @contextlib.contextmanager
    def gather(self, local: dict[int, torch.Tensor]):
        """Every rank's flat deposit, in rank order, for the body of the
        ``with``: the local ranks' own tensors and the peers' (on the
        card, views of their windows, valid until the ``with`` ends). The
        deposits share a dtype and size, and lie on this exchanger's
        device; a CUDA deposit must be complete on the current stream."""
        first = local[self.local_ranks[0]]
        nbytes = first.numel() * first.element_size()
        with self._lock:
            if self.device.type == "cuda":
                ins = self._gather_cuda_locked(local, first, nbytes)
                try:
                    yield ins
                finally:
                    # Every reader is done before any window is rewritten
                    torch.cuda.current_stream(self.device).synchronize()
                    self._barrier_locked()
            else:
                yield self._gather_cpu_locked(local, first, nbytes)

    def _gather_cpu_locked(self, local, first, nbytes: int) -> list:
        share = torch.zeros(self.max_local * nbytes, dtype=torch.uint8)
        for r in self.local_ranks:
            i = self.slot[r]
            share[i * nbytes:(i + 1) * nbytes] = _as_bytes(local[r])
        group = self._group_locked()
        outs = [torch.empty_like(share) for _ in self.members]
        _wait(group.allgather([outs], [share]))
        ins = []
        for r in range(self.n):
            if r in local:
                ins.append(local[r])
                continue
            i = self.slot[r]
            ins.append(outs[self.member_of[r]][i * nbytes:(i + 1) * nbytes]
                       .view(first.dtype))
        return ins

    def _gather_cuda_locked(self, local, first, nbytes: int) -> list:
        stride = self._ensure_window_locked(nbytes)
        own = _device_bytes(self._own, self._cap, self.device)
        for r in self.local_ranks:
            i = self.slot[r]
            own[i * stride:i * stride + nbytes].copy_(_as_bytes(local[r]))
        # The window is written before the peers may read it
        torch.cuda.current_stream(self.device).synchronize()
        self._barrier_locked()
        ins = []
        for r in range(self.n):
            if r in local:
                ins.append(local[r])
                continue
            ptr = self._peers[self.member_of[r]] + self.slot[r] * stride
            ins.append(_device_bytes(ptr, nbytes, self.device)
                       .view(first.dtype))
        return ins

    # ------------------------------------------------------------------
    def ring(self, local: dict[int, torch.Tensor],
             shift: int) -> dict[int, torch.Tensor]:
        """One ring hop over every rank: rank r's flat deposit lands on
        rank ``(r + shift) % n``. Returns the local ranks' outputs, fresh
        tensors. On the card one launch of the ring-permute kernel writes
        every local shard into its destination, a local output or a
        peer's window; on the CPU the plain version runs over the
        gathered deposits."""
        from faabric_tpu_torch.ops.ring_permute import ring_permute

        shift %= self.n
        if self.device.type != "cuda":
            with self.gather(local) as ins:
                outs = ring_permute(ins, shift)
                return {r: outs[r] for r in self.local_ranks}
        return self._ring_cuda(local, shift)

    def _ring_cuda(self, local, shift: int) -> dict[int, torch.Tensor]:
        from faabric_tpu_torch.ops.ring_permute import ring_permute_to

        first = local[self.local_ranks[0]]
        nbytes = first.numel() * first.element_size()
        stream = torch.cuda.current_stream(self.device)
        outs = {r: torch.empty_like(first) for r in self.local_ranks}
        with self._lock:
            stride = self._ensure_window_locked(nbytes)
            srcs, dsts = [], []
            for r in self.local_ranks:
                d = (r + shift) % self.n
                srcs.append(local[r])
                if d in outs:
                    dsts.append(outs[d].data_ptr())
                else:
                    dsts.append(self._peers[self.member_of[d]]
                                + self.slot[d] * stride)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            ring_permute_to(srcs, dsts)
            end.record(stream)
            # Every shard has landed before the round is published
            stream.synchronize()
            self._ring_ms.append(start.elapsed_time(end))
            self._barrier_locked()
            own = _device_bytes(self._own, self._cap, self.device)
            for d in self.local_ranks:
                if (d - shift) % self.n not in outs:
                    i = self.slot[d]
                    _as_bytes(outs[d]).copy_(
                        own[i * stride:i * stride + nbytes])
            stream.synchronize()
            self._barrier_locked()
        return outs

    def ring_kernel_ms(self) -> list[float]:
        """The ring kernel's CUDA-event ms in this process's latest ring
        rounds (at most ``RING_TIMES_KEPT``), the launch alone: no
        barrier, sync or copy-out."""
        with self._lock:
            return list(self._ring_ms)

    # ------------------------------------------------------------------
    def close(self) -> None:
        """Unmap the peers' windows and tell their owners, and queue this
        process's window to be freed once every peer has unmapped it.
        Waits on no peer."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            own, cap, peers = self._own, self._cap, dict(self._peers)
            self._own, self._cap = None, 0
            self._peers.clear()
            self._group = None
        if own is None and not peers:
            return
        from faabric_tpu_torch.ops import _build

        k = _build.kernels()
        dev = self.device.index
        store = self.plane.store
        for m, ptr in peers.items():
            k.ipc_close(dev, ptr)
            try:
                store.add(self._unmapped_key(m), 1)
            except Exception:  # noqa: BLE001 — the store's owner may be gone
                logger.debug("could not report an unmapped window",
                             exc_info=True)
        if own is not None:
            with _registry_lock:
                _pending_free.append((store, self._unmapped_key(self.me),
                                      len(self.members) - 1, dev, own))
        reap()

    def _unmapped_key(self, member: int) -> str:
        return f"g{self.plane.generation}/{self.name}/unmapped/{member}"


def reap() -> int:
    """Free the queued windows whose peers have all unmapped them;
    returns how many still wait."""
    from faabric_tpu_torch.ops import _build

    with _registry_lock:
        pending = list(_pending_free)
        _pending_free.clear()
    keep = []
    for item in pending:
        store, key, expected, dev, ptr = item
        try:
            done = store.add(key, 0) >= expected
        except Exception:  # noqa: BLE001 — store gone: leave it mapped
            done = None
        if done:
            _build.kernels().ipc_free(dev, ptr)
        elif done is False:
            keep.append(item)
    with _registry_lock:
        _pending_free.extend(keep)
        return len(_pending_free)


def named_exchanger(name: str, rank_process: Sequence[int],
                    device: torch.device) -> Exchanger:
    """The process's exchanger under ``name`` (made at its first use)."""
    key = (name, tuple(rank_process), str(device))
    with _registry_lock:
        ex = _named.get(key)
    if ex is None:
        ex = Exchanger(name, rank_process, device)
        with _registry_lock:
            ex = _named.setdefault(key, ex)
    return ex


def close_all(wait_s: float = 0.0) -> int:
    """Close every exchanger of the process, then free the windows their
    peers unmap within ``wait_s``; returns how many stay mapped (freed
    with the process)."""
    with _registry_lock:
        live = list(_live)
        _named.clear()
    for ex in live:
        ex.close()
    deadline = time.monotonic() + wait_s
    left = reap()
    while left and time.monotonic() < deadline:
        time.sleep(0.05)
        left = reap()
    return left
