"""MpiWorld: MPI semantics over the point-to-point broker, single host.

Counterpart of ``faabric_tpu/mpi/world.py`` (``MpiWorld`` :248), for a
world whose ranks are threads of one host:

- rank → host and rank → device come from the broker's mappings
  (``refresh_rank_hosts``, ``topology``, ``device_for_rank``);
- ``send``, ``recv`` and ``barrier`` ride the broker's in-process
  queues (numpy payloads; a tensor given to the host path crosses to
  the host as one counted staging copy);
- ``allreduce``, ``allgather`` and ``reduce_scatter`` try the device
  plane first (``activate_device_plane``), then take the algorithms the
  reference picks on one machine: a tree (reduce or gather to rank 0,
  then broadcast or scatter) for small payloads, the rings for large
  ones. Contributions fold in the reference's order, so host results
  match the reference's host ladder bit for bit;
- the schedule runner (``_sched_get``, ``_run_schedule``) executes
  verified schedules, offering annotated phases to their execution
  target first (the ``device-ring`` target of device_plane/ring.py).
  No collective ported so far calls ``_sched_get``: the reference's
  callers wait (``ROADMAP.md`` Queue 1 #7);
- ``device_collectives`` and ``device_send_recv`` run the mesh
  substrate's ``DeviceCollectives`` over the ranks' devices.

The reference's rings stream each segment as 2 MiB pipeline chunks to
overlap wire legs; ranks of one process have no wire leg, so a ring step
here moves its whole segment as one message. Hierarchical, quantised,
cross-host, one-sided, Cartesian and fault-injection paths are not
ported (``ROADMAP.md`` Queue 1 #7); a send to a rank on another host
raises.
"""

from __future__ import annotations

import logging
import threading

import numpy as np

from faabric_tpu_torch.mpi.schedule import ScheduleCache
from faabric_tpu_torch.mpi.types import (
    MpiMessageType,
    MpiOp,
    MpiStatus,
    UserOp,
    apply_op,
)
from faabric_tpu_torch.transport.point_to_point import GroupAbortedError

logger = logging.getLogger(__name__)

MAIN_RANK = 0

# The MPI-facing name for a group abort
MpiWorldAborted = GroupAbortedError


def _size_class(nbytes: int) -> str:
    """Power-of-4 payload class label of the schedule cache key (the
    reference's telemetry/perfprofile.py size_class)."""
    n = max(1, int(nbytes))
    lo = 1 << (2 * ((n.bit_length() - 1) // 2))
    for shift, unit in ((30, "GiB"), (20, "MiB"), (10, "KiB")):
        if lo >= 1 << shift:
            return f"{lo >> shift}{unit}"
    return f"{lo}B"


class MpiWorld:
    # Above 2 x CHUNK_BYTES a single-host allreduce or reduce_scatter
    # takes the ring, and above CHUNK_BYTES per contribution an
    # allgather does (the reference's thresholds)
    CHUNK_BYTES = 4 * 1024 * 1024

    def __init__(self, broker, world_id: int, size: int,
                 group_id: int) -> None:
        self.broker = broker
        self.id = world_id
        self.size = size
        self.group_id = group_id

        # Rank bookkeeping and the topology cache mutate under the world
        # lock; collectives on N rank threads share them
        self._lock = threading.RLock()
        self._rank_hosts: dict[int, str] = {}
        self._rank_devices: dict[int, int] = {}
        self._topology_cache = None
        self._topology_gen = 0  # bumped by refresh_rank_hosts

        # Verified-schedule cache (keys carry the topology generation)
        # and the per-rank selection-round ledger (see _sched_family)
        self._sched_cache = ScheduleCache()
        self._sched_seen: dict[int, set] = {}

        # None until activate_device_plane's handshake resolves the
        # world onto one device; cleared on migration remaps
        self._device_plane = None
        # device_collectives, by device type
        self._device_collectives: dict = {}

    def abort(self, reason: str = "MPI_Abort") -> None:
        """Every rank's blocked or future recv on this world raises
        MpiWorldAborted."""
        self.broker.abort_group(self.group_id, reason)

    # ------------------------------------------------------------------
    # Topology
    # ------------------------------------------------------------------
    def refresh_rank_hosts(self) -> None:
        self.broker.wait_for_mappings(self.group_id)
        with self._lock:
            self._rank_hosts = {
                idx: self.broker.get_host_for_receiver(self.group_id, idx)
                for idx in range(self.size)}
            self._rank_devices = {
                idx: self.broker.get_device_for_idx(self.group_id, idx)
                for idx in range(self.size)}
            self._topology_cache = None
            self._topology_gen += 1

    def topology(self):
        """The world's Topology (mpi/topology.py), rebuilt lazily after
        refresh_rank_hosts or a migration remap. The broker is local, so
        the refresh runs under the world lock: concurrent rank threads
        build one topology of one generation."""
        from faabric_tpu_torch.mpi.topology import Topology

        with self._lock:
            if self._topology_cache is None:
                if len(self._rank_hosts) != self.size:
                    self.refresh_rank_hosts()
                devices = (dict(self._rank_devices)
                           if any(d >= 0 for d in self._rank_devices.values())
                           else None)
                self._topology_cache = Topology(dict(self._rank_hosts),
                                                rank_devices=devices)
            return self._topology_cache

    def ranks_on_host(self, host: str) -> list[int]:
        return list(self.topology().ranks_on_host(host))

    def hosts(self) -> list[str]:
        return list(self.topology().hosts)

    def device_for_rank(self, rank: int) -> int:
        self.broker.wait_for_mappings(self.group_id)
        return self.broker.get_device_for_idx(self.group_id, rank)

    # ------------------------------------------------------------------
    # Device path
    # ------------------------------------------------------------------
    def device_collectives(self, device_type: str = "cuda"):
        """Device collectives over this world's rank devices (rank i ↔
        the planner-assigned device of rank i, wrapped onto this host's
        ``device_type`` devices by ``local_devices_for_ids``; ranks may
        share one). Made once per device type."""
        with self._lock:
            coll = self._device_collectives.get(device_type)
            if coll is None:
                from faabric_tpu_torch.parallel.collectives import (
                    DeviceCollectives,
                    local_devices_for_ids,
                )

                ids = [self.device_for_rank(r) for r in range(self.size)]
                coll = DeviceCollectives(
                    local_devices_for_ids(ids, device_type))
                self._device_collectives[device_type] = coll
            return coll

    def device_send_recv(self, xs, src_rank: int, dst_rank: int,
                         device_type: str = "cuda"):
        """Device point-to-point: rank ``src``'s buffer lands on rank
        ``dst``'s device (the other ranks get zeros), the device twin of
        the host send/recv below."""
        return self.device_collectives(device_type).send_recv(
            xs, src_rank, dst_rank)

    # ------------------------------------------------------------------
    # Device collective plane (faabric_tpu_torch/device_plane/)
    # ------------------------------------------------------------------
    def activate_device_plane(self, rank: int, device=None) -> bool:
        """Collective registration handshake: every rank calls this once
        (after the world forms, or again after a migration remap) with
        its device — by default the planner-assigned card riding the PTP
        mappings, which raises when there is no card; ``device="cpu"``
        registers the CPU. One host-path allgather exchanges the rows;
        every rank then derives the SAME verdict from them
        (device_plane/registry.py). Returns True when the plane is
        active: from then on eligible allreduce, allgather and
        reduce_scatter run on the plane's device."""
        from faabric_tpu_torch.device_plane import (
            DevicePlane,
            MeshMismatch,
            registration_row,
            resolve_local_device,
        )
        from faabric_tpu_torch.device_plane.registry import resolve_mesh
        from faabric_tpu_torch.util.device import resolve_device

        device = (resolve_local_device(self, rank) if device is None
                  else resolve_device(device))
        self.topology()  # the generation below must be of a built one
        with self._lock:
            gen = self._topology_gen
            plane = self._device_plane
            if plane is not None and plane.topology_gen != gen:
                self._device_plane = None
        # The handshake rides the host ladder even while a plane is live
        rows = self._allgather_host(rank, registration_row(rank, device))
        with self._lock:
            plane = self._device_plane
            if (plane is not None and plane.topology_gen == gen
                    and plane.disabled_reason is None):
                return True  # a sibling local rank already resolved it
        local_ranks = self.ranks_on_host(self.broker.host)
        try:
            devices = resolve_mesh(rows, self.size, local_ranks=local_ranks)
        except MeshMismatch as e:
            logger.info("Device plane for world %s not activated: %s",
                        self.id, e)
            return False
        plane = DevicePlane(self.id, devices, local_ranks=local_ranks,
                            topology_gen=gen)
        with self._lock:
            # First resolver publishes; a re-handshake REPLACES a
            # disabled plane (activation is the recovery path after a
            # backend error); a remap racing the handshake leaves the
            # rung down
            if self._topology_gen != gen:
                return False
            cur = self._device_plane
            if (cur is None or cur.topology_gen != gen
                    or cur.disabled_reason is not None):
                self._device_plane = plane
        return True

    def device_plane(self):
        """The active DevicePlane, or None (host ladder only). A plane of
        an older topology generation reads as None."""
        with self._lock:
            plane = self._device_plane
            if plane is not None and plane.topology_gen != self._topology_gen:
                return None
            return plane

    # ------------------------------------------------------------------
    # Point-to-point
    # ------------------------------------------------------------------
    def send(self, send_rank: int, recv_rank: int, data,
             msg_type: MpiMessageType = MpiMessageType.NORMAL,
             _copy: bool = True) -> None:
        """``_copy=False`` is for callers that hand over a private buffer
        nobody writes again (ring steps, the broadcast's shared copy)."""
        host = self.topology().host_of(recv_rank)
        if host != self.broker.host:
            raise NotImplementedError(
                f"rank {recv_rank} of world {self.id} is on {host}, "
                f"not {self.broker.host}: the MPI world's remote legs are "
                f"not ported")
        arr = np.asarray(self._stage_host(data))
        if _copy:
            arr = arr.copy()
        self.broker.send_message(self.group_id, send_rank, recv_rank,
                                 (msg_type, arr))

    def _recv_typed(self, send_rank: int, recv_rank: int,
                    timeout: float | None = None):
        """(message type, array); the array may be shared and read-only."""
        return self.broker.recv_message(self.group_id, send_rank,
                                        recv_rank, timeout=timeout)

    def _recv_raw(self, send_rank: int, recv_rank: int) -> np.ndarray:
        return self._recv_typed(send_rank, recv_rank)[1]

    def recv(self, send_rank: int, recv_rank: int,
             timeout: float | None = None) -> tuple[np.ndarray, MpiStatus]:
        """The returned buffer is caller-owned and writable."""
        _t, arr = self._recv_typed(send_rank, recv_rank, timeout)
        if not arr.flags.writeable:
            arr = arr.copy()
        return arr, MpiStatus(source=send_rank, count=arr.size)

    def barrier(self, rank: int) -> None:
        """Gather-to-0 then release (reference MpiWorld.cpp:1753-1775)."""
        empty = np.empty(0, dtype=np.uint8)
        if rank == MAIN_RANK:
            for r in range(1, self.size):
                self._recv_raw(r, MAIN_RANK)
            for r in range(1, self.size):
                self.send(MAIN_RANK, r, empty, MpiMessageType.BARRIER_DONE)
        else:
            self.send(rank, MAIN_RANK, empty, MpiMessageType.BARRIER_JOIN)
            self._recv_raw(MAIN_RANK, rank)

    # ------------------------------------------------------------------
    # Collective schedule runner (mpi/schedule.py)
    # ------------------------------------------------------------------
    def _sched_key(self, collective: str, op=None, dtype=None,
                   nbytes=None, root: int = 0) -> tuple:
        """Cache key: (topology generation, collective, root, op class,
        dtype class, size class), identical on every rank of a call."""
        self.topology()  # ensure the generation matches a built topology
        with self._lock:
            gen = self._topology_gen
        opc = ("-" if op is None
               else "u" if isinstance(op, UserOp) else f"b{int(op)}")
        dtc = "-" if dtype is None else np.dtype(dtype).str
        szc = "-" if nbytes is None else _size_class(int(nbytes))
        return (gen, collective, root, opc, dtc, szc)

    def _sched_family(self, rank: int, key: tuple, collective: str,
                      nbytes: int | None) -> str:
        """World-agreed schedule family for ``key``: computed on rank 0
        and distributed by a one-shot broadcast (the selection sync
        round). A rank joins the round exactly when its OWN call sequence
        first meets ``key``, which is identical on every rank."""
        from faabric_tpu_torch.mpi.schedule_compile import (
            FAMILIES,
            FAMILY_IDS,
            choose_family,
        )

        with self._lock:
            seen = self._sched_seen.setdefault(rank, set())
            need_round = key not in seen
        if not need_round:
            fam = self._sched_cache.family_of(key)
            if fam is None:
                raise RuntimeError(f"selection ran but {key} is uncached")
            return fam
        if rank == MAIN_RANK:
            fam = self._sched_cache.family_of(key)
            if fam is None:
                fam = choose_family(collective, self.topology(),
                                    nbytes or 0, True)
            self._broadcast_impl(MAIN_RANK, rank,
                                 np.array([FAMILY_IDS[fam]], dtype=np.int64))
        else:
            arr = self._broadcast_impl(MAIN_RANK, rank,
                                       np.empty(1, dtype=np.int64))
            fam = FAMILIES[int(arr.reshape(-1)[0])]
        # Ledger write before the seen-mark: a rank that skips every
        # later round for this key must always recover the verdict
        self._sched_cache.note_family(key, fam)
        with self._lock:
            seen = self._sched_seen[rank]
            # Keys of older generations are never looked up again
            seen -= {k for k in seen if k[0] != key[0]}
            seen.add(key)
        return fam

    def _sched_get(self, rank: int, collective: str, op=None, dtype=None,
                   nbytes=None, root: int = 0):
        """(schedule, family) for one collective call: selection sync on
        first encounter, then compile-verify-cache once per process."""
        from faabric_tpu_torch.mpi.schedule_compile import compile_schedule

        key = self._sched_key(collective, op=op, dtype=dtype,
                              nbytes=nbytes, root=root)
        family = self._sched_family(rank, key, collective, nbytes)
        topo = self.topology()
        sched = self._sched_cache.get_or_compile(
            key, family,
            lambda: compile_schedule(family, collective, topo, root=root))
        return sched, family

    @staticmethod
    def _sched_phase_groups(steps):
        groups: list[tuple[str, list]] = []
        for st in steps:
            if not groups or groups[-1][0] != st.phase:
                groups.append((st.phase, []))
            groups[-1][1].append(st)
        return groups

    def _run_schedule(self, rank: int, sched, env: dict, op,
                      resolver, msg_type: MpiMessageType) -> dict:
        """Execute ``rank``'s step program over ``env`` (block key → flat
        array or tensor). Sends concatenate blocks into one message;
        recvs split by ``resolver``-bound sizes; folds apply ``op`` in
        the schedule's operand order; copies are reference moves.

        Phases annotated with an execution target (``spec["targets"]``)
        are offered to the registered target first; a decline (None) or
        a partial run (the count of leading steps it executed) falls
        through to the per-step host path for the rest."""
        from faabric_tpu_torch.mpi.schedule import (
            COPY,
            FOLD,
            RECV,
            SEND,
            ScheduleError,
            get_step_target,
        )

        if not sched.verified:
            raise ScheduleError(
                f"refusing to execute unverified schedule {sched.name}")
        steps = sched.steps.get(rank, ())
        phase_targets = sched.spec.get("targets") or {}
        for phase, group in self._sched_phase_groups(steps):
            done = 0
            tname = phase_targets.get(phase)
            if tname:
                target = get_step_target(tname)
                if target is not None:
                    done = target.try_run(self, rank, sched, phase, group,
                                          env, resolver) or 0
            for st in group[done:]:
                if st.op == SEND:
                    bufs = [np.asarray(self._stage_host(env[k])).reshape(-1)
                            for k in st.keys]
                    payload = (bufs[0] if len(bufs) == 1
                               else np.concatenate(bufs))
                    self.send(rank, st.peer, payload, msg_type)
                elif st.op == RECV:
                    arr = self._recv_raw(st.peer, rank).reshape(-1)
                    if len(st.keys) == 1:
                        env[st.keys[0]] = arr
                        continue
                    pos = 0
                    for k, sym in zip(st.keys, st.syms):
                        count = int(resolver(sym, env))
                        env[k] = arr[pos:pos + count]
                        pos += count
                    if pos != arr.size:
                        raise ScheduleError(
                            f"{sched.name}: rank {rank} recv from "
                            f"{st.peer} split {pos} of {arr.size} "
                            f"elements (framing desync)")
                elif st.op == FOLD:
                    a, b = env[st.a], env[st.b]
                    if type(a) is not type(b):
                        a, b = self._stage_host(a), self._stage_host(b)
                    env[st.dst] = apply_op(op, a, b).reshape(-1)
                elif st.op == COPY:
                    src = env[st.src]
                    env[st.dst] = (src.reshape(-1) if hasattr(src, "reshape")
                                   else np.asarray(src).reshape(-1))
        return env

    # ------------------------------------------------------------------
    # Collectives
    # ------------------------------------------------------------------
    def _try_device(self, kind: str, dplane, rank: int, arr, op=None):
        """The device rung: the collective on the activated plane, or
        None after a clean fallback (a host round's backend error
        disabled the plane and the caller re-runs on the host ladder).
        A resident round's backend error propagates."""
        from faabric_tpu_torch.device_plane import DevicePlaneFallback

        try:
            if kind == "allreduce":
                return dplane.allreduce(rank, arr, op)
            if kind == "allgather":
                return dplane.allgather(rank, arr)
            return dplane.reduce_scatter(rank, arr, op)
        except DevicePlaneFallback as e:
            logger.warning("Device %s (world %s) fell back to the host "
                           "ladder: %s", kind, self.id, e)
            return None

    @staticmethod
    def _stage_host(arr):
        """A tensor that does not ride the device rung crosses to the
        host as ONE counted ``d2h.staging`` copy; numpy passes through."""
        from faabric_tpu_torch.device_plane.plane import to_host

        return to_host(arr)

    @staticmethod
    def _payload(data):
        from faabric_tpu_torch.device_plane.plane import is_device_payload

        return data if is_device_payload(data) else np.asarray(data)

    def _ring_eligible(self, arr: np.ndarray, op) -> bool:
        """Large payloads, a commuting op, every rank on this host."""
        return (self.size > 1 and arr.nbytes >= self.CHUNK_BYTES * 2
                and (not isinstance(op, UserOp) or op.commute)
                and len(self.hosts()) == 1)

    def allreduce(self, rank: int, data, op: MpiOp = MpiOp.SUM):
        arr = self._payload(data)
        dplane = self.device_plane()
        if dplane is not None and dplane.eligible("allreduce", arr, op):
            out = self._try_device("allreduce", dplane, rank, arr, op)
            if out is not None:
                return out
        arr = self._stage_host(arr)
        if arr.size >= self.size and self._ring_eligible(arr, op):
            return self._allreduce_ring(rank, arr, op)
        reduced = self._reduce_impl(rank, MAIN_RANK, arr, op)
        return self._broadcast_impl(MAIN_RANK, rank,
                                    reduced if rank == MAIN_RANK else arr)

    def allgather(self, rank: int, data):
        data = self._payload(data)
        dplane = self.device_plane()
        if dplane is not None and dplane.eligible("allgather", data):
            out = self._try_device("allgather", dplane, rank, data)
            if out is not None:
                return out
        return self._allgather_host(rank, self._stage_host(data))

    def _allgather_host(self, rank: int, data: np.ndarray) -> np.ndarray:
        if (self.size > 1 and data.nbytes >= self.CHUNK_BYTES
                and len(self.hosts()) == 1):
            return self._allgather_ring(rank, data)
        gathered = self._gather_impl(rank, MAIN_RANK, data)
        template = (gathered if rank == MAIN_RANK
                    else np.empty(0, dtype=data.dtype))
        return self._broadcast_impl(MAIN_RANK, rank, template)

    def reduce_scatter(self, rank: int, data, op: MpiOp = MpiOp.SUM):
        """MPI_Reduce_scatter_block: reduce (size·k,) contributions; rank
        r keeps segment r."""
        data = self._payload(data).reshape(-1)
        if data.shape[0] % self.size:
            raise ValueError(
                f"reduce_scatter needs size divisible by {self.size}")
        k = data.shape[0] // self.size
        dplane = self.device_plane()
        if dplane is not None and dplane.eligible("reduce_scatter", data,
                                                  op):
            out = self._try_device("reduce_scatter", dplane, rank, data, op)
            if out is not None:
                return out
        data = self._stage_host(data)
        if self._ring_eligible(data, op):
            # The ring leaves rank holding segment rank+1; one hop
            # forward hands every rank its own
            held = self._ring_reduce_scatter(rank, data, op)
            self.send(rank, (rank + 1) % self.size, held,
                      MpiMessageType.REDUCE, _copy=False)
            return self._recv_raw((rank - 1) % self.size, rank)
        reduced = self._reduce_impl(rank, MAIN_RANK, data, op)
        return self._scatter_impl(
            MAIN_RANK, rank, reduced if rank == MAIN_RANK else None, k)

    # -- tree legs (reference _reduce_impl, _broadcast_impl,
    # _gather_impl, _scatter_impl on one host) ----------------------------
    def _reduce_impl(self, rank: int, root: int, data: np.ndarray,
                     op: MpiOp) -> np.ndarray | None:
        """Every rank sends to the root, which folds in rank order."""
        if rank != root:
            self.send(rank, root, data, MpiMessageType.REDUCE)
            return None
        acc = np.array(data, copy=True)
        for r in range(self.size):
            if r != root:
                acc = apply_op(op, acc, self._recv_raw(r, root))
        return acc

    def _broadcast_impl(self, send_rank: int, recv_rank: int,
                        data: np.ndarray) -> np.ndarray:
        """The root sends one shared read-only copy to every rank; each
        receiver returns a private writable copy, shaped like ``data``
        when the sizes agree (size-less templates stay flat)."""
        if recv_rank == send_rank:
            shared = np.array(data, copy=True)
            shared.flags.writeable = False
            for r in range(self.size):
                if r != send_rank:
                    self.send(send_rank, r, shared,
                              MpiMessageType.BROADCAST, _copy=False)
            return data
        arr = self._recv_raw(send_rank, recv_rank).copy()
        if data.size == arr.size and data.shape != arr.shape:
            arr = arr.reshape(data.shape)
        return arr

    def _gather_impl(self, send_rank: int, root: int,
                     data: np.ndarray) -> np.ndarray | None:
        if send_rank != root:
            self.send(send_rank, root, data, MpiMessageType.GATHER)
            return None
        out = np.empty((self.size, data.size), dtype=data.dtype)
        out[root] = data.reshape(-1)
        for r in range(self.size):
            if r != root:
                out[r] = self._recv_raw(r, root).reshape(-1)
        return out.reshape(-1)

    def _scatter_impl(self, send_rank: int, recv_rank: int, data,
                      recv_count: int) -> np.ndarray:
        """The root splits (size · recv_count,) into per-rank chunks."""
        if recv_rank != send_rank:
            return self.recv(send_rank, recv_rank)[0]
        chunks = np.asarray(data).reshape(self.size, recv_count)
        for r in range(self.size):
            if r != send_rank:
                self.send(send_rank, r, chunks[r], MpiMessageType.SCATTER)
        return chunks[send_rank].copy()

    # -- rings (reference _ring_reduce_scatter, _allreduce_ring,
    # _allgather_ring) -----------------------------------------------------
    def _ring_segments(self, n_elems: int) -> list[tuple[int, int]]:
        n = self.size
        return [((i * n_elems) // n, ((i + 1) * n_elems) // n)
                for i in range(n)]

    def _ring_reduce_scatter(self, rank: int, data: np.ndarray,
                             op: MpiOp) -> np.ndarray:
        """The ring's fold phase: n-1 steps, each rank folding its part
        of the segment it receives, (received, mine). Returns the fully
        reduced segment (rank + 1) % n, a private array."""
        flat = data.reshape(-1)
        n = self.size
        seg = self._ring_segments(flat.size)
        nxt, prv = (rank + 1) % n, (rank - 1) % n
        lo, hi = seg[rank]
        self.send(rank, nxt, flat[lo:hi], MpiMessageType.REDUCE)
        held = None
        for step in range(n - 1):
            slo, shi = seg[(rank - step - 1) % n]
            folded = np.asarray(apply_op(op, self._recv_raw(prv, rank),
                                         flat[slo:shi]))
            if step < n - 2:
                self.send(rank, nxt, folded, MpiMessageType.REDUCE,
                          _copy=False)
            else:
                held = folded
        return held

    def _allreduce_ring(self, rank: int, data: np.ndarray,
                        op: MpiOp) -> np.ndarray:
        """Ring reduce-scatter, then n-1 allgather steps that pass the
        reduced segments on, each written straight into the result."""
        flat = data.reshape(-1)
        n = self.size
        seg = self._ring_segments(flat.size)
        nxt, prv = (rank + 1) % n, (rank - 1) % n
        part = self._ring_reduce_scatter(rank, data, op)
        out = np.empty(flat.size, dtype=part.dtype)
        lo, hi = seg[(rank + 1) % n]
        out[lo:hi] = part
        for step in range(n - 1):
            self.send(rank, nxt, part, MpiMessageType.REDUCE, _copy=False)
            lo, hi = seg[(rank - step) % n]
            part = self._recv_raw(prv, rank)
            out[lo:hi] = part
        return out.reshape(data.shape)

    def _allgather_ring(self, rank: int, data: np.ndarray) -> np.ndarray:
        """Rank r's contribution is segment r; n-1 steps pass segments
        on, each written into the result and forwarded."""
        flat = data.reshape(-1)
        n, k = self.size, flat.size
        nxt, prv = (rank + 1) % n, (rank - 1) % n
        out = np.empty(n * k, dtype=flat.dtype)
        out[rank * k:(rank + 1) * k] = flat
        part = np.array(flat, copy=True)
        for step in range(n - 1):
            self.send(rank, nxt, part, MpiMessageType.ALLGATHER,
                      _copy=False)
            src = (rank - step - 1) % n
            part = self._recv_raw(prv, rank)
            out[src * k:(src + 1) * k] = part
        return out

    # ------------------------------------------------------------------
    # Migration (reference prepareMigration)
    # ------------------------------------------------------------------
    def prepare_migration(self, rank: int,
                          new_group_id: int | None = None) -> None:
        """Drop the rank → host and rank → device maps: the device rung
        stays down until every rank re-runs the activation handshake."""
        with self._lock:
            if new_group_id is not None:
                self.group_id = new_group_id
            self._rank_hosts.clear()
            self._rank_devices.clear()
            self._topology_cache = None
            self._topology_gen += 1
            self._device_plane = None
