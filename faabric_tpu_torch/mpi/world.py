"""MpiWorld: MPI semantics over the point-to-point broker.

Counterpart of ``faabric_tpu/mpi/world.py`` (``MpiWorld`` :248). One
world per app: rank 0 creates it by chaining the other ranks through
the planner (mpi/registry.py), the others join from their dispatched
message. A world's ranks may span hosts:

- rank → host and rank → device come from the broker's mappings
  (``refresh_rank_hosts``, ``topology``, ``device_for_rank``);
- point to point: a message to a rank of this host rides the broker's
  in-process queue as the array itself (``_LocalMpiPayload``); one to a
  rank of another host goes out as an ``MpiWirePayload``, in send order,
  on the plane the broker picks (bulk TCP stripes, shm rings to a host
  of this machine, the RPC plane: transport/point_to_point.py). A
  received wire array may be read-only, shared with the bulk plane's
  codec cache: ``recv`` and every collective copy it before writing.
  ``isend`` to another host runs on the rank's send worker, and a
  blocking send never overtakes the rank's queued isends to the same
  destination;
- the collectives keep the reference's algorithms and fold orders, so
  host results match the reference's bit for bit: locality-aware leader
  trees (broadcast, reduce, gather: one message per remote host), the
  chunk-pipelined rings on one machine, the hierarchical compositions
  (``_allreduce_hier``, ``_reduce_scatter_hier``, ``_allgather_hier``)
  when the hosts are real machines or ``hier_enabled == "force"``, and
  the verified schedules of ``scatter``, ``scatterv``, ``scan`` and
  ``alltoall`` through ``_sched_get`` and the schedule runner;
- ``allreduce``, ``allgather`` and ``reduce_scatter`` try the device
  plane first (``activate_device_plane``); every other collective and
  every remote leg stages a tensor payload to the host as one counted
  ``d2h.staging`` copy;
- communicators: Cartesian topology, ``split``, ``dup``,
  ``create_group_comm`` and ``split_type_shared`` make subworlds with no
  planner round trip;
- ``device_collectives`` and ``device_send_recv`` run the mesh
  substrate's ``DeviceCollectives`` over the ranks' devices.

``rungs`` records the algorithm each rank's last call of each
collective took ("device", "hier", "ring", "tree", "sched:<family>",
"direct", "chain"), where the reference tags its trace spans.

The environment knobs are read once, at import, as the reference reads
them: ``FAABRIC_RING_CHUNK_BYTES`` (``RING_CHUNK_BYTES``),
``FAABRIC_HIER_COLLECTIVES`` and ``FAABRIC_SCHED_COLLECTIVES`` (the
defaults of a world's ``hier_enabled`` and ``sched_enabled``: "1", "0"
or "force") and ``FAABRIC_DEVICE_PLANE`` ("0" makes
``activate_device_plane`` refuse). They must agree across the processes
of a world. ``sched_reductions`` is a plain attribute.

``allreduce_quant`` ("" or "int8", default ``FAABRIC_ALLREDUCE_QUANT``)
quantises the hierarchical allreduce's leader ring on its fold leg
(``mpi/quant.py``), each hop as the wire-codec governor says
(``_quant_link_ok``); every host's world must agree on it.

Telemetry, as the reference's: every collective passes the
``mpi.collective`` fault point and is counted
(``faabric_mpi_collectives_total``, ``..._bytes_total``), runs in an
``mpi``/<collective> span tagged with its algorithm, its phases in
``mpi.phase`` spans (the hierarchy level under ``phase``), ring folds in
``mpi.detail`` spans and wire (de)serialisation in ``mpi.wire`` spans;
allreduce, reduce_scatter and allgather record their entry stamp,
per-level durations and total in the collective profiler.
"""

from __future__ import annotations

import logging
import os
import struct
import threading
import time
from typing import Optional, Sequence

import numpy as np

from faabric_tpu_torch.faults import fault_point, faults_enabled
from faabric_tpu_torch.mpi.quant import (
    ALLREDUCE_QUANT,
    leader_ring_codec,
    resolve_quant_mode,
)
from faabric_tpu_torch.mpi.schedule import ScheduleCache
from faabric_tpu_torch.mpi.types import (
    MPI_HEADER_FMT,
    MPI_HEADER_LEN,
    MpiDataType,
    MpiMessageType,
    MpiOp,
    MpiStatus,
    MpiWirePayload,
    UserOp,
    apply_op,
    apply_op_inplace,
    mpi_dtype_for,
    np_dtype_for,
    unpack_mpi_payload,
)
from faabric_tpu_torch.telemetry import (
    NULL_SPAN,
    get_collective_profiler,
    get_metrics,
    span,
    tracing_enabled,
)
from faabric_tpu_torch.transport.point_to_point import GroupAbortedError

logger = logging.getLogger(__name__)

MAIN_RANK = 0

# The MPI-facing name for a group abort
MpiWorldAborted = GroupAbortedError

_FAULTS = faults_enabled()
_FP_COLLECTIVE = fault_point("mpi.collective")

_metrics = get_metrics()
_coll_total: dict = {}
_coll_bytes: dict = {}
# Every rank records its round entry stamp, per-phase durations and
# total here: the store behind the critical-path decomposition and the
# straggler detector. A shared no-op while metrics are off
_PROFILER = get_collective_profiler()


def _count_collective(op: str, nbytes: int) -> None:
    if _FAULTS:
        # One choke point for every collective: delay rules add
        # straggler latency, raise rules fail the rank
        _FP_COLLECTIVE.fire(op=op, bytes=nbytes)
    c = _coll_total.get(op)
    b = _coll_bytes.get(op)
    if c is None or b is None:
        # Both run: ranks are concurrent threads, and one dict holding
        # the op must not imply the other does (the registry dedupes
        # handles, so racers agree)
        c = _coll_total.setdefault(op, _metrics.counter(
            "faabric_mpi_collectives_total",
            "Host-path collective invocations (per participating rank)",
            op=op))
        b = _coll_bytes.setdefault(op, _metrics.counter(
            "faabric_mpi_collective_bytes_total",
            "Per-rank payload bytes entering host-path collectives",
            op=op))
    c.inc()
    b.inc(nbytes)

# Ring collectives stream each per-rank segment as chunk-sized messages,
# so a rank folds chunk k while chunk k+1 crosses the wire (the
# reference's default)
RING_CHUNK_BYTES = int(os.environ.get("FAABRIC_RING_CHUNK_BYTES",
                                      2 * 1024 * 1024))


def _tristate_knob(name: str) -> bool | str:
    """"force", or whether the knob is on (default on)."""
    value = os.environ.get(name, "1").lower()
    return "force" if value == "force" else value not in ("0", "false", "off")


# Hierarchical compositions and the schedule compiler: a world's
# hier_enabled and sched_enabled start from these
HIER_COLLECTIVES = _tristate_knob("FAABRIC_HIER_COLLECTIVES")
SCHED_COLLECTIVES = _tristate_knob("FAABRIC_SCHED_COLLECTIVES")
# "0" makes activate_device_plane refuse on every world
DEVICE_PLANE_ENABLED = os.environ.get(
    "FAABRIC_DEVICE_PLANE", "1").lower() not in ("0", "false", "off")


def _size_class(nbytes: int) -> str:
    """Power-of-4 payload class label of the schedule cache key (the
    reference's telemetry/perfprofile.py size_class)."""
    n = max(1, int(nbytes))
    lo = 1 << (2 * ((n.bit_length() - 1) // 2))
    for shift, unit in ((30, "GiB"), (20, "MiB"), (10, "KiB")):
        if lo >= 1 << shift:
            return f"{lo >> shift}{unit}"
    return f"{lo}B"


class _SendWorker:
    """Daemon FIFO worker for one rank's remote async sends: FIFO keeps
    a rank's sends to one destination in order; daemon so a transfer
    wedged on a dead peer never holds up interpreter exit."""

    # _closed orders submits against shutdown's sentinel (see submit);
    # the SimpleQueue itself is internally synchronized
    GUARDS = {"_closed": "_state_lock"}

    def __init__(self, name: str) -> None:
        import queue as _queue

        self._q: "_queue.SimpleQueue" = _queue.SimpleQueue()
        self._closed = False
        self._state_lock = threading.Lock()
        self._t = threading.Thread(target=self._loop, name=name, daemon=True)
        self._t.start()

    def submit(self, fn):
        from concurrent.futures import Future

        fut: Future = Future()
        # Either the job lands before the shutdown sentinel (the worker
        # runs it) or the future fails: never run inline (it would
        # overtake queued sends) and never dropped (a wait would hang)
        with self._state_lock:
            if self._closed:
                fut.set_exception(RuntimeError(
                    "MPI world closed while async send pending"))
            else:
                self._q.put((fn, fut))
        return fut

    def _loop(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            fn, fut = item
            try:
                fut.set_result(fn())
            except BaseException as e:  # noqa: BLE001 — delivered at wait()
                fut.set_exception(e)

    def shutdown(self) -> None:
        with self._state_lock:
            self._closed = True
            self._q.put(None)


class _LocalMpiPayload:
    """A message to a rank of this host: the array itself rides the
    queue. ``shared`` marks fan-out buffers several receivers hold (a
    consumer copies before exposing them writable); ``owned`` marks a
    buffer the sender handed over, which the receiver may fold into."""

    __slots__ = ("msg_type", "data", "shared", "owned")

    def __init__(self, msg_type: MpiMessageType, data: np.ndarray,
                 shared: bool = False, owned: bool = False) -> None:
        self.msg_type = msg_type
        self.data = data
        self.shared = shared
        self.owned = owned


class MpiWorld:
    # Concurrency contract (analysis/concheck.py): rank bookkeeping and
    # topology caches mutate under the world RLock — collectives on N
    # rank threads share them. Deliberately unlisted: record_exec_graph
    # (configured before traffic starts), _in_send_pool (thread-local),
    # _send_workers (per-rank entries created under _lock in
    # _send_worker(); reads are GIL-atomic dict hits on an add-only
    # dict), _split_seq (only mutated under _lock in _split_draw).
    GUARDS = {
        "_requests": "_lock",
        "_next_request_id": "_lock",
        "_rank_hosts": "_lock",
        "_rank_devices": "_lock",
        "_topology_cache": "_lock",
        "_same_machine_cache": "_lock",
        "_topology_gen": "_lock",
        "_msg_count_to_rank": "_lock",
        "_msg_type_count": "_lock",
        "_device_collectives": "_lock",
        "_device_plane": "_lock",
        "_plane_activations": "_lock",
        "_sched_seen": "_lock",
    }

    # Above 2 x CHUNK_BYTES a single-machine allreduce or reduce_scatter
    # takes the ring, a broadcast and a reduce stream in chunks; above
    # CHUNK_BYTES a contribution takes the allgather ring. A one-host
    # world has no wire leg to overlap, so its chunks are larger.
    CHUNK_BYTES = 4 * 1024 * 1024
    CHUNK_BYTES_LOCAL = 16 * 1024 * 1024

    def __init__(self, broker, world_id: int, size: int, group_id: int,
                 user: str = "", function: str = "") -> None:
        self.broker = broker
        self.id = world_id
        self.size = size
        self.group_id = group_id
        self.user = user
        self.function = function

        # Rank bookkeeping, requests and the topology cache mutate under
        # the world lock: collectives on N rank threads share them
        self._lock = threading.RLock()
        # Per-rank async requests: rank → {request id: entry}
        self._requests: dict[int, dict[int, tuple]] = {}
        self._next_request_id = 1
        self._rank_hosts: dict[int, str] = {}
        self._rank_devices: dict[int, int] = {}
        self._topology_cache = None
        self._same_machine_cache: bool | None = None
        self._topology_gen = 0  # bumped by refresh_rank_hosts

        # Hierarchical composition: True composes only across real
        # machines (_hier_wins), "force" also across hosts of this one,
        # False never. Every host's world must hold the same value.
        self.hier_enabled: bool | str = HIER_COLLECTIVES
        # The leader ring's wire quantisation (mpi/quant.py): "" or
        # "int8". Every host's world must hold the same value
        self.allreduce_quant = ALLREDUCE_QUANT
        # The schedule compiler (mpi/schedule.py): True or "force" runs
        # scatter, scatterv, scan and alltoall as verified schedules,
        # False as the direct loops. sched_reductions (with "force")
        # runs the hierarchical reduction lowerings in place of the
        # hand-written paths. Every host's world must agree.
        self.sched_enabled: bool | str = SCHED_COLLECTIVES
        self.sched_reductions = False
        self._sched_cache = ScheduleCache()
        self._sched_seen: dict[int, set] = {}

        # Exec-graph accounting (reference MpiWorld.h:13-18)
        self._msg_count_to_rank: dict[int, int] = {}
        self._msg_type_count: dict[tuple[int, int], int] = {}
        self.record_exec_graph = False

        # device_collectives, by device type
        self._device_collectives: dict = {}
        # None until activate_device_plane's handshake resolves the
        # world onto one device; cleared on migration remaps
        self._device_plane = None
        # rank → activation handshakes it made: the Nth handshake of
        # every rank, in every process, names one cross-process exchange
        self._plane_activations: dict[int, int] = {}
        self._send_workers: dict[int, _SendWorker] = {}
        self._in_send_pool = threading.local()
        self._split_seq = 0  # split-generation draws (see _split_draw)
        # (rank, collective) → the algorithm its last call took
        self.rungs: dict[tuple[int, str], str] = {}

        # A blocked recv of this world probes its sender's host and
        # raises MpiWorldAborted when that host is gone (some tests build
        # worlds over stub brokers, or none, that have no watches)
        watch = getattr(broker, "watch_group", None)
        if watch is not None:
            watch(group_id)

    def abort(self, reason: str = "MPI_Abort") -> None:
        """Every rank's blocked or future recv on this world raises
        MpiWorldAborted."""
        self.broker.abort_group(self.group_id, reason)

    # ------------------------------------------------------------------
    # Topology
    # ------------------------------------------------------------------
    def refresh_rank_hosts(self) -> None:
        """Re-read rank → host and rank → device from the mappings. A
        new generation starts only when they changed: every rank of a
        host calls this on the one world object as it joins (the
        reference starts one each time), and a sibling's refresh must
        not read as a remap racing a rank's device-plane handshake."""
        self.broker.wait_for_mappings(self.group_id)
        with self._lock:
            hosts = {
                idx: self.broker.get_host_for_receiver(self.group_id, idx)
                for idx in range(self.size)}
            devices = {
                idx: self.broker.get_device_for_idx(self.group_id, idx)
                for idx in range(self.size)}
            if hosts == self._rank_hosts and devices == self._rank_devices:
                return
            self._rank_hosts, self._rank_devices = hosts, devices
            self._topology_cache = None
            self._same_machine_cache = None
            self._topology_gen += 1

    def topology(self):
        """The world's Topology (mpi/topology.py), rebuilt lazily after
        refresh_rank_hosts or a migration remap. The completeness check
        and the cache write happen under one lock acquisition; a remap
        racing the refresh outside the lock sends us round again."""
        from faabric_tpu_torch.mpi.topology import Topology

        while True:
            with self._lock:
                if self._topology_cache is not None:
                    return self._topology_cache
                if len(self._rank_hosts) == self.size:
                    devices = (dict(self._rank_devices)
                               if any(d >= 0 for d in
                                      self._rank_devices.values())
                               else None)
                    self._topology_cache = Topology(dict(self._rank_hosts),
                                                    rank_devices=devices)
                    return self._topology_cache
            self.refresh_rank_hosts()

    def host_for_rank(self, rank: int) -> str:
        with self._lock:
            if rank not in self._rank_hosts:
                self.refresh_rank_hosts()
            return self._rank_hosts[rank]

    def ranks_on_host(self, host: str) -> list[int]:
        return list(self.topology().ranks_on_host(host))

    def local_leader(self, host: str) -> int:
        """Lowest rank on a host (reference initLocalRemoteLeaders)."""
        ranks = self.topology().ranks_on_host(host)
        if not ranks:
            raise ValueError(f"No ranks on host {host}")
        return ranks[0]

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
        reduce_scatter run on the plane's device. With
        ``FAABRIC_DEVICE_PLANE=0`` it returns False on every rank, with
        no exchange."""
        if not DEVICE_PLANE_ENABLED:
            return False
        from faabric_tpu_torch.device_plane import (
            DevicePlane,
            MeshMismatch,
            registration_row,
            resolve_local_device,
        )
        from faabric_tpu_torch.device_plane.registry import (
            rank_processes,
            resolve_mesh,
        )
        from faabric_tpu_torch.util.device import resolve_device

        device = (resolve_local_device(self, rank) if device is None
                  else resolve_device(device))
        self.topology()  # the generation below must be of a built one
        dropped = None
        with self._lock:
            gen = self._topology_gen
            seq = self._plane_activations.get(rank, 0) + 1
            self._plane_activations[rank] = seq
            plane = self._device_plane
            if plane is not None and plane.topology_gen != gen:
                dropped, self._device_plane = plane, None
        if dropped is not None:
            dropped.close()
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
        plane = DevicePlane(
            self.id, devices, local_ranks=local_ranks, topology_gen=gen,
            processes=rank_processes(rows, self.size),
            exchange_name=f"world/{self.id}/{self.group_id}/{gen}/{seq}")
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
                dropped = cur
            else:
                dropped = None
        if dropped is not None:
            dropped.close()
        return True

    def device_plane(self):
        """The active DevicePlane, or None (host ladder only). A plane of
        an older topology generation reads as None."""
        with self._lock:
            plane = self._device_plane
            if plane is not None and plane.topology_gen != self._topology_gen:
                return None
            return plane

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

    # ------------------------------------------------------------------
    # Point-to-point
    # ------------------------------------------------------------------
    def send(self, send_rank: int, recv_rank: int, data,
             msg_type: MpiMessageType = MpiMessageType.NORMAL,
             request_id: int = 0, _copy: bool = True,
             _transfer: bool = False) -> None:
        """``_copy=False`` is for fan-out callers that already hold an
        immutable private buffer (broadcast trees): no per-receiver
        copy. ``_transfer=True`` hands the buffer's ownership to the
        receiver (the sender drops every reference), which may fold into
        it in place (the rings)."""
        if self.record_exec_graph:
            with self._lock:
                self._msg_count_to_rank[recv_rank] = \
                    self._msg_count_to_rank.get(recv_rank, 0) + 1
                key = (int(msg_type), recv_rank)
                self._msg_type_count[key] = \
                    self._msg_type_count.get(key, 0) + 1

        # Program order: a blocking send must not overtake this rank's
        # queued async sends to the same destination
        self._fence_sends(send_rank, recv_rank)

        arr = np.asarray(self._stage_host(data))
        self.broker.wait_for_mappings(self.group_id)
        if self.broker.get_host_for_receiver(self.group_id, recv_rank) \
                == self.broker.host:
            # One copy (MPI lets the sender reuse its buffer at once)
            # rides the in-process queue as the array itself
            if _copy and not _transfer:
                arr = arr.copy()
            if not _transfer:
                arr.flags.writeable = False
            payload = _LocalMpiPayload(msg_type, arr,
                                       shared=not _copy and not _transfer,
                                       owned=_transfer)
        else:
            # With zero-copy framing this span should be ~0; a fat one
            # (a non-contiguous input forcing a copy) is a suspect
            with span("mpi.wire", "serialize", rank=send_rank) \
                    if tracing_enabled() else NULL_SPAN:
                payload = MpiWirePayload(msg_type, arr, request_id)
        self.broker.send_message(self.group_id, send_rank, recv_rank,
                                 payload)

    def _recv_raw(self, send_rank: int, recv_rank: int,
                  timeout: float | None = None
                  ) -> tuple[np.ndarray, MpiStatus]:
        """Internal receive: the array may be read-only and shared.
        Collectives never write into it unless the sender transferred it
        (``_recv_raw_owned``)."""
        arr, status, _ = self._recv_raw_owned(send_rank, recv_rank,
                                              timeout=timeout)
        return arr, status

    def _recv_raw_owned(self, send_rank: int, recv_rank: int,
                        timeout: float | None = None
                        ) -> tuple[np.ndarray, MpiStatus, bool]:
        """Internal receive and whether the sender transferred the
        buffer (so the receiver may write into it)."""
        raw = self.broker.recv_message(self.group_id, send_rank, recv_rank,
                                       timeout=timeout)
        if isinstance(raw, _LocalMpiPayload):
            arr, owned = raw.data, raw.owned
        else:
            _, arr, _req = self._unpack_wire(raw)
            owned = arr.flags.writeable
        status = MpiStatus(source=send_rank, count=arr.size,
                           dtype=int(mpi_dtype_for(arr.dtype)))
        return arr, status, owned

    @staticmethod
    def _unpack_wire(raw):
        """Unpack a wire payload in a ``mpi.wire`` deserialize span (a
        zero-copy wrap on the bulk plane; a fat span points at the RPC
        plane's bytes → array copy)."""
        with span("mpi.wire", "deserialize", bytes=len(raw)) \
                if tracing_enabled() else NULL_SPAN:
            return unpack_mpi_payload(raw)

    def _recv_typed(self, send_rank: int, recv_rank: int
                    ) -> tuple[MpiMessageType, np.ndarray]:
        """Receive keeping the message type; the array may be shared and
        read-only (see _private_result)."""
        raw = self.broker.recv_message(self.group_id, send_rank, recv_rank)
        if isinstance(raw, _LocalMpiPayload):
            return raw.msg_type, raw.data
        msg_type, arr, _req = self._unpack_wire(raw)
        return msg_type, arr

    def recv(self, send_rank: int, recv_rank: int,
             timeout: float | None = None) -> tuple[np.ndarray, MpiStatus]:
        """The returned buffer is caller-owned and writable."""
        raw = self.broker.recv_message(self.group_id, send_rank, recv_rank,
                                       timeout=timeout)
        if isinstance(raw, _LocalMpiPayload):
            arr = raw.data
            if raw.shared:
                arr = arr.copy()  # several receivers hold this buffer
            elif not arr.flags.writeable:
                try:
                    # The sender's private copy: flip it back, no copy
                    arr.flags.writeable = True
                except ValueError:
                    arr = arr.copy()
        else:
            _, arr, _req = self._unpack_wire(raw)
            if not arr.flags.writeable:
                arr = arr.copy()
        status = MpiStatus(source=send_rank, count=arr.size,
                           dtype=int(mpi_dtype_for(arr.dtype)))
        return arr, status

    def recv_shared(self, send_rank: int, recv_rank: int,
                    timeout: float | None = None
                    ) -> tuple[np.ndarray, MpiStatus]:
        """Zero-copy receive: like ``recv``, but the array may be
        read-only and shared with the other receivers of a fan-out. For
        consumers that only read it."""
        return self._recv_raw(send_rank, recv_rank, timeout=timeout)

    def probe(self, send_rank: int, recv_rank: int,
              timeout: float | None = None) -> MpiStatus:
        """Blocking MPI_Probe: the status of the next message from
        ``send_rank``, which stays for the next recv."""
        raw = self.broker.probe_message(self.group_id, send_rank, recv_rank,
                                        timeout=timeout)
        return self._status_of(send_rank, raw)

    def iprobe(self, send_rank: int, recv_rank: int) -> Optional[MpiStatus]:
        """Non-blocking MPI_Iprobe: a status or None."""
        raw = self.broker.try_probe_message(self.group_id, send_rank,
                                            recv_rank)
        if raw is None:
            return None
        return self._status_of(send_rank, raw)

    @staticmethod
    def _status_of(send_rank: int, raw) -> MpiStatus:
        if isinstance(raw, _LocalMpiPayload):
            return MpiStatus(source=send_rank, count=raw.data.size,
                             dtype=int(mpi_dtype_for(raw.data.dtype)))
        # A wire payload's count and dtype come from its fixed header:
        # a probe never deserialises the message
        _mt, dtype, _, count, _rid = struct.unpack(
            MPI_HEADER_FMT, bytes(raw[:MPI_HEADER_LEN]))
        return MpiStatus(source=send_rank, count=count, dtype=dtype)

    def sendrecv(self, send_data, send_rank: int, dst: int, src: int,
                 recv_rank: int) -> tuple[np.ndarray, MpiStatus]:
        """Send to ``dst`` and receive from ``src`` for one rank (sends
        never block on the receiver here)."""
        self.send(send_rank, dst, send_data, MpiMessageType.SENDRECV)
        return self.recv(src, recv_rank)

    # -- async: a request registry and per-rank send workers ------------
    def _send_worker(self, rank: int) -> _SendWorker:
        """One worker per sending rank: a rank's async sends stay in
        order, and one rank's slow transfer never stalls another's."""
        with self._lock:
            w = self._send_workers.get(rank)
            if w is None:
                w = _SendWorker(f"mpi/send@{self.id}-r{rank}")
                self._send_workers[rank] = w
            return w

    def _fence_sends(self, rank: int, recv_rank: int) -> None:
        """Order a blocking send after the rank's queued isends to the
        same destination (MPI's non-overtaking is per (source, dest)).
        Skipped on the send worker itself, which is the queue."""
        if not self._send_workers:
            return  # this world never ran a remote isend
        if getattr(self._in_send_pool, "flag", False):
            return
        with self._lock:
            futs = [entry[1] for entry in
                    self._requests.get(rank, {}).values()
                    if entry[0] == "send" and entry[1] is not None
                    and entry[2] == recv_rank]
        for f in futs:
            f.exception()  # wait; errors surface at wait()

    def isend(self, send_rank: int, recv_rank: int, data) -> int:
        with self._lock:
            rid = self._next_request_id
            self._next_request_id += 1

        self.broker.wait_for_mappings(self.group_id)
        remote = self.broker.get_host_for_receiver(
            self.group_id, recv_rank) != self.broker.host
        if remote:
            # A remote send can block on TCP: it runs on the rank's send
            # worker and isend returns at once. Copy now: MPI lets the
            # caller reuse the buffer as soon as isend returns.
            payload = np.array(self._stage_host(data), copy=True)

            def _do_send():
                self._in_send_pool.flag = True
                self.send(send_rank, recv_rank, payload, request_id=rid)

            fut = self._send_worker(send_rank).submit(_do_send)
            with self._lock:
                self._requests.setdefault(send_rank, {})[rid] = (
                    "send", fut, recv_rank)
        else:
            # A local enqueue never blocks
            self.send(send_rank, recv_rank, data, request_id=rid)
            with self._lock:
                self._requests.setdefault(send_rank, {})[rid] = (
                    "send", None, recv_rank)
        return rid

    def irecv(self, send_rank: int, recv_rank: int) -> int:
        with self._lock:
            rid = self._next_request_id
            self._next_request_id += 1
            self._requests.setdefault(recv_rank, {})[rid] = (
                "recv", send_rank, recv_rank)
        return rid

    def await_async(self, rank: int, request_id: int
                    ) -> Optional[tuple[np.ndarray, MpiStatus]]:
        """MPI_Wait. A recv completes here; a local send completed at
        isend; a remote isend joins its send worker (errors surface)."""
        with self._lock:
            entry = self._requests.get(rank, {}).pop(request_id, None)
        if entry is None:
            raise KeyError(f"Unknown MPI request {request_id} for rank {rank}")
        if entry[0] == "send":
            fut = entry[1]
            if fut is not None:
                fut.result()
            return None
        _, send_rank, recv_rank = entry
        return self.recv(send_rank, recv_rank)

    def pending_requests(self, rank: int) -> int:
        with self._lock:
            return len(self._requests.get(rank, {}))

    def request_free(self, rank: int, request_id: int) -> None:
        """MPI_Request_free: drop the handle without waiting. A freed
        irecv whose message already arrived consumes and discards it, so
        it cannot reach a later unrelated recv."""
        with self._lock:
            entry = self._requests.get(rank, {}).pop(request_id, None)
        if entry is None:
            return  # already completed or freed
        if entry[0] == "recv":
            _, send_rank, recv_rank = entry
            if self.broker.try_probe_message(self.group_id, send_rank,
                                             recv_rank) is not None:
                self.recv(send_rank, recv_rank)

    def request_ready(self, rank: int, request_id: int) -> bool:
        """Whether await_async would complete without blocking."""
        with self._lock:
            entry = self._requests.get(rank, {}).get(request_id)
        if entry is None:
            raise KeyError(f"Unknown MPI request {request_id} for rank {rank}")
        if entry[0] == "send":
            fut = entry[1]
            return fut is None or fut.done()
        _, send_rank, recv_rank = entry
        return self.broker.try_probe_message(self.group_id, send_rank,
                                             recv_rank) is not None

    def waitall(self, rank: int, request_ids: list[int]
                ) -> list[Optional[tuple[np.ndarray, MpiStatus]]]:
        """MPI_Waitall: complete every request, results in input order."""
        return [self.await_async(rank, rid) for rid in request_ids]

    def waitany(self, rank: int, request_ids: list[int],
                timeout: float | None = None
                ) -> tuple[int, Optional[tuple[np.ndarray, MpiStatus]]]:
        """MPI_Waitany: (index, result) of the first completable request.
        Ids completed by an earlier wait are skipped; a list with none
        left returns (-1, None), MPI_UNDEFINED."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            live = 0
            for i, rid in enumerate(request_ids):
                try:
                    ready = self.request_ready(rank, rid)
                except KeyError:
                    continue
                live += 1
                if ready:
                    return i, self.await_async(rank, rid)
            if live == 0:
                return -1, None
            if deadline is not None and time.monotonic() >= deadline:
                raise TimeoutError("MPI_Waitany timed out")
            time.sleep(0.0005)

    # ------------------------------------------------------------------
    # Collective schedule runner (mpi/schedule.py)
    # ------------------------------------------------------------------
    def _sched_key(self, collective: str, op=None, dtype=None,
                   nbytes=None, root: int = 0) -> tuple:
        """Cache key: (topology generation, collective, root, op class,
        dtype class, size class), identical on every rank of a call."""
        self.topology()  # the generation must be of a built topology
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
                                    nbytes or 0, self.sched_enabled)
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
        traced = tracing_enabled()
        phase_targets = sched.spec.get("targets") or {}
        for phase, group in self._sched_phase_groups(steps):
            done = 0
            tname = phase_targets.get(phase)
            if tname:
                target = get_step_target(tname)
                if target is not None:
                    done = target.try_run(self, rank, sched, phase, group,
                                          env, resolver) or 0
            if done >= len(group):
                continue
            with span("mpi.phase", phase or "run", rank=rank) \
                    if traced else NULL_SPAN:
                for st in group[done:]:
                    if st.op == SEND:
                        bufs = [np.asarray(
                            self._stage_host(env[k])).reshape(-1)
                            for k in st.keys]
                        payload = (bufs[0] if len(bufs) == 1
                                   else np.concatenate(bufs))
                        self.send(rank, st.peer, payload, msg_type)
                    elif st.op == RECV:
                        arr, _ = self._recv_raw(st.peer, rank)
                        arr = arr.reshape(-1)
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
                        env[st.dst] = (src.reshape(-1)
                                       if hasattr(src, "reshape")
                                       else np.asarray(src).reshape(-1))
        return env

    # ------------------------------------------------------------------
    # Collectives: locality-aware leader trees on the host path
    # ------------------------------------------------------------------
    def barrier(self, rank: int) -> None:
        """The group barrier: one host's ranks meet on a thread barrier,
        several hosts' gather to rank 0 and are released by it."""
        _count_collective("barrier", 0)
        with span("mpi", "barrier", rank=rank, size=self.size):
            self.broker.wait_for_mappings(self.group_id)
            self.broker.get_group(self.group_id).barrier(rank)

    def _try_device(self, kind: str, dplane, rank: int, arr, op=None):
        """The device rung: the collective on the activated plane, or
        None after a clean fallback (a host round's backend error
        disabled the plane and the caller re-runs on the host ladder).
        A resident round's backend error propagates."""
        from faabric_tpu_torch.device_plane import DevicePlaneFallback

        _count_collective(kind, int(arr.nbytes))
        with span("mpi", kind, rank=rank, size=self.size,
                  bytes=int(arr.nbytes), algo="device"):
            try:
                if kind == "allreduce":
                    out = dplane.allreduce(rank, arr, op)
                elif kind == "allgather":
                    out = dplane.allgather(rank, arr)
                else:
                    out = dplane.reduce_scatter(rank, arr, op)
            except DevicePlaneFallback as e:
                logger.warning("Device %s (world %s) fell back to the "
                               "host ladder: %s", kind, self.id, e)
                return None
        self.rungs[rank, kind] = "device"
        return out

    def _chunk_bounds(self, arr: np.ndarray) -> list[tuple[int, int]]:
        chunk_bytes = (self.CHUNK_BYTES_LOCAL if len(self.hosts()) == 1
                       else self.CHUNK_BYTES)
        elems = max(1, chunk_bytes // max(1, arr.itemsize))
        return [(lo, min(lo + elems, arr.size))
                for lo in range(0, arr.size, elems)]

    def broadcast(self, send_rank: int, recv_rank: int, data) -> np.ndarray:
        data = np.asarray(self._stage_host(data))
        _count_collective("broadcast", int(data.nbytes))
        with span("mpi", "broadcast", rank=recv_rank, root=send_rank,
                  bytes=int(data.nbytes)):
            return self._broadcast_impl(send_rank, recv_rank, data)

    def _broadcast_impl(self, send_rank: int, recv_rank: int,
                        data: np.ndarray) -> np.ndarray:
        """Reference :786-853: the root sends once per remote host (to
        its local leader) and to its own host's ranks; leaders
        re-broadcast locally. Large payloads stream in chunks behind a
        CHUNK_HEADER message, so receivers follow the root's chunking
        and never need a sized template."""
        data = np.asarray(data)
        my_host = self.host_for_rank(recv_rank)
        root_host = self.host_for_rank(send_rank)

        if recv_rank == send_rank:
            local = [r for r in self.ranks_on_host(root_host)
                     if r != send_rank]
            remote_leaders = [self.local_leader(h) for h in self.hosts()
                              if h != root_host]
            dests_remote_first = remote_leaders + local

            if data.nbytes >= self.CHUNK_BYTES * 2:
                flat = data.reshape(-1)
                bounds = self._chunk_bounds(flat)
                shared = np.array(flat, copy=True)
                shared.flags.writeable = False
                header = self._chunk_header(len(bounds), flat)
                for d in dests_remote_first:
                    self.send(send_rank, d, header,
                              MpiMessageType.CHUNK_HEADER)
                for lo, hi in bounds:
                    chunk = shared[lo:hi]
                    # Remote first: the wire starts before the local fan-out
                    for d in dests_remote_first:
                        self.send(send_rank, d, chunk,
                                  MpiMessageType.BROADCAST, _copy=False)
            else:
                shared = np.array(data, copy=True)
                for d in dests_remote_first:
                    self.send(send_rank, d, shared,
                              MpiMessageType.BROADCAST, _copy=False)
            return data

        # Leaders follow the incoming stream, forwarding locally
        leader = self.local_leader(my_host)
        if my_host != root_host and recv_rank == leader:
            local = [r for r in self.ranks_on_host(my_host)
                     if r != recv_rank]

            def forward(arr, msg_type=MpiMessageType.BROADCAST):
                for r in local:
                    self.send(recv_rank, r, arr, msg_type, _copy=False)

            msg_type, first = self._recv_typed(send_rank, recv_rank)
            if msg_type != MpiMessageType.CHUNK_HEADER:
                forward(first)
                return self._private_result(first, data)
            n_chunks, out = self._parse_chunk_header(first)
            forward(first, MpiMessageType.CHUNK_HEADER)
            pos = 0
            for _ in range(n_chunks):
                arr, _ = self._recv_raw(send_rank, recv_rank)
                out[pos:pos + arr.size] = arr
                ro = out[pos:pos + arr.size]
                ro.flags.writeable = False
                forward(ro)
                pos += arr.size
            # out's chunks were shared read-only with the local
            # receivers: the caller gets a private copy
            return self._private_result(out.copy(), data, private=True)

        src = send_rank if my_host == root_host else leader
        msg_type, first = self._recv_typed(src, recv_rank)
        if msg_type != MpiMessageType.CHUNK_HEADER:
            return self._private_result(first, data)
        n_chunks, out = self._parse_chunk_header(first)
        pos = 0
        for _ in range(n_chunks):
            arr, _ = self._recv_raw(src, recv_rank)
            out[pos:pos + arr.size] = arr
            pos += arr.size
        return self._private_result(out, data, private=True)

    @staticmethod
    def _chunk_header(n_chunks: int, flat: np.ndarray) -> np.ndarray:
        return np.array([n_chunks, flat.size,
                         int(mpi_dtype_for(flat.dtype))], dtype=np.int64)

    @staticmethod
    def _parse_chunk_header(header: np.ndarray) -> tuple[int, np.ndarray]:
        n_chunks, total, dtype_code = (int(x) for x in header[:3])
        return n_chunks, np.empty(total,
                                  dtype=np_dtype_for(MpiDataType(dtype_code)))

    @staticmethod
    def _private_result(arr: np.ndarray, template: np.ndarray,
                        private: bool = False) -> np.ndarray:
        """A caller-owned writable result, shaped like the template when
        the sizes agree (size-less templates stay flat). ``private``
        marks buffers this rank already owns."""
        if not private and not arr.flags.writeable:
            arr = arr.copy()
        if template.size == arr.size and template.shape != arr.shape:
            arr = arr.reshape(template.shape)
        return arr

    def reduce(self, rank: int, root: int, data,
               op: MpiOp = MpiOp.SUM) -> Optional[np.ndarray]:
        data = np.asarray(self._stage_host(data))
        _count_collective("reduce", int(data.nbytes))
        with span("mpi", "reduce", rank=rank, root=root,
                  bytes=int(data.nbytes)):
            return self._reduce_impl(rank, root, data, op)

    def _reduce_impl(self, rank: int, root: int, data: np.ndarray,
                     op: MpiOp = MpiOp.SUM,
                     _shared_ok: bool = False) -> Optional[np.ndarray]:
        """Reference :1127-1249: non-leaders send to their local leader;
        leaders fold and forward one message to the root. Large payloads
        stream in chunks."""
        data = np.asarray(data)
        if data.nbytes >= self.CHUNK_BYTES * 2:
            return self._reduce_chunked(rank, root, data, op, _shared_ok)
        my_host = self.host_for_rank(rank)
        root_host = self.host_for_rank(root)
        leader = self.local_leader(my_host)

        if rank == root:
            acc = data.copy()
            # The root's own host's ranks send to it directly
            for r in self.ranks_on_host(root_host):
                if r != root:
                    arr, _ = self._recv_raw(r, root)
                    acc = apply_op_inplace(op, acc, arr)
            # One partial result per remote host
            for host in self.hosts():
                if host != root_host:
                    arr, _ = self._recv_raw(self.local_leader(host), root)
                    acc = apply_op_inplace(op, acc, arr)
            return acc

        if my_host == root_host:
            self.send(rank, root, data, MpiMessageType.REDUCE)
            return None

        if rank == leader:
            acc = data.copy()
            for r in self.ranks_on_host(my_host):
                if r != rank:
                    arr, _ = self._recv_raw(r, rank)
                    acc = apply_op_inplace(op, acc, arr)
            self.send(rank, root, acc, MpiMessageType.REDUCE)
            return None

        self.send(rank, leader, data, MpiMessageType.REDUCE)
        return None

    def _reduce_chunked(self, rank: int, root: int, data: np.ndarray,
                        op: MpiOp, _shared_ok: bool = False
                        ) -> Optional[np.ndarray]:
        """Chunk-pipelined leader-tree reduce: leaders fold and forward
        chunk k while chunk k+1 arrives. ``_shared_ok`` (allreduce only):
        senders' chunks ride the queues as read-only views with no copy,
        safe because allreduce's trailing broadcast consumes every
        contribution before any caller regains its buffer."""
        my_host = self.host_for_rank(rank)
        root_host = self.host_for_rank(root)
        leader = self.local_leader(my_host)
        flat = data.reshape(-1)
        bounds = self._chunk_bounds(flat)

        def send_chunk(dst: int, chunk: np.ndarray) -> None:
            if _shared_ok:
                view = chunk[:]
                view.flags.writeable = False
                self.send(rank, dst, view, MpiMessageType.REDUCE,
                          _copy=False)
            else:
                self.send(rank, dst, chunk, MpiMessageType.REDUCE)

        def fold_into(acc, senders, dst_rank):
            for lo, hi in bounds:
                acc_chunk = acc[lo:hi]
                for s in senders:
                    arr, _ = self._recv_raw(s, dst_rank)
                    res = apply_op_inplace(op, acc_chunk, arr)
                    if res is not acc_chunk:  # an op that allocates
                        acc[lo:hi] = res
                        acc_chunk = acc[lo:hi]
                yield acc_chunk

        if rank == root:
            senders = [r for r in self.ranks_on_host(root_host)
                       if r != root]
            senders += [self.local_leader(h) for h in self.hosts()
                        if h != root_host]
            acc = flat.copy()
            for _ in fold_into(acc, senders, root):
                pass
            return acc.reshape(data.shape)

        if my_host == root_host:
            for lo, hi in bounds:
                send_chunk(root, flat[lo:hi])
            return None

        if rank == leader:
            locals_ = [r for r in self.ranks_on_host(my_host) if r != rank]
            acc = flat.copy()
            for acc_chunk in fold_into(acc, locals_, rank):
                # acc is the leader's own: forward with no copy
                self.send(rank, root, acc_chunk, MpiMessageType.REDUCE)
            return None

        for lo, hi in bounds:
            send_chunk(leader, flat[lo:hi])
        return None

    def allreduce(self, rank: int, data, op: MpiOp = MpiOp.SUM):
        arr = self._payload(data)
        if not _PROFILER.enabled:
            return self._allreduce_entry(rank, arr, op)
        # The wall-anchored entry stamp is what straggler analysis
        # compares across ranks: in a synchronous collective a late
        # arriver inflates everyone's total alike
        _PROFILER.record_phase(self.id, "allreduce", rank, "enter_ts",
                               time.time())
        t0 = time.monotonic()
        try:
            return self._allreduce_entry(rank, arr, op)
        finally:
            _PROFILER.record_phase(self.id, "allreduce", rank, "total",
                                   time.monotonic() - t0, int(arr.nbytes))

    def _allreduce_entry(self, rank: int, arr, op):
        dplane = self.device_plane()
        if dplane is not None and dplane.eligible("allreduce", arr, op):
            out = self._try_device("allreduce", dplane, rank, arr, op)
            if out is not None:
                return out
        arr = self._stage_host(arr)
        if self._sched_reduction_eligible(op):
            return self._reduction_sched(rank, "allreduce", arr, op)
        algo = ("hier" if self._hier_eligible(arr, op)
                else "ring" if (arr.size >= self.size
                                and self._ring_eligible(arr, op))
                else "tree")
        self.rungs[rank, "allreduce"] = algo
        _count_collective("allreduce", int(arr.nbytes))
        with span("mpi", "allreduce", rank=rank, size=self.size,
                  bytes=int(arr.nbytes), algo=algo):
            if algo == "hier":
                return self._allreduce_hier(rank, arr, op)
            if algo == "ring":
                return self._allreduce_ring(rank, arr, op)
            # Reduce to 0 and broadcast (reference :1251-1264); the
            # trailing broadcast is the completion barrier that makes
            # the zero-copy contribution sends safe (_shared_ok)
            with span("mpi.phase", "reduce", rank=rank):
                reduced = self._reduce_impl(rank, MAIN_RANK, arr, op,
                                            _shared_ok=True)
            with span("mpi.phase", "broadcast", rank=rank):
                return self._broadcast_impl(
                    MAIN_RANK, rank, reduced if rank == MAIN_RANK else arr)

    def _sched_reduction_eligible(self, op=None) -> bool:
        """Whether the hierarchical reduction lowerings run in place of
        the hand-written paths: both ``sched_enabled == "force"`` and
        ``sched_reductions``, a commuting op and several hosts."""
        if self.sched_enabled != "force" or not self.sched_reductions:
            return False
        if op is not None and isinstance(op, UserOp) and not op.commute:
            return False
        return self.size > 1 and self.topology().n_hosts > 1

    def _reduction_sched(self, rank: int, collective: str,
                         data: np.ndarray, op) -> np.ndarray:
        """Allreduce, reduce_scatter or allgather as its verified
        schedule lowering (mpi/schedule_compile.py), the schedule twin
        of the hand-written hierarchical paths."""
        flat = np.asarray(data).reshape(-1)
        op_arg = None if collective == "allgather" else op
        sched, family = self._sched_get(
            rank, collective, op=op_arg, dtype=flat.dtype,
            nbytes=int(flat.nbytes))
        self.rungs[rank, collective] = "sched:" + family.split(".", 1)[1]
        _count_collective(collective, int(flat.nbytes))
        with span("mpi", collective, rank=rank, size=self.size,
                  bytes=int(flat.nbytes),
                  algo="sched:" + family.split(".", 1)[1]):
            env: dict = {}
            if collective == "allreduce":
                segs = self._ring_segments(flat.size, sched.spec["segments"])
                for s, (lo, hi) in enumerate(segs):
                    env[("in", s)] = flat[lo:hi]

                def resolver(sym, e, _segs=segs):
                    return _segs[sym[1]][1] - _segs[sym[1]][0]

                self._run_schedule(rank, sched, env, op, resolver,
                                   MpiMessageType.ALLREDUCE)
                out = np.empty(flat.size, dtype=flat.dtype)
                for s, (lo, hi) in enumerate(segs):
                    out[lo:hi] = env[("out", s)]
                return out.reshape(np.asarray(data).shape)
            if collective == "reduce_scatter":
                k = flat.size // self.size
                for j in range(self.size):
                    env[("in", j)] = flat[j * k:(j + 1) * k]
                self._run_schedule(rank, sched, env, op, lambda sym, e: k,
                                   MpiMessageType.REDUCE)
                return np.array(env[("out", 0)])
            k = flat.size
            env[("in", 0)] = flat
            self._run_schedule(rank, sched, env, None, lambda sym, e: k,
                               MpiMessageType.ALLGATHER)
            out = np.empty(self.size * k, dtype=flat.dtype)
            for q in range(self.size):
                out[q * k:(q + 1) * k] = env[("out", q)]
            return out

    def _ring_eligible(self, arr: np.ndarray, op) -> bool:
        """The ring for allreduce and reduce_scatter: large enough to
        beat the tree, every host on this machine, a commuting op."""
        return (self.size > 1 and arr.nbytes >= self.CHUNK_BYTES * 2
                and (not isinstance(op, UserOp) or op.commute)
                and self._all_hosts_same_machine())

    def _all_hosts_same_machine(self) -> bool:
        """Whether every rank's host resolves to this machine. A ring's
        extra hops are free on local bandwidth; over a real network the
        hierarchical composition's one message per host wins."""
        from faabric_tpu_torch.transport.common import resolve_host
        from faabric_tpu_torch.util.network import is_local_ip

        with self._lock:
            if self._same_machine_cache is not None:
                return self._same_machine_cache
            gen = self._topology_gen
        hosts = self.hosts()
        result = len(hosts) == 1 or all(
            is_local_ip(resolve_host(h, 0)[0]) for h in hosts)
        with self._lock:
            # A remap racing this computation must not cache a stale
            # verdict: it would desync the algorithm choice across hosts
            if self._topology_gen == gen:
                self._same_machine_cache = result
        return result

    # ------------------------------------------------------------------
    # Hierarchical topology-composed collectives
    # ------------------------------------------------------------------
    def _hier_eligible(self, arr: np.ndarray, op=None) -> bool:
        """Payload large enough to chunk, a commuting op, and a topology
        with both several hosts and co-located ranks."""
        if not self.hier_enabled:
            return False
        if op is not None and isinstance(op, UserOp) and not op.commute:
            return False
        if arr.nbytes < self.CHUNK_BYTES * 2 or arr.size < self.size:
            return False
        return self.topology().hierarchical and self._hier_wins()

    def _hier_wins(self) -> bool:
        """Composing pays only when the leader ring's saved bytes cross a
        real machine boundary; ``hier_enabled == "force"`` composes on
        one machine too."""
        return (self.hier_enabled == "force"
                or not self._all_hosts_same_machine())

    def _host_reduce(self, rank: int, data: np.ndarray, op,
                     locals_: list[int]):
        """Phase ``intra``: a chunked ring reduce-scatter over this
        host's ranks, then non-leaders hand their folded segments to the
        local leader, which assembles the host-reduced vector. Returns
        (host_acc on the leader, None elsewhere; restore_fn), and every
        caller runs restore_fn only once a later phase proves the local
        successor consumed this rank's step-0 views."""
        flat = data.reshape(-1)
        m = len(locals_)
        leader = locals_[0]
        if m == 1:
            return (flat if rank == leader else None), (lambda: None)
        with span("mpi.phase", "reduce_scatter", rank=rank,
                  phase="intra"):
            held, restore = self._ring_reduce_scatter(rank, data, op,
                                                      ring=locals_)
        with span("mpi.phase", "gather", rank=rank, phase="intra"):
            seg = self._ring_segments(flat.size, m)
            pos = locals_.index(rank)
            if rank != leader:
                for part in held:
                    self.send(rank, leader, part, MpiMessageType.REDUCE,
                              _transfer=True)
                return None, restore
            host_acc = np.empty(
                flat.size, dtype=held[0].dtype if held else flat.dtype)
            # Own chunks cover segment (pos+1) % m ...
            write = seg[(pos + 1) % m][0]
            for part in held:
                host_acc[write:write + part.size] = part
                write += part.size
            # ... and the local rank at position p holds segment (p+1) % m
            for p in range(m):
                if locals_[p] == rank:
                    continue
                slo, shi = seg[(p + 1) % m]
                for clo, chi in self._ring_chunks(slo, shi, flat.itemsize):
                    arr, _ = self._recv_raw(locals_[p], rank)
                    host_acc[clo:chi] = arr
        return host_acc, restore

    def _allreduce_hier(self, rank: int, data: np.ndarray,
                        op) -> np.ndarray:
        """Reduce-scatter within each host, a chunked ring over the
        per-host leaders only, then redistribution back down: each host
        puts 2·(H−1)/H of the payload on the wire."""
        topo = self.topology()
        locals_ = list(topo.ranks_on_host(topo.host_of(rank)))
        leader = locals_[0]
        # Per-level durations go to the collective profiler, so the
        # critical path names the slow level, not just the slow rank
        prof = _PROFILER.enabled
        t_ph = time.monotonic() if prof else 0.0
        host_acc, restore = self._host_reduce(rank, data, op, locals_)
        if prof:
            now = time.monotonic()
            _PROFILER.record_phase(self.id, "allreduce", rank, "intra",
                                   now - t_ph)
            t_ph = now
        if rank != leader:
            with span("mpi.phase", "broadcast", rank=rank,
                      phase="redistribute"):
                arr, _ = self._recv_raw(leader, rank)
                out = self._private_result(arr, data)
            if prof:
                _PROFILER.record_phase(self.id, "allreduce", rank,
                                       "redistribute",
                                       time.monotonic() - t_ph)
            restore()
            return out
        # The leader ring, the leg that crosses machines, may quantise
        # its fold (mpi/quant.py); intra-host phases stay exact
        result = self._allreduce_ring(
            rank, host_acc, op, ring=list(topo.leaders), phase="leader",
            codec=leader_ring_codec(resolve_quant_mode(self.allreduce_quant),
                                    host_acc.dtype, op))
        if prof:
            now = time.monotonic()
            _PROFILER.record_phase(self.id, "allreduce", rank, "leader",
                                   now - t_ph)
            t_ph = now
        with span("mpi.phase", "broadcast", rank=rank,
                  phase="redistribute"):
            if len(locals_) > 1:
                shared = result.reshape(-1)
                shared.flags.writeable = False
                for r in locals_[1:]:
                    self.send(rank, r, shared, MpiMessageType.BROADCAST,
                              _copy=False)
                # Receivers keep the frozen buffer; the caller gets its
                # own
                result = shared.copy()
        if prof:
            _PROFILER.record_phase(self.id, "allreduce", rank,
                                   "redistribute", time.monotonic() - t_ph)
        restore()
        return self._private_result(result, data, private=True)

    def _allreduce_ring(self, rank: int, data: np.ndarray, op,
                        ring: list[int] | None = None,
                        phase: str | None = None,
                        codec=None) -> np.ndarray:
        """Chunk-pipelined ring allreduce: n-1 reduce-scatter steps, then
        n-1 allgather steps passing chunk references on, each received
        chunk written straight into the result. ``ring`` restricts it to
        an ordered rank subset (the hierarchical leader ring); ``codec``
        encodes the reduce-scatter's wire (``_ring_reduce_scatter``);
        ``phase`` tags the spans with the hierarchy level."""
        flat = data.reshape(-1)
        if ring is None:
            ring = list(range(self.size))
        n = len(ring)
        pos = ring.index(rank)
        seg = self._ring_segments(flat.size, n)
        nxt, prv = ring[(pos + 1) % n], ring[(pos - 1) % n]
        lvl = {"phase": phase} if phase else {}
        with span("mpi.phase", "reduce_scatter", rank=rank, **lvl):
            held, restore = self._ring_reduce_scatter(rank, data, op,
                                                      ring=ring, codec=codec)
        out = np.empty(flat.size,
                       dtype=held[0].dtype if held else flat.dtype)
        with span("mpi.phase", "allgather", rank=rank, **lvl):
            # Our fully reduced segment, while its chunks are in hand
            start = seg[(pos + 1) % n][0]
            for part in held:
                out[start:start + part.size] = part
                start += part.size
            parts: dict[int, list[np.ndarray]] = {(pos + 1) % n: held}
            for step in range(n - 1):
                send_seg = (pos + 1 - step) % n
                for part in parts.pop(send_seg):
                    if part.flags.writeable:
                        part.flags.writeable = False
                    self.send(rank, nxt, part, MpiMessageType.REDUCE,
                              _copy=False)
                recv_seg = (pos - step) % n
                rlo, rhi = seg[recv_seg]
                recv_parts = []
                for clo, chi in self._ring_chunks(rlo, rhi, flat.itemsize):
                    arr, _ = self._recv_raw(prv, rank)
                    out[clo:chi] = arr
                    recv_parts.append(arr)
                parts[recv_seg] = recv_parts
        # The last allgather recv implies nxt finished its fold phase,
        # so it consumed our step-0 views: the caller's buffer may go
        # writable again
        restore()
        return out.reshape(data.shape)

    def _ring_segments(self, n_elems: int,
                       n: int | None = None) -> list[tuple[int, int]]:
        if n is None:
            n = self.size
        return [((i * n_elems) // n, ((i + 1) * n_elems) // n)
                for i in range(n)]

    @staticmethod
    def _ring_chunks(lo: int, hi: int, itemsize: int
                     ) -> list[tuple[int, int]]:
        """Pipeline-chunk bounds of one segment [lo, hi): a pure function
        of the bounds, so every rank derives each link's stream shape."""
        elems = max(1, RING_CHUNK_BYTES // max(1, itemsize))
        return [(c, min(c + elems, hi)) for c in range(lo, hi, elems)]

    def _quant_link_ok(self, peer: int) -> bool:
        """Whether the leader-ring hop to ``peer`` quantises (the
        wire-codec governor's verdict). Each chunk carries the answer
        (the NaN-scale raw form), so peers need agree only on the
        codec's framing, which the world's knob fixes."""
        from faabric_tpu_torch.transport.codec import get_wire_governor
        from faabric_tpu_torch.transport.common import host_is_local

        host = self.host_for_rank(peer)
        local = host == self.broker.host or host_is_local(host)
        return get_wire_governor().quant_for_link(self.allreduce_quant,
                                                  host, local)

    def _ring_reduce_scatter(self, rank: int, data: np.ndarray, op,
                             ring: list[int] | None = None,
                             seg: list[tuple[int, int]] | None = None,
                             codec=None):
        """The ring's fold phase: n-1 steps, each participant folding its
        part into the partial chunks it receives, (received, mine).
        Returns (chunks of the fully reduced segment (pos+1) % n in
        offset order, restore_fn); the caller runs restore_fn only after
        its trailing phase proves every neighbour consumed the step-0
        views of its buffer. ``seg`` overrides the segment partition
        (the hierarchical reduce_scatter's per-host spans).

        ``codec`` (mpi/quant.py) encodes every chunk on the wire and
        decodes it into a private buffer before the fold. Encoding
        copies, so the caller's buffer is never shared with a peer and
        restore_fn does nothing. Every participant must use the same
        codec."""
        flat = data.reshape(-1)
        if ring is None:
            ring = list(range(self.size))
        n = len(ring)
        pos = ring.index(rank)
        if seg is None:
            seg = self._ring_segments(flat.size, n)
        nxt, prv = ring[(pos + 1) % n], ring[(pos - 1) % n]
        traced = tracing_enabled()

        lo, hi = seg[pos]
        first = flat[lo:hi]
        was_writeable = first.flags.writeable
        if codec is None:
            first.flags.writeable = False
        else:
            # Whether this rank's next hop quantises is its own link's
            # verdict; a raw hop ships the NaN-scale fp32 form
            quant_link = self._quant_link_ok(nxt)
        for clo, chi in self._ring_chunks(lo, hi, flat.itemsize):
            chunk = first[clo - lo:chi - lo]
            if codec is not None:
                chunk = codec.encode(chunk, quantize=quant_link)
            self.send(rank, nxt, chunk, MpiMessageType.REDUCE, _copy=False)
        held: list[np.ndarray] = []
        for step in range(n - 1):
            slo, shi = seg[(pos - step - 1) % n]
            for clo, chi in self._ring_chunks(slo, shi, flat.itemsize):
                arr, _, owned = self._recv_raw_owned(prv, rank)
                mine = flat[clo:chi]
                with span("mpi.detail", "fold", rank=rank, step=step) \
                        if traced else NULL_SPAN:
                    if codec is not None:
                        # decode allocates a private fp32 chunk to fold
                        # into
                        folded = apply_op_inplace(op, codec.decode(arr),
                                                  mine)
                    elif owned and arr.flags.writeable \
                            and arr.dtype == mine.dtype:
                        folded = apply_op_inplace(op, arr, mine)
                    else:  # a shared or read-only chunk: fold into a new
                        folded = np.asarray(apply_op(op, arr, mine))
                if step < n - 2:
                    if codec is not None:
                        self.send(rank, nxt,
                                  codec.encode(folded, quantize=quant_link),
                                  MpiMessageType.REDUCE, _copy=False)
                    else:
                        # Ownership moves on: the receiver folds into it
                        self.send(rank, nxt, folded, MpiMessageType.REDUCE,
                                  _transfer=True)
                    del folded
                else:
                    held.append(folded)

        def restore():
            if codec is None and was_writeable:
                first.flags.writeable = True

        return held, restore

    def scatter(self, send_rank: int, recv_rank: int, data,
                recv_count: int) -> np.ndarray:
        data = np.asarray(self._stage_host(data))
        _count_collective("scatter", int(data.nbytes))
        if self.sched_enabled and self.size > 1:
            sched, family = self._sched_get(rank=recv_rank,
                                            collective="scatter",
                                            root=send_rank)
            algo = "sched:" + family.split(".", 1)[1]
            self.rungs[recv_rank, "scatter"] = algo
            with span("mpi", "scatter", rank=recv_rank, root=send_rank,
                      algo=algo):
                return self._scatter_sched(send_rank, recv_rank, sched,
                                           data, recv_count=recv_count)
        self.rungs[recv_rank, "scatter"] = "direct"
        with span("mpi", "scatter", rank=recv_rank, root=send_rank,
                  algo="direct"):
            return self._scatter_impl(send_rank, recv_rank, data,
                                      recv_count)

    def _scatter_sched(self, root: int, rank: int, sched, data,
                       recv_count: int | None = None,
                       counts=None) -> np.ndarray:
        """Schedule-path scatter and scatterv: the root binds its
        per-rank input blocks (and, for scatterv trees, the int64
        count-vector header the leaders split by); other ranks' blocks
        arrive sized by the wire or the header."""
        env: dict = {}
        if rank == root:
            flat = np.asarray(data).reshape(-1)
            if counts is None:
                chunks = flat.reshape(self.size, recv_count)
                for j in range(self.size):
                    env[("in", j)] = chunks[j]
            else:
                offsets = np.cumsum([0] + list(counts[:-1]))
                for j in range(self.size):
                    env[("in", j)] = flat[offsets[j]:offsets[j]
                                          + counts[j]]
                if sched.spec.get("counts_header"):
                    env[("in", "cnt")] = np.asarray(counts, dtype=np.int64)

        def resolver(sym, e):
            if sym == ("cnt",):
                return self.size
            j = sym[1]
            if counts is not None and rank == root:
                return int(counts[j])
            if recv_count is not None:
                return int(recv_count)
            return int(np.asarray(e[("tmp", "cnt")]).reshape(-1)[j])

        self._run_schedule(rank, sched, env, None, resolver,
                           MpiMessageType.SCATTER)
        # Out blocks may alias the root's input or a shared buffer
        return np.array(env[("out", 0)])

    def _scatter_impl(self, send_rank: int, recv_rank: int,
                      data: np.ndarray, recv_count: int) -> np.ndarray:
        """The root splits (size · recv_count,) into per-rank chunks."""
        if recv_rank == send_rank:
            chunks = np.asarray(data).reshape(self.size, recv_count)
            for r in range(self.size):
                if r != send_rank:
                    self.send(send_rank, r, chunks[r],
                              MpiMessageType.SCATTER)
            return chunks[send_rank].copy()
        arr, _ = self.recv(send_rank, recv_rank)
        return arr

    def gather(self, send_rank: int, root: int, data) -> Optional[np.ndarray]:
        data = np.asarray(self._stage_host(data))
        _count_collective("gather", int(data.nbytes))
        with span("mpi", "gather", rank=send_rank, root=root,
                  bytes=int(data.nbytes)):
            return self._gather_impl(send_rank, root, data)

    def _gather_impl(self, send_rank: int, root: int, data: np.ndarray
                     ) -> Optional[np.ndarray]:
        """Two-step local-leader aggregation (reference :917-1080)."""
        my_host = self.host_for_rank(send_rank)
        root_host = self.host_for_rank(root)
        leader = self.local_leader(my_host)
        data = np.asarray(data)
        chunk = data.size

        if send_rank == root:
            out = np.empty((self.size, chunk), dtype=data.dtype)
            out[root] = data.reshape(-1)
            for r in self.ranks_on_host(root_host):
                if r != root:
                    arr, _ = self._recv_raw(r, root)
                    out[r] = arr.reshape(-1)
            for host in self.hosts():
                if host != root_host:
                    remote_ranks = sorted(self.ranks_on_host(host))
                    arr, _ = self._recv_raw(self.local_leader(host), root)
                    packed = arr.reshape(len(remote_ranks), chunk)
                    for i, r in enumerate(remote_ranks):
                        out[r] = packed[i]
            return out.reshape(-1)

        if my_host == root_host:
            self.send(send_rank, root, data, MpiMessageType.GATHER)
            return None

        if send_rank == leader:
            local_ranks = sorted(self.ranks_on_host(my_host))
            packed = np.empty((len(local_ranks), chunk), dtype=data.dtype)
            packed[local_ranks.index(send_rank)] = data.reshape(-1)
            for r in local_ranks:
                if r != send_rank:
                    arr, _ = self._recv_raw(r, send_rank)
                    packed[local_ranks.index(r)] = arr.reshape(-1)
            self.send(send_rank, root, packed.reshape(-1),
                      MpiMessageType.GATHER)
            return None

        self.send(send_rank, leader, data, MpiMessageType.GATHER)
        return None

    # -- v-variants: counts ride the wire with each message, so only the
    # root needs the count vector -------------------------------------------
    def gatherv(self, rank: int, root: int, data
                ) -> Optional[tuple[np.ndarray, list[int]]]:
        """Root returns (concatenated values in rank order, counts)."""
        data = np.asarray(self._stage_host(data)).reshape(-1)
        if rank != root:
            self.send(rank, root, data, MpiMessageType.GATHER)
            return None
        parts: list[np.ndarray] = []
        for r in range(self.size):
            if r == root:
                parts.append(data)
            else:
                arr, _ = self._recv_raw(r, root)
                parts.append(arr)
        return np.concatenate(parts), [int(p.size) for p in parts]

    def scatterv(self, send_rank: int, recv_rank: int, data,
                 counts: Optional[list[int]]) -> np.ndarray:
        """The root splits ``data`` into per-rank pieces of ``counts``
        sizes; receivers need no counts. Through the schedule compiler
        the tree family packs one bundle per remote host behind an int64
        count-vector header."""
        if data is not None:
            data = np.asarray(self._stage_host(data))
        if recv_rank == send_rank:
            flat = np.asarray(data).reshape(-1)
            if counts is None or len(counts) != self.size:
                raise ValueError("scatterv root needs one count per rank")
            if sum(counts) != flat.size:
                raise ValueError(
                    f"scatterv counts sum {sum(counts)} != data {flat.size}")
        # Payload bytes enter at the root only; receivers count the
        # invocation
        _count_collective(
            "scatterv",
            int(np.asarray(data).nbytes) if recv_rank == send_rank else 0)
        if self.sched_enabled and self.size > 1:
            sched, family = self._sched_get(rank=recv_rank,
                                            collective="scatterv",
                                            root=send_rank)
            algo = "sched:" + family.split(".", 1)[1]
            self.rungs[recv_rank, "scatterv"] = algo
            with span("mpi", "scatterv", rank=recv_rank, root=send_rank,
                      algo=algo):
                return self._scatter_sched(send_rank, recv_rank, sched,
                                           data, counts=counts)
        self.rungs[recv_rank, "scatterv"] = "direct"
        with span("mpi", "scatterv", rank=recv_rank, root=send_rank,
                  algo="direct"):
            return self._scatterv_direct(send_rank, recv_rank, data,
                                         counts)

    def _scatterv_direct(self, send_rank: int, recv_rank: int,
                         data: Optional[np.ndarray],
                         counts: Optional[list[int]]) -> np.ndarray:
        if recv_rank == send_rank:
            flat = np.asarray(data).reshape(-1)
            offsets = np.cumsum([0] + list(counts[:-1]))
            for r in range(self.size):
                if r != send_rank:
                    self.send(send_rank, r,
                              flat[offsets[r]:offsets[r] + counts[r]],
                              MpiMessageType.SCATTER)
            lo = offsets[send_rank]
            return flat[lo:lo + counts[send_rank]].copy()
        arr, _ = self.recv(send_rank, recv_rank)
        return arr

    def alltoallv(self, rank: int, data, send_counts: list[int]
                  ) -> tuple[np.ndarray, list[int]]:
        """Rank ``j``'s slice of ``data`` (``send_counts[j]`` elements)
        goes to rank j; returns (the received blocks in rank order,
        received counts)."""
        flat = np.asarray(self._stage_host(data)).reshape(-1)
        if len(send_counts) != self.size:
            raise ValueError("alltoallv needs one send count per rank")
        if sum(send_counts) != flat.size:
            raise ValueError(
                f"alltoallv counts sum {sum(send_counts)} != {flat.size}")
        offsets = np.cumsum([0] + list(send_counts[:-1]))
        my_block = None
        for r in range(self.size):
            block = flat[offsets[r]:offsets[r] + send_counts[r]]
            if r == rank:
                my_block = block.copy()
            else:
                self.send(rank, r, block, MpiMessageType.ALLTOALL)
        parts: list[np.ndarray] = []
        for r in range(self.size):
            if r == rank:
                parts.append(my_block)
            else:
                arr, _ = self._recv_raw(r, rank)
                parts.append(arr)
        return np.concatenate(parts), [int(p.size) for p in parts]

    def reduce_scatter(self, rank: int, data, op: MpiOp = MpiOp.SUM):
        """MPI_Reduce_scatter_block: reduce (size·k,) contributions; rank
        r keeps segment r."""
        data = self._payload(data).reshape(-1)
        if not _PROFILER.enabled:
            return self._reduce_scatter_entry(rank, data, op)
        _PROFILER.record_phase(self.id, "reduce_scatter", rank,
                               "enter_ts", time.time())
        t0 = time.monotonic()
        try:
            return self._reduce_scatter_entry(rank, data, op)
        finally:
            _PROFILER.record_phase(self.id, "reduce_scatter", rank,
                                   "total", time.monotonic() - t0,
                                   int(data.nbytes))

    def _reduce_scatter_entry(self, rank: int, data, op):
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
        if self._sched_reduction_eligible(op):
            return self._reduction_sched(rank, "reduce_scatter", data, op)
        algo = ("hier" if self._hier_eligible(data, op)
                else "ring" if self._ring_eligible(data, op) else "tree")
        self.rungs[rank, "reduce_scatter"] = algo
        _count_collective("reduce_scatter", int(data.nbytes))
        with span("mpi", "reduce_scatter", rank=rank, size=self.size,
                  bytes=int(data.nbytes), algo=algo):
            if algo == "hier":
                return self._reduce_scatter_hier(rank, data, op)
            if algo == "ring":
                return self._reduce_scatter_ring(rank, data, op)
            with span("mpi.phase", "reduce", rank=rank):
                reduced = self._reduce_impl(rank, MAIN_RANK, data, op)
            with span("mpi.phase", "scatter", rank=rank):
                return self._scatter_impl(
                    MAIN_RANK, rank,
                    reduced if rank == MAIN_RANK else np.empty(0), k)

    def _reduce_scatter_ring(self, rank: int, data: np.ndarray,
                             op) -> np.ndarray:
        """The ring's fold phase leaves rank holding segment rank+1,
        which is rank+1's: one hop forward, chunk by chunk, hands every
        rank its own, ownership included."""
        with span("mpi.phase", "reduce_scatter", rank=rank):
            held, restore = self._ring_reduce_scatter(rank, data, op)
        with span("mpi.phase", "rotate", rank=rank):
            for part in held:
                self.send(rank, (rank + 1) % self.size, np.asarray(part),
                          MpiMessageType.REDUCE, _transfer=True)
            del held
            slo, shi = self._ring_segments(data.size)[rank]
            chunks = self._ring_chunks(slo, shi, data.itemsize)
            out = pos = None
            for clo, chi in chunks:
                arr, _, owned = self._recv_raw_owned(
                    (rank - 1) % self.size, rank)
                if len(chunks) == 1:
                    out = (arr if owned and arr.flags.writeable
                           else arr.copy())
                    break
                if out is None:
                    out = np.empty(shi - slo, dtype=arr.dtype)
                    pos = 0
                out[pos:pos + arr.size] = arr
                pos += arr.size
            # The rotation recv extends the causal chain to n: nxt
            # consumed our step-0 views
            restore()
            return out

    def _reduce_scatter_hier(self, rank: int, data: np.ndarray,
                             op) -> np.ndarray:
        """Intra-host reduce-scatter and handover (_host_reduce), then
        the leader ring's fold phase only, over per-host spans of a
        permuted coordinate space (rank order grouped by host, the
        identity for gang-contiguous placements), so each leader ends
        holding exactly its host's outputs, which it scatters down."""
        topo = self.topology()
        k = data.size // self.size
        locals_ = list(topo.ranks_on_host(topo.host_of(rank)))
        leader = locals_[0]
        leaders = list(topo.leaders)
        n_hosts = len(leaders)
        host_acc, restore = self._host_reduce(rank, data, op, locals_)

        if rank != leader:
            with span("mpi.phase", "scatter", rank=rank,
                      phase="redistribute"):
                out, _ = self.recv(leader, rank)
            restore()
            return out

        order = [r for h in topo.hosts for r in topo.ranks_on_host(h)]
        if order != list(range(self.size)):
            perm = np.empty(host_acc.size, dtype=host_acc.dtype)
            for j, r in enumerate(order):
                perm[j * k:(j + 1) * k] = host_acc[r * k:(r + 1) * k]
            host_acc = perm
        elif len(locals_) == 1:
            # The fold-only ring has no trailing circulation to extend
            # the causal chain: the caller's buffer must not feed it
            host_acc = host_acc.copy()

        # spans[p]: the permuted span of ring position p's host; the fold
        # leaves position p holding seg[(p+1) % n], so pass the
        # partition rotated one position back
        spans = []
        off = 0
        for lead in leaders:
            m_host = len(topo.ranks_on_host(topo.host_of(lead)))
            spans.append((off, off + m_host * k))
            off += m_host * k
        seg = [spans[(q - 1) % n_hosts] for q in range(n_hosts)]
        with span("mpi.phase", "reduce_scatter", rank=rank,
                  phase="leader"):
            held, _noop = self._ring_reduce_scatter(rank, host_acc, op,
                                                    ring=leaders, seg=seg)
        with span("mpi.phase", "scatter", rank=rank, phase="redistribute"):
            slo, shi = spans[leaders.index(rank)]
            hostseg = np.empty(shi - slo,
                               dtype=held[0].dtype if held else data.dtype)
            write = 0
            for part in held:
                hostseg[write:write + part.size] = part
                write += part.size
            del held
            # hostseg holds this host's outputs in local rank order
            for i, r in enumerate(locals_[1:], start=1):
                self.send(rank, r, hostseg[i * k:(i + 1) * k],
                          MpiMessageType.SCATTER)
            out = hostseg[:k].copy()  # the leader is local position 0
        restore()
        return out

    def allgather(self, rank: int, data):
        data = self._payload(data)
        if not _PROFILER.enabled:
            return self._allgather_entry(rank, data)
        _PROFILER.record_phase(self.id, "allgather", rank, "enter_ts",
                               time.time())
        t0 = time.monotonic()
        try:
            return self._allgather_entry(rank, data)
        finally:
            _PROFILER.record_phase(self.id, "allgather", rank, "total",
                                   time.monotonic() - t0, int(data.nbytes))

    def _allgather_entry(self, rank: int, data):
        dplane = self.device_plane()
        if dplane is not None and dplane.eligible("allgather", data):
            out = self._try_device("allgather", dplane, rank, data)
            if out is not None:
                return out
        return self._allgather_host(rank, self._stage_host(data))

    def _allgather_host(self, rank: int, data: np.ndarray) -> np.ndarray:
        data = np.asarray(data)
        if self._sched_reduction_eligible() and data.size > 0:
            return self._reduction_sched(rank, "allgather", data, None)
        # Hierarchy pays once the OUTPUT (size × contribution) is
        # pipeline-sized; the contribution itself may be small
        use_hier = (self.hier_enabled and data.size > 0
                    and data.nbytes * self.size >= self.CHUNK_BYTES * 2
                    and self.topology().hierarchical and self._hier_wins())
        use_ring = (not use_hier and self.size > 1
                    and data.nbytes >= self.CHUNK_BYTES
                    and self._all_hosts_same_machine())
        algo = "hier" if use_hier else "ring" if use_ring else "tree"
        self.rungs[rank, "allgather"] = algo
        _count_collective("allgather", int(data.nbytes))
        with span("mpi", "allgather", rank=rank, size=self.size,
                  bytes=int(data.nbytes), algo=algo):
            if use_hier:
                return self._allgather_hier(rank, data)
            if use_ring:
                return self._allgather_ring(rank, data)
            # gather(0) and broadcast; the broadcast stream describes
            # itself, so non-roots need no sized template
            with span("mpi.phase", "gather", rank=rank):
                gathered = self._gather_impl(rank, MAIN_RANK, data)
            template = (gathered if rank == MAIN_RANK
                        else np.empty(0, dtype=data.dtype))
            with span("mpi.phase", "broadcast", rank=rank):
                return self._broadcast_impl(MAIN_RANK, rank, template)

    def _allgather_ring(self, rank: int, data: np.ndarray) -> np.ndarray:
        """Chunk-pipelined ring allgather: rank r's contribution is
        segment r; n-1 steps pass chunk references on. The contribution
        rides as a private read-only copy (others keep references after
        this rank returns, and MPI lets the caller reuse its buffer)."""
        flat = data.reshape(-1)
        n = self.size
        k = flat.size
        nxt, prv = (rank + 1) % n, (rank - 1) % n
        shared = flat.copy()
        shared.flags.writeable = False
        chunks = self._ring_chunks(0, k, flat.itemsize)
        out = np.empty(n * k, dtype=flat.dtype)
        out[rank * k:(rank + 1) * k] = flat
        parts: dict[int, list[np.ndarray]] = {
            rank: [shared[clo:chi] for clo, chi in chunks]}
        for step in range(n - 1):
            send_seg = (rank - step) % n
            for part in parts.pop(send_seg):
                if part.flags.writeable:
                    part.flags.writeable = False
                self.send(rank, nxt, part, MpiMessageType.ALLGATHER,
                          _copy=False)
            recv_seg = (rank - step - 1) % n
            base = recv_seg * k
            recv_parts = []
            for clo, chi in chunks:
                arr, _ = self._recv_raw(prv, rank)
                out[base + clo:base + chi] = arr
                recv_parts.append(arr)
            parts[recv_seg] = recv_parts
        return out

    def _allgather_hier(self, rank: int, data: np.ndarray) -> np.ndarray:
        """Contributions gather to the local leader (``intra``), the
        leaders circulate per-host blocks round the wire ring in chunks
        (``leader``), and the result fans back out as a frozen reference
        (``redistribute``). Host blocks follow the topology's rank
        lists, so scattered placements reassemble correctly."""
        topo = self.topology()
        flat = data.reshape(-1)
        k = flat.size
        locals_ = list(topo.ranks_on_host(topo.host_of(rank)))
        leader = locals_[0]
        leaders = list(topo.leaders)
        n_hosts = len(leaders)

        if rank != leader:
            with span("mpi.phase", "gather", rank=rank, phase="intra"):
                self.send(rank, leader, flat, MpiMessageType.GATHER)
            with span("mpi.phase", "broadcast", rank=rank,
                      phase="redistribute"):
                arr, _ = self._recv_raw(leader, rank)
                return self._private_result(
                    arr, np.empty(0, dtype=flat.dtype))

        m = len(locals_)
        out = np.empty(self.size * k, dtype=flat.dtype)

        def place(host_ranks, block) -> None:
            for i, r in enumerate(host_ranks):
                out[r * k:(r + 1) * k] = block[i * k:(i + 1) * k]

        with span("mpi.phase", "gather", rank=rank, phase="intra"):
            block = np.empty(m * k, dtype=flat.dtype)
            block[:k] = flat  # the leader is local position 0
            for i, r in enumerate(locals_[1:], start=1):
                arr, _ = self._recv_raw(r, rank)
                block[i * k:(i + 1) * k] = arr

        with span("mpi.phase", "allgather", rank=rank, phase="leader"):
            place(locals_, block)
            block.flags.writeable = False
            pos = leaders.index(rank)
            nxt = leaders[(pos + 1) % n_hosts]
            prv = leaders[(pos - 1) % n_hosts]
            blocks: dict[int, list[np.ndarray]] = {
                pos: [block[clo:chi] for clo, chi in
                      self._ring_chunks(0, block.size, block.itemsize)]}
            for step in range(n_hosts - 1):
                send_pos = (pos - step) % n_hosts
                for part in blocks.pop(send_pos):
                    if part.flags.writeable:
                        part.flags.writeable = False
                    self.send(rank, nxt, part, MpiMessageType.ALLGATHER,
                              _copy=False)
                recv_pos = (pos - step - 1) % n_hosts
                rranks = topo.ranks_on_host(topo.host_of(leaders[recv_pos]))
                rblock = np.empty(len(rranks) * k, dtype=flat.dtype)
                parts = []
                write = 0
                for clo, chi in self._ring_chunks(0, rblock.size,
                                                  flat.itemsize):
                    arr, _ = self._recv_raw(prv, rank)
                    rblock[write:write + arr.size] = arr
                    parts.append(arr)
                    write += arr.size
                place(rranks, rblock)
                blocks[recv_pos] = parts

        with span("mpi.phase", "broadcast", rank=rank,
                  phase="redistribute"):
            if m > 1:
                out.flags.writeable = False
                for r in locals_[1:]:
                    self.send(rank, r, out, MpiMessageType.BROADCAST,
                              _copy=False)
                out = out.copy()  # receivers keep the frozen buffer
        return out

    def scan(self, rank: int, data, op: MpiOp = MpiOp.SUM) -> np.ndarray:
        """MPI_Scan through the schedule compiler: ``scan.chain`` is the
        reference's linear chain as a verified step program (fold order
        (prefix, mine)); ``scan.hier`` (gang-contiguous placements) runs
        chains within hosts and a carrier chain between them."""
        data = np.asarray(self._stage_host(data))
        _count_collective("scan", int(data.nbytes))
        if not (self.sched_enabled and self.size > 1):
            self.rungs[rank, "scan"] = "chain"
            with span("mpi", "scan", rank=rank, size=self.size,
                      bytes=int(data.nbytes), algo="chain"):
                return self._scan_chain(rank, data, op)
        sched, family = self._sched_get(
            rank, "scan", op=op, dtype=data.dtype, nbytes=int(data.nbytes))
        algo = "sched:" + family.split(".", 1)[1]
        self.rungs[rank, "scan"] = algo
        with span("mpi", "scan", rank=rank, size=self.size,
                  bytes=int(data.nbytes), algo=algo):
            flat = data.reshape(-1)
            env: dict = {("in", 0): flat}
            self._run_schedule(rank, sched, env, op,
                               lambda sym, e: flat.size, MpiMessageType.SCAN)
            return np.array(env[("out", 0)]).reshape(data.shape)

    def _scan_chain(self, rank: int, data: np.ndarray,
                    op) -> np.ndarray:
        """Rank r receives the prefix from r-1, folds, forwards to r+1."""
        if rank > 0:
            prev, _ = self.recv(rank - 1, rank)
            acc = apply_op(op, prev, data)
        else:
            acc = data.copy()
        if rank < self.size - 1:
            self.send(rank, rank + 1, acc, MpiMessageType.SCAN)
        return acc

    def alltoall(self, rank: int, data) -> np.ndarray:
        """All-pairs exchange of equal chunks: data is (size·chunk,), row
        r goes to rank r. Through the schedule compiler,
        ``alltoall.hier`` packs host blocks through the local leaders
        and ``alltoall.flat`` is the pairwise pattern."""
        data = np.asarray(self._stage_host(data))
        _count_collective("alltoall", int(data.nbytes))
        if not (self.sched_enabled and self.size > 1):
            self.rungs[rank, "alltoall"] = "direct"
            with span("mpi", "alltoall", rank=rank, size=self.size,
                      bytes=int(data.nbytes), algo="direct"):
                return self._alltoall_direct(rank, data)
        sched, family = self._sched_get(
            rank, "alltoall", dtype=data.dtype, nbytes=int(data.nbytes))
        algo = "sched:" + family.split(".", 1)[1]
        self.rungs[rank, "alltoall"] = algo
        with span("mpi", "alltoall", rank=rank, size=self.size,
                  bytes=int(data.nbytes), algo=algo):
            return self._alltoall_sched(rank, data, sched, family)

    def _alltoall_direct(self, rank: int, data: np.ndarray) -> np.ndarray:
        chunk = data.size // self.size
        rows = data.reshape(self.size, chunk)
        for r in range(self.size):
            if r != rank:
                self.send(rank, r, rows[r], MpiMessageType.ALLTOALL)
        out = np.empty_like(rows)
        out[rank] = rows[rank]
        for r in range(self.size):
            if r != rank:
                arr, _ = self.recv(r, rank)
                out[r] = arr
        return out.reshape(-1)

    def _alltoall_sched(self, rank: int, data: np.ndarray, sched,
                        family: str) -> np.ndarray:
        flat = data.reshape(-1)
        k = flat.size // self.size
        rows = flat.reshape(self.size, k)
        env: dict = {("in", j): rows[j] for j in range(self.size)}
        msg_type = (MpiMessageType.ALLTOALL_PACKED
                    if family == "alltoall.hier"
                    else MpiMessageType.ALLTOALL)
        self._run_schedule(rank, sched, env, None, lambda sym, e: k,
                           msg_type)
        out = np.empty(self.size * k, dtype=flat.dtype)
        for j in range(self.size):
            out[j * k:(j + 1) * k] = env[("out", j)]
        return out

    # ------------------------------------------------------------------
    # Cartesian topology (reference :369-493: user dims through
    # cart_create, all periodic, defaulting to the near-square 2-D grid)
    # ------------------------------------------------------------------
    _cart_user_dims: Optional[tuple[int, ...]] = None

    def cart_create(self, dims: Optional[Sequence[int]] = None
                    ) -> tuple[int, ...]:
        """MPI_Cart_create with user dims; ``None`` keeps the default."""
        if dims is None:
            self._cart_user_dims = None
            return self.cart_dims()
        dims = tuple(int(d) for d in dims)
        if any(d <= 0 for d in dims):
            raise ValueError(f"Cartesian dims must be positive: {dims}")
        if int(np.prod(dims)) != self.size:
            raise ValueError(
                f"Cartesian dims {dims} do not tile {self.size} ranks")
        self._cart_user_dims = dims
        return dims

    def cart_dims(self) -> tuple[int, ...]:
        if self._cart_user_dims is not None:
            return self._cart_user_dims
        side = int(np.floor(np.sqrt(self.size)))
        while side > 1 and self.size % side != 0:
            side -= 1
        return side, self.size // side

    def cart_coords(self, rank: int) -> tuple[int, ...]:
        return tuple(int(c) for c in
                     np.unravel_index(rank, self.cart_dims()))

    def cart_rank(self, coords: Sequence[int]) -> int:
        dims = self.cart_dims()
        wrapped = [c % d for c, d in zip(coords, dims)]
        return int(np.ravel_multi_index(wrapped, dims))

    def cart_shift(self, rank: int, dim: int, disp: int) -> tuple[int, int]:
        """(source, dest) of a periodic shift along ``dim``."""
        coords = list(self.cart_coords(rank))
        src_coords = list(coords)
        dst_coords = list(coords)
        src_coords[dim] -= disp
        dst_coords[dim] += disp
        return self.cart_rank(src_coords), self.cart_rank(dst_coords)

    # ------------------------------------------------------------------
    # Sub-communicators (MPI_Comm_split, _split_type, _dup,
    # _create_group)
    # ------------------------------------------------------------------
    def _split_draw(self) -> int:
        """A locally unique number per call: co-located ranks share this
        world object, and the split's allgather agrees on the max."""
        with self._lock:
            self._split_seq += 1
            return self._split_seq

    @staticmethod
    def _derive_group_id(parent: int, seq: int, color: int) -> int:
        """A cryptographic mix (Python's hash() differs per process; a
        linear mix collides when color and seq deltas cancel), in a high
        range no planner group id reaches."""
        import hashlib

        digest = hashlib.sha256(
            f"{parent}:{seq}:{color}".encode()).digest()
        mixed = int.from_bytes(digest[:8], "little") & ((1 << 62) - 1)
        return (1 << 126) | mixed

    def make_subworld(self, member_ranks: list[int], sub_group_id: int
                      ) -> "MpiWorld":
        """A world whose rank i is parent rank member_ranks[i]: every
        member host derives the same mappings from the parent's, so no
        planner round trip is needed."""
        from faabric_tpu_torch.batch_scheduler.decision import (
            SchedulingDecision,
        )

        self.broker.wait_for_mappings(self.group_id)
        d = SchedulingDecision(app_id=sub_group_id, group_id=sub_group_id)
        for new_idx, parent_rank in enumerate(member_ranks):
            host = self.broker.get_host_for_receiver(self.group_id,
                                                     parent_rank)
            port = self.broker.get_mpi_port_for_receiver(self.group_id,
                                                         parent_rank)
            dev = self.broker.get_device_for_idx(self.group_id, parent_rank)
            d.add_message(host, sub_group_id + new_idx + 1, new_idx,
                          new_idx, mpi_port=port, device_id=dev)
        # Installed by every local member; idempotent per host
        self.broker.set_up_local_mappings_from_decision(d)
        sub = MpiWorld(self.broker, sub_group_id, len(member_ranks),
                       sub_group_id, user=self.user, function=self.function)
        sub.record_exec_graph = self.record_exec_graph
        return sub

    def split(self, rank: int, color: int, key: int = 0
              ) -> tuple[Optional["MpiWorld"], int]:
        """MPI_Comm_split: ranks of one ``color`` form a subworld,
        ordered by (key, parent rank); color < 0 (MPI_UNDEFINED) opts
        out with (None, -1). Collective over the parent world."""
        triple = np.array([color, key, rank, self._split_draw()],
                          dtype=np.int64)
        gathered = self._allgather_host(rank, triple).reshape(self.size, 4)
        seq = int(gathered[:, 3].max())
        if color < 0:
            return None, -1
        members = sorted((int(k), int(r)) for c, k, r, _ in gathered
                         if int(c) == color)
        member_ranks = [r for _, r in members]
        sub_group_id = self._derive_group_id(self.group_id, seq, color)
        sub = self.make_subworld(member_ranks, sub_group_id)
        return sub, member_ranks.index(rank)

    def split_type_shared(self, rank: int, key: int = 0
                          ) -> tuple["MpiWorld", int]:
        """MPI_Comm_split_type(MPI_COMM_TYPE_SHARED): one subworld per
        host."""
        host = self.host_for_rank(rank)
        color = sorted(self.hosts()).index(host)
        sub, new_rank = self.split(rank, color, key)
        return sub, new_rank

    def dup(self, rank: int) -> tuple["MpiWorld", int]:
        """MPI_Comm_dup: the same members in a new group (isolated
        queues)."""
        return self.split(rank, color=0, key=rank)

    def create_group_comm(self, rank: int, member_ranks: list[int],
                          tag: int = 0) -> tuple[Optional["MpiWorld"], int]:
        """MPI_Comm_create_group: collective over ``member_ranks`` only
        (each member passes the same list); non-members get (None, -1).
        The group id derives from (parent, members, tag); reuse with the
        same members needs another ``tag``, as in MPI."""
        if rank not in member_ranks:
            return None, -1
        mix = 0
        for r in member_ranks:
            mix = (mix * 131 + int(r) + 1) & ((1 << 62) - 1)
        sub_group_id = self._derive_group_id(self.group_id, mix,
                                             tag + (1 << 20))
        sub = self.make_subworld(list(member_ranks), sub_group_id)
        return sub, list(member_ranks).index(rank)

    def close(self) -> None:
        """Stop this world's send workers and release its device plane
        (registry teardown)."""
        with self._lock:
            workers, self._send_workers = dict(self._send_workers), {}
            plane, self._device_plane = self._device_plane, None
        for w in workers.values():
            w.shutdown()
        if plane is not None:
            plane.close()

    # ------------------------------------------------------------------
    # Migration (reference prepareMigration)
    # ------------------------------------------------------------------
    def prepare_migration(self, rank: int,
                          new_group_id: int | None = None) -> None:
        """Drop the rank → host and rank → device maps: the device rung
        stays down until every rank re-runs the activation handshake.
        The world's device state handles drop too
        (``state/device_handle.py::invalidate_world``): a migrated rank
        never pulls a tensor of its old placement. The new group id is
        watched."""
        with self._lock:
            if any(self._requests.values()):
                raise RuntimeError(
                    "Cannot migrate an MPI world with pending async requests")
            if new_group_id is not None:
                self.group_id = new_group_id
            self._rank_hosts.clear()
            self._rank_devices.clear()
            self._topology_cache = None
            self._same_machine_cache = None
            self._topology_gen += 1
            self._device_collectives.clear()
            plane, self._device_plane = self._device_plane, None
        if plane is not None:
            plane.close()
        from faabric_tpu_torch.state.device_handle import invalidate_world

        invalidate_world(self.id)
        watch = getattr(self.broker, "watch_group", None)
        if watch is not None:
            watch(self.group_id)  # the probes follow the new group id

    def exec_graph_details(self) -> dict[str, int]:
        with self._lock:
            out = {f"mpi-msgcount-torank-{r}": n
                   for r, n in self._msg_count_to_rank.items()}
            for (t, r), n in self._msg_type_count.items():
                out[f"mpi-msgtype-{t}-torank-{r}"] = n
            return out
