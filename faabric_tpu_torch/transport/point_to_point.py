"""Point-to-point group messaging: the broker and its groups.

Counterpart of ``faabric_tpu/transport/point_to_point.py``
(``PointToPointBroker`` :95, ``PointToPointGroup`` :801). The broker
maps (group_id, group_idx) → (host, MPI port, device id) from a
``SchedulingDecision``. A message lands in an in-process FIFO queue per
(group, sender, receiver, channel): directly when both ranks live on
this host, through the receiving host's servers when they do not.
``send_message`` picks the plane as the reference's ``_send_remote``
does:

- frames of ``BULK_THRESHOLD`` to ``MAX_FRAME_BYTES`` go to the bulk
  plane (``bulk.py``: striped tuned sockets, or shm rings to a peer on
  this machine);
- smaller data-channel frames go to a peer on this machine when its
  control stripe has a live shm ring (``small_frames_ok``);
- everything else, coordination frames and mock mode included, goes on
  the RPC plane (``ptp_remote.py``). A bulk outage is remembered for
  ``BULK_RETRY_SECONDS``, and its frames take the RPC plane meanwhile.

Remote messages carry a sequence number per queue on every plane, and
the receiving broker puts them back in send order before they enter the
FIFO: the planes, the stripes and the server's worker threads hand them
over in any order, and a reconnect may deliver one twice (the duplicate
is dropped). So every queue keeps MPI's non-overtaking order.

Coordination traffic (lock grants, barrier releases, notify) uses its
own channel, so that it never shares a queue with application data.

A message to another host is bytes, or an object with ``buffers()``
(an MPI wire payload): its header and array go out back to back,
without being joined into one copy. A large one arrives as a uint8
array the receiver owns, or a read-only one shared with the bulk
plane's codec cache. A probe (``probe_message``, ``try_probe_message``)
takes the next message off its queue and holds it for the recv that
follows.

Not ported: peer-liveness probes of watched groups and the abort relay
through the planner (``ROADMAP.md`` Queue 1 #7 part C), and the send
spans, comm-matrix and flight records (part B).
"""

from __future__ import annotations

import collections
import queue
import struct
import threading
import time

from faabric_tpu_torch.proto import PointToPointMapping, PointToPointMappings
from faabric_tpu_torch.util.config import get_system_config
from faabric_tpu_torch.util.logging import get_logger
from faabric_tpu_torch.util.testing import is_mock_mode

logger = get_logger(__name__)

POINT_TO_POINT_MAIN_IDX = 0
NO_LOCK_OWNER_IDX = -1
NO_SEQUENCE_NUM = -1

DATA_CHANNEL = 0
COORD_CHANNEL = 1


class GroupAbortedError(RuntimeError):
    """A group (an MPI world) was aborted. Blocked recvs raise this
    instead of waiting out their timeout. The MPI layer re-exports it as
    ``MpiWorldAborted``."""

    def __init__(self, group_id: int, reason: str = "") -> None:
        super().__init__(f"group {group_id} aborted: {reason or 'unknown'}")
        self.group_id = group_id
        self.reason = reason


# Delivered into every queue of an aborted group so blocked consumers
# wake at once; compared by identity
_ABORT = object()


def _timeout(timeout: float | None) -> float:
    return (get_system_config().global_message_timeout if timeout is None
            else timeout)


def mappings_from_decision(decision) -> PointToPointMappings:
    out = PointToPointMappings(app_id=decision.app_id,
                               group_id=decision.group_id)
    for i in range(decision.n_messages):
        out.mappings.append(PointToPointMapping(
            host=decision.hosts[i],
            message_id=decision.message_ids[i],
            app_idx=decision.app_idxs[i],
            group_idx=decision.group_idxs[i],
            mpi_port=decision.mpi_ports[i],
            device_ids=[decision.device_ids[i]]
            if decision.device_ids[i] >= 0 else [],
        ))
    return out


class PointToPointBroker:
    """One host's view of its groups. Instantiable per host identity, so
    several hosts can run side by side in one process."""

    def __init__(self, host: str) -> None:
        self.host = host
        self._lock = threading.RLock()
        # group_id → {group_idx: mapping}
        self._mappings: dict[int, dict[int, PointToPointMapping]] = {}
        # group_id → set once the group's mappings are installed
        self._flags: dict[int, threading.Event] = {}
        # (group, send, recv, channel) → FIFO of payloads
        self._queues: dict[tuple[int, int, int, int], queue.SimpleQueue] = {}
        # Sequence numbers of remote messages per queue: the next one
        # this host sends, the next one it delivers, and those that
        # arrived early
        self._sent_seq: dict[tuple[int, int, int, int], int] = {}
        self._recv_seq: dict[tuple[int, int, int, int], int] = {}
        self._early: dict[tuple[int, int, int, int], dict[int, object]] = {}
        # Messages a probe took off their queue, ahead of the queue
        self._peeked: dict[tuple[int, int, int, int], collections.deque] = {}
        self._groups: dict[int, PointToPointGroup] = {}
        self._clients: dict[str, object] = {}
        self._bulk_clients: dict[str, object] = {}
        self._bulk_down_until: dict[str, float] = {}
        # host → whether it is this machine with shm rings usable
        self._shm_peers: dict[str, bool] = {}
        self._aborted: dict[int, str] = {}

    # ------------------------------------------------------------------
    # Mappings
    # ------------------------------------------------------------------
    def set_up_local_mappings_from_decision(self, decision) -> list[str]:
        """Install this host's view of a group; returns the hosts
        involved (reference setUpLocalMappingsFromSchedulingDecision)."""
        group_id = decision.group_id
        with self._lock:
            group = self._mappings.setdefault(group_id, {})
            for m in mappings_from_decision(decision).mappings:
                group[m.group_idx] = m
            group_obj = self._groups.get(group_id)
            if group_obj is None:
                self._groups[group_id] = PointToPointGroup(
                    self, decision.app_id, group_id, len(group))
            else:
                group_obj.group_size = len(group)
            self._flag(group_id).set()
        return decision.unique_hosts()

    def set_up_local_mappings_from_mappings(
            self, mappings: PointToPointMappings) -> None:
        from faabric_tpu_torch.batch_scheduler.decision import (
            SchedulingDecision,
        )

        self.set_up_local_mappings_from_decision(
            SchedulingDecision.from_point_to_point_mappings(mappings))

    def _flag(self, group_id: int) -> threading.Event:
        with self._lock:
            flag = self._flags.get(group_id)
            if flag is None:
                flag = self._flags[group_id] = threading.Event()
            return flag

    def wait_for_mappings(self, group_id: int,
                          timeout: float | None = None) -> None:
        timeout = _timeout(timeout)
        if not self._flag(group_id).wait(timeout):
            raise TimeoutError(
                f"no mappings for group {group_id} on {self.host} after "
                f"{timeout} s")

    def _mapping(self, group_id: int, idx: int) -> PointToPointMapping:
        with self._lock:
            return self._mappings[group_id][idx]

    def get_host_for_receiver(self, group_id: int, recv_idx: int) -> str:
        return self._mapping(group_id, recv_idx).host

    def get_mpi_port_for_receiver(self, group_id: int, recv_idx: int) -> int:
        return self._mapping(group_id, recv_idx).mpi_port

    def get_device_for_idx(self, group_id: int, idx: int) -> int:
        devs = self._mapping(group_id, idx).device_ids
        return devs[0] if devs else -1

    def get_idxs_registered_for_host(self, group_id: int,
                                     host: str) -> set[int]:
        with self._lock:
            return {idx for idx, m in self._mappings.get(group_id, {}).items()
                    if m.host == host}

    def group_size(self, group_id: int) -> int:
        with self._lock:
            return len(self._mappings.get(group_id, {}))

    # ------------------------------------------------------------------
    # Messaging
    # ------------------------------------------------------------------
    def _queue(self, key: tuple[int, int, int, int]) -> queue.SimpleQueue:
        with self._lock:
            q = self._queues.get(key)
            if q is None:
                q = self._queues[key] = queue.SimpleQueue()
            return q

    def send_message(self, group_id: int, send_idx: int, recv_idx: int,
                     data, channel: int = DATA_CHANNEL) -> None:
        """Deliver ``data`` to ``recv_idx``'s queue: any object when the
        receiver is on this host; bytes, or an object with ``buffers()``,
        when it is on another. Every remote message carries its queue's
        next sequence number, so all of them get the order the
        reference gives its ``must_order=True`` (MPI) traffic."""
        self.wait_for_mappings(group_id)
        dst_host = self.get_host_for_receiver(group_id, recv_idx)
        key = (group_id, send_idx, recv_idx, channel)
        if dst_host == self.host:
            self._queue(key).put(data)
            return
        if hasattr(data, "buffers"):
            wire = data.buffers()
        elif isinstance(data, (bytes, bytearray, memoryview)):
            wire = bytes(data)
        else:
            raise TypeError(
                f"rank {recv_idx} of group {group_id} is on {dst_host}: a "
                f"message to another host must be bytes or have buffers(), "
                f"not {type(data).__name__}")
        with self._lock:
            seq = self._sent_seq.get(key, 0)
            self._sent_seq[key] = seq + 1
        self._send_remote(key, dst_host, wire, seq)

    def _send_remote(self, key: tuple[int, int, int, int], dst_host: str,
                     wire, seq: int) -> None:
        """``wire`` is bytes or a list of buffers (header, array)."""
        from faabric_tpu_torch.transport.bulk import (
            BULK_THRESHOLD,
            MAX_FRAME_BYTES,
        )

        group_id, send_idx, recv_idx, channel = key
        bufs = wire if isinstance(wire, list) else [wire]
        nbytes = sum(memoryview(b).nbytes for b in bufs)
        use_bulk = BULK_THRESHOLD <= nbytes <= MAX_FRAME_BYTES
        small_shm = (not use_bulk and channel == DATA_CHANNEL
                     and self._shm_peer(dst_host))
        if ((use_bulk or small_shm) and not is_mock_mode()
                and not self._bulk_down(dst_host)):
            try:
                client = self._get_bulk_client(dst_host)
                # Sub-threshold frames switch plane only onto a live
                # control ring: over TCP the RPC plane is as fast
                if use_bulk or client.small_frames_ok():
                    client.send(group_id, send_idx, recv_idx, bufs, seq,
                                channel)
                    return
            except (OSError, ValueError, struct.error) as e:
                # Remembered, so a chunk stream does not pay a dial a
                # chunk; the receiver drops a frame that arrives twice
                self._mark_bulk_down(dst_host)
                logger.debug("Bulk send to %s unavailable (%s); using "
                             "RPC plane for %.0fs", dst_host, e,
                             self.BULK_RETRY_SECONDS)
        self._get_client(dst_host).send_message(
            group_id, send_idx, recv_idx, wire, seq, channel)

    def deliver(self, group_id: int, send_idx: int, recv_idx: int, data,
                seq: int = NO_SEQUENCE_NUM,
                channel: int = DATA_CHANNEL) -> None:
        """Enqueue a message that arrived from another host, in the
        order of its sequence number; one without a number goes in at
        once."""
        key = (group_id, send_idx, recv_idx, channel)
        if seq == NO_SEQUENCE_NUM:
            self._queue(key).put(data)
            return
        with self._lock:
            expected = self._recv_seq.get(key, 0)
            if seq < expected:
                return  # a duplicate of a delivered message
            early = self._early.setdefault(key, {})
            early[seq] = data
            q = self._queue(key)
            while expected in early:
                q.put(early.pop(expected))
                expected += 1
            self._recv_seq[key] = expected

    def deliver_many(self, group_id: int, send_idx: int, recv_idx: int,
                     items: list, channel: int = DATA_CHANNEL) -> None:
        """Deliver a burst of ``(seq, data)`` of one queue (a shm ring
        drain's batch)."""
        with self._lock:
            for seq, data in items:
                self.deliver(group_id, send_idx, recv_idx, data, seq,
                             channel)

    def recv_message(self, group_id: int, send_idx: int, recv_idx: int,
                     timeout: float | None = None,
                     channel: int = DATA_CHANNEL):
        """The next payload from ``send_idx`` to ``recv_idx``, in send
        order. Raises
        GroupAbortedError after an abort and TimeoutError after
        ``timeout`` seconds (the global message timeout when None)."""
        self._raise_if_aborted(group_id)
        key = (group_id, send_idx, recv_idx, channel)
        with self._lock:
            peeked = self._peeked.get(key)
            if peeked:
                return peeked.popleft()
        return self._take(key, _timeout(timeout))

    def _take(self, key: tuple[int, int, int, int],
              timeout: float | None):
        """The next payload off ``key``'s queue; None when ``timeout``
        is 0 and the queue is empty."""
        try:
            if timeout == 0:
                data = self._queue(key).get_nowait()
            else:
                data = self._queue(key).get(timeout=timeout)
        except queue.Empty as e:
            if timeout == 0:
                return None
            raise TimeoutError(f"PTP recv timed out on {key}") from e
        if data is _ABORT:
            raise GroupAbortedError(key[0], self.group_aborted(key[0]) or "")
        return data

    def probe_message(self, group_id: int, send_idx: int, recv_idx: int,
                      timeout: float | None = None,
                      channel: int = DATA_CHANNEL):
        """The next payload, left for the next recv (MPI_Probe). Blocks
        up to ``timeout``; raises TimeoutError."""
        self._raise_if_aborted(group_id)
        key = (group_id, send_idx, recv_idx, channel)
        with self._lock:
            peeked = self._peeked.get(key)
            if peeked:
                return peeked[0]
        data = self._take(key, _timeout(timeout))
        with self._lock:
            self._peeked.setdefault(key, collections.deque()).append(data)
        return data

    def try_probe_message(self, group_id: int, send_idx: int, recv_idx: int,
                          channel: int = DATA_CHANNEL):
        """Non-blocking probe: the next payload or None."""
        self._raise_if_aborted(group_id)
        key = (group_id, send_idx, recv_idx, channel)
        with self._lock:
            peeked = self._peeked.get(key)
            if peeked:
                return peeked[0]
        data = self._take(key, 0)
        if data is None:
            return None
        with self._lock:
            self._peeked.setdefault(key, collections.deque()).append(data)
        return data

    def _get_client(self, host: str):
        from faabric_tpu_torch.transport.ptp_remote import PointToPointClient

        with self._lock:
            client = self._clients.get(host)
            if client is None:
                client = self._clients[host] = PointToPointClient(host)
            return client

    def _get_bulk_client(self, host: str):
        client = self._bulk_clients.get(host)  # unlocked per-message read
        if client is not None:
            return client
        from faabric_tpu_torch.transport.bulk import BulkClient

        with self._lock:
            client = self._bulk_clients.get(host)
            if client is None:
                client = self._bulk_clients[host] = BulkClient(host)
            return client

    # After a failed bulk send, the RPC plane carries the host's frames
    # for this long instead of a dial a frame
    BULK_RETRY_SECONDS = 30.0

    def _shm_peer(self, host: str) -> bool:
        """Whether ``host`` is this machine and shm rings are usable:
        the rule for the small-frame fast path. Cached a host."""
        cached = self._shm_peers.get(host)  # unlocked per-message read
        if cached is not None:
            return cached
        from faabric_tpu_torch.transport import shm
        from faabric_tpu_torch.transport.common import host_is_local

        try:
            result = shm.shm_available() and host_is_local(host)
        except Exception:  # noqa: BLE001 — an unresolvable host is remote
            result = False
        with self._lock:
            self._shm_peers[host] = result
        return result

    def _bulk_down(self, host: str) -> bool:
        until = self._bulk_down_until.get(host, 0.0)
        return until > 0.0 and time.monotonic() < until

    def _mark_bulk_down(self, host: str) -> None:
        with self._lock:
            self._bulk_down_until[host] = (time.monotonic()
                                           + self.BULK_RETRY_SECONDS)

    # ------------------------------------------------------------------
    # Abort
    # ------------------------------------------------------------------
    def abort_group(self, group_id: int, reason: str) -> None:
        """Mark a group aborted and wake every blocked consumer; later
        recvs fail at entry. Idempotent."""
        with self._lock:
            if group_id in self._aborted:
                return
            self._aborted[group_id] = reason
            queues = [q for k, q in self._queues.items() if k[0] == group_id]
        for q in queues:
            q.put(_ABORT)

    def group_aborted(self, group_id: int) -> str | None:
        with self._lock:
            return self._aborted.get(group_id)

    def _raise_if_aborted(self, group_id: int) -> None:
        reason = self.group_aborted(group_id)
        if reason is not None:
            raise GroupAbortedError(group_id, reason)

    # ------------------------------------------------------------------
    # Groups
    # ------------------------------------------------------------------
    def get_group(self, group_id: int) -> "PointToPointGroup":
        with self._lock:
            group = self._groups.get(group_id)
            if group is None:
                raise KeyError(
                    f"Group {group_id} not registered on {self.host}")
            return group

    def group_exists(self, group_id: int) -> bool:
        with self._lock:
            return group_id in self._groups

    def clear_group(self, group_id: int) -> None:
        """Drop a finished group's state (the planner sends this once the
        group's app completes)."""
        with self._lock:
            self._groups.pop(group_id, None)
            self._mappings.pop(group_id, None)
            self._flags.pop(group_id, None)
            self._aborted.pop(group_id, None)
            for d in (self._queues, self._sent_seq, self._recv_seq,
                      self._early, self._peeked):
                for key in [k for k in d if k[0] == group_id]:
                    del d[key]

    def clear(self) -> None:
        with self._lock:
            for d in (self._groups, self._mappings, self._flags,
                      self._queues, self._sent_seq, self._recv_seq,
                      self._early, self._peeked, self._aborted):
                d.clear()
            clients = (list(self._clients.values())
                       + list(self._bulk_clients.values()))
            self._clients.clear()
            self._bulk_clients.clear()
            self._bulk_down_until.clear()
            self._shm_peers.clear()
        for c in clients:
            c.close()


class PointToPointGroup:
    """Coordination for one group: the main idx (0) holds the lock
    state; lock, barrier and notify ride point-to-point messages on the
    coordination channel (reference PointToPointBroker.h:26-97)."""

    def __init__(self, broker: PointToPointBroker, app_id: int,
                 group_id: int, group_size: int) -> None:
        self.broker = broker
        self.app_id = app_id
        self.group_id = group_id
        self.group_size = group_size

        self._mx = threading.RLock()
        self._lock_owner_idx = NO_LOCK_OWNER_IDX
        self._recursive_owners: list[int] = []
        # Waiters remember whether they asked for a recursive lock, so a
        # grant restores the right kind of ownership
        self._lock_waiters: list[tuple[int, bool]] = []
        self._local_barrier: threading.Barrier | None = None

    def _main_host(self) -> str:
        return self.broker.get_host_for_receiver(self.group_id,
                                                 POINT_TO_POINT_MAIN_IDX)

    def _signal(self, send_idx: int, recv_idx: int) -> None:
        self.broker.send_message(self.group_id, send_idx, recv_idx, b"\x00",
                                 channel=COORD_CHANNEL)

    def _await(self, send_idx: int, recv_idx: int,
               timeout: float | None = None) -> None:
        self.broker.recv_message(self.group_id, send_idx, recv_idx,
                                 timeout=timeout, channel=COORD_CHANNEL)

    # ------------------------------------------------------------------
    # Distributed lock
    # ------------------------------------------------------------------
    def lock(self, group_idx: int, recursive: bool = False) -> None:
        if self._main_host() != self.broker.host:
            # Ask the main host, then wait for the grant
            self.broker._get_client(self._main_host()).group_lock(
                self.app_id, self.group_id, group_idx, recursive)
            self._await(POINT_TO_POINT_MAIN_IDX, group_idx)
            return
        with self._mx:
            # Recursive and plain ownership exclude each other
            free_of_plain = self._lock_owner_idx == NO_LOCK_OWNER_IDX
            acquired = False
            if recursive and free_of_plain and (
                    not self._recursive_owners
                    or self._recursive_owners[-1] == group_idx):
                self._recursive_owners.append(group_idx)
                acquired = True
            elif (not recursive and free_of_plain
                    and not self._recursive_owners):
                self._lock_owner_idx = group_idx
                acquired = True
            if not acquired:
                self._lock_waiters.append((group_idx, recursive))
        locker_is_local = self.broker.get_host_for_receiver(
            self.group_id, group_idx) == self.broker.host
        if acquired:
            if not locker_is_local:
                self._signal(POINT_TO_POINT_MAIN_IDX, group_idx)
        elif locker_is_local:
            self._await(POINT_TO_POINT_MAIN_IDX, group_idx)
        # A queued remote locker is granted by unlock() later

    def unlock(self, group_idx: int, recursive: bool = False) -> None:
        if self._main_host() != self.broker.host:
            self.broker._get_client(self._main_host()).group_unlock(
                self.app_id, self.group_id, group_idx, recursive)
            return
        with self._mx:
            if recursive:
                if self._recursive_owners:
                    self._recursive_owners.pop()
                if self._recursive_owners:
                    return
            else:
                self._lock_owner_idx = NO_LOCK_OWNER_IDX
            if not self._lock_waiters:
                return
            nxt, nxt_recursive = self._lock_waiters.pop(0)
            if nxt_recursive:
                self._recursive_owners.append(nxt)
            else:
                self._lock_owner_idx = nxt
        self._signal(POINT_TO_POINT_MAIN_IDX, nxt)

    def get_lock_owner(self, recursive: bool = False) -> int:
        with self._mx:
            if recursive:
                return (self._recursive_owners[-1]
                        if self._recursive_owners else NO_LOCK_OWNER_IDX)
            return self._lock_owner_idx

    # ------------------------------------------------------------------
    # Barrier / notify
    # ------------------------------------------------------------------
    def is_single_host(self) -> bool:
        return len(self.broker.get_idxs_registered_for_host(
            self.group_id, self.broker.host)) == self.group_size

    def barrier(self, group_idx: int, timeout: float | None = None) -> None:
        """Every member waits until all have arrived; raises TimeoutError
        after ``timeout`` seconds (the global message timeout when
        None)."""
        timeout = _timeout(timeout)
        if self.is_single_host():
            with self._mx:
                if (self._local_barrier is None
                        or self._local_barrier.parties != self.group_size):
                    self._local_barrier = threading.Barrier(self.group_size)
                barrier = self._local_barrier
            try:
                barrier.wait(timeout)
            except threading.BrokenBarrierError as e:
                raise TimeoutError(
                    f"barrier of group {self.group_id} broken or timed out "
                    f"after {timeout} s") from e
            return
        if group_idx == POINT_TO_POINT_MAIN_IDX:
            for i in range(1, self.group_size):
                self._await(i, POINT_TO_POINT_MAIN_IDX, timeout)
            for i in range(1, self.group_size):
                self._signal(POINT_TO_POINT_MAIN_IDX, i)
        else:
            self._signal(group_idx, POINT_TO_POINT_MAIN_IDX)
            self._await(POINT_TO_POINT_MAIN_IDX, group_idx, timeout)

    def notify(self, group_idx: int, timeout: float | None = None) -> None:
        """Non-main idxs signal the main, which waits for all of them
        (reference PointToPointBroker.cpp:348-365)."""
        if group_idx == POINT_TO_POINT_MAIN_IDX:
            for i in range(1, self.group_size):
                self._await(i, POINT_TO_POINT_MAIN_IDX, timeout)
        else:
            self._signal(group_idx, POINT_TO_POINT_MAIN_IDX)
