"""Point-to-point group messaging: the broker's local half.

Counterpart of ``faabric_tpu/transport/point_to_point.py``
(``PointToPointBroker`` :95): the broker maps (group_id, group_idx) →
(host, MPI port, device id) from a ``SchedulingDecision``, and a message
between two ranks of this host lands in an in-process FIFO queue per
(group, sender, receiver). One FIFO per pair keeps MPI's
non-overtaking order without the reference's sequence numbers, which
exist for messages that cross hosts.

Ported here: the mappings (``set_up_local_mappings_from_decision``,
``wait_for_mappings``, ``get_host_for_receiver``,
``get_device_for_idx``), the in-process queues of ``send_message`` and
``recv_message``, group abort and ``clear``. The TCP, bulk and shm legs
and the ``PointToPointGroup`` locks wait (``ROADMAP.md`` Queue 1 #2):
a send to a rank on another host raises.
"""

from __future__ import annotations

import dataclasses
import queue
import threading

# The reference's default GLOBAL_MESSAGE_TIMEOUT (util/config.py)
MESSAGE_TIMEOUT_S = 60.0


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


@dataclasses.dataclass
class PointToPointMapping:
    host: str
    message_id: int
    app_idx: int
    group_idx: int
    mpi_port: int
    device_id: int


class PointToPointBroker:
    """One host's view of its groups. Instantiable per host identity."""

    def __init__(self, host: str) -> None:
        self.host = host
        self._lock = threading.RLock()
        # group_id → {group_idx: mapping}
        self._mappings: dict[int, dict[int, PointToPointMapping]] = {}
        # group_id → set once the group's mappings are installed
        self._flags: dict[int, threading.Event] = {}
        # (group, send, recv) → FIFO of payloads
        self._queues: dict[tuple[int, int, int], queue.SimpleQueue] = {}
        self._aborted: dict[int, str] = {}

    # ------------------------------------------------------------------
    # Mappings
    # ------------------------------------------------------------------
    def set_up_local_mappings_from_decision(self, decision) -> list[str]:
        """Install this host's view of a group; returns the hosts
        involved (reference setUpLocalMappingsFromSchedulingDecision)."""
        with self._lock:
            group = self._mappings.setdefault(decision.group_id, {})
            for i in range(decision.n_messages):
                group[decision.group_idxs[i]] = PointToPointMapping(
                    host=decision.hosts[i],
                    message_id=decision.message_ids[i],
                    app_idx=decision.app_idxs[i],
                    group_idx=decision.group_idxs[i],
                    mpi_port=decision.mpi_ports[i],
                    device_id=decision.device_ids[i])
            self._flag(decision.group_id).set()
        return decision.unique_hosts()

    def _flag(self, group_id: int) -> threading.Event:
        with self._lock:
            flag = self._flags.get(group_id)
            if flag is None:
                flag = self._flags[group_id] = threading.Event()
            return flag

    def wait_for_mappings(self, group_id: int,
                          timeout: float | None = None) -> None:
        timeout = MESSAGE_TIMEOUT_S if timeout is None else timeout
        if not self._flag(group_id).wait(timeout):
            raise TimeoutError(
                f"no mappings for group {group_id} on {self.host} after "
                f"{timeout} s")

    def _mapping(self, group_id: int, idx: int) -> PointToPointMapping:
        with self._lock:
            return self._mappings[group_id][idx]

    def get_host_for_receiver(self, group_id: int, recv_idx: int) -> str:
        return self._mapping(group_id, recv_idx).host

    def get_device_for_idx(self, group_id: int, idx: int) -> int:
        return self._mapping(group_id, idx).device_id

    # ------------------------------------------------------------------
    # Messaging
    # ------------------------------------------------------------------
    def _queue(self, key: tuple[int, int, int]) -> queue.SimpleQueue:
        with self._lock:
            q = self._queues.get(key)
            if q is None:
                q = self._queues[key] = queue.SimpleQueue()
            return q

    def send_message(self, group_id: int, send_idx: int, recv_idx: int,
                     data) -> None:
        """Deliver ``data`` (any object) to ``recv_idx``'s queue."""
        self.wait_for_mappings(group_id)
        dst_host = self.get_host_for_receiver(group_id, recv_idx)
        if dst_host != self.host:
            raise NotImplementedError(
                f"rank {recv_idx} of group {group_id} is on {dst_host}, not "
                f"{self.host}: the remote legs are not ported")
        self._queue((group_id, send_idx, recv_idx)).put(data)

    def recv_message(self, group_id: int, send_idx: int, recv_idx: int,
                     timeout: float | None = None):
        """The next payload from ``send_idx`` to ``recv_idx``, in send
        order. Raises GroupAbortedError after an abort and TimeoutError
        after ``timeout`` seconds."""
        self._raise_if_aborted(group_id)
        timeout = MESSAGE_TIMEOUT_S if timeout is None else timeout
        try:
            data = self._queue((group_id, send_idx, recv_idx)).get(
                timeout=timeout)
        except queue.Empty as e:
            raise TimeoutError(
                f"PTP recv timed out on {(group_id, send_idx, recv_idx)}"
            ) from e
        if data is _ABORT:
            raise GroupAbortedError(group_id,
                                    self.group_aborted(group_id) or "")
        return data

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

    def clear(self) -> None:
        with self._lock:
            self._mappings.clear()
            self._flags.clear()
            self._queues.clear()
            self._aborted.clear()
