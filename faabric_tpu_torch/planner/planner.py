"""The cluster's control plane.

Counterpart of ``faabric_tpu/planner/planner.py`` (reference
src/planner/Planner.cpp), for the part that gang-schedules FUNCTIONS,
PROCESSES and THREADS batches:

- host registration, removal, keep-alive and expiry (:300-516); the
  in-flight messages of an expired host are recovered;
- per-host device claiming (:140-150): every placement pins a device
  id, the least-loaded device of the chosen host;
- ``call_batch`` for NEW, SCALE_CHANGE and DIST_CHANGE decisions
  (:573-726): slots, MPI ports and devices are accounted under the
  planner lock, and the group's mappings and the per-host dispatches go
  out after it is released, so that one unreachable worker cannot stall
  keep-alives or other apps. A NEW THREADS decision reuses the decision
  cache's placement of the same fork shape (:636-656); each sub-batch
  says whether the batch is on one host (:1489-1508), and a THREADS
  sub-batch on one host restores nothing;
- before a THREADS sub-batch goes to a host other than its main host,
  the main thread's snapshot, which the main host's planner client
  pushed to the planner's registry, is pushed there
  (``_push_snapshot_for_threads``, :1548-1570);
- recovery (:1176-1406): the messages of an expired host, of a failed
  dispatch or of a failed THREADS snapshot push are requeued onto the
  surviving hosts after an exponential backoff, within a budget of
  ``planner_max_requeues`` rounds an app, and fail once it is spent. An
  MPI app (any of its messages MPI) is never requeued: its world's
  state died with its ranks. A genuine result that lands first always
  wins over a synthetic FAILED one;
- spot freeze and thaw (:1076-1091, :617-708): a MUST_FREEZE decision
  parks the app's request and frees its claims (``get_frozen_apps``);
  the next NEW request of the app resumes the whole parked request, on
  sub-batches that are never single-host, so that the thaw host
  restores the image that the frozen guests parked on the planner's
  registry. A thaw that finds no slots parks the request again. Hosts
  named by ``set_next_evicted_host_ips`` are marked for eviction in the
  policy's host map;
- migration (:1007-1074): ``check_migration`` asks the policy for a
  DIST_CHANGE, which moves the app to a new group id and counts
  ``get_num_migrations``. A rank that reports MIGRATED is re-dispatched
  to its new host as a MIGRATION batch after the lock. A MIGRATED or
  FROZEN report is not a result: it records nothing, and a host that
  waits on the message keeps waiting for the real one (the reference
  pushes the report to it);
- the point-to-point mappings sent for each group (:1571-1577);
- results: ``set_message_result(s)``, ``get_message_result`` (with a
  push to waiting hosts) and ``get_batch_results`` (:1585-1775);
- the state-master registry (``claim_state_master``,
  ``drop_state_master``, ``state_placement``; the reference's
  ``planner/planner.py:1784-1876``): a key's first claimer is its
  master, a consistent-hash backup among the other live hosts holds its
  replica, and an epoch fences ops across failovers. A removed or
  expired master fails over to its live backup (the epoch bumps and
  the backup is told to promote), and a dead backup is replaced
  (``_drop_state_masters_for_locked``);
- the planner's ``SnapshotRegistry`` and its pool of snapshot clients,
  dropped with a removed or rebooted host.

The elastic scale hint raises instead of running some other way.

Telemetry, as the reference's: ``call_batch`` and the dispatch are
``planner`` spans timed in histograms; every dispatch passes the
``planner.dispatch`` fault point (a ``drop`` strands its messages until
their host expires); messages get their lifecycle stamps (admit,
schedule, dispatch, recorded) and recorded results are folded into the
lifecycle stats and the SLO tracker; results, in-flight apps and the
round trip are counted; host expiry and state failover are
flight-recorded. Requeues are counted (rounds, messages, exhausted
budgets), their detection-to-redispatch time goes into a histogram, a
requeued message is stamped ``rqu`` and a recovery pass is
flight-recorded and dumps the ring.

Not ported (``ROADMAP.md`` Queue 1 #7 and #9): the journal (and its
replay of state placement), preloaded decisions, the elastic scale
hint, ingress, ``call_batch_group``, and the telemetry RPCs and
``collect_telemetry`` (#7 part D).
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from faabric_tpu_torch.batch_scheduler import (
    DecisionType,
    HostState,
    SchedulingDecision,
    get_batch_scheduler,
    get_decision_cache,
    is_sentinel_decision,
)
from faabric_tpu_torch.batch_scheduler.decision import (
    MUST_FREEZE,
    NOT_ENOUGH_SLOTS,
    do_not_migrate_decision,
)
from faabric_tpu_torch.proto import (
    BatchExecuteRequest,
    BatchExecuteRequestStatus,
    BatchExecuteType,
    Message,
    ReturnValue,
    update_batch_exec_app_id,
    update_batch_exec_group_id,
)
from faabric_tpu_torch.faults import DROP, fault_point, faults_enabled
from faabric_tpu_torch.telemetry import (
    flight_dump,
    flight_record,
    get_lifecycle,
    get_metrics,
    span,
)
from faabric_tpu_torch.telemetry.lifecycle import (
    PHASE_ADMIT,
    PHASE_DISPATCH,
    PHASE_RECORDED,
    PHASE_REQUEUE,
    PHASE_SCHED,
)
from faabric_tpu_torch.transport.client_pool import ClientPool
from faabric_tpu_torch.transport.common import MPI_BASE_PORT, MPI_PORTS_PER_HOST
from faabric_tpu_torch.util.config import get_system_config
from faabric_tpu_torch.util.gids import generate_gid
from faabric_tpu_torch.util.logging import get_logger

logger = get_logger(__name__)

_FAULTS = faults_enabled()
_FP_DISPATCH = fault_point("planner.dispatch")

# The messages' lifecycle ledger (a shared no-op while metrics are off)
_LC = get_lifecycle()

_metrics = get_metrics()
_SCHEDULE_SECONDS = _metrics.histogram(
    "faabric_planner_schedule_seconds",
    "End-to-end call_batch latency (decision + mappings + dispatch)")
_DISPATCH_SECONDS = _metrics.histogram(
    "faabric_planner_dispatch_seconds",
    "Per-decision worker dispatch latency (network, post-lock)")
_IN_FLIGHT_APPS = _metrics.gauge(
    "faabric_planner_in_flight_apps",
    "Apps currently holding slots on the planner")
_RESULTS_TOTAL = _metrics.counter(
    "faabric_planner_results_total",
    "Message results recorded by the planner")
_RESULT_ROUNDTRIP = _metrics.histogram(
    "faabric_planner_result_roundtrip_seconds",
    "Message creation to result recorded at the planner (wall clocks of "
    "the submitting host and the planner: cross-machine skew shifts it)")
_REQUEUES_TOTAL = _metrics.counter(
    "faabric_planner_requeues_total",
    "Recovery requeues performed (one per affected app per failure)")
_REQUEUED_MESSAGES = _metrics.counter(
    "faabric_planner_requeued_messages_total",
    "Messages moved to surviving hosts by recovery requeues")
_RETRY_EXHAUSTED = _metrics.counter(
    "faabric_planner_retry_exhausted_total",
    "Messages terminally failed after the requeue budget ran out")
_RECOVERY_SECONDS = _metrics.histogram(
    "faabric_planner_recovery_seconds",
    "Failure detection to requeued messages re-dispatched (includes the "
    "backoff delay)")


class PlannerHost:
    """The planner's record of one registered worker host."""

    def __init__(self, ip: str, slots: int, n_devices: int = 0) -> None:
        self.state = HostState(ip=ip, slots=slots, n_devices=n_devices)
        self.register_ts = time.monotonic()
        self.used_mpi_ports: set[int] = set()
        # ranks pinned per device: a placement picks the least loaded
        self.device_load: list[int] = [0] * max(0, n_devices)

    def claim_mpi_port(self) -> int:
        for port in range(MPI_BASE_PORT, MPI_BASE_PORT + MPI_PORTS_PER_HOST):
            if port not in self.used_mpi_ports:
                self.used_mpi_ports.add(port)
                return port
        raise RuntimeError(f"Host {self.state.ip} exhausted its MPI port pool")

    def release_mpi_port(self, port: int) -> None:
        self.used_mpi_ports.discard(port)

    def claim_device(self) -> int:
        if not self.device_load:
            return -1
        dev = self.device_load.index(min(self.device_load))
        self.device_load[dev] += 1
        return dev

    def release_device(self, dev: int) -> None:
        if 0 <= dev < len(self.device_load) and self.device_load[dev] > 0:
            self.device_load[dev] -= 1


class Planner:
    # Completed apps' results are kept for late readers, oldest dropped
    # first beyond this many apps
    MAX_KEPT_APP_RESULTS = 1000

    def __init__(self) -> None:
        # One lock guards all of the state below: decisions, claims and
        # results must change together
        self._lock = threading.RLock()
        self._hosts: dict[str, PlannerHost] = {}
        # app_id → (req, decision)
        self._in_flight: dict[int, tuple[BatchExecuteRequest,
                                         SchedulingDecision]] = {}
        # app_id → {msg_id: result}
        self._results: dict[int, dict[int, Message]] = {}
        self._results_count = 0
        # app_id → expected message count (outlives the in-flight entry)
        self._expected: dict[int, int] = {}
        # app_id → next unassigned app/group index; monotonic, never
        # derived from the remaining messages, which shrink as results land
        self._next_idx: dict[int, int] = {}
        self._completed_order: list[int] = []
        # (app_id, msg_id) → hosts to push the result to
        self._waiters: dict[tuple[int, int], set[str]] = {}
        # app_id → (every group id it used, every host involved), for
        # the group cleanup once the app completes
        self._group_hosts: dict[int, tuple[set[int], set[str]]] = {}
        # app_id → recovery requeues spent (cleared when the app completes)
        self._requeue_attempts: dict[int, int] = {}
        # app_id → the parked request of a frozen app, and the hosts the
        # next decisions must evacuate
        self._evicted: dict[int, BatchExecuteRequest] = {}
        self._next_evicted_ips: set[str] = set()
        self._num_migrations = 0
        # State keys: full key → master host, backup host and fencing
        # epoch (the epoch outlives a drop)
        self._state_masters: dict[str, str] = {}
        self._state_backups: dict[str, str] = {}
        self._state_epochs: dict[str, int] = {}

        from faabric_tpu_torch.scheduler.function_call import (
            FunctionCallClient,
        )

        self._clients = ClientPool(FunctionCallClient)

        # The main-thread snapshots of THREADS batches, pushed by their
        # main hosts and pushed on to the other hosts of a batch
        # (reference planner-held SnapshotRegistry)
        from faabric_tpu_torch.snapshot.registry import SnapshotRegistry
        from faabric_tpu_torch.snapshot.remote import SnapshotClient

        self.snapshot_registry = SnapshotRegistry()
        self._snapshot_clients = ClientPool(SnapshotClient)

    # ------------------------------------------------------------------
    # Hosts (reference Planner.cpp:267-392)
    # ------------------------------------------------------------------
    def register_host(self, ip: str, slots: int, n_devices: int = 0,
                      overwrite: bool = False) -> float:
        """Register a host, or refresh its keep-alive. Returns the host
        timeout. ``overwrite`` marks a worker boot: its pooled
        connections belong to a dead incarnation and are dropped."""
        with self._lock:
            existing = self._hosts.get(ip)
            if existing is None or overwrite:
                self._hosts[ip] = PlannerHost(ip, slots, n_devices)
                # In-flight decisions may still pin rows to this host
                self._reclaim_host_rows_locked(ip)
                logger.debug("Planner registered host %s (slots=%d "
                             "devices=%d)", ip, slots, n_devices)
            else:
                existing.register_ts = time.monotonic()
                existing.state.slots = slots
                if n_devices != len(existing.device_load):
                    existing.device_load = [0] * max(0, n_devices)
                    existing.state.n_devices = n_devices
        if overwrite:
            self._clients.drop(ip)
            self._snapshot_clients.drop(ip)
        return get_system_config().planner_host_timeout

    def _reclaim_host_rows_locked(self, ip: str) -> None:
        host = self._hosts[ip]
        for _req, decision in self._in_flight.values():
            for i, h in enumerate(decision.hosts):
                if h != ip:
                    continue
                host.state.claim(1)
                if decision.mpi_ports[i]:
                    host.used_mpi_ports.add(decision.mpi_ports[i])
                dev = decision.device_ids[i]
                if 0 <= dev < len(host.device_load):
                    host.device_load[dev] += 1

    def is_host_registered(self, ip: str) -> bool:
        with self._lock:
            return ip in self._hosts

    def remove_host(self, ip: str) -> None:
        with self._lock:
            self._hosts.pop(ip, None)
            # A removed host serves no state: fail its masterships over
            self._drop_state_masters_for_locked({ip})
        self._snapshot_clients.drop(ip)

    def expire_hosts(self) -> None:
        """Drop hosts that missed their keep-alives. Their in-flight
        messages can no longer report, so they are recovered, on one
        thread an app: expiry runs under callers' locks, recovery sleeps
        its backoff and dispatches over the network, and one app's
        backoff must not hold another's."""
        timeout = get_system_config().planner_host_timeout
        now = time.monotonic()
        doomed: dict[int, list[Message]] = {}
        with self._lock:
            stale = {ip for ip, h in self._hosts.items()
                     if now - h.register_ts > timeout}
            for ip in stale:
                logger.warning("Expiring host %s (no keep-alive)", ip)
                flight_record("host_expired", host=ip)
                del self._hosts[ip]
            if stale:
                self._drop_state_masters_for_locked(stale)
            for app_id, (req, decision) in self._in_flight.items():
                ids = {mid for mid, h in zip(decision.message_ids,
                                             decision.hosts) if h in stale}
                if ids:
                    doomed[app_id] = [m for m in req.messages if m.id in ids]
        for app_id, msgs in doomed.items():
            threading.Thread(target=self._recover_messages,
                             args=(app_id, msgs, b"Host expired"),
                             name=f"planner/recover@{app_id}",
                             daemon=True).start()

    def get_available_hosts(self) -> list[HostState]:
        self.expire_hosts()
        with self._lock:
            return [HostState(ip=h.state.ip, slots=h.state.slots,
                              used_slots=h.state.used_slots,
                              n_devices=h.state.n_devices)
                    for h in self._hosts.values()]

    def set_next_evicted_host_ips(self, ips: list[str]) -> None:
        """Mark hosts for eviction: the spot policy places nothing new
        on them, and a migration check evacuates or freezes the apps
        running there."""
        with self._lock:
            self._next_evicted_ips = set(ips)

    # ------------------------------------------------------------------
    # Scheduling (reference Planner::callBatch)
    # ------------------------------------------------------------------
    def call_batch(self, req: BatchExecuteRequest) -> SchedulingDecision:
        """Schedule a batch: account under the lock, then send the
        group's mappings and dispatch after it."""
        t0 = time.monotonic()
        with span("planner", "call_batch", app_id=req.app_id,
                  n_messages=req.n_messages()):
            try:
                return self._call_batch_inner(req)
            finally:
                _SCHEDULE_SECONDS.observe(time.monotonic() - t0)

    def _call_batch_inner(self, req: BatchExecuteRequest
                          ) -> SchedulingDecision:
        if req.elastic_scale_hint:
            raise ValueError("the elastic scale hint is not served by this "
                             "planner")
        # Messages must agree with their batch's app id
        update_batch_exec_app_id(req, req.app_id)
        # The ledger's first stamp, unless an earlier hop stamped it
        for m in req.messages:
            _LC.stamp_first(m, PHASE_ADMIT)

        with self._lock:
            scheduler = get_batch_scheduler()
            decision_type = scheduler.get_decision_type(self._in_flight, req)
            # A MIGRATION request that no longer classifies as a
            # DIST_CHANGE raced completing results: no opportunity
            if (req.type == int(BatchExecuteType.MIGRATION)
                    and decision_type != DecisionType.DIST_CHANGE):
                return do_not_migrate_decision()
            # Thaw: a NEW request of a frozen app resumes the whole
            # parked request
            thawing = (decision_type == DecisionType.NEW
                       and req.app_id in self._evicted)
            if thawing:
                req = self._evicted.pop(req.app_id)

            host_map = self._policy_host_map_locked()
            # Repeated fork-join shapes reuse their placement (reference
            # DecisionCache). NEW decisions only: a scale change extends
            # an app's placement and must not take or poison entries
            # keyed by (user, function, type, count)
            cacheable = (req.type == int(BatchExecuteType.THREADS)
                         and decision_type == DecisionType.NEW)
            decision = (self._decision_from_cache_locked(req, host_map)
                        if cacheable else None)
            if cacheable:
                get_decision_cache().record_outcome(decision is not None)
            if decision is None:
                decision = scheduler.make_scheduling_decision(
                    host_map, self._in_flight, req)
                if cacheable and not is_sentinel_decision(decision):
                    get_decision_cache().add_cached_decision(
                        req, list(decision.hosts), 0)
            if decision.app_id == NOT_ENOUGH_SLOTS:
                if thawing:
                    # A failed thaw must not lose the parked app: a later
                    # one succeeds once slots free
                    self._evicted[req.app_id] = req
                logger.warning("Not enough slots for app %d (%d msgs)",
                               req.app_id, req.n_messages())
                return decision
            if decision.app_id == MUST_FREEZE:
                self._freeze_app_locked(req)
                return decision
            if is_sentinel_decision(decision):  # DO_NOT_MIGRATE
                return decision

            if decision_type == DecisionType.NEW:
                dispatches = self._handle_new_locked(req, decision)
                mappings = decision
            elif decision_type == DecisionType.SCALE_CHANGE:
                dispatches = self._handle_scale_change_locked(req, decision)
                mappings = self._in_flight[req.app_id][1]
            else:
                dispatches = self._handle_dist_change_locked(req, decision)
                mappings = decision
            _LC.stamp_many(req.messages, PHASE_SCHED)
            if thawing:
                # The thaw host is rarely the one the app froze on (that
                # one was being evicted): a single-host sub-batch would
                # skip the snapshot push and the restore, and resume on
                # a blank image
                for _, sub in dispatches:
                    sub.single_host = False

            # Detached copies: results landing on other threads remove
            # rows from the live decision
            result = decision.clone()
            mappings = mappings.clone()
            gids, hosts = self._group_hosts.get(req.app_id, (set(), set()))
            self._group_hosts[req.app_id] = (
                gids | {mappings.group_id}, hosts | set(mappings.hosts))
            _IN_FLIGHT_APPS.set(len(self._in_flight))

        # Network strictly outside the lock: mappings first (guests
        # block on wait_for_mappings before messaging), then dispatch
        from faabric_tpu_torch.transport.ptp_remote import (
            send_mappings_from_decision,
        )

        send_mappings_from_decision(mappings)
        self._do_dispatch(dispatches)
        return result

    def _handle_new_locked(self, req: BatchExecuteRequest,
                           decision: SchedulingDecision) -> list:
        group_id = req.group_id or generate_gid()
        decision.group_id = group_id
        update_batch_exec_group_id(req, group_id)
        for i, msg in enumerate(req.messages):
            # Messages that picked no group idx take their app idx, so
            # every batch forms a usable group
            if decision.group_idxs[i] == 0 and decision.app_idxs[i] != 0:
                decision.group_idxs[i] = decision.app_idxs[i]
            msg.group_idx = decision.group_idxs[i]
        self._claim_for_decision_locked(decision, req)
        self._in_flight[req.app_id] = (req, decision)
        self._expected[req.app_id] = req.n_messages()
        self._next_idx[req.app_id] = 1 + max(
            (m.app_idx for m in req.messages), default=req.n_messages() - 1)
        self._results.setdefault(req.app_id, {})
        return self._build_dispatches(req, decision)

    def _handle_scale_change_locked(self, req: BatchExecuteRequest,
                                    decision: SchedulingDecision) -> list:
        old_req, old_decision = self._in_flight[req.app_id]
        update_batch_exec_group_id(req, old_decision.group_id)
        decision.group_id = old_decision.group_id
        # New messages continue the app's index space monotonically
        for i, msg in enumerate(req.messages):
            if not msg.app_idx:
                msg.app_idx = self._next_idx[req.app_id]
                self._next_idx[req.app_id] += 1
            else:
                self._next_idx[req.app_id] = max(
                    self._next_idx[req.app_id], msg.app_idx + 1)
            msg.group_idx = msg.group_idx or msg.app_idx
            decision.app_idxs[i] = msg.app_idx
            decision.group_idxs[i] = msg.group_idx
            decision.message_ids[i] = msg.id
        self._claim_for_decision_locked(decision, req)
        for i in range(decision.n_messages):
            old_decision.add_message(
                decision.hosts[i], decision.message_ids[i],
                decision.app_idxs[i], decision.group_idxs[i],
                decision.mpi_ports[i], decision.device_ids[i])
            old_req.messages.append(req.messages[i])
        self._expected[req.app_id] = (
            self._expected.get(req.app_id, 0) + req.n_messages())
        return self._build_dispatches(req, decision)

    def _handle_dist_change_locked(self, req: BatchExecuteRequest,
                                   decision: SchedulingDecision) -> list:
        """Move the app's claims to the new placement under a new group
        id. Unmoved messages keep their ports and devices. Nothing is
        dispatched: a rank that moves reports MIGRATED and is
        re-dispatched from ``set_message_results``."""
        old_req, old_decision = self._in_flight[req.app_id]
        self._release_for_decision_locked(old_decision)
        self._claim_for_decision_locked(decision, old_req,
                                        keep_from=old_decision)
        decision.group_id = generate_gid()
        self._num_migrations += 1
        update_batch_exec_group_id(old_req, decision.group_id)
        self._in_flight[req.app_id] = (old_req, decision)
        return []

    # -- migration and freezing (reference :1053-1091) --------------------
    def check_migration(self, app_id: int) -> Optional[SchedulingDecision]:
        """The app's new placement (a new group id, its mappings already
        sent) when the policy finds a better one, the MUST_FREEZE
        sentinel when the app had to park, else None."""
        with self._lock:
            in_flight = self._in_flight.get(app_id)
            if in_flight is None:
                return None
            cur_req, _ = in_flight
            mig_req = BatchExecuteRequest(
                app_id=app_id, user=cur_req.user, function=cur_req.function,
                type=int(BatchExecuteType.MIGRATION), subtype=cur_req.subtype)
            mig_req.messages = list(cur_req.messages)
        decision = self.call_batch(mig_req)
        if decision.app_id == MUST_FREEZE:
            return decision
        if is_sentinel_decision(decision):
            return None
        return decision

    def _freeze_app_locked(self, req: BatchExecuteRequest) -> None:
        """Park a running app: free its claims and keep its request for
        the thaw (reference Planner.cpp:1005-1019)."""
        in_flight = self._in_flight.pop(req.app_id, None)
        if in_flight is not None:
            old_req, old_decision = in_flight
            self._release_for_decision_locked(old_decision)
            self._evicted[req.app_id] = old_req
        else:
            self._evicted[req.app_id] = req
        _IN_FLIGHT_APPS.set(len(self._in_flight))

    def _decision_from_cache_locked(self, req: BatchExecuteRequest,
                                    host_map) -> Optional[SchedulingDecision]:
        """The cached placement of the same fork shape, if its hosts
        still have the slots and still pass the policy's host filter;
        None falls back to the policy."""
        cached = get_decision_cache().get_cached_decision(req)
        if cached is None:
            return None
        hosts = cached.hosts
        need: dict[str, int] = {}
        for ip in hosts:
            need[ip] = need.get(ip, 0) + 1
        for ip, n in need.items():
            h = host_map.get(ip)
            if h is None or h.available < n or h.for_eviction:
                return None
        # The filter is part of placement correctness (compact's tenant
        # isolation, spot's eviction), not a preference
        probe = {ip: host_map[ip] for ip in need}
        if get_batch_scheduler().filter_hosts(probe, self._in_flight, req):
            return None
        decision = SchedulingDecision(req.app_id, 0)
        for i, msg in enumerate(req.messages):
            decision.add_message(hosts[i], msg.id, msg.app_idx,
                                 msg.group_idx)
        logger.debug("Reused the cached placement of %s/%s x%d", req.user,
                     req.function, req.n_messages())
        return decision

    # -- resource accounting ---------------------------------------------
    def _policy_host_map_locked(self) -> dict[str, HostState]:
        self.expire_hosts()
        return {ip: HostState(ip=ip, slots=h.state.slots,
                              used_slots=h.state.used_slots,
                              n_devices=h.state.n_devices,
                              for_eviction=ip in self._next_evicted_ips)
                for ip, h in self._hosts.items()}

    def _claim_for_decision_locked(
            self, decision: SchedulingDecision, req: BatchExecuteRequest,
            keep_from: SchedulingDecision | None = None) -> None:
        is_mpi = req.n_messages() > 0 and req.messages[0].is_mpi
        for i, ip in enumerate(decision.hosts):
            host = self._hosts.get(ip)
            if host is None:
                continue
            host.state.claim(1)
            if keep_from is not None and keep_from.hosts[i] == ip:
                # Unmoved message: re-claim its port and device
                port, dev = keep_from.mpi_ports[i], keep_from.device_ids[i]
                if port:
                    host.used_mpi_ports.add(port)
                if 0 <= dev < len(host.device_load):
                    host.device_load[dev] += 1
                decision.mpi_ports[i] = port
                decision.device_ids[i] = dev
            else:
                decision.mpi_ports[i] = host.claim_mpi_port() if is_mpi else 0
                decision.device_ids[i] = host.claim_device()

    def _release_row_locked(self, decision: SchedulingDecision,
                            i: int) -> None:
        host = self._hosts.get(decision.hosts[i])
        if host is None:
            return
        host.state.free(1)
        if decision.mpi_ports[i]:
            host.release_mpi_port(decision.mpi_ports[i])
        host.release_device(decision.device_ids[i])

    def _release_for_decision_locked(self,
                                     decision: SchedulingDecision) -> None:
        for i in range(decision.n_messages):
            self._release_row_locked(decision, i)

    # ------------------------------------------------------------------
    # Recovery: requeues with backoff (reference :1176-1406)
    # ------------------------------------------------------------------
    def _fail_messages(self, msgs: list[Message], reason: bytes) -> None:
        """Record FAILED results, so that batch waiters wake. A message
        already recorded keeps its result (first write wins)."""
        with self._lock:
            todo = [m for m in msgs
                    if m.id not in self._results.get(m.app_id, {})]
        for m in todo:
            m.return_value = int(ReturnValue.FAILED)
            m.output_data = reason
        if todo:
            self.set_message_results(todo)

    def _recover_messages(self, app_id: int, msgs: list[Message],
                          reason: bytes) -> None:
        """Requeue ``msgs`` after a backoff while the app's budget lasts,
        else fail them. Runs on a thread of its own. An MPI app is never
        requeued: its surviving ranks get MpiWorldAborted from the
        transport, and the guest owns the restart."""
        t_detect = time.monotonic()
        conf = get_system_config()
        with self._lock:
            msgs = [m for m in msgs
                    if m.id not in self._results.get(app_id, {})]
            if not msgs:
                return
            record = self._in_flight.get(app_id)
            in_flight = record is not None
            used = self._requeue_attempts.get(app_id, 0)
            # The whole app is scanned: the planner's copy of an MPI root
            # often reads is_mpi False (the worker sets it when it builds
            # the world), but the ranks it chained read True
            app_is_mpi = in_flight and any(m.is_mpi
                                           for m in record[0].messages)
            retryable = (in_flight and not app_is_mpi
                         and not any(m.is_mpi for m in msgs)
                         and used < conf.planner_max_requeues)
            if retryable:
                self._requeue_attempts[app_id] = used + 1
        flight_record("planner_recovery", app=app_id, n_messages=len(msgs),
                      retryable=retryable,
                      reason=reason.decode("utf-8", "replace"))
        flight_dump("planner_recovery")
        if not retryable:
            if in_flight and used >= conf.planner_max_requeues:
                _RETRY_EXHAUSTED.inc(len(msgs))
                logger.warning("Requeue budget (%d) exhausted for app %d; "
                               "failing %d msgs", conf.planner_max_requeues,
                               app_id, len(msgs))
            self._fail_messages(msgs, reason)
            return
        # The backoff keeps a requeue from racing the failure that
        # displaced it, and many apps' retries from arriving together
        time.sleep(self._requeue_delay(used))
        self._requeue(app_id, msgs, t_detect, reason)

    @staticmethod
    def _requeue_delay(used: int) -> float:
        from faabric_tpu_torch.util.retry import RetryPolicy

        conf = get_system_config()
        return RetryPolicy(max_attempts=conf.planner_max_requeues + 1,
                           backoff=conf.planner_requeue_backoff,
                           max_backoff=30.0).delay(used)

    def _requeue(self, app_id: int, msgs: list[Message], t_detect: float,
                 reason: bytes) -> None:
        """Take the messages' dead rows out of the live decision, place
        them again through the policy, merge the new rows in, then send
        the mappings and dispatch after the lock."""
        fail: Optional[list[Message]] = None
        fail_reason = reason
        retry_later = False
        conf = get_system_config()
        with self._lock:
            pending = [m for m in msgs
                       if m.id not in self._results.get(app_id, {})]
            if not pending:
                return  # genuine late results won every race
            todo = {m.id for m in pending}
            in_flight = self._in_flight.get(app_id)
            if in_flight is None:
                # The app's other results completed it during the
                # backoff: these messages have no row and no result, and
                # must fail or the batch never finishes
                fail = pending
                fail_reason = reason + b" (app completed around requeue)"
            else:
                req, decision = in_flight
                for mid in todo:
                    # An earlier round without capacity took the row out
                    if mid in decision.message_ids:
                        self._release_row_locked(
                            decision, decision.message_ids.index(mid))
                        decision.remove_message(mid)
                retry_msgs = [m for m in req.messages if m.id in todo]
                sub = BatchExecuteRequest(
                    app_id=req.app_id, group_id=req.group_id, user=req.user,
                    function=req.function, type=req.type,
                    subtype=req.subtype, snapshot_key=req.snapshot_key)
                sub.messages = retry_msgs
                # An empty in-flight view: the slice places like a NEW
                # batch of its own messages, whose idxs ride along
                new_decision = get_batch_scheduler().make_scheduling_decision(
                    self._policy_host_map_locked(), {}, sub)
                if is_sentinel_decision(new_decision):
                    # No capacity yet; it frees as running messages end, so
                    # spend a budget unit on a longer backoff
                    used = self._requeue_attempts.get(app_id, 0)
                    if used < conf.planner_max_requeues:
                        used += 1
                        self._requeue_attempts[app_id] = used
                        retry_later = True
                    else:
                        fail = retry_msgs
                        fail_reason = reason + b" (no requeue capacity)"
                else:
                    new_decision.group_id = decision.group_id
                    self._claim_for_decision_locked(new_decision, sub)
                    for i in range(new_decision.n_messages):
                        decision.add_message(
                            new_decision.hosts[i],
                            new_decision.message_ids[i],
                            new_decision.app_idxs[i],
                            new_decision.group_idxs[i],
                            new_decision.mpi_ports[i],
                            new_decision.device_ids[i])
                    dispatches = self._build_dispatches(sub, new_decision)
                    # A requeued slice of a multi-host app is not
                    # single-host: the new host needs a THREADS snapshot
                    single = len(decision.unique_hosts()) == 1
                    for _, s in dispatches:
                        s.single_host = single
                    mappings = decision.clone()
                    gids, hosts = self._group_hosts.get(app_id,
                                                        (set(), set()))
                    self._group_hosts[app_id] = (
                        gids | {mappings.group_id},
                        hosts | set(mappings.hosts))
                    _REQUEUES_TOTAL.inc()
                    _REQUEUED_MESSAGES.inc(len(todo))
        if retry_later:
            delay = self._requeue_delay(used)
            logger.warning("No capacity to requeue %d msgs of app %d yet; "
                           "retrying in %.2fs (attempt %d/%d)", len(todo),
                           app_id, delay, used, conf.planner_max_requeues)
            time.sleep(delay)
            self._requeue(app_id, pending, t_detect, reason)
            return
        if fail is not None:
            logger.warning("Failing %d unrecoverable msgs of app %d: %s",
                           len(fail), app_id, fail_reason.decode())
            _RETRY_EXHAUSTED.inc(len(fail))
            self._fail_messages(fail, fail_reason)
            return
        hosts = sorted(set(new_decision.hosts))
        logger.warning("Requeued %d msgs of app %d onto %s after: %s",
                       len(todo), app_id, hosts, reason.decode())
        # The stamp splits the dead first attempt from the re-dispatch in
        # the message's ledger
        _LC.stamp_many(retry_msgs, PHASE_REQUEUE)
        flight_record("planner_requeued", app=app_id, n_messages=len(todo),
                      hosts=hosts)
        from faabric_tpu_torch.transport.ptp_remote import (
            send_mappings_from_decision,
        )

        send_mappings_from_decision(mappings)
        self._do_dispatch(dispatches)
        _RECOVERY_SECONDS.observe(time.monotonic() - t_detect)

    def _recover_dispatch(self, sub: BatchExecuteRequest,
                          reason: bytes) -> None:
        """A failed dispatch recovers on a thread of its own: its backoff
        must not hold the dispatches after it."""
        threading.Thread(
            target=self._recover_messages,
            args=(sub.app_id, list(sub.messages), reason),
            name=f"planner/recover@{sub.app_id}", daemon=True).start()

    # ------------------------------------------------------------------
    # Dispatch (reference Planner::dispatchSchedulingDecision)
    # ------------------------------------------------------------------
    def _build_dispatches(self, req: BatchExecuteRequest,
                          decision: SchedulingDecision
                          ) -> list[tuple[str, BatchExecuteRequest]]:
        """The per-host sub-batches, built under the lock."""
        per_host: dict[str, list[int]] = {}
        for i, ip in enumerate(decision.hosts):
            per_host.setdefault(ip, []).append(i)
        out = []
        for ip, idxs in per_host.items():
            sub = BatchExecuteRequest(
                app_id=req.app_id, group_id=req.group_id, user=req.user,
                function=req.function, type=req.type, subtype=req.subtype,
                single_host=len(per_host) == 1,
                snapshot_key=req.snapshot_key)
            sub.messages = [req.messages[i] for i in idxs]
            out.append((ip, sub))
        return out

    def _do_dispatch(self,
                     dispatches: list[tuple[str, BatchExecuteRequest]]) -> None:
        t0 = time.monotonic()
        with span("planner", "dispatch", n_hosts=len(dispatches)):
            self._do_dispatch_inner(dispatches)
        if dispatches:
            _DISPATCH_SECONDS.observe(time.monotonic() - t0)

    def _do_dispatch_inner(
            self, dispatches: list[tuple[str, BatchExecuteRequest]]) -> None:
        for ip, sub in dispatches:
            if (sub.type == int(BatchExecuteType.THREADS)
                    and not sub.single_host
                    and not self._push_snapshot_for_threads(sub, ip)):
                # Without its snapshot the host could not restore: the
                # messages go to a host that can be given it
                self._recover_dispatch(sub, b"Snapshot push failed")
                continue
            try:
                if _FAULTS:
                    verdict = _FP_DISPATCH.fire(host=ip, app_id=sub.app_id)
                    if verdict is DROP:
                        # An injected silent loss: the messages strand
                        # until their host's keep-alive expiry recovers
                        # them
                        continue
                _LC.stamp_many(sub.messages, PHASE_DISPATCH)
                self._clients.get(ip).execute_functions(sub)
            except Exception:  # noqa: BLE001 — a dead host must not stall
                # the others; its messages are recovered
                logger.exception("Dispatch of app %d to %s failed",
                                 sub.app_id, ip)
                self._recover_dispatch(sub, b"Dispatch failed")

    def _push_snapshot_for_threads(self, req: BatchExecuteRequest,
                                   host: str) -> bool:
        """Push the main thread's snapshot ahead of a THREADS dispatch to
        ``host`` (reference Planner.cpp:1334-1360). False when the host
        cannot be given the snapshot it must restore from."""
        key = req.snapshot_key
        main_host = req.messages[0].main_host if req.messages else ""
        if not key or host == main_host:
            return True  # nothing to restore, or the main host has it
        snap = self.snapshot_registry.try_get_snapshot(key)
        if snap is None:
            logger.warning("No snapshot %s on the planner for a THREADS "
                           "dispatch to %s", key, host)
            return False
        try:
            self._snapshot_clients.get(host).push_snapshot(key, snap)
        except Exception:  # noqa: BLE001 — the caller fails the messages
            logger.exception("Failed pushing snapshot %s to %s", key, host)
            return False
        return True

    # ------------------------------------------------------------------
    # Results (reference Planner::setMessageResult / getMessageResult)
    # ------------------------------------------------------------------
    def set_message_result(self, msg: Message) -> None:
        self.set_message_results([msg])

    def set_message_results(self, msgs: list[Message]) -> None:
        """Record results, then push each to its waiting hosts and tell
        the hosts of completed apps to drop their groups, after the
        lock."""
        pushes: list[tuple[str, Message]] = []
        cleanups: dict[str, set[int]] = {}
        recorded: list[Message] = []
        redispatches: list[tuple[str, BatchExecuteRequest]] = []
        with self._lock:
            for msg in msgs:
                if msg.return_value == int(ReturnValue.MIGRATED):
                    # The rank left its old host: send it to its place in
                    # the post-migration decision
                    redispatch = self._build_migration_redispatch_locked(
                        msg.app_id, msg.id)
                    if redispatch is not None:
                        redispatches.append(redispatch)
                elif msg.return_value != int(ReturnValue.FROZEN):
                    if not self._record_result_locked(msg):
                        continue
                    _LC.stamp(msg, PHASE_RECORDED)
                    recorded.append(msg)
                    for ip in self._waiters.pop((msg.app_id, msg.id), set()):
                        pushes.append((ip, msg))
                if msg.app_id not in self._in_flight:
                    done = self._group_hosts.pop(msg.app_id, None)
                    if done is not None:
                        gids, hosts = done
                        for host in hosts:
                            cleanups.setdefault(host, set()).update(gids)
        # Fold the recorded ledgers into the per-phase digest and the
        # SLO tracker outside the lock (~10 µs a message)
        if recorded and _LC.enabled:
            from faabric_tpu_torch.telemetry import get_lifecycle_stats

            get_lifecycle_stats().fold(recorded)
        for ip, msg in pushes:
            try:
                self._clients.get(ip).set_message_result(msg)
            except Exception:  # noqa: BLE001 — one unreachable waiter
                # must not keep the others from their results
                logger.exception("Failed pushing result %d to %s", msg.id,
                                 ip)
        if cleanups:
            from faabric_tpu_torch.transport.ptp_remote import (
                send_clear_groups,
            )

            for host, gids in cleanups.items():
                send_clear_groups(host, sorted(gids))
        for redispatch in redispatches:
            self._do_dispatch([redispatch])

    def _build_migration_redispatch_locked(
            self, app_id: int, msg_id: int
    ) -> Optional[tuple[str, BatchExecuteRequest]]:
        """The MIGRATION sub-batch that moves one migrated rank to its
        post-migration host."""
        in_flight = self._in_flight.get(app_id)
        if in_flight is None:
            return None
        req, decision = in_flight
        if msg_id not in decision.message_ids:
            return None
        target = decision.hosts[decision.message_ids.index(msg_id)]
        for m in req.messages:
            if m.id == msg_id:
                m.return_value = 0
                m.output_data = b""
                sub = BatchExecuteRequest(
                    app_id=req.app_id, group_id=req.group_id, user=req.user,
                    function=req.function,
                    type=int(BatchExecuteType.MIGRATION),
                    subtype=req.subtype, snapshot_key=req.snapshot_key)
                sub.messages = [m]
                logger.debug("Re-dispatching migrated msg %d to %s", msg_id,
                             target)
                return target, sub
        return None

    def _record_result_locked(self, msg: Message) -> bool:
        """First write wins: a FAILED result of an expired host racing a
        late genuine one, or a duplicate, never overwrites. Returns False
        on a duplicate."""
        app_id, msg_id = msg.app_id, msg.id
        if msg_id in self._results.get(app_id, {}):
            logger.debug("Ignoring duplicate result for msg %d (app %d)",
                         msg_id, app_id)
            return False
        self._results_count += 1
        _RESULTS_TOTAL.inc()
        if msg.timestamp:
            _RESULT_ROUNDTRIP.observe(max(0.0, time.time() - msg.timestamp))
        in_flight = self._in_flight.get(app_id)
        if in_flight is not None:
            req, decision = in_flight
            if msg_id in decision.message_ids:
                self._release_row_locked(
                    decision, decision.message_ids.index(msg_id))
        self._results.setdefault(app_id, {})[msg_id] = msg
        if in_flight is not None:
            decision.remove_message(msg_id)
            req.messages[:] = [m for m in req.messages if m.id != msg_id]
            if decision.n_messages == 0:
                del self._in_flight[app_id]
                self._next_idx.pop(app_id, None)
                self._requeue_attempts.pop(app_id, None)
                self._completed_order.append(app_id)
                while len(self._completed_order) > self.MAX_KEPT_APP_RESULTS:
                    oldest = self._completed_order.pop(0)
                    self._results.pop(oldest, None)
                    self._expected.pop(oldest, None)
            _IN_FLIGHT_APPS.set(len(self._in_flight))
        return True

    def get_message_result(self, app_id: int, msg_id: int,
                           waiting_host: str = "") -> Optional[Message]:
        """The result if known; otherwise ``waiting_host`` is registered
        for a push when it lands (reference Planner.cpp:543-589)."""
        with self._lock:
            result = self._results.get(app_id, {}).get(msg_id)
            if result is None and waiting_host:
                self._waiters.setdefault((app_id, msg_id),
                                         set()).add(waiting_host)
            return result

    def get_batch_results(self, app_id: int) -> BatchExecuteRequestStatus:
        with self._lock:
            results = list(self._results.get(app_id, {}).values())
            expected = self._expected.get(app_id, 0)
            return BatchExecuteRequestStatus(
                app_id=app_id,
                finished=(app_id not in self._in_flight
                          and expected > 0 and len(results) >= expected),
                message_results=results,
                expected_num_messages=expected)

    def get_scheduling_decision(self, app_id: int
                                ) -> Optional[SchedulingDecision]:
        with self._lock:
            in_flight = self._in_flight.get(app_id)
            return in_flight[1].clone() if in_flight else None

    def get_num_migrations(self) -> int:
        with self._lock:
            return self._num_migrations

    def get_frozen_apps(self) -> list[int]:
        with self._lock:
            return list(self._evicted)

    # ------------------------------------------------------------------
    # State masters (reference planner/planner.py:357-460, 1784-1876)
    # ------------------------------------------------------------------
    def claim_state_master(self, user: str, key: str,
                           claiming_host: str) -> tuple[str, str, int]:
        """``(master, backup, epoch)`` of a state key, the caller claiming
        mastership of an unowned key. A fresh claim elects the claimer
        (the first writer is usually the hottest), a consistent-hash
        backup among the other live hosts, and the next epoch. A master
        that fell out of the host registry fails over to its live backup
        or, with none, the claimer takes the key. With
        ``FAABRIC_STATE_REPLICAS=0`` the backup stays "" and the epoch
        0. A planner with no registered host keeps plain first-claimer
        semantics."""
        full = f"{user}/{key}"
        replicas = get_system_config().state_replicas
        promoted: list[tuple[str, str, str, int]] = []
        with self._lock:
            master = self._state_masters.get(full)
            stale = (master is not None and bool(self._hosts)
                     and master not in self._hosts)
            if master is None or stale:
                backup = self._state_backups.get(full, "")
                epoch = (self._state_epochs.get(full, 0) + 1
                         if replicas > 0 else self._state_epochs.get(full, 0))
                if stale and backup and backup in self._hosts:
                    # The dead master's replica holds every acked write:
                    # promote it, not the claimer's empty image
                    master = backup
                    logger.warning(
                        "State master for %s is not registered; promoting "
                        "backup %s (epoch %d)", full, master, epoch)
                    self._state_masters[full] = master
                    self._state_backups[full] = self._elect_backup_locked(
                        full, {master})
                    self._state_epochs[full] = epoch
                    promoted.append((full, master,
                                     self._state_backups[full], epoch))
                else:
                    if stale:
                        logger.warning(
                            "State master %s for %s is not registered; "
                            "re-electing %s", master, full, claiming_host)
                    master = claiming_host
                    self._state_masters[full] = master
                    self._state_backups[full] = self._elect_backup_locked(
                        full, {master})
                    if replicas > 0:
                        self._state_epochs[full] = epoch
            elif replicas > 0 and self._hosts:
                # A live master: heal a dead or absent backup (no epoch
                # bump, ownership did not change)
                backup = self._state_backups.get(full, "")
                if not backup or backup not in self._hosts:
                    self._state_backups[full] = self._elect_backup_locked(
                        full, {master})
            placement = (master, self._state_backups.get(full, ""),
                         self._state_epochs.get(full, 0))
        if promoted:
            self._dispatch_state_promotions(promoted)
        return placement

    def drop_state_master(self, user: str, key: str) -> None:
        with self._lock:
            self._state_masters.pop(f"{user}/{key}", None)
            # The epoch survives the drop: the next claim must fence out
            # any process still holding the old mastership
            self._state_backups.pop(f"{user}/{key}", None)

    def state_placement(self) -> dict[str, dict]:
        """Per-key placement: full key → {master, backup, epoch}."""
        with self._lock:
            return {
                full: {"master": master,
                       "backup": self._state_backups.get(full, ""),
                       "epoch": self._state_epochs.get(full, 0)}
                for full, master in self._state_masters.items()}

    def _drop_state_masters_for_locked(self, ips: set[str]) -> None:
        """Fail over or drop the state masterships of hosts ``ips`` (host
        removal or expiry, under the planner lock). A dead master whose
        backup lives is promoted: the epoch bumps and a new backup is
        elected. Only when master and backup are both gone does the key
        drop. A dead backup under a live master is replaced. The
        promotion RPCs go out on a thread of their own."""
        promoted: list[tuple[str, str, str, int]] = []
        dropped: list[str] = []
        for full, master in list(self._state_masters.items()):
            backup = self._state_backups.get(full, "")
            if master in ips:
                if backup and backup not in ips and backup in self._hosts:
                    epoch = self._state_epochs.get(full, 0) + 1
                    new_backup = self._elect_backup_locked(
                        full, {backup} | set(ips))
                    self._state_masters[full] = backup
                    self._state_backups[full] = new_backup
                    self._state_epochs[full] = epoch
                    flight_record("state_failover", key=full,
                                  old_master=master, new_master=backup,
                                  backup=new_backup, epoch=epoch)
                    promoted.append((full, backup, new_backup, epoch))
                else:
                    del self._state_masters[full]
                    self._state_backups.pop(full, None)
                    dropped.append(full)
            elif backup and backup in ips:
                self._state_backups[full] = self._elect_backup_locked(
                    full, {master} | set(ips))
        if dropped:
            logger.warning("Dropped %d state mastership(s) of dead host(s) "
                           "%s (no live backup)", len(dropped), sorted(ips))
        if promoted:
            logger.warning(
                "Failing over %d state mastership(s) from dead host(s) %s",
                len(promoted), sorted(ips))
            self._dispatch_state_promotions(promoted)

    def _elect_backup_locked(self, full: str, exclude: set[str]) -> str:
        """Consistent-hash backup among the live hosts ("" when
        replication is off or no host is eligible)."""
        if get_system_config().state_replicas <= 0:
            return ""
        from faabric_tpu_torch.state.placement import place_backup

        return place_backup(full, [h for h in self._hosts
                                   if h not in exclude])

    def _dispatch_state_promotions(
            self, promoted: list[tuple[str, str, str, int]]) -> None:
        threading.Thread(
            target=self._notify_state_promotions, args=(list(promoted),),
            name="planner/state-promote", daemon=True).start()

    def _notify_state_promotions(
            self, promoted: list[tuple[str, str, str, int]]) -> None:
        """Tell each promoted backup to turn its replica into the master
        copy. Best effort: a lost notice is covered by self-promotion on
        the first fenced client op."""
        from faabric_tpu_torch.state.remote import StateClient

        for full, master, backup, epoch in promoted:
            user, _, key = full.partition("/")
            try:
                client = StateClient(master)
                try:
                    ok = client.promote(user, key, epoch, backup)
                finally:
                    client.close()
            except Exception as e:  # noqa: BLE001 — best-effort notice
                logger.warning(
                    "State promotion notify %s -> %s failed: %s (the new "
                    "master self-promotes on its first fenced op)",
                    full, master, e)
                continue
            if not ok:
                logger.warning(
                    "Host %s holds no replica of %s; dropping the "
                    "mastership so the next claim re-elects", master, full)
                with self._lock:
                    if self._state_epochs.get(full, 0) == epoch:
                        self._state_masters.pop(full, None)
                        self._state_backups.pop(full, None)

    # -- gauges the planner server samples into the time-series ring --
    def free_slot_watermark(self) -> int:
        with self._lock:
            return sum(max(0, h.state.slots - h.state.used_slots)
                       for h in self._hosts.values())

    def result_backlog(self) -> int:
        """Outstanding result waits registered with the planner."""
        with self._lock:
            return len(self._waiters)

    def in_flight_message_count(self) -> int:
        with self._lock:
            return sum(d.n_messages for _, d in self._in_flight.values())

    def results_total(self) -> int:
        with self._lock:
            return self._results_count

    def reset(self) -> None:
        with self._lock:
            for d in (self._hosts, self._in_flight, self._results,
                      self._expected, self._next_idx, self._waiters,
                      self._group_hosts, self._requeue_attempts,
                      self._evicted, self._next_evicted_ips,
                      self._state_masters, self._state_backups,
                      self._state_epochs):
                d.clear()
            self._completed_order.clear()
            self._results_count = 0
            self._num_migrations = 0
        _IN_FLIGHT_APPS.set(0)
        self._clients.close_all()
        self._snapshot_clients.close_all()
        from faabric_tpu_torch.transport.ptp_remote import (
            close_mapping_clients,
        )

        get_decision_cache().clear()
        close_mapping_clients()


_planner: Optional[Planner] = None
_planner_lock = threading.Lock()


def get_planner() -> Planner:
    global _planner
    if _planner is None:
        with _planner_lock:
            if _planner is None:
                _planner = Planner()
    return _planner
