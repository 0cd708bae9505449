"""Batch-scheduler policy layer: a copy of
``faabric_tpu/batch_scheduler/scheduler.py``.

Reference analog: include/faabric/batch-scheduler/BatchScheduler.h:70-131 and
src/batch-scheduler/BatchScheduler.cpp:15-45. Pure in-memory: policies map
(host map, in-flight apps, request) → SchedulingDecision and never do I/O.

All three reference policies share the same skeleton — sort the hosts by a
policy-specific criterion, then greedily fill — so the shared greedy fill
and migration-minimisation live here and policies supply the sort/compare
hooks, rather than duplicating the fill loop per policy as the reference
does.

A ``HostState`` also advertises its device count; slots are execution
slots, and ranks gang-scheduled onto a host are later pinned to devices
(device ids in the decision) by the planner at dispatch time.
"""

from __future__ import annotations

import dataclasses
import enum
import threading
from typing import Dict, Optional, Tuple

from faabric_tpu_torch.batch_scheduler.decision import SchedulingDecision
from faabric_tpu_torch.proto import BatchExecuteRequest, BatchExecuteType


@dataclasses.dataclass
class HostState:
    """One row of the planner's host map (reference BatchScheduler.h:29-41,
    plus the device inventory and spot-eviction taint)."""

    ip: str
    slots: int = 0
    used_slots: int = 0
    n_devices: int = 0
    for_eviction: bool = False

    @property
    def available(self) -> int:
        return max(0, self.slots - self.used_slots)

    def claim(self, n: int) -> None:
        self.used_slots = min(self.slots, self.used_slots + n)

    def free(self, n: int) -> None:
        self.used_slots = max(0, self.used_slots - n)


HostMap = Dict[str, HostState]
# app_id → (request, decision)
InFlightReqs = Dict[int, Tuple[BatchExecuteRequest, SchedulingDecision]]


class DecisionType(enum.IntEnum):
    NO_DECISION_TYPE = 0
    NEW = 1
    DIST_CHANGE = 2
    SCALE_CHANGE = 3


def copy_host_map(host_map: HostMap) -> HostMap:
    return {ip: dataclasses.replace(h) for ip, h in host_map.items()}


def minimise_num_of_migrations(new_decision: SchedulingDecision,
                               old_decision: SchedulingDecision) -> SchedulingDecision:
    """Rewrite ``new_decision`` to keep as many messages on their old host as
    its host histogram allows, so a migration moves the fewest ranks
    (reference BinPackScheduler.cpp:26-93)."""
    out = SchedulingDecision(old_decision.app_id, old_decision.group_id)
    budget = new_decision.host_freq_count()

    assert new_decision.n_messages == old_decision.n_messages

    # Keep old placements wherever the new histogram has room for them.
    placed = [False] * old_decision.n_messages
    for i, old_host in enumerate(old_decision.hosts):
        if budget.get(old_host, 0) > 0:
            out.add_message_in_position(
                i, old_host, old_decision.message_ids[i],
                old_decision.app_idxs[i], old_decision.group_idxs[i],
                old_decision.mpi_ports[i], old_decision.device_ids[i])
            budget[old_host] -= 1
            placed[i] = True

    # Spill the rest onto whichever hosts still have histogram budget. These
    # are the actual migrations; ports/devices are assigned by the planner.
    for i in range(old_decision.n_messages):
        if placed[i]:
            continue
        next_host = next(ip for ip, n in budget.items() if n > 0)
        out.add_message_in_position(
            i, next_host, old_decision.message_ids[i],
            old_decision.app_idxs[i], old_decision.group_idxs[i], -1, -1)
        budget[next_host] -= 1

    assert all(n == 0 for n in budget.values())
    return out


class BatchScheduler:
    """Policy interface. Subclasses implement ``get_sorted_hosts`` and
    ``is_first_decision_better``; the greedy fill is shared."""

    # True only for policies whose filter_hosts() removes hosts that are
    # being taken away from the cluster (spot eviction) rather than hosts
    # that are merely ineligible for this app.
    filtered_hosts_are_evicted = False

    @staticmethod
    def get_decision_type(in_flight: InFlightReqs,
                          req: BatchExecuteRequest) -> DecisionType:
        # Reference BatchScheduler.cpp getDecisionType: NEW if the app is not
        # in flight; DIST_CHANGE for a same-size MIGRATION request;
        # SCALE_CHANGE otherwise (chaining / fork adds messages).
        if req.app_id not in in_flight:
            return DecisionType.NEW
        old_req, _ = in_flight[req.app_id]
        if (req.type == int(BatchExecuteType.MIGRATION)
                and req.n_messages() == old_req.n_messages()):
            return DecisionType.DIST_CHANGE
        return DecisionType.SCALE_CHANGE

    # ------------------------------------------------------------------
    # Policy hooks
    # ------------------------------------------------------------------
    def get_sorted_hosts(self, host_map: HostMap, in_flight: InFlightReqs,
                         req: BatchExecuteRequest,
                         decision_type: DecisionType) -> list[HostState]:
        raise NotImplementedError

    def is_first_decision_better(self, host_map: HostMap,
                                 decision_a: SchedulingDecision,
                                 decision_b: SchedulingDecision) -> bool:
        raise NotImplementedError

    def filter_hosts(self, host_map: HostMap, in_flight: InFlightReqs,
                     req: BatchExecuteRequest) -> set[str]:
        """Drop ineligible hosts before sorting; returns removed ips."""
        return set()

    # ------------------------------------------------------------------
    def make_scheduling_decision(self, host_map: HostMap,
                                 in_flight: InFlightReqs,
                                 req: BatchExecuteRequest) -> SchedulingDecision:
        from faabric_tpu_torch.batch_scheduler.decision import (
            do_not_migrate_decision,
            must_freeze_decision,
            not_enough_slots_decision,
        )

        # Work on a copy: sorting hooks mutate slot counts (freeing the
        # migrating app's slots) and the caller's map must stay authoritative.
        host_map = copy_host_map(host_map)
        removed = self.filter_hosts(host_map, in_flight, req)

        decision_type = self.get_decision_type(in_flight, req)
        sorted_hosts = self.get_sorted_hosts(host_map, in_flight, req,
                                             decision_type)

        # An OpenMP-style request with the single-host hint only ever
        # considers the first host (reference BinPackScheduler.cpp:312-317).
        is_omp = req.n_messages() > 0 and req.messages[0].is_omp
        if req.single_host_hint and is_omp:
            sorted_hosts = sorted_hosts[:1]

        # Greedy fill: as many messages as fit per host, in sort order.
        decision = SchedulingDecision(req.app_id, 0)
        msg_idx = 0
        left = req.n_messages()
        for host in sorted_hosts:
            n_here = min(left, host.available)
            for _ in range(n_here):
                m = req.messages[msg_idx]
                decision.add_message(host.ip, m.id, m.app_idx, m.group_idx)
                msg_idx += 1
            left -= n_here
            if left == 0:
                break

        if decision_type != DecisionType.DIST_CHANGE:
            if left > 0:
                return not_enough_slots_decision()
            return decision

        # DIST_CHANGE: only migrate if the fresh decision is an improvement.
        old_decision = in_flight[req.app_id][1]
        if left > 0:
            # Only spot's filtered hosts mean "host going away": ranks there
            # with nowhere to go must freeze. Other policies filter hosts
            # that are merely off-limits for new placements (e.g. compact's
            # other-tenant hosts), where a full cluster means "don't move".
            if (self.filtered_hosts_are_evicted and removed
                    and any(h in removed for h in old_decision.hosts)):
                return must_freeze_decision()
            return not_enough_slots_decision()
        if self._should_migrate(host_map, decision, old_decision, removed):
            return minimise_num_of_migrations(decision, old_decision)
        return do_not_migrate_decision()

    def _should_migrate(self, host_map: HostMap, new_decision: SchedulingDecision,
                        old_decision: SchedulingDecision,
                        removed: set[str]) -> bool:
        return self.is_first_decision_better(host_map, new_decision, old_decision)


# ---------------------------------------------------------------------------
# Mode switch (reference src/batch-scheduler/BatchScheduler.cpp:15-45)
# ---------------------------------------------------------------------------

_scheduler: Optional[BatchScheduler] = None
_mode_override: Optional[str] = None
_scheduler_lock = threading.Lock()


def get_batch_scheduler() -> BatchScheduler:
    from faabric_tpu_torch.batch_scheduler.bin_pack import BinPackScheduler
    from faabric_tpu_torch.batch_scheduler.compact import CompactScheduler
    from faabric_tpu_torch.batch_scheduler.spot import SpotScheduler
    from faabric_tpu_torch.util.config import get_system_config

    global _scheduler
    with _scheduler_lock:
        if _scheduler is None:
            mode = _mode_override or get_system_config().batch_scheduler_mode
            if mode == "bin-pack":
                _scheduler = BinPackScheduler()
            elif mode == "compact":
                _scheduler = CompactScheduler()
            elif mode == "spot":
                _scheduler = SpotScheduler()
            else:
                raise ValueError(f"Unknown batch scheduler mode: {mode}")
        return _scheduler


def reset_batch_scheduler(new_mode: str | None = None) -> None:
    """Drop the cached policy; an explicit ``new_mode`` overrides the config
    knob for this process without touching the environment or the live
    SystemConfig (reference resetBatchScheduler(newMode))."""
    global _scheduler, _mode_override
    with _scheduler_lock:
        _scheduler = None
        _mode_override = new_mode
    # Cached placements were chosen by the old policy
    from faabric_tpu_torch.batch_scheduler.decision_cache import get_decision_cache

    get_decision_cache().clear()
