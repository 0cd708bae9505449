"""Spot policy: a copy of ``faabric_tpu/batch_scheduler/spot.py``
(reference src/batch-scheduler/SpotScheduler.cpp).

Bin-pack behaviour for NEW/SCALE_CHANGE, but hosts tainted for spot
eviction are never scheduled onto. A DIST_CHANGE evacuates any ranks off
to-be-evicted hosts if capacity exists elsewhere; with no capacity the whole
app MUST_FREEZE (snapshots parked on the planner until slots return).
"""

from __future__ import annotations

from faabric_tpu_torch.batch_scheduler.decision import SchedulingDecision
from faabric_tpu_torch.batch_scheduler.scheduler import (
    BatchScheduler,
    DecisionType,
    HostMap,
    HostState,
    InFlightReqs,
)
from faabric_tpu_torch.batch_scheduler.bin_pack import (
    sort_hosts_by_app_freq,
    sort_hosts_larger_first,
)
from faabric_tpu_torch.proto import BatchExecuteRequest


class SpotScheduler(BatchScheduler):
    filtered_hosts_are_evicted = True

    def filter_hosts(self, host_map: HostMap, in_flight: InFlightReqs,
                     req: BatchExecuteRequest) -> set[str]:
        # Remove the next-to-be-evicted hosts entirely (reference
        # SpotScheduler.cpp filterHosts — there tainted via MUST_EVICT_IP,
        # here via an explicit flag on HostState).
        removed = {ip for ip, h in host_map.items() if h.for_eviction}
        for ip in removed:
            del host_map[ip]
        return removed

    def get_sorted_hosts(self, host_map: HostMap, in_flight: InFlightReqs,
                         req: BatchExecuteRequest,
                         decision_type: DecisionType) -> list[HostState]:
        hosts = list(host_map.values())
        if decision_type == DecisionType.NEW:
            return sort_hosts_larger_first(hosts)

        old_decision = in_flight[req.app_id][1]
        freq = old_decision.host_freq_count()

        if decision_type == DecisionType.SCALE_CHANGE:
            return sort_hosts_by_app_freq(hosts, freq)

        # DIST_CHANGE: free the app's slots on the surviving hosts and
        # re-schedule with the bin-pack-with-freq criteria.
        for h in hosts:
            if h.ip in freq:
                h.free(freq[h.ip])
        return sort_hosts_by_app_freq(hosts, freq)

    def _should_migrate(self, host_map: HostMap, new_decision: SchedulingDecision,
                        old_decision: SchedulingDecision,
                        removed: set[str]) -> bool:
        # Only migrate if the app currently has ranks on an evicted host
        # (reference SpotScheduler.cpp:313-323).
        return any(ip in removed for ip in old_decision.hosts)

    def is_first_decision_better(self, host_map: HostMap,
                                 decision_a: SchedulingDecision,
                                 decision_b: SchedulingDecision) -> bool:
        raise NotImplementedError("SPOT migrates on eviction, not on locality")
