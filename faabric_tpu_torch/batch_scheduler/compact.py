"""Compact policy: a copy of ``faabric_tpu/batch_scheduler/compact.py``
(reference src/batch-scheduler/CompactScheduler.cpp).

NEW/SCALE_CHANGE behave like bin-pack; DIST_CHANGE consolidates: re-schedule
into the *fullest* hosts and migrate only if that frees at least one whole
host. Also filters out hosts running other tenants' apps (the reference
wedges a user id into the request subtype for multi-tenant simulations).
"""

from __future__ import annotations

from faabric_tpu_torch.batch_scheduler.decision import SchedulingDecision
from faabric_tpu_torch.batch_scheduler.scheduler import (
    BatchScheduler,
    DecisionType,
    HostMap,
    HostState,
    InFlightReqs,
    copy_host_map,
)
from faabric_tpu_torch.batch_scheduler.bin_pack import (
    sort_hosts_by_app_freq,
    sort_hosts_larger_first,
)
from faabric_tpu_torch.proto import BatchExecuteRequest


class CompactScheduler(BatchScheduler):
    def filter_hosts(self, host_map: HostMap, in_flight: InFlightReqs,
                     req: BatchExecuteRequest) -> set[str]:
        # Hosts running apps of a different tenant are off-limits
        # (reference CompactScheduler.cpp filterHosts).
        removed: set[str] = set()
        for other_req, other_decision in in_flight.values():
            if other_req.subtype == req.subtype:
                continue
            for ip in other_decision.hosts:
                if ip in host_map:
                    del host_map[ip]
                    removed.add(ip)
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

        # DIST_CHANGE: free the app's slots, then pack into the FULLEST
        # hosts first so holes are filled and whole hosts drain empty.
        for h in hosts:
            if h.ip in freq:
                h.free(freq[h.ip])
        return sorted(hosts, key=lambda h: (h.used_slots, h.slots, h.ip),
                      reverse=True)

    def is_first_decision_better(self, host_map: HostMap,
                                 decision_a: SchedulingDecision,
                                 decision_b: SchedulingDecision) -> bool:
        """Better = more completely-free hosts after applying the decision
        (reference CompactScheduler.cpp:115-172). ``host_map`` arrives with
        the app's old slots already freed, so each candidate is applied on
        top of it."""

        def n_free_hosts_with(decision: SchedulingDecision) -> int:
            trial = copy_host_map(host_map)
            for ip in decision.hosts:
                if ip in trial:
                    trial[ip].claim(1)
            return sum(1 for h in trial.values() if h.used_slots == 0)

        return n_free_hosts_with(decision_a) > n_free_hosts_with(decision_b)
