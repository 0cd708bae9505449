"""Bin-pack policy: a copy of ``faabric_tpu/batch_scheduler/bin_pack.py``
(reference src/batch-scheduler/BinPackScheduler.cpp).

NEW: fill hosts in decreasing order of free capacity — except MPI
batches, which gang-schedule: the sort consults the world's
prospective Topology and prefers FILLING one host with the world's
ranks before spilling, so the ranks land co-located and the
hierarchical collectives get their shm tier. SCALE_CHANGE: co-locate
with the app's existing placement first. DIST_CHANGE: re-schedule from
scratch (app's slots virtually freed) and migrate only if the placement
spans fewer hosts or cuts cross-host links.
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
from faabric_tpu_torch.proto import BatchExecuteRequest


def sort_hosts_larger_first(hosts: list[HostState]) -> list[HostState]:
    # Free slots desc, total slots desc, ip desc
    # (reference BinPackScheduler.cpp isFirstHostLarger).
    return sorted(hosts, key=lambda h: (h.available, h.slots, h.ip), reverse=True)


def sort_hosts_gang(hosts: list[HostState], world_size: int,
                    prefer_devices: bool = False) -> list[HostState]:
    """Gang order for an MPI world of ``world_size`` ranks: the host
    that can swallow the most of the REMAINDER first; among hosts that
    fit the whole remainder, the tightest fit wins (an 8-rank world
    lands on the 8-free host, keeping the 16-free host whole for a
    bigger world). Greedy simulation rather than a one-shot key sort:
    after the first host spills, the remainder shrinks, and the
    tightest-fit rule must apply to THAT (hosts 6/5/4 free, world of
    10 → 6-host then the exact-fit 4-host, not the 5-host it would
    fragment). Hosts the world never reaches follow in the classic
    larger-first order. Capacity-blind larger-first would fragment the
    big host and scatter the next world topology-blind.

    ``prefer_devices`` (default OFF — the caller derives it
    from the REQUEST via ``request_wants_devices``, never from the host
    pool, so a world with no device demand cannot be steered onto chip
    hosts and starve a later device-eligible world of them) adds a
    mesh-contiguity tie-break: among hosts swallowing the same share of
    the remainder, one whose device count covers the ranks it would
    take ranks first — each rank gets its own chip, so the placement's
    Topology reads mesh_contiguous and the world's device-plane
    activation resolves cleanly instead of aliasing chips."""
    pool = list(hosts)
    order: list[HostState] = []
    remaining = world_size
    while pool and remaining > 0:
        def key(h, _rem=remaining):
            take = min(h.available, _rem)
            covers = 1 if (prefer_devices and take > 0
                           and h.n_devices >= take) else 0
            return (take, covers, -h.available, h.ip)

        best = max(pool, key=key)
        pool.remove(best)
        order.append(best)
        remaining -= best.available
    order.extend(sort_hosts_larger_first(pool))
    return order


def sort_hosts_by_app_freq(hosts: list[HostState],
                           freq: dict[str, int]) -> list[HostState]:
    # App placement count desc first, then the NEW criteria
    # (reference isFirstHostLargerWithFreq).
    return sorted(
        hosts,
        key=lambda h: (freq.get(h.ip, 0), h.available, h.slots, h.ip),
        reverse=True,
    )


def locality_score(decision: SchedulingDecision) -> tuple[int, int]:
    """(number of hosts, cross-host links in the fully-connected rank
    graph) — reference BinPackScheduler.cpp:97-148, read from the
    placement's Topology (the same object the MPI collectives compose
    over). Cross-host links are the collective hops that leave the
    host's device interconnect for the network, which is why fewer is
    strictly better."""
    topo = decision.topology()
    return (topo.n_hosts, topo.cross_host_pairs())


def is_mpi_request(req: BatchExecuteRequest) -> bool:
    return req.n_messages() > 0 and bool(req.messages[0].is_mpi)


def request_wants_devices(req: BatchExecuteRequest) -> bool:
    """Device eligibility of a REQUEST: does this batch want
    each rank on its own chip? Today every gang-scheduled MPI world is
    device-eligible — the planner claims one device per rank
    unconditionally and the world may run the activation handshake —
    so this is exactly ``is_mpi_request``. One place to refine when the
    proto grows an explicit per-request device demand."""
    return is_mpi_request(req)


class BinPackScheduler(BatchScheduler):
    def get_sorted_hosts(self, host_map: HostMap, in_flight: InFlightReqs,
                         req: BatchExecuteRequest,
                         decision_type: DecisionType) -> list[HostState]:
        from faabric_tpu_torch.util.config import get_system_config

        hosts = list(host_map.values())
        if decision_type == DecisionType.NEW:
            if (is_mpi_request(req)
                    and get_system_config().gang_schedule_mpi):
                return sort_hosts_gang(
                    hosts, req.n_messages(),
                    prefer_devices=request_wants_devices(req))
            return sort_hosts_larger_first(hosts)

        old_decision = in_flight[req.app_id][1]
        freq = old_decision.host_freq_count()

        if decision_type == DecisionType.SCALE_CHANGE:
            return sort_hosts_by_app_freq(hosts, freq)

        # DIST_CHANGE: give the app a fresh shot — free its current slots,
        # then sort by free capacity, breaking ties toward hosts already
        # running the app (minimises migrations on a tie).
        for h in hosts:
            if h.ip in freq:
                h.free(freq[h.ip])
        return sorted(
            hosts,
            key=lambda h: (h.available, freq.get(h.ip, 0), h.slots, h.ip),
            reverse=True,
        )

    def is_first_decision_better(self, host_map: HostMap,
                                 decision_a: SchedulingDecision,
                                 decision_b: SchedulingDecision) -> bool:
        # Fewer hosts wins; tie broken by fewer cross-host links.
        return locality_score(decision_a) < locality_score(decision_b)
