"""Cluster topology of one rank group: who shares a machine with whom.

Counterpart of ``faabric_tpu/mpi/topology.py`` (``Topology`` :33),
whole: the rank -> host -> leader/local-rank structure the collectives'
hierarchy decisions and the schedule compiler read. Pure Python.

A ``Topology`` is immutable after construction (every derived field is
computed once in ``__init__``), so readers on N rank threads need no
lock. ``MpiWorld`` caches one per topology generation.
"""

from __future__ import annotations

from typing import Iterable, Mapping

class Topology:
    """rank → host → (leader, local rank) for one rank group.

    Host order is first-appearance-by-rank (rank 0's host first), so
    every participant derives the identical leader ring without any
    exchange. Leaders are the lowest rank on each host, matching the
    reference's local-leader election.
    """

    __slots__ = ("size", "rank_hosts", "hosts", "host_ranks", "leaders",
                 "_local_idx", "ranks_per_host", "max_ranks_per_host",
                 "rank_devices")

    def __init__(self, rank_hosts: Mapping[int, str],
                 rank_devices: Mapping[int, int] | None = None) -> None:
        size = len(rank_hosts)
        if sorted(rank_hosts) != list(range(size)):
            raise ValueError(
                f"rank set must be exactly 0..{size - 1}, got "
                f"{sorted(rank_hosts)[:8]}...")
        self.size = size
        self.rank_hosts: tuple[str, ...] = tuple(
            rank_hosts[r] for r in range(size))

        host_ranks: dict[str, list[int]] = {}
        for r, h in enumerate(self.rank_hosts):
            host_ranks.setdefault(h, []).append(r)
        # dict preserves first-appearance order; rank iteration above is
        # 0..size-1, so hosts[0] is rank 0's host on every participant
        self.hosts: tuple[str, ...] = tuple(host_ranks)
        self.host_ranks: dict[str, tuple[int, ...]] = {
            h: tuple(ranks) for h, ranks in host_ranks.items()}
        self.leaders: tuple[int, ...] = tuple(
            ranks[0] for ranks in self.host_ranks.values())
        self._local_idx: dict[int, int] = {
            r: i for ranks in self.host_ranks.values()
            for i, r in enumerate(ranks)}
        self.ranks_per_host: dict[str, int] = {
            h: len(ranks) for h, ranks in self.host_ranks.items()}
        self.max_ranks_per_host = max(self.ranks_per_host.values(),
                                      default=0)
        # Device placement: the planner-assigned per-host
        # chip index of each rank, -1 unknown. None when the placement
        # carries no device information at all. Identity (__eq__/
        # __hash__) stays rank→host only — devices are a placement
        # DETAIL of the same topology, and the MpiWorld cache must not
        # rebuild over a device re-claim that moved no rank.
        if rank_devices is None:
            self.rank_devices: tuple[int, ...] | None = None
        else:
            self.rank_devices = tuple(
                int(rank_devices.get(r, -1)) for r in range(size))

    # -- constructors ---------------------------------------------------
    @classmethod
    def from_rank_hosts(cls, rank_hosts: Mapping[int, str]) -> "Topology":
        return cls(rank_hosts)

    @classmethod
    def from_decision(cls, decision) -> "Topology":
        """Topology of a SchedulingDecision's placement: group idx (the
        MPI rank of gang-scheduled worlds) → host. This is the object
        the planner/batch-scheduler side reads. Decisions whose group
        idxs are not a clean 0..N-1 rank set (non-gang batches) fall
        back to positional order — host structure is what matters to
        the scheduler's locality metrics, not rank labels."""
        idxs = list(decision.group_idxs)
        if sorted(idxs) != list(range(len(idxs))):
            idxs = list(range(len(decision.hosts)))
        devices = None
        if any(d >= 0 for d in decision.device_ids):
            devices = dict(zip(idxs, decision.device_ids))
        return cls(dict(zip(idxs, decision.hosts)), rank_devices=devices)

    # -- structure queries ----------------------------------------------
    def host_of(self, rank: int) -> str:
        return self.rank_hosts[rank]

    def ranks_on_host(self, host: str) -> tuple[int, ...]:
        """Ranks co-located on ``host``, ascending (empty for unknown)."""
        return self.host_ranks.get(host, ())

    def leader_of(self, rank: int) -> int:
        """Lowest co-located rank (reference initLocalRemoteLeaders)."""
        return self.host_ranks[self.rank_hosts[rank]][0]

    def is_leader(self, rank: int) -> bool:
        return self.leader_of(rank) == rank

    def local_rank(self, rank: int) -> int:
        """Index of ``rank`` among its host's ranks (0 = leader)."""
        return self._local_idx[rank]

    @property
    def n_hosts(self) -> int:
        return len(self.hosts)

    @property
    def single_host(self) -> bool:
        return self.n_hosts <= 1

    @property
    def one_rank_per_host(self) -> bool:
        return self.max_ranks_per_host <= 1

    @property
    def hierarchical(self) -> bool:
        """True when composing collectives over the hierarchy can win:
        more than one host AND at least one host with co-located ranks.
        The degenerate shapes (1 host, or 1 rank/host) are exactly the
        flat rings' sweet spot and must stay on them."""
        return self.n_hosts > 1 and self.max_ranks_per_host > 1

    def hosts_contiguous(self) -> bool:
        """True when every host's rank set is a contiguous run of rank
        ids (the gang-scheduled layout). Collectives whose output
        assignment is positional (reduce_scatter) need this to map
        per-host wire segments onto per-rank result segments."""
        return all(ranks[-1] - ranks[0] + 1 == len(ranks)
                   for ranks in self.host_ranks.values())

    def device_of(self, rank: int) -> int:
        """Planner-assigned per-host chip index of ``rank`` (-1 when the
        placement carries no device information)."""
        if self.rank_devices is None:
            return -1
        return self.rank_devices[rank]

    def devices_on_host(self, host: str) -> tuple[int, ...]:
        """Chip indexes claimed by ``host``'s ranks, in rank order."""
        if self.rank_devices is None:
            return ()
        return tuple(self.rank_devices[r] for r in self.ranks_on_host(host))

    def mesh_contiguous(self) -> bool:
        """True when the placement can light up a device mesh cleanly:
        gang-contiguous rank runs per host AND every co-located rank on
        its own chip (distinct, known device ids). This is the layout
        the gang scheduler prefers for device-eligible worlds — a host
        double-booking a chip (or a scattered rank run) forces the
        device plane's eligibility check to fall back to the host
        ladder."""
        if self.rank_devices is None or not self.hosts_contiguous():
            return False
        for ranks in self.host_ranks.values():
            devs = [self.rank_devices[r] for r in ranks]
            if any(d < 0 for d in devs) or len(set(devs)) != len(devs):
                return False
        return True

    def cross_host_pairs(self) -> int:
        """Rank pairs that would hit the wire in a fully-connected
        traffic pattern (reference BinPackScheduler.cpp:97-148) — the
        scheduler's locality tie-break metric."""
        if self.n_hosts <= 1:
            return 0
        total = self.size
        return sum(n * (total - n)
                   for n in self.ranks_per_host.values()) // 2

    # -- export ----------------------------------------------------------
    def to_dict(self) -> dict:
        """JSON-safe summary (planner telemetry / debugging)."""
        out = {
            "size": self.size,
            "n_hosts": self.n_hosts,
            "hosts": {h: list(r) for h, r in self.host_ranks.items()},
            "leaders": list(self.leaders),
            "max_ranks_per_host": self.max_ranks_per_host,
            "hierarchical": self.hierarchical,
        }
        if self.rank_devices is not None:
            out["devices"] = list(self.rank_devices)
            out["mesh_contiguous"] = self.mesh_contiguous()
        return out

    def __repr__(self) -> str:
        per_host = ",".join(str(n) for n in self.ranks_per_host.values())
        return (f"Topology(size={self.size}, hosts={self.n_hosts}, "
                f"ranks/host=[{per_host}])")

    def __eq__(self, other) -> bool:
        return (isinstance(other, Topology)
                and self.rank_hosts == other.rank_hosts)

    def __hash__(self) -> int:
        return hash(self.rank_hosts)


def leader_ring(topology: Topology) -> list[int]:
    """The cross-host wire ring: one leader per host, host order —
    identical on every rank by construction."""
    return list(topology.leaders)


def interleave_hosts(hosts: Iterable[str], n_ranks: int) -> dict[int, str]:
    """Round-robin rank→host mapping (the topology-BLIND placement a
    scheduler without the gang hook produces). Test/bench helper: the
    worst case for flat rings — every ring hop crosses hosts."""
    hosts = list(hosts)
    return {r: hosts[r % len(hosts)] for r in range(n_ranks)}
