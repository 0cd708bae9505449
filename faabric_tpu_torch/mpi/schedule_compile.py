"""Schedule lowerings and family selection.

Counterpart of ``faabric_tpu/mpi/schedule_compile.py``: the lowerings
(:135-489), ``compile_schedule`` (:509) and ``choose_family`` (:587).
Compiles (collective, Topology) into the verified step programs of
``mpi/schedule.py``. Families:

- ``alltoall.flat`` / ``alltoall.hier`` — direct pairwise exchange vs
  the locality-aware leader composition (one packed host-block per
  host pair).
- ``scatter.flat`` / ``scatter.tree`` — root-direct vs root→leaders→
  local fan-out (scatterv binds split sizes through an int64
  count-vector header block).
- ``scan.chain`` / ``scan.hier`` — the linear chain vs intra-host
  chains plus a carrier chain between hosts (gang placements only).
- ``allreduce.hier`` / ``reduce_scatter.hier`` / ``allgather.hier`` —
  schedule twins of the hierarchical collectives.
- ``allgather.ring`` — the flat shift-1 ring whose permute legs the
  ``device-ring`` execution target runs on the device plane.

Selection: the composed families for cross-machine links that are slow
or unmeasured, the flat ones for links measured at or above
``FAABRIC_SCHED_FAST_GIBS`` (default 2 GiB/s). A link's rate comes from
the perf store's big-frame evidence, then the comm matrix
(``measured_cross_gibs``). The verdict is computed on rank 0 only and
broadcast by the selection-sync round in ``MpiWorld._sched_family``.
"""

from __future__ import annotations

import os

from faabric_tpu_torch.mpi.schedule import (
    COPY,
    FOLD,
    RECV,
    SEND,
    Schedule,
    ScheduleError,
    Step,
    verify_schedule,
)

ALL = ("all",)
CNT = ("cnt",)


def BLK(j) -> tuple:
    return ("blk", j)


def SEG(i) -> tuple:
    return ("seg", i)


# Links measured at or above this are fast: flat schedules win there
# (per-message overhead is negligible next to the composed families'
# extra local copies). Below it, or unmeasured, the composed families'
# 1/m² message count wins
FAST_LINK_GIBS = float(os.environ.get("FAABRIC_SCHED_FAST_GIBS", "2.0"))

# Bandwidth evidence floor, as the wire-codec governor's: small frames
# measure dispatch overhead, not the link
EVIDENCE_BYTES = 1 << 20

# Families in a stable order: the selection-sync broadcast ships the
# INDEX, so this tuple is wire protocol — append only.
FAMILIES = (
    "alltoall.flat",
    "alltoall.hier",
    "scatter.flat",
    "scatter.tree",
    "scan.chain",
    "scan.hier",
    "allreduce.hier",
    "reduce_scatter.hier",
    "allgather.hier",
    "allgather.ring",
)
FAMILY_IDS = {f: i for i, f in enumerate(FAMILIES)}


class _Prog:
    """Per-rank step-list builder."""

    def __init__(self, size: int) -> None:
        self.size = size
        self._steps: dict[int, list[Step]] = {r: [] for r in range(size)}

    def send(self, r, peer, keys, syms, phase):
        self._steps[r].append(Step(SEND, peer=peer, keys=tuple(keys),
                                   syms=tuple(syms), phase=phase))

    def recv(self, r, peer, keys, syms, phase):
        self._steps[r].append(Step(RECV, peer=peer, keys=tuple(keys),
                                   syms=tuple(syms), phase=phase))

    def fold(self, r, dst, a, b, phase):
        self._steps[r].append(Step(FOLD, dst=dst, a=a, b=b, phase=phase))

    def copy(self, r, dst, src, phase):
        self._steps[r].append(Step(COPY, dst=dst, src=src, phase=phase))

    def build(self, name, collective, spec=None) -> Schedule:
        return Schedule(name=name, collective=collective, size=self.size,
                        steps={r: tuple(s) for r, s in self._steps.items()},
                        spec=spec or {})


# ---------------------------------------------------------------------------
# alltoall
# ---------------------------------------------------------------------------
def _alltoall_flat(topo) -> Schedule:
    n = topo.size
    p = _Prog(n)
    for r in range(n):
        for s in range(n):
            if s != r:
                p.send(r, s, [("in", s)], [BLK(s)], "exchange")
        p.copy(r, ("out", r), ("in", r), "exchange")
        for s in range(n):
            if s != r:
                p.recv(r, s, [("out", s)], [BLK(r)], "exchange")
    return p.build("alltoall.flat", "alltoall")


def _alltoall_hier(topo) -> Schedule:
    n = topo.size
    p = _Prog(n)
    hosts = list(topo.hosts)
    for host in hosts:
        locals_ = list(topo.ranks_on_host(host))
        leader = locals_[0]
        remote_hosts = [h for h in hosts if h != host]
        for r in locals_:
            # -- local blocks swap directly in process ------------------
            for s in locals_:
                if s != r:
                    p.send(r, s, [("in", s)], [BLK(s)], "local")
            p.copy(r, ("out", r), ("in", r), "local")
            for s in locals_:
                if s != r:
                    p.recv(r, s, [("out", s)], [BLK(r)], "local")
            # -- remote blocks gather to the leader, per dest host ------
            if r != leader:
                for h in remote_hosts:
                    dsts = topo.ranks_on_host(h)
                    p.send(r, leader, [("in", s) for s in dsts],
                           [BLK(s) for s in dsts], "intra")
        for r2 in locals_[1:]:
            for h in remote_hosts:
                dsts = topo.ranks_on_host(h)
                p.recv(leader, r2,
                       [("tmp", ("g", r2, s)) for s in dsts],
                       [BLK(s) for s in dsts], "intra")

        # -- leaders exchange ONE packed block per host pair ------------
        def _gkey(src_rank, dst_rank):
            return (("in", dst_rank) if src_rank == leader
                    else ("tmp", ("g", src_rank, dst_rank)))

        for h in remote_hosts:
            dsts = topo.ranks_on_host(h)
            keys = [_gkey(r2, s) for r2 in locals_ for s in dsts]
            syms = [BLK(s) for _ in locals_ for s in dsts]
            p.send(leader, topo.ranks_on_host(h)[0], keys, syms, "leader")
        for h in remote_hosts:
            srcs = topo.ranks_on_host(h)
            keys = [("tmp", ("x", r2, s)) for r2 in srcs for s in locals_]
            syms = [BLK(s) for _ in srcs for s in locals_]
            p.recv(leader, srcs[0], keys, syms, "leader")

        # -- leaders redistribute in process ----------------------------
        remote_ranks = [r2 for h in remote_hosts
                        for r2 in topo.ranks_on_host(h)]
        for s in locals_[1:]:
            p.send(leader, s, [("tmp", ("x", r2, s)) for r2 in remote_ranks],
                   [BLK(s) for _ in remote_ranks], "redistribute")
        for r2 in remote_ranks:
            p.copy(leader, ("out", r2), ("tmp", ("x", r2, leader)),
                   "redistribute")
        for s in locals_[1:]:
            p.recv(s, leader, [("out", r2) for r2 in remote_ranks],
                   [BLK(s) for _ in remote_ranks], "redistribute")
    return p.build("alltoall.hier", "alltoall")


# ---------------------------------------------------------------------------
# scatter / scatterv
# ---------------------------------------------------------------------------
def _scatter_flat(topo, collective: str, root: int) -> Schedule:
    n = topo.size
    p = _Prog(n)
    for s in range(n):
        if s == root:
            continue
        p.send(root, s, [("in", s)], [BLK(s)], "scatter")
    p.copy(root, ("out", 0), ("in", root), "scatter")
    for s in range(n):
        if s != root:
            p.recv(s, root, [("out", 0)], [BLK(s)], "scatter")
    return p.build("scatter.flat", collective, {"root": root})


def _scatter_tree(topo, collective: str, root: int) -> Schedule:
    n = topo.size
    p = _Prog(n)
    root_host = topo.host_of(root)
    counts_header = collective == "scatterv"
    spec = {"root": root}
    if counts_header:
        spec["counts_header"] = True
    for host in topo.hosts:
        locals_ = list(topo.ranks_on_host(host))
        leader = locals_[0]
        if host == root_host:
            # Root is its own host's fan-out point, leader or not
            for s in locals_:
                if s != root:
                    p.send(root, s, [("in", s)], [BLK(s)], "local")
            p.copy(root, ("out", 0), ("in", root), "local")
            for s in locals_:
                if s != root:
                    p.recv(s, root, [("out", 0)], [BLK(s)], "local")
            continue
        # The count-vector header precedes the packed bundle so the
        # leader can split it (scatterv leaders have no count vector)
        if counts_header and len(locals_) > 1:
            p.send(root, leader, [("in", "cnt")], [CNT], "header")
            p.recv(leader, root, [("tmp", "cnt")], [CNT], "header")
        p.send(root, leader, [("in", s) for s in locals_],
               [BLK(s) for s in locals_], "tree")
        p.recv(leader, root, [("tmp", ("s", s)) for s in locals_],
               [BLK(s) for s in locals_], "tree")
        p.copy(leader, ("out", 0), ("tmp", ("s", leader)), "fanout")
        for s in locals_[1:]:
            p.send(leader, s, [("tmp", ("s", s))], [BLK(s)], "fanout")
            p.recv(s, leader, [("out", 0)], [BLK(s)], "fanout")
    return p.build("scatter.tree", collective, spec)


# ---------------------------------------------------------------------------
# scan
# ---------------------------------------------------------------------------
def _scan_chain(topo) -> Schedule:
    n = topo.size
    p = _Prog(n)
    for r in range(n):
        if r == 0:
            p.copy(r, ("out", 0), ("in", 0), "chain")
        else:
            p.recv(r, r - 1, [("tmp", "p")], [ALL], "chain")
            # Operand order (prefix, mine) — the reference chain's
            # apply_op(op, prev, data), so non-commutative user ops and
            # float folds stay bit-identical to the legacy path
            p.fold(r, ("out", 0), ("tmp", "p"), ("in", 0), "chain")
        if r < n - 1:
            p.send(r, r + 1, [("out", 0)], [ALL], "chain")
    return p.build("scan.chain", "scan")


def _scan_hier(topo) -> Schedule:
    if not topo.hosts_contiguous():
        raise ScheduleError("scan.hier needs gang-contiguous placement")
    n = topo.size
    p = _Prog(n)
    host_runs = [list(topo.ranks_on_host(h)) for h in topo.hosts]
    # Contiguity gives each host one rank run; prefix order needs the
    # runs sorted by their first rank (host first-appearance order
    # already is, but make it explicit)
    host_runs.sort(key=lambda run: run[0])
    carriers = [run[-1] for run in host_runs]
    for hi, run in enumerate(host_runs):
        for i, r in enumerate(run):
            # -- intra-host prefix chain --------------------------------
            if i == 0:
                p.copy(r, ("tmp", "acc"), ("in", 0), "intra")
            else:
                p.recv(r, run[i - 1], [("tmp", "lp")], [ALL], "intra")
                p.fold(r, ("tmp", "acc"), ("tmp", "lp"), ("in", 0),
                       "intra")
            if i < len(run) - 1:
                p.send(r, run[i + 1], [("tmp", "acc")], [ALL], "intra")
        carrier = carriers[hi]
        # -- carrier chain between hosts --------------------------------
        if hi == 0:
            p.copy(carrier, ("out", 0), ("tmp", "acc"), "leader")
        else:
            p.recv(carrier, carriers[hi - 1], [("tmp", "carry")], [ALL],
                   "leader")
            p.fold(carrier, ("out", 0), ("tmp", "carry"), ("tmp", "acc"),
                   "leader")
        if hi < len(host_runs) - 1:
            p.send(carrier, carriers[hi + 1], [("out", 0)], [ALL],
                   "leader")
        # -- carry fix-up for the host's other ranks --------------------
        for r in run[:-1]:
            if hi == 0:
                p.copy(r, ("out", 0), ("tmp", "acc"), "redistribute")
            else:
                p.send(carrier, r, [("tmp", "carry")], [ALL],
                       "redistribute")
                p.recv(r, carrier, [("tmp", "carry")], [ALL],
                       "redistribute")
                p.fold(r, ("out", 0), ("tmp", "carry"), ("tmp", "acc"),
                       "redistribute")
    return p.build("scan.hier", "scan")


# ---------------------------------------------------------------------------
# Hierarchical reductions — schedule twins of the hand-written paths
# ---------------------------------------------------------------------------
def _allreduce_hier(topo) -> Schedule:
    n = topo.size
    leaders = list(topo.leaders)
    nh = len(leaders)
    if nh < 2:
        raise ScheduleError("allreduce.hier needs multiple hosts")
    segs = nh
    p = _Prog(n)
    seg_keys = [("tmp", ("acc", s)) for s in range(segs)]
    for host in topo.hosts:
        locals_ = list(topo.ranks_on_host(host))
        leader = locals_[0]
        for r in locals_[1:]:
            p.send(r, leader, [("in", s) for s in range(segs)],
                   [SEG(s) for s in range(segs)], "intra")
        for s in range(segs):
            p.copy(leader, seg_keys[s], ("in", s), "intra")
        for r in locals_[1:]:
            p.recv(leader, r, [("tmp", ("c", r, s)) for s in range(segs)],
                   [SEG(s) for s in range(segs)], "intra")
            for s in range(segs):
                p.fold(leader, seg_keys[s], ("tmp", ("c", r, s)),
                       seg_keys[s], "intra")
    # Leader ring: reduce-scatter then allgather over the segments,
    # mirroring _allreduce_ring's (received, mine) fold convention
    for pos, leader in enumerate(leaders):
        nxt = leaders[(pos + 1) % nh]
        prv = leaders[(pos - 1) % nh]
        p.send(leader, nxt, [seg_keys[pos]], [SEG(pos)], "leader")
        for t in range(nh - 1):
            q = (pos - 1 - t) % nh
            p.recv(leader, prv, [("tmp", ("r", t))], [SEG(q)], "leader")
            p.fold(leader, seg_keys[q], ("tmp", ("r", t)), seg_keys[q],
                   "leader")
            if t < nh - 2:
                p.send(leader, nxt, [seg_keys[q]], [SEG(q)], "leader")
        full = (pos + 1) % nh
        p.copy(leader, ("out", full), seg_keys[full], "leader")
        for t in range(nh - 1):
            g = (pos + 1 - t) % nh
            p.send(leader, nxt, [("out", g)], [SEG(g)], "leader")
            g2 = (pos - t) % nh
            p.recv(leader, prv, [("out", g2)], [SEG(g2)], "leader")
    for host in topo.hosts:
        locals_ = list(topo.ranks_on_host(host))
        leader = locals_[0]
        for r in locals_[1:]:
            p.send(leader, r, [("out", s) for s in range(segs)],
                   [SEG(s) for s in range(segs)], "redistribute")
            p.recv(r, leader, [("out", s) for s in range(segs)],
                   [SEG(s) for s in range(segs)], "redistribute")
    return p.build("allreduce.hier", "allreduce", {"segments": segs})


def _reduce_scatter_hier(topo) -> Schedule:
    n = topo.size
    if len(topo.hosts) < 2:
        raise ScheduleError("reduce_scatter.hier needs multiple hosts")
    p = _Prog(n)
    for host in topo.hosts:
        locals_ = list(topo.ranks_on_host(host))
        leader = locals_[0]
        remote_hosts = [h for h in topo.hosts if h != host]
        acc = {j: ("tmp", ("acc", j)) for j in range(n)}
        for r in locals_[1:]:
            p.send(r, leader, [("in", j) for j in range(n)],
                   [BLK(j) for j in range(n)], "intra")
        for j in range(n):
            p.copy(leader, acc[j], ("in", j), "intra")
        for r in locals_[1:]:
            p.recv(leader, r, [("tmp", ("c", r, j)) for j in range(n)],
                   [BLK(j) for j in range(n)], "intra")
            for j in range(n):
                p.fold(leader, acc[j], ("tmp", ("c", r, j)), acc[j],
                       "intra")
        # One packed partial per remote host: exactly that host's output
        # blocks, host-folded
        for h in remote_hosts:
            dsts = topo.ranks_on_host(h)
            p.send(leader, dsts[0], [acc[j] for j in dsts],
                   [BLK(j) for j in dsts], "leader")
        for h in remote_hosts:
            src = topo.ranks_on_host(h)[0]
            p.recv(leader, src,
                   [("tmp", ("x", src, j)) for j in locals_],
                   [BLK(j) for j in locals_], "leader")
            for j in locals_:
                p.fold(leader, acc[j], ("tmp", ("x", src, j)), acc[j],
                       "leader")
        p.copy(leader, ("out", 0), acc[leader], "redistribute")
        for s in locals_[1:]:
            p.send(leader, s, [acc[s]], [BLK(s)], "redistribute")
            p.recv(s, leader, [("out", 0)], [BLK(s)], "redistribute")
    return p.build("reduce_scatter.hier", "reduce_scatter")


def _allgather_hier(topo) -> Schedule:
    n = topo.size
    if len(topo.hosts) < 2:
        raise ScheduleError("allgather.hier needs multiple hosts")
    p = _Prog(n)
    for host in topo.hosts:
        locals_ = list(topo.ranks_on_host(host))
        leader = locals_[0]
        remote_hosts = [h for h in topo.hosts if h != host]
        for r in locals_[1:]:
            p.send(r, leader, [("in", 0)], [BLK(r)], "intra")
        p.copy(leader, ("out", leader), ("in", 0), "intra")
        for r in locals_[1:]:
            p.recv(leader, r, [("out", r)], [BLK(r)], "intra")
        # Pairwise host-block exchange between leaders
        for h in remote_hosts:
            p.send(leader, topo.ranks_on_host(h)[0],
                   [("out", r) for r in locals_],
                   [BLK(r) for r in locals_], "leader")
        for h in remote_hosts:
            srcs = topo.ranks_on_host(h)
            p.recv(leader, srcs[0], [("out", q) for q in srcs],
                   [BLK(q) for q in srcs], "leader")
        for s in locals_[1:]:
            p.send(leader, s, [("out", q) for q in range(n)],
                   [BLK(q) for q in range(n)], "redistribute")
            p.recv(s, leader, [("out", q) for q in range(n)],
                   [BLK(q) for q in range(n)], "redistribute")
    return p.build("allgather.hier", "allgather")


def _allgather_ring(topo) -> Schedule:
    """Flat shift-1 ring allgather: n−1 rounds of "send the block I most
    recently hold to my right neighbour, receive the left neighbour's" —
    the bandwidth-optimal pattern on a ring, and every wire leg a pure
    uniform-shift permute. The ``ring`` phase is annotated with the
    ``device-ring`` execution target: on an activated device world the
    runner executes each round as ONE ring-permute kernel launch for all
    local ranks instead of 2(n−1) host messages; without a device plane
    the same verified steps run on the host path unchanged. ``ring_uniform`` records the compile-time
    guarantee the target relies on: every block resolves to the same
    element count (allgather contributions are uniform by contract)."""
    n = topo.size
    if n < 2:
        raise ScheduleError("allgather.ring needs at least 2 ranks")
    p = _Prog(n)
    for r in range(n):
        p.copy(r, ("out", r), ("in", 0), "assemble")
    for step in range(n - 1):
        for r in range(n):
            seg = (r - step) % n
            p.send(r, (r + 1) % n, [("out", seg)], [BLK(seg)], "ring")
            p.recv(r, (r - 1) % n, [("out", (r - step - 1) % n)],
                   [BLK((r - step - 1) % n)], "ring")
    return p.build("allgather.ring", "allgather",
                   spec={"targets": {"ring": "device-ring"},
                         "ring_uniform": True})


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------
_LOWERINGS = {
    "alltoall.flat": lambda topo, root: _alltoall_flat(topo),
    "alltoall.hier": lambda topo, root: _alltoall_hier(topo),
    "scatter.flat": None,  # needs the collective name; see compile_schedule
    "scatter.tree": None,
    "scan.chain": lambda topo, root: _scan_chain(topo),
    "scan.hier": lambda topo, root: _scan_hier(topo),
    "allreduce.hier": lambda topo, root: _allreduce_hier(topo),
    "reduce_scatter.hier": lambda topo, root: _reduce_scatter_hier(topo),
    "allgather.hier": lambda topo, root: _allgather_hier(topo),
    "allgather.ring": lambda topo, root: _allgather_ring(topo),
}


def compile_schedule(family: str, collective: str, topo,
                     root: int = 0) -> Schedule:
    """Compile AND verify one family over one Topology. The verifier
    runs on every compile — a schedule object with ``verified`` unset
    cannot exist outside this module's negative tests."""
    if family.startswith("scatter."):
        fn = _scatter_flat if family == "scatter.flat" else _scatter_tree
        sched = fn(topo, collective, root)
    else:
        lower = _LOWERINGS.get(family)
        if lower is None:
            raise ScheduleError(f"Unknown schedule family {family!r}")
        sched = lower(topo, root)
        if sched.collective != collective:
            raise ScheduleError(
                f"{family} lowers {sched.collective}, not {collective}")
    return verify_schedule(sched)


def measured_cross_gibs(topo, my_host: str, store=None,
                        matrix=None) -> float | None:
    """Worst measured outbound bandwidth toward the topology's OTHER
    hosts: perf-profile store first (big-frame evidence), comm-matrix
    window as fallback, None when every remote link is unmeasured."""
    if store is None:
        from faabric_tpu_torch.telemetry.perfprofile import get_perf_store

        store = get_perf_store()
    worst = None
    for host in topo.hosts:
        if host == my_host:
            continue
        gibs = store.link_gibs(host, plane="bulk-tcp",
                               min_bytes=EVIDENCE_BYTES)
        if gibs is None:
            gibs = _matrix_gibs(topo, host, matrix)
        if gibs is None:
            continue
        if worst is None or gibs < worst:
            worst = gibs
    return worst


def _matrix_gibs(topo, dst_host: str, matrix=None) -> float | None:
    """Comm-matrix window fallback for one destination host: best
    observed wire rate of any cell whose dst rank lives there."""
    if matrix is None:
        from faabric_tpu_torch.telemetry import get_comm_matrix

        matrix = get_comm_matrix()
    snap = matrix.snapshot() or {}
    dst_ranks = {str(r) for r in topo.ranks_on_host(dst_host)}
    best = None
    for c in snap.get("cells", []):
        if c.get("plane") not in ("bulk-tcp", "shm"):
            continue
        if c.get("dst") not in dst_ranks:
            continue
        lat = c.get("lat_sum") or 0.0
        if lat <= 0:
            continue
        gibs = (c.get("bytes_raw", c.get("bytes", 0)) / lat) / (1 << 30)
        if best is None or gibs > best:
            best = gibs
    return best


def _links_slow(topo, mode, store, matrix) -> bool:
    """Assume-slow convention: unmeasured links are slow (a fresh WAN
    link must not run the copy-heavy flat schedule until a measurement
    earns it)."""
    if mode == "force":
        return True
    gibs = measured_cross_gibs(topo, topo.host_of(0), store=store,
                               matrix=matrix)
    return gibs is None or gibs < FAST_LINK_GIBS


def choose_family(collective: str, topo, nbytes: int, mode,
                  store=None, matrix=None) -> str:
    """Pick the schedule family for one (collective, Topology, payload).
    Deterministic given its inputs; the WORLD-agreed verdict is rank
    0's, distributed by the selection-sync round (per-process perf
    stores disagree, and a desynced family choice hangs the world).
    ``mode`` is the world's sched knob value (True / "force")."""
    multi_host = topo.n_hosts > 1
    if collective == "alltoall":
        if not multi_host:
            return "alltoall.flat"
        return ("alltoall.hier"
                if _links_slow(topo, mode, store, matrix)
                else "alltoall.flat")
    if collective in ("scatter", "scatterv"):
        if not multi_host:
            return "scatter.flat"
        return ("scatter.tree"
                if _links_slow(topo, mode, store, matrix)
                else "scatter.flat")
    if collective == "scan":
        if (multi_host and topo.max_ranks_per_host > 1
                and topo.hosts_contiguous()
                and _links_slow(topo, mode, store, matrix)):
            return "scan.hier"
        return "scan.chain"
    if collective in ("allreduce", "reduce_scatter", "allgather"):
        # Only reachable under force + world.sched_reductions; the flat
        # shapes keep the hand-written executors. Allgather over a
        # one-rank-per-host placement lowers to the flat ring whose
        # permute legs the device-ring target can execute on the device
        # plane.
        if collective == "allgather" and topo.n_hosts == topo.size:
            return "allgather.ring"
        return f"{collective}.hier"
    raise ScheduleError(f"No schedule families for {collective!r}")
