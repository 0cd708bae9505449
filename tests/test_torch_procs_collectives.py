"""The reference's multi-process collective cases on the port: hosts as
OS processes, each a ``PointToPointBroker`` and its server holding its
ranks of one world on aliased loopback ports.

Counterparts of ``tests/dist/test_hier_collectives.py:153`` (the
hierarchical allreduce over 4 simulated hosts), of
``tests/dist/test_sched_alltoall.py:157`` (the schedule-compiled
alltoall over 4) and of ``tests/dist/test_wire_codec.py:82`` (the wire
governor over 3). Each test's process is simulated host 0; the others
are this module run as a script (``python
tests/test_torch_procs_collectives.py --<case>-child <idx> <base>``),
which report one JSON line each. The hosts' ports come from a conftest
slot through ``port_slot()`` (host i at the slot's base plus
``OFFSETS[i]``, offsets no other cluster of the suite binds) and are
held by listening sockets until each process
binds them; the children wait on their standard input, never on a
clock, and nothing asserts a wall time.
"""

import json
import os
import subprocess
import sys
import threading

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Host i's port offset inside its slot: offsets that no other cluster of
# the suite binds. The reference's process tests put hosts at a slot's
# base, +1000, +1200, +2000, +2400 and +3600 and at the next slots'
# bases; the port's clusters at 0, 1000, 2000 and 2500
OFFSETS = (300, 1500, 1700, 2700)
DATA_PLANES = ("shm", "bulk-tcp")

# -- the hierarchical allreduce (test_hier_collectives.py) ---------------
N_HOSTS = 4
RANKS_PER_HOST = 3
N = N_HOSTS * RANKS_PER_HOST
ELEMS = 1_500_000  # int64 → 12 MiB/rank, over the 8 MiB pipeline floor
HIER_GROUP = 9900
HIER_HOSTS = [f"pxh{i}" for i in range(N_HOSTS)]

# -- the compiled alltoall (test_sched_alltoall.py) ----------------------
BLOCK = 60_000  # int64 elems per (src, dst) block → 480 KiB wire blocks
SCHED_GROUP = 9940
SCHED_HOSTS = [f"pxsched{i}" for i in range(N_HOSTS)]

# -- the wire governor (test_wire_codec.py) ------------------------------
CODEC_HOSTS = ["pxwcA", "pxwcB", "pxwcC"]
CODEC_GROUP = 9941
CODEC_ELEMS = 300_000  # ~1.2 MiB fp32 per round: over BULK_THRESHOLD
ROUNDS = 4


def _build_world(hosts: list[str], group: int, my_idx: int, n: int,
                 first_msg_id: int, held=()):
    """This host's broker and server, and its view of an ``n``-rank world
    whose rank r lives on ``hosts[r % len(hosts)]``."""
    from faabric_tpu_torch.batch_scheduler.decision import SchedulingDecision
    from faabric_tpu_torch.mpi import MpiWorld
    from faabric_tpu_torch.transport.point_to_point import PointToPointBroker
    from faabric_tpu_torch.transport.ptp_remote import PointToPointServer
    from tests.test_torch_procs import _release_held_ports

    decision = SchedulingDecision(app_id=group, group_id=group)
    for r in range(n):
        decision.add_message(hosts[r % len(hosts)], first_msg_id + r, r, r)
    broker = PointToPointBroker(hosts[my_idx])
    server = PointToPointServer(broker)
    _release_held_ports()
    for s in held:
        s.close()
    server.start()
    broker.set_up_local_mappings_from_decision(decision)
    world = MpiWorld(broker, group, n, group)
    my_ranks = [r for r in range(n) if r % len(hosts) == my_idx]
    return broker, server, world, my_ranks


def _data_cells(with_msgs: bool = False) -> dict:
    from faabric_tpu_torch.telemetry import get_comm_matrix

    cells = (get_comm_matrix().snapshot() or {}).get("cells", [])
    return {(c["src"], c["dst"], c["plane"]):
            ((c["bytes"], c["messages"]) if with_msgs else c["bytes"])
            for c in cells if c["plane"] in DATA_PLANES}


def _run_threads(fns) -> bool:
    threads = [threading.Thread(target=f) for f in fns]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    return not any(t.is_alive() for t in threads)


def _hier_modes(world, my_ranks: list[int]) -> dict:
    """The flat ring and the hierarchical composition in every process,
    barrier-fenced so the whole world flips ``hier_enabled`` at a
    quiesced point. Returns the report the parent aggregates."""
    from faabric_tpu_torch.mpi import MpiOp
    from faabric_tpu_torch.telemetry import (
        reset_tracing,
        set_tracing,
        trace_events,
    )

    rng = np.random.default_rng(99)
    datas = {r: rng.integers(-10_000, 10_000, ELEMS).astype(np.int64)
             for r in range(N)}
    expected = sum(datas.values())
    datas = {r: datas[r] for r in my_ranks}

    report = {"ok": True, "err": "", "wire": {}, "cells": {},
              "algos": [], "phases": []}
    results = {}
    set_tracing(True)
    reset_tracing()
    try:
        # "force": the simulated hosts all resolve to loopback, and
        # plain "on" composes only across real machines
        for mode, hier in (("flat", False), ("hier", "force")):
            world.hier_enabled = hier
            out = {}

            def rank_fn(rank):
                world.barrier(rank)
                out[rank] = world.allreduce(rank, datas[rank].copy(),
                                            MpiOp.SUM)
                world.barrier(rank)

            before = _data_cells()
            if not _run_threads([lambda r=r: rank_fn(r) for r in my_ranks]):
                return {"ok": False, "err": f"{mode} hung"}
            after = _data_cells()
            delta = {k: after.get(k, 0) - before.get(k, 0)
                     for k in after if after[k] > before.get(k, 0)}
            report["wire"][mode] = sum(delta.values())
            report["cells"][mode] = [list(k) for k in delta]
            results[mode] = out

        events = [e for e in trace_events() if e.get("ph") == "X"]
        report["algos"] = sorted({e["args"]["algo"] for e in events
                                  if e["cat"] == "mpi"
                                  and e["name"] == "allreduce"})
        report["phases"] = sorted({e["args"]["phase"] for e in events
                                   if e["cat"] == "mpi.phase"
                                   and "phase" in e.get("args", {})})
    finally:
        reset_tracing()
        set_tracing(False)

    for r in my_ranks:
        if not np.array_equal(results["hier"][r], results["flat"][r]):
            return {"ok": False,
                    "err": f"rank {r}: hier differs from flat ring"}
        if not np.array_equal(results["hier"][r], expected):
            return {"ok": False, "err": f"rank {r}: wrong allreduce value"}
    return report


def _sched_modes(world, my_ranks: list[int]) -> dict:
    """The naive all-pairs path and the compiled ``alltoall.hier`` in
    every process, barrier-fenced so the whole world flips
    ``sched_enabled`` at a quiesced point."""
    from faabric_tpu_torch.telemetry import (
        reset_tracing,
        set_tracing,
        trace_events,
    )

    rng = np.random.default_rng(42)
    datas = {r: rng.integers(-10_000, 10_000, N * BLOCK).astype(np.int64)
             for r in range(N)}
    expected = {r: np.concatenate(
        [datas[src].reshape(N, BLOCK)[r] for src in range(N)])
        for r in my_ranks}
    datas = {r: datas[r] for r in my_ranks}

    report = {"ok": True, "err": "", "wire_bytes": {}, "wire_msgs": {},
              "cells": {}, "algos": [], "phases": []}
    results = {}
    set_tracing(True)
    reset_tracing()
    try:
        for mode, sched in (("naive", False), ("sched", "force")):
            world.sched_enabled = sched
            out = {}

            def rank_fn(rank):
                world.barrier(rank)
                out[rank] = world.alltoall(rank, datas[rank].copy())
                world.barrier(rank)

            before = _data_cells(with_msgs=True)
            if not _run_threads([lambda r=r: rank_fn(r) for r in my_ranks]):
                return {"ok": False, "err": f"{mode} hung"}
            after = _data_cells(with_msgs=True)
            delta = {k: (after[k][0] - before.get(k, (0, 0))[0],
                         after[k][1] - before.get(k, (0, 0))[1])
                     for k in after
                     if after[k][0] > before.get(k, (0, 0))[0]}
            report["wire_bytes"][mode] = sum(b for b, _ in delta.values())
            report["wire_msgs"][mode] = sum(m for _, m in delta.values())
            report["cells"][mode] = [list(k) for k in delta]
            results[mode] = out

        events = [e for e in trace_events() if e.get("ph") == "X"]
        report["algos"] = sorted({e["args"]["algo"] for e in events
                                  if e["cat"] == "mpi"
                                  and e["name"] == "alltoall"})
        report["phases"] = sorted({e["name"] for e in events
                                   if e["cat"] == "mpi.phase"})
    finally:
        reset_tracing()
        set_tracing(False)

    for r in my_ranks:
        if not np.array_equal(results["sched"][r], results["naive"][r]):
            return {"ok": False,
                    "err": f"rank {r}: compiled differs from naive"}
        if not np.array_equal(results["sched"][r], expected[r]):
            return {"ok": False, "err": f"rank {r}: wrong alltoall value"}
    return report


def _round_payload(k: int) -> np.ndarray:
    """Deterministic iterative payload: every process derives the same
    per-round arrays, so receivers verify bitwise with no side channel."""
    rng = np.random.default_rng(4242)
    data = rng.standard_normal(CODEC_ELEMS).astype(np.float32)
    slice_len = max(1, CODEC_ELEMS // 100)
    for j in range(1, k + 1):
        off = (j * 977 * slice_len) % (CODEC_ELEMS - slice_len)
        data[off:off + slice_len] += np.float32(j)
    return data


def _codec_receiver(world, rank: int) -> dict:
    report = {"ok": True, "err": ""}
    for k in range(ROUNDS):
        arr, _ = world.recv_shared(0, rank, timeout=60)
        got = np.asarray(arr).reshape(-1).view(np.float32)
        if not np.array_equal(got, _round_payload(k)):
            return {"ok": False, "err": f"round {k} not bitwise"}
    world.send(rank, 0, np.array([1.0], np.float32))
    return report


# ---------------------------------------------------------------------------
# The cluster: this process is host 0, the children hosts 1..n-1
# ---------------------------------------------------------------------------

def _child_main(case: str, my_idx: int) -> None:
    hosts = {"hier": HIER_HOSTS, "sched": SCHED_HOSTS,
             "codec": CODEC_HOSTS}[case]
    if case == "codec":
        broker, server, world, _ = _build_world(
            hosts, CODEC_GROUP, my_idx, 3, 5600)
        world.refresh_rank_hosts()
    else:
        group, first = ((HIER_GROUP, 5000) if case == "hier"
                        else (SCHED_GROUP, 5200))
        broker, server, world, my_ranks = _build_world(
            hosts, group, my_idx, N, first)
    print("READY", flush=True)
    try:
        if case == "hier":
            report = _hier_modes(world, my_ranks)
        elif case == "sched":
            report = _sched_modes(world, my_ranks)
        else:
            report = _codec_receiver(world, my_idx)
    except Exception as e:  # noqa: BLE001 — reported to the parent
        report = {"ok": False, "err": repr(e)[:300]}
    print("REPORT " + json.dumps(report), flush=True)
    # Stay up until the parent is done with every process's ranks: a
    # host that stops early refuses its peers' last frames
    sys.stdin.read()
    server.stop()
    broker.clear()


class _Hosts:
    """The simulated hosts of one case on a conftest port slot: host 0
    in this process, the others as children, every host's ports held by
    listening sockets until it binds them. Host 0 moves bytes in this
    process, so both packages' measured links are reset at the start
    and at the stop: no later test in the worker reads them."""

    def __init__(self, case: str, hosts: list[str]):
        from tests.test_torch_mpi import _hold_ports
        from tests.test_torch_mpi_world import reset_reference_links
        from tests.test_torch_multiprocess import _service_ports, port_slot

        reset_reference_links()
        self.case, self.hosts = case, hosts
        for _ in range(20):
            base = port_slot()
            held = [_hold_ports((base + OFFSETS[i] + p
                                 for p in _service_ports()), listen=True)
                    for i in range(len(hosts))]
            if all(held):
                break
            for socks in held:
                for s in socks:
                    s.close()
        else:
            raise AssertionError("no port slot with its hosts' ports free")
        self.base, self.held = base, held
        self.children: list[subprocess.Popen] = []

    def start(self) -> None:
        from faabric_tpu_torch.transport.common import (
            clear_host_aliases,
            register_host_alias,
        )

        clear_host_aliases()
        aliases = []
        for i, h in enumerate(self.hosts):
            register_host_alias(h, "127.0.0.1", self.base + OFFSETS[i])
            aliases.append(f"{h}=127.0.0.1+{self.base + OFFSETS[i]}")
        env = {**os.environ, "FAABRIC_HOST_ALIASES": ",".join(aliases),
               "PYTHONPATH": os.pathsep.join(
                   filter(None, [ROOT, os.environ.get("PYTHONPATH")]))}
        for i in range(1, len(self.hosts)):
            fds = [s.fileno() for s in self.held[i]]
            try:
                self.children.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__),
                     f"--{self.case}-child", str(i)],
                    stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                    stderr=subprocess.DEVNULL, text=True, cwd=ROOT,
                    env={**env, "PROCS_HELD_FDS": ",".join(map(str, fds))},
                    pass_fds=fds))
            finally:
                # The child holds its own copies until it binds
                for s in self.held[i]:
                    s.close()

    def wait_ready(self) -> None:
        for c in self.children:
            line = c.stdout.readline().strip()
            assert line == "READY", (line, c.poll())

    def reports(self) -> list[dict]:
        out = []
        for c in self.children:
            line = c.stdout.readline().strip()
            assert line.startswith("REPORT "), (line, c.poll())
            out.append(json.loads(line[len("REPORT "):]))
        return out

    def stop(self) -> None:
        from faabric_tpu_torch.transport.common import clear_host_aliases
        from tests.test_torch_mpi_world import reset_reference_links

        for socks in self.held:
            for s in socks:
                s.close()
        for c in self.children:
            try:
                c.stdin.close()
            except OSError:
                pass
        for c in self.children:
            try:
                c.wait(timeout=60)
            except subprocess.TimeoutExpired:
                c.kill()
                c.wait(30)
            c.stdout.close()
        clear_host_aliases()
        reset_reference_links()


def test_dist_hier_allreduce_four_simulated_hosts():
    """12 ranks over 4 processes under the interleaved placement (rank r
    on host r % 4). (a) The hierarchical allreduce is bitwise equal to
    the flat ring and to numpy on every rank; (b) the cross-process
    bytes are within 15% of each algorithm's model, and their ratio
    within 15% of (H-1)/(N-1); (c) during the hierarchical run only
    leader ranks have wire cells; (d) both algorithms' spans, and the
    hierarchical phases, are in every process's trace."""
    cluster = _Hosts("hier", HIER_HOSTS)
    broker = server = None
    try:
        cluster.start()
        broker, server, world, my_ranks = _build_world(
            HIER_HOSTS, HIER_GROUP, 0, N, 5000, held=cluster.held[0])
        cluster.wait_ready()
        reports = [_hier_modes(world, my_ranks)] + cluster.reports()
    finally:
        cluster.stop()
        if server is not None:
            server.stop()
            broker.clear()

    # (a) every process: bitwise hier == flat == numpy on all its ranks
    for i, rep in enumerate(reports):
        assert rep["ok"], f"host {i}: {rep.get('err')}"

    # (b) the wire bytes against the composition model: flat moves
    # 2(N-1)/N of the payload per rank across processes (every hop
    # crosses), hier only the H leaders move 2(H-1)/H
    payload = ELEMS * 8
    flat_bytes = sum(rep["wire"]["flat"] for rep in reports)
    hier_bytes = sum(rep["wire"]["hier"] for rep in reports)
    model_flat = 2 * (N - 1) * payload
    model_hier = 2 * (N_HOSTS - 1) * payload
    assert abs(flat_bytes - model_flat) <= 0.15 * model_flat, (
        flat_bytes, model_flat)
    assert abs(hier_bytes - model_hier) <= 0.15 * model_hier, (
        hier_bytes, model_hier)
    ratio = hier_bytes / flat_bytes
    model_ratio = (N_HOSTS - 1) / (N - 1)
    assert abs(ratio - model_ratio) <= 0.15 * model_ratio, (
        ratio, model_ratio)

    # (c) hierarchical wire cells are leader<->leader only: the leaders
    # are ranks 0..H-1 (rank r's host is r % H)
    leaders = set(range(N_HOSTS))
    for rep in reports:
        for src, dst, plane in rep["cells"]["hier"]:
            assert int(src) in leaders and int(dst) in leaders, (
                src, dst, plane)

    # (d) spans: both algorithms ran, and the hierarchical run tagged
    # all three per-level phases in every process
    for i, rep in enumerate(reports):
        assert rep["algos"] == ["hier", "ring"], (i, rep["algos"])
        assert {"intra", "leader", "redistribute"} <= set(rep["phases"]), (
            i, rep["phases"])


def test_dist_sched_alltoall_four_simulated_hosts():
    """12 ranks over 4 processes, interleaved. (a) The compiled
    ``alltoall.hier`` is bitwise equal to the naive all-pairs path and
    to numpy; (b) the cross-process messages collapse to the packed
    model's H(H-1) (plus the selection round's) while the bytes stay
    within 10% of the naive path's; (c) compiled wire cells are
    leader<->leader only; (d) the span tags and the schedule's phases
    are in every process's trace."""
    cluster = _Hosts("sched", SCHED_HOSTS)
    broker = server = None
    try:
        cluster.start()
        broker, server, world, my_ranks = _build_world(
            SCHED_HOSTS, SCHED_GROUP, 0, N, 5200, held=cluster.held[0])
        cluster.wait_ready()
        reports = [_sched_modes(world, my_ranks)] + cluster.reports()
    finally:
        cluster.stop()
        if server is not None:
            server.stop()
            broker.clear()

    for i, rep in enumerate(reports):
        assert rep["ok"], f"host {i}: {rep.get('err')}"

    naive_msgs = sum(rep["wire_msgs"]["naive"] for rep in reports)
    sched_msgs = sum(rep["wire_msgs"]["sched"] for rep in reports)
    model_naive = N * (N - RANKS_PER_HOST)          # 108
    model_sched = N_HOSTS * (N_HOSTS - 1)           # 12 packed sends
    assert naive_msgs >= model_naive, (naive_msgs, model_naive)
    assert sched_msgs <= model_sched + N_HOSTS, (sched_msgs, model_sched)
    msg_ratio = sched_msgs / naive_msgs
    model_ratio = 1 / RANKS_PER_HOST ** 2
    assert msg_ratio <= 1.5 * model_ratio, (msg_ratio, model_ratio)

    naive_bytes = sum(rep["wire_bytes"]["naive"] for rep in reports)
    sched_bytes = sum(rep["wire_bytes"]["sched"] for rep in reports)
    model_bytes = N * (N - RANKS_PER_HOST) * BLOCK * 8
    assert abs(naive_bytes - model_bytes) <= 0.1 * model_bytes, (
        naive_bytes, model_bytes)
    byte_ratio = sched_bytes / naive_bytes
    assert 0.9 <= byte_ratio <= 1.1, byte_ratio

    leaders = {str(i) for i in range(N_HOSTS)}
    for rep in reports:
        for src, dst, _plane in rep["cells"]["sched"]:
            assert src in leaders and dst in leaders, (src, dst)

    for rep in reports:
        assert "sched:hier" in rep["algos"], rep["algos"]
        assert "direct" in rep["algos"], rep["algos"]
        for phase in ("intra", "leader", "redistribute", "local"):
            assert phase in rep["phases"], (phase, rep["phases"])


def test_dist_governor_keeps_shm_raw_and_delta_compresses_tcp():
    """The sender (this process) pushes the same iterative stream to two
    receiver processes: to the first under the AUTO governor with shm
    rings live, where every comm-matrix row it made says ``codec=raw``
    (some of them ``plane=shm``); to the second with rings off and the
    governor forced to ``delta``, where the rows say ``codec=delta`` on
    bulk TCP and their wire bytes undercut the raw bytes tenfold. Both
    receivers verify every round bitwise."""
    from faabric_tpu_torch.telemetry import get_comm_matrix
    from faabric_tpu_torch.transport.codec import set_wire_codec

    cluster = _Hosts("codec", CODEC_HOSTS)
    broker = server = None
    saved_ring = os.environ.get("SHM_RING_BYTES")
    reports = []

    def cells():
        return [c for c in (get_comm_matrix().snapshot() or {}).get(
            "cells", []) if c["plane"] in DATA_PLANES and c["src"] == "0"]

    try:
        cluster.start()
        broker, server, world, _ = _build_world(
            CODEC_HOSTS, CODEC_GROUP, 0, 3, 5600, held=cluster.held[0])
        world.refresh_rank_hosts()
        cluster.wait_ready()

        # -- pass 1: AUTO governor, shm rings live, dst rank 1 ---------
        set_wire_codec("auto")
        before1 = {(c["dst"], c["plane"], c["codec"]): c["bytes"]
                   for c in cells()}
        for k in range(ROUNDS):
            world.send(0, 1, _round_payload(k))
        world.recv(1, 0, timeout=60)  # receiver verified and acked
        pass1 = [c for c in cells()
                 if c["dst"] == "1" and c["bytes"] > before1.get(
                     (c["dst"], c["plane"], c["codec"]), 0)]
        assert pass1, "no data-plane rows for the shm pass"
        assert all(c["codec"] == "raw" for c in pass1), pass1
        assert any(c["plane"] == "shm" for c in pass1), pass1

        # -- pass 2: forced delta, rings off, dst rank 2 ---------------
        os.environ["SHM_RING_BYTES"] = "0"
        set_wire_codec("delta")
        for k in range(ROUNDS):
            world.send(0, 2, _round_payload(k))
        world.recv(2, 0, timeout=60)
        pass2 = [c for c in cells() if c["dst"] == "2"]
        coded = [c for c in pass2 if c["codec"] == "delta"]
        assert coded, f"no delta rows: {pass2}"
        assert all(c["plane"] == "bulk-tcp" for c in coded)
        wire = sum(c["bytes"] for c in coded)
        raw = sum(c["bytes_raw"] for c in coded)
        # Rounds 2..N ship ~1% deltas: wire undercuts raw tenfold on the
        # delta rows, and the matrix still accounts the raw bytes
        assert raw >= (ROUNDS - 1) * CODEC_ELEMS * 4 * 0.9, (wire, raw)
        assert wire * 10 < raw, (wire, raw)
        reports = cluster.reports()
    finally:
        set_wire_codec(os.environ.get("FAABRIC_WIRE_CODEC", "auto"))
        if saved_ring is None:
            os.environ.pop("SHM_RING_BYTES", None)
        else:
            os.environ["SHM_RING_BYTES"] = saved_ring
        cluster.stop()
        if server is not None:
            server.stop()
            broker.clear()

    for i, rep in enumerate(reports):
        assert rep["ok"], f"receiver {i + 1}: {rep.get('err')}"


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    for case in ("hier", "sched", "codec"):
        flag = f"--{case}-child"
        if flag in sys.argv:
            _child_main(case, int(sys.argv[sys.argv.index(flag) + 1]))
