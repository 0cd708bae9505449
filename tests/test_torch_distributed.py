"""The device plane across processes: the port against the JAX package.

Counterpart of ``tests/dist/test_device_plane.py`` and of the first half
of ``tests/dist/test_multiprocess.py::test_device_plane_cross_process_
collectives``, plus the roster and the verdicts both packages compute
in this process:

- ``DevicePlaneSpec`` round trips and coordinator addresses;
- the planner's device-plane roster (``join_device_plane``,
  ``clear_device_plane``, the reset) against the reference's over the
  same join sequences, directly and through the port's RPC;
- ``resolve_mesh`` over two processes' rows;
- two child processes (2 + 2 ranks of one MPI world) joined over gloo on
  the CPU: every device collective bitwise against the host ring and
  numpy, zero payload bytes on the host planes, zero host↔device copies
  for resident rounds, the comm matrix's ``device`` bytes equal to the
  payload, an ineligible op on the host ladder, fp32 allreduce bitwise
  equal to the single-process plane's, the ring permute equal to its
  plain version, and 64-bit payloads on the plane (the port's
  divergence: the reference's plane narrows them, so it refuses them);
- two ``planeworker`` processes through a planner process, whose
  addressable collectives see an 8-device plane split 4 + 4.

The children import the port and nothing of JAX. Every process test
takes its ports from ``tests/test_torch_multiprocess.py::port_slot()``
and waits a bounded time for its children; no assertion reads a time.
"""

import hashlib
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

N_PROCS = 2
RANKS_PER_PROC = 2
N = N_PROCS * RANKS_PER_PROC
GROUP = 9920
HOSTS = ["xdp0", "xdp1"]
DATA_PLANES = ("shm", "bulk-tcp")
ELEMS = 20_000
CHILD_TIMEOUT_S = 180.0


def _digest(a) -> str:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _inputs():
    """Every rank's inputs, made from one seed in every process."""
    rng = np.random.default_rng(23)
    return {
        "ar": {r: rng.integers(-9999, 9999, ELEMS).astype(np.int32)
               for r in range(N)},
        "rs": {r: rng.integers(-9999, 9999, N * 500).astype(np.int32)
               for r in range(N)},
        "f32": {r: rng.standard_normal(ELEMS).astype(np.float32)
                for r in range(N)},
        "i64": {r: np.full(256, 2 ** 40 + r, np.int64) for r in range(N)},
    }


# ---------------------------------------------------------------------------
# The child: one process of the plane, RANKS_PER_PROC ranks of the world
# ---------------------------------------------------------------------------

def _child_main(my_idx: int, coord_port: int, device: str) -> None:
    # The parent held this host's ports (and the coordinator's) while
    # the interpreter started: they are bound next
    for fd in filter(None, os.environ.pop("PROCS_HELD_FDS", "").split(",")):
        os.close(int(fd))
    from faabric_tpu_torch.parallel.distributed import (
        DevicePlaneSpec,
        join_device_plane,
        leave_device_plane,
    )

    join_device_plane(DevicePlaneSpec(
        coordinator_host=HOSTS[0], coordinator_port=coord_port,
        num_processes=N_PROCS, process_id=my_idx),
        local_devices=[device] * RANKS_PER_PROC, init_timeout_s=90)
    dev = torch.device(device)

    from faabric_tpu_torch.batch_scheduler import SchedulingDecision
    from faabric_tpu_torch.device_plane import device_copy_totals
    from faabric_tpu_torch.mpi import MpiOp, MpiWorld, UserOp
    from faabric_tpu_torch.ops import _build
    from faabric_tpu_torch.ops.ring_permute import ring_permute
    from faabric_tpu_torch.telemetry import get_comm_matrix
    from faabric_tpu_torch.transport import PointToPointBroker
    from faabric_tpu_torch.transport.ptp_remote import PointToPointServer

    decision = SchedulingDecision(app_id=GROUP, group_id=GROUP)
    for r in range(N):
        decision.add_message(HOSTS[r // RANKS_PER_PROC], 5300 + r, r, r,
                             device_id=r % RANKS_PER_PROC)
    broker = PointToPointBroker(HOSTS[my_idx])
    server = PointToPointServer(broker)
    server.start()
    broker.set_up_local_mappings_from_decision(decision)
    world = MpiWorld(broker, GROUP, N, GROUP)
    world.refresh_rank_hosts()
    my_ranks = [r for r in range(N) if r // RANKS_PER_PROC == my_idx]
    print("READY", flush=True)

    def run_ranks(fn):
        out, errs = {}, []

        def go(rank):
            try:
                out[rank] = fn(rank)
            except Exception as e:  # noqa: BLE001 — reported upward
                errs.append(f"rank {rank}: {e!r}"[:300])

        threads = [threading.Thread(target=go, args=(r,)) for r in my_ranks]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        if errs or any(t.is_alive() for t in threads):
            raise RuntimeError(errs or "rank threads hung")
        return out

    def plane_bytes():
        out: dict = {}
        for c in (get_comm_matrix().snapshot() or {}).get("cells", []):
            out[c["plane"]] = out.get(c["plane"], 0) + c["bytes"]
        return out

    def delta(b0, b1):
        return {p: b1.get(p, 0) - b0.get(p, 0) for p in set(b0) | set(b1)}

    report = {"ok": True, "err": ""}
    try:
        ins = _inputs()
        ar, rs, f32, i64 = ins["ar"], ins["rs"], ins["f32"], ins["i64"]
        # The host ladder first, before the plane activates
        flat_ar = run_ranks(lambda r: world.allreduce(r, ar[r].copy(),
                                                      MpiOp.SUM))
        acts = run_ranks(lambda r: world.activate_device_plane(
            r, device=dev))
        report["activated"] = all(acts.values())
        if not report["activated"]:
            raise RuntimeError(f"activation failed: {acts}")

        b0 = plane_bytes()
        dev_ar = run_ranks(lambda r: world.allreduce(r, ar[r].copy(),
                                                     MpiOp.SUM))
        dev_ag = run_ranks(lambda r: world.allgather(
            r, np.full(64, r + 1, np.int32)))
        dev_rs = run_ranks(lambda r: world.reduce_scatter(
            r, rs[r].copy(), MpiOp.SUM))
        d = delta(b0, plane_bytes())
        report["device_bytes"] = d.get("device", 0)
        report["device_bytes_expected"] = sum(
            ar[r].nbytes + 64 * 4 + rs[r].nbytes for r in my_ranks)
        report["host_plane_bytes"] = sum(v for p, v in d.items()
                                         if p in DATA_PLANES)
        ag_expected = np.concatenate([np.full(64, r + 1, np.int32)
                                      for r in range(N)])
        rs_expected = sum(rs.values())
        for r in my_ranks:
            assert dev_ar[r].dtype == flat_ar[r].dtype == np.int32, r
            assert np.array_equal(dev_ar[r], flat_ar[r]), r
            assert np.array_equal(dev_ar[r], sum(ar.values())), r
            assert dev_ag[r].dtype == np.int32, r
            assert np.array_equal(dev_ag[r], ag_expected), r
            assert dev_rs[r].dtype == np.int32, r
            assert np.array_equal(dev_rs[r],
                                  rs_expected[r * 500:(r + 1) * 500]), r
            assert world.rungs[r, "allreduce"] == "device", r

        # 64-bit payloads ride the plane, exactly (sums past 2^31)
        big = run_ranks(lambda r: world.allreduce(r, i64[r].copy(),
                                                  MpiOp.SUM))
        big_expected = sum(i64.values())
        assert int(big_expected[0]) > 2 ** 31
        for r in my_ranks:
            assert big[r].dtype == np.int64, r
            assert np.array_equal(big[r], big_expected), r
            assert world.rungs[r, "allreduce"] == "device", r

        # fp32, host rounds and resident rounds: the parent holds the
        # digests against the single-process plane's
        f_host = run_ranks(lambda r: world.allreduce(r, f32[r].copy(),
                                                     MpiOp.SUM))
        resident = {r: torch.from_numpy(f32[r].copy()).to(dev)
                    for r in my_ranks}
        run_ranks(lambda r: world.allreduce(r, resident[r], MpiOp.SUM))
        c0, rb0 = device_copy_totals(), plane_bytes()
        f_res = run_ranks(lambda r: world.allreduce(r, resident[r],
                                                    MpiOp.SUM))
        c1, rd = device_copy_totals(), delta(rb0, plane_bytes())
        report["resident_copy_count"] = c1["count"] - c0["count"]
        report["resident_copy_bytes"] = c1["bytes"] - c0["bytes"]
        report["resident_host_plane_bytes"] = sum(
            v for p, v in rd.items() if p in DATA_PLANES)
        report["resident_device_bytes"] = rd.get("device", 0)
        report["resident_device_bytes_expected"] = sum(
            f32[r].nbytes for r in my_ranks)
        assert all(isinstance(f_res[r], torch.Tensor)
                   and f_res[r].device == dev for r in my_ranks)
        report["f32_host"] = {r: _digest(f_host[r]) for r in my_ranks}
        report["f32_resident"] = {r: _digest(f_res[r]) for r in my_ranks}

        # The ring permute across the processes against its plain version
        plane = world.device_plane()
        ring_ok = {}
        launches0 = _build.LAUNCHES["ring_permute"]
        for shift in (1, 2, 3):
            for dtype in (np.int32, np.float32, np.int64):
                src = {r: (f32[r] * (shift + 1)).astype(dtype)
                       for r in range(N)}
                want = ring_permute([torch.from_numpy(src[r])
                                     for r in range(N)], shift)
                got = run_ranks(lambda r: plane.ring_permute(
                    r, torch.from_numpy(src[r]).to(dev), shift))
                ring_ok[f"{shift}/{np.dtype(dtype).name}"] = all(
                    torch.equal(got[r].cpu(), want[r]) for r in my_ranks)
        report["ring"] = ring_ok
        report["ring_launches"] = _build.LAUNCHES["ring_permute"] - launches0

        # An ineligible op takes the host ladder and still agrees
        op = UserOp(lambda a, b: np.maximum(a, b), commute=True)
        fb = run_ranks(lambda r: world.allreduce(r, ar[r].copy(), op))
        fb_expected = np.max(np.stack([ar[r] for r in range(N)]), axis=0)
        for r in my_ranks:
            assert np.array_equal(fb[r], fb_expected), r
        plane = world.device_plane()
        summary = plane.summary() if plane else {}
        report["disabled"] = summary.get("disabled", "GONE")
        report["process_index"] = summary.get("process_index")
        report["process_count"] = summary.get("process_count")
        report["rounds"] = summary.get("rounds")
    except Exception as e:  # noqa: BLE001 — reported to the parent
        report = {"ok": False, "err": repr(e)[:500]}
    finally:
        server.stop()
        broker.clear()
        world.close()
        leave_device_plane()
    print("REPORT " + json.dumps(report), flush=True)


def _single_process_plane(datas: dict, device: str) -> dict:
    """The single-process plane's allreduce of ``datas`` (rank → array)
    on ``device``: rank → digest."""
    from faabric_tpu_torch.device_plane import DevicePlane
    from faabric_tpu_torch.mpi import MpiOp

    plane = DevicePlane(9921, [torch.device(device)] * N, range(N), 0)
    out = {}

    def go(r):
        out[r] = plane.allreduce(r, datas[r].copy(), MpiOp.SUM)

    threads = [threading.Thread(target=go, args=(r,)) for r in range(N)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    return {r: _digest(out[r]) for r in range(N)}


def _read_line(proc, prefix: str, timeout: float) -> str:
    """The first line of ``proc``'s output that starts with ``prefix``
    (its other lines are skipped); "" if it ends or ``timeout`` passes
    first."""
    got = []

    def read():
        for line in proc.stdout:
            if line.startswith(prefix):
                got.append(line.strip())
                return

    t = threading.Thread(target=read, daemon=True)
    t.start()
    t.join(timeout)
    return got[0] if got else ""


def world_across_processes(device: str, base: int, hold) -> list[dict]:
    """Two children, 2 + 2 ranks of one world on ``device`` over a
    2-process plane, at port offsets ``base`` + 1000 and + 2000 (their
    ports held by ``hold(ports)``, which returns listening sockets or []
    when one is taken); each child's report, checked against the
    single-process plane's fold on ``device``."""
    from faabric_tpu_torch.transport.bulk import BULK_PORT
    from faabric_tpu_torch.transport.common import (
        MPI_BASE_PORT,
        MPI_PORTS_PER_HOST,
        PLANNER_SYNC_PORT,
        STATE_ASYNC_PORT,
    )

    coord_port = MPI_BASE_PORT + MPI_PORTS_PER_HOST - 1
    service = [*range(STATE_ASYNC_PORT, PLANNER_SYNC_PORT + 1), BULK_PORT]
    offsets = [base + 1000 * (i + 1) for i in range(N_PROCS)]
    # Each child's service ports, and the coordinator's in the first,
    # held by listening sockets until the child binds them
    held = [hold([*(off + p for p in service),
                  *([off + coord_port] if i == 0 else [])])
            for i, off in enumerate(offsets)]
    if not all(held):
        for socks in held:
            for s in socks:
                s.close()
        return []
    env = {**os.environ, "FAABRIC_HOST_ALIASES": ",".join(
        f"{h}=127.0.0.1+{o}" for h, o in zip(HOSTS, offsets)),
        "PYTHONPATH": ROOT}
    env.pop("FAABRIC_LOCKCHECK", None)
    children = []
    try:
        for i in range(N_PROCS):
            fds = [s.fileno() for s in held[i]]
            children.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--dp-child",
                 str(i), str(coord_port), device], stdout=subprocess.PIPE,
                stderr=subprocess.DEVNULL, stdin=subprocess.DEVNULL,
                text=True, cwd=ROOT, pass_fds=fds,
                env={**env, "PROCS_HELD_FDS": ",".join(map(str, fds))}))
    finally:
        for socks in held:
            for s in socks:
                s.close()
    reports = []
    try:
        for c in children:
            assert _read_line(c, "READY", CHILD_TIMEOUT_S) == "READY"
        for c in children:
            line = _read_line(c, "REPORT ", CHILD_TIMEOUT_S)
            assert line, f"child exited with {c.poll()} and no report"
            reports.append(json.loads(line[len("REPORT "):]))
    finally:
        for c in children:
            try:
                c.wait(timeout=30)
            except subprocess.TimeoutExpired:
                c.kill()
                c.wait(30)
            c.stdout.close()
    ins = _inputs()
    single = _single_process_plane(ins["f32"], device)
    for i, rep in enumerate(reports):
        assert rep["ok"], f"process {i}: {rep.get('err')}"
        assert rep["activated"]
        # (a) bitwise, checked in the child; (b) the payload rode the
        # device rows, none of it the host data planes
        assert rep["device_bytes"] == rep["device_bytes_expected"], rep
        assert rep["host_plane_bytes"] == 0, rep
        # (c) resident rounds: zero host↔device copies, zero host bytes
        assert rep["resident_copy_count"] == 0, rep
        assert rep["resident_copy_bytes"] == 0, rep
        assert rep["resident_host_plane_bytes"] == 0, rep
        assert rep["resident_device_bytes"] == \
            rep["resident_device_bytes_expected"], rep
        # fp32 bitwise equal to the single-process plane's fold
        for r, dig in rep["f32_host"].items():
            assert dig == single[int(r)], (i, r)
        for r, dig in rep["f32_resident"].items():
            assert dig == single[int(r)], (i, r)
        assert rep["ring"] and all(rep["ring"].values()), rep["ring"]
        # (d) the ineligible op never entered the rung
        assert rep["disabled"] is None, rep
        assert rep["process_index"] == i and rep["process_count"] == 2, rep
        assert rep["rounds"]["ring_permute"] == 9, rep["rounds"]
        # One ring-kernel launch a round in each process on the card (the
        # CPU runs the plain version)
        assert rep["ring_launches"] == (9 if device.startswith("cuda")
                                        else 0), rep
    return reports


def test_world_across_two_processes_matches_host_ring_and_single_plane():
    from tests.test_torch_mpi import _hold_ports
    from tests.test_torch_multiprocess import port_slot

    for _ in range(20):
        reports = world_across_processes(
            "cpu", port_slot(), lambda ports: _hold_ports(ports, listen=True))
        if reports:
            break
    assert len(reports) == N_PROCS


# ---------------------------------------------------------------------------
# DevicePlaneSpec
# ---------------------------------------------------------------------------

SPECS = [("xdp0", 8531, 2, 0), ("xdp1", 8020, 4, 3), ("127.0.0.1", 29500, 1, 0)]


@pytest.mark.parametrize("fields", SPECS)
def test_device_plane_spec_round_trips_as_the_reference(fields):
    from faabric_tpu.parallel.distributed import DevicePlaneSpec as RefSpec
    from faabric_tpu.transport.common import (
        clear_host_aliases as ref_clear,
        register_host_alias as ref_alias,
    )

    from faabric_tpu_torch.parallel import DevicePlaneSpec
    from faabric_tpu_torch.transport import (
        clear_host_aliases,
        register_host_alias,
    )

    spec, ref = DevicePlaneSpec(*fields), RefSpec(*fields)
    assert spec.to_dict() == ref.to_dict()
    assert DevicePlaneSpec.from_dict(spec.to_dict()) == spec
    assert DevicePlaneSpec.from_dict(json.loads(json.dumps(
        ref.to_dict()))) == spec
    try:
        for alias in (register_host_alias, ref_alias):
            alias("xdp0", "127.0.0.1", 3000)
            alias("xdp1", "127.0.0.1", 5000)
        assert spec.coordinator_address() == ref.coordinator_address()
    finally:
        clear_host_aliases()
        ref_clear()


# ---------------------------------------------------------------------------
# The planner's roster against the reference's
# ---------------------------------------------------------------------------

# Steps: (host, n) joins, "clear" or "reset"
SEQUENCES = {
    "two": [("a", 2), ("b", 2), ("a", 2), ("b", 2), ("a", 2)],
    "three_late": [("c", 3), ("a", 3), ("c", 3), ("b", 3), ("a", 3)],
    "size_mismatch": [("a", 2), ("b", 3), ("b", 2)],
    "full": [("a", 2), ("b", 2), ("c", 2), ("a", 2)],
    "unregistered_coordinator": [("z", 2), ("a", 2), ("z", 2)],
    "clear_then_rejoin": [("a", 2), ("b", 2), "clear", ("b", 2), ("a", 2),
                          ("b", 2)],
    "reset": [("a", 1), "reset", ("b", 2), ("a", 2)],
    "one": [("b", 1), ("b", 1)],
}


def _run_roster(planner, steps) -> list:
    out = []
    for step in steps:
        if step == "clear":
            planner.clear_device_plane()
            out.append("cleared")
            continue
        if step == "reset":
            planner.reset()
            for h in ("a", "b", "c"):
                planner.register_host(h, 4)
            out.append("reset")
            continue
        host, n = step
        try:
            out.append(planner.join_device_plane(host, n))
        except ValueError as e:
            out.append(f"ValueError: {e}")
    return out


def _planners():
    from faabric_tpu.planner.planner import Planner as RefPlanner

    from faabric_tpu_torch.planner.planner import Planner

    made = [RefPlanner(), Planner()]
    for p in made:
        for h in ("a", "b", "c"):
            p.register_host(h, 4)
    return made


def _close(planners) -> None:
    for p in planners:
        ingress = getattr(p, "ingress", None)
        if ingress is not None:
            ingress.stop()
        close = getattr(p, "close_journal", None)
        if close is not None:
            close()


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_planner_roster_matches_the_reference(name):
    planners = _planners()
    try:
        ref, port = (_run_roster(p, SEQUENCES[name]) for p in planners)
        assert port == ref
        # The coordinator's port comes from its host's MPI pool and goes
        # back at the clear
        for p in planners:
            p.clear_device_plane()
        assert planners[1]._device_plane == {"roster": [], "size": 0,
                                             "port": 0}
        with planners[1]._lock:
            used = {h: set(st.used_mpi_ports)
                    for h, st in planners[1]._hosts.items()}
        with planners[0]._lock:
            ref_used = {h: set(st.used_mpi_ports)
                        for h, st in planners[0]._hosts.items()}
        assert used == ref_used
    finally:
        _close(planners)


def test_planner_roster_through_the_rpc_matches_the_reference():
    from faabric_tpu.planner.planner import Planner as RefPlanner

    from faabric_tpu_torch.planner import PlannerServer, get_planner
    from faabric_tpu_torch.planner.client import PlannerClient
    from faabric_tpu_torch.transport import (
        clear_host_aliases,
        register_host_alias,
    )
    from tests.conftest import next_port_base

    base = next_port_base()
    register_host_alias("xdpplanner", "127.0.0.1", base)
    get_planner().reset()
    server = PlannerServer(port_offset=base)
    server.start()
    ref = RefPlanner()
    clients = {}
    try:
        for h in ("a", "b"):
            clients[h] = PlannerClient(h, "xdpplanner")
            clients[h].register_host(4, 0, overwrite=True)
            ref.register_host(h, 4)
        got, want = [], []
        for h in ("a", "b", "a", "b"):
            spec = clients[h].join_device_plane(2)
            got.append(None if spec is None else spec.to_dict())
            want.append(ref.join_device_plane(h, 2))
        assert got == want
        with pytest.raises(Exception, match="already sized 2"):
            clients["a"].join_device_plane(3)
    finally:
        for c in clients.values():
            c.close()
        server.stop()
        get_planner().reset()
        _close([ref])
        clear_host_aliases()


# ---------------------------------------------------------------------------
# The verdict over two processes' rows
# ---------------------------------------------------------------------------

def _two_process_rows(kind="cpu"):
    from faabric_tpu_torch.device_plane import registration_row

    rows = np.stack([registration_row(r, torch.device(kind))
                     for r in range(N)])
    rows[:, 2] = 0
    rows[:, 3] = [r // RANKS_PER_PROC for r in range(N)]
    return rows


def _table(kind="cpu", uuids=("", "")):
    from faabric_tpu_torch.parallel import PlaneDevice

    dev = torch.device(kind) if kind == "cpu" else torch.device(kind, 0)
    return [PlaneDevice(p, dev, uuids[p]) for p in range(N_PROCS)]


@pytest.mark.parametrize("me", range(N_PROCS))
def test_resolve_mesh_accepts_the_matching_process_split(me):
    from faabric_tpu_torch.device_plane import resolve_mesh
    from faabric_tpu_torch.device_plane.registry import rank_processes

    rows = _two_process_rows()
    local = [r for r in range(N) if r // RANKS_PER_PROC == me]
    got = resolve_mesh(rows, N, local, process_index=me, table=_table())
    assert got == [torch.device("cpu")] * N
    assert rank_processes(rows, N) == [0, 0, 1, 1]


@pytest.mark.parametrize("local,match", [
    ([0], "disagrees with device"),
    ([0, 1, 2], "disagrees with device"),
    ([2, 3], "disagrees with device"),
])
def test_resolve_mesh_refuses_a_split_that_disagrees(local, match):
    from faabric_tpu_torch.device_plane import MeshMismatch, resolve_mesh

    with pytest.raises(MeshMismatch, match=match):
        resolve_mesh(_two_process_rows(), N, local, process_index=0,
                     table=_table())


def test_resolve_mesh_over_cards_by_uuid(monkeypatch):
    """Processes on one card (equal UUIDs) form a plane; on two cards the
    verdict names the queued multi-card item; a remote device missing
    from the plane's table, or no joined plane, refuses too."""
    from faabric_tpu_torch.device_plane import MeshMismatch, resolve_mesh

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    rows = _two_process_rows("cuda")
    same = _table("cuda", ("GPU-1", "GPU-1"))
    assert resolve_mesh(rows, N, [0, 1], process_index=0, table=same) == \
        [torch.device("cuda", 0)] * N
    with pytest.raises(MeshMismatch, match="Queue 1 step 9"):
        resolve_mesh(rows, N, [0, 1], process_index=0,
                     table=_table("cuda", ("GPU-1", "GPU-2")))
    bad = rows.copy()
    bad[2:, 2] = 1  # process 1's card 1, which its table does not hold
    with pytest.raises(MeshMismatch, match="not in this backend"):
        resolve_mesh(bad, N, [0, 1], process_index=0, table=same)
    mixed = _table() + _table("cuda", ("GPU-1", "GPU-1"))
    with pytest.raises(MeshMismatch, match="a plane's processes share"):
        resolve_mesh(np.concatenate([_two_process_rows()[:2], rows[2:]]),
                     N, [0, 1], process_index=0, table=mixed)
    with pytest.raises(MeshMismatch, match="joined no device plane"):
        resolve_mesh(rows, N, [0, 1], process_index=0)


def test_plane_across_processes_needs_an_exchange_name():
    """A plane whose ranks live in several processes exchanges under a
    name every process gives it alike and no other activation reuses;
    made without one, it raises."""
    from faabric_tpu_torch.device_plane import DevicePlane

    with pytest.raises(ValueError, match="exchange_name"):
        DevicePlane(9922, [torch.device("cpu")] * N, [0, 1], 0,
                    processes=[0, 0, 1, 1])


# ---------------------------------------------------------------------------
# The planeworker pair through a planner process
# ---------------------------------------------------------------------------

def test_planeworkers_form_an_eight_device_plane_through_the_planner():
    """Two ``planeworker`` processes join a 2-process plane through a
    planner process at boot, with four CPU entries each: both see 8
    global devices, one owns ranks 0-3 and the other 4-7, and each
    checks its own shards of an allreduce and an allgather."""
    from tests.test_torch_multiprocess import ProcCluster

    cluster = ProcCluster("xpw", {"xpw1": 1, "xpw2": 1},
                          worker_role="planeworker", worker_args=("2",))
    try:
        cluster.start()
        lines = [cluster.ready[w]["plane"] for w in cluster.workers]
        # Both leave the plane together, as a cluster's workers stop
        for w in cluster.workers:
            cluster.children[w].proc.stdin.close()
    finally:
        cluster.stop()
    assert all(line.startswith("PLANE-OK") for line in lines), lines
    assert {line.split("gdev=")[1].split()[0] for line in lines} == {"8"}
    assert {line.split("ldev=")[1].split()[0] for line in lines} == {"4"}
    ranks = {line.split("ranks=")[1] for line in lines}
    assert ranks == {"[0, 1, 2, 3]", "[4, 5, 6, 7]"}, ranks


if __name__ == "__main__":
    if "--dp-child" in sys.argv:
        i = sys.argv.index("--dp-child")
        _child_main(int(sys.argv[i + 1]), int(sys.argv[i + 2]),
                    sys.argv[i + 3])
