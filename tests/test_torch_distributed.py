"""The device plane across processes: the port against the JAX package.

Counterpart of ``tests/dist/test_device_plane.py`` and of
``tests/dist/test_multiprocess.py::test_device_plane_cross_process_
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
  addressable collectives (and their backward) see an 8-device plane
  split 4 + 4, and which run the reference's sharded train steps across
  the processes: 2 steps over (dp 4, tp 2) and one 1F1B step over (dp
  2, tp 2, pp 2) with every pp hop crossing the processes. Both
  processes report equal losses; the losses, the whole weights and the
  last step's gradients are bitwise the port's single-process mesh's,
  and within the JAX tests' tolerances of the JAX package's steps on
  the conftest's 8 devices, from the same ``init_params(PRNGKey(0))``;
- two processes joined directly at a coordinator, running the step with
  tp crossing the processes under remat (activation allreduces with
  gradients across the boundary, rerun in the recomputation) and with a
  clip norm that bites, both bitwise the single-process mesh's;
- in this process, over a mesh of plane devices of which another
  process holds half: what each process holds and computes, and the
  forms that stay refused across processes (sharded serving, local
  ranks on several devices), naming their ``ROADMAP.md`` items. The
  other training forms across processes are
  ``tests/test_torch_xproc_forms.py``'s.

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


def _steps_child_main(my_idx: int, coord_port: int, weights: str, out: str,
                      runs: str) -> None:
    """One process of a 2-process plane (four CPU entries), joined
    directly at the coordinator: ``tests/test_torch_procs.py::
    plane_step_runs`` of the comma-separated ``runs`` on one intra-op
    thread, its results written to ``<out>/<my_idx>.npz``; the run
    ``collectives`` is ``plane_collective_runs``, written to
    ``<out>/<my_idx>-collectives.npz``, and the report takes
    ``changed_input_error``'s message as ``inplace``."""
    for fd in filter(None, os.environ.pop("PROCS_HELD_FDS", "").split(",")):
        os.close(int(fd))
    torch.set_num_threads(1)
    from faabric_tpu_torch.parallel import global_devices
    from faabric_tpu_torch.parallel.distributed import (
        DevicePlaneSpec,
        join_device_plane,
        leave_device_plane,
    )
    from tests.test_torch_procs import (
        _step_weights,
        changed_input_error,
        plane_collective_runs,
        plane_step_runs,
        save_collective_runs,
        save_step_runs,
    )

    join_device_plane(DevicePlaneSpec(
        coordinator_host=HOSTS[0], coordinator_port=coord_port,
        num_processes=N_PROCS, process_id=my_idx),
        local_devices=["cpu"] * 4, init_timeout_s=90)
    print("READY", flush=True)
    report = {"ok": True, "err": ""}
    try:
        runs = runs.split(",")
        steps = [run for run in runs if run != "collectives"]
        got = plane_step_runs(global_devices(), _step_weights(weights),
                              steps)
        save_step_runs(os.path.join(out, f"{my_idx}.npz"), got)
        report["ranks"] = {run: g["ranks"] for run, g in got.items()}
        report["crossing"] = {run: g["crossing"] for run, g in got.items()}
        if "collectives" in runs:
            save_collective_runs(
                os.path.join(out, f"{my_idx}-collectives.npz"),
                plane_collective_runs(global_devices()))
            report["inplace"] = changed_input_error(global_devices())
        modules = {m.split(".")[0] for m in sys.modules}
        report["jax"] = sorted(modules & {"jax", "jaxlib", "faabric_tpu"})
    except Exception as e:  # noqa: BLE001 — reported to the parent
        import traceback

        report = {"ok": False, "err": traceback.format_exc()[-2000:]}
    finally:
        leave_device_plane()
    print("REPORT " + json.dumps(report), flush=True)


def steps_across_processes(runs, weights: str, out: str, base: int,
                           hold) -> list[dict]:
    """Two ``--steps-child`` processes over a 2-process CPU plane whose
    coordinator listens at ``base`` + 1000 plus the MPI range's last
    port (held by ``hold(ports)`` until the first child binds it; []
    when taken): each child's report, [] when the port was taken. The
    state port at ``base``, which neither child binds, stays held until
    both have ended: other test workers' ``next_port_base()`` keeps off
    the slot while the children start and run."""
    from faabric_tpu_torch.transport.common import (
        MPI_BASE_PORT,
        MPI_PORTS_PER_HOST,
        STATE_ASYNC_PORT,
    )

    coord_port = MPI_BASE_PORT + MPI_PORTS_PER_HOST - 1
    guard = hold([base + STATE_ASYNC_PORT])
    try:
        return _steps_children(runs, weights, out, base, coord_port,
                               hold) if guard else []
    finally:
        for sock in guard:
            sock.close()


def _steps_children(runs, weights: str, out: str, base: int,
                    coord_port: int, hold) -> list[dict]:
    """:func:`steps_across_processes`' two children, their coordinator's
    port held by ``hold`` until the first binds it: their reports, []
    when the port was taken."""
    held = hold([base + 1000 + coord_port])
    if not held:
        return []
    env = {**os.environ, "PYTHONPATH": ROOT, "FAABRIC_HOST_ALIASES": ",".join(
        f"{h}=127.0.0.1+{base + 1000 * (i + 1)}"
        for i, h in enumerate(HOSTS))}
    env.pop("FAABRIC_LOCKCHECK", None)
    children = []
    try:
        for i in range(N_PROCS):
            fds = [s.fileno() for s in held] if i == 0 else []
            children.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--steps-child",
                 str(i), str(coord_port), weights, out, ",".join(runs)],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                stdin=subprocess.DEVNULL, text=True, cwd=ROOT, pass_fds=fds,
                env={**env, "PROCS_HELD_FDS": ",".join(map(str, fds))}))
    finally:
        for sock in held:
            sock.close()
    reports = []
    try:
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
    return reports


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
# The planeworker pair through a planner process, and its train steps
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def step_weights(tmp_path_factory):
    """The JAX package's ``init_params(PRNGKey(0))`` at the planeworker's
    config: (an ``.npz`` of its leaves by name, the pytree)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from faabric_tpu.models import ModelConfig as JaxConfig
    from faabric_tpu.models import init_params

    from faabric_tpu_torch.models.transformer import _leaves
    from tests.test_torch_procs import STEP_CFG

    jcfg = JaxConfig(**{k: v for k, v in STEP_CFG.items()
                        if k not in ("attention_impl", "norm_impl")},
                     compute_dtype=jnp.float32)
    params = jax.tree.map(np.asarray, init_params(jax.random.PRNGKey(0),
                                                  jcfg))
    path = str(tmp_path_factory.mktemp("plane-steps") / "weights.npz")
    np.savez(path, **dict(_leaves(params)))
    return path, params


@pytest.fixture(scope="module")
def planeworkers(step_weights, tmp_path_factory):
    """Two ``planeworker`` processes through a planner process, four CPU
    entries each: (their ``PLANE-`` lines, their step results)."""
    from tests.test_torch_multiprocess import ProcCluster
    from tests.test_torch_procs import load_step_runs

    out = tmp_path_factory.mktemp("planeworkers")
    cluster = ProcCluster("xpw", {"xpw1": 1, "xpw2": 1},
                          worker_role="planeworker", worker_args=("2",),
                          worker_env={"PLANE_WEIGHTS": step_weights[0],
                                      "PLANE_OUT": str(out)})
    try:
        cluster.start()
        lines = [cluster.ready[w]["plane"] for w in cluster.workers]
        # Both leave the plane together, as a cluster's workers stop
        for w in cluster.workers:
            cluster.children[w].proc.stdin.close()
    finally:
        cluster.stop()
    runs = [load_step_runs(str(out / f"{w}.npz"))
            if (out / f"{w}.npz").exists() else None
            for w in cluster.workers]
    return lines, runs


def _one_thread(fn):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return fn()
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def single_process_steps(step_weights):
    """The same runs over the port's single-process mesh of 8 CPU ranks,
    on one intra-op thread as the children."""
    from tests.test_torch_procs import STEP_RUNS, plane_step_runs

    return _one_thread(lambda: plane_step_runs(
        [torch.device("cpu")] * 8, step_weights[1], tuple(STEP_RUNS)))


def test_planeworkers_form_an_eight_device_plane_through_the_planner(
        planeworkers):
    """Two ``planeworker`` processes join a 2-process plane through a
    planner process at boot, with four CPU entries each: both see 8
    global devices, one owns ranks 0-3 and the other 4-7, each checks
    its own shards of the addressable collectives and their backward,
    and both ran the same train steps: equal ``loss`` and ``pp_loss``,
    as the reference's test holds its two controllers."""
    lines, runs = planeworkers
    assert all(line.startswith("PLANE-OK") for line in lines), lines
    assert {line.split("gdev=")[1].split()[0] for line in lines} == {"8"}
    assert {line.split("ldev=")[1].split()[0] for line in lines} == {"4"}
    ranks = {line.split("ranks=")[1] for line in lines}
    assert ranks == {"[0, 1, 2, 3]", "[4, 5, 6, 7]"}, ranks
    assert len({line.split(" loss=")[1].split()[0] for line in lines}) == 1
    assert len({line.split("pp_loss=")[1].split()[0]
                for line in lines}) == 1
    assert all(r is not None for r in runs)
    for run in ("dense", "pp"):
        assert runs[0][run]["losses"] == runs[1][run]["losses"], run


@pytest.mark.parametrize("run", ["dense", "pp"])
def test_planeworker_steps_are_bitwise_the_single_process_mesh(
        planeworkers, single_process_steps, run):
    """Each process's losses, whole weights after the steps and last
    step's gradients (each shard's sum over its holders) are bitwise the
    port's single-process mesh's on the same weights and batches: the
    exchanger folds in rank order with the single-process code, and each
    process seeds its loss copies so that the allreduce's backward gives
    every rank exactly 1 (a 1 in each process would double every
    gradient)."""
    _, runs = planeworkers
    want = single_process_steps[run]
    for got in runs:
        assert [float(x) for x in got[run]["losses"]] == want["losses"]
        assert set(got[run]["params"]) == set(want["params"])
        for name, arr in want["params"].items():
            assert np.array_equal(got[run]["params"][name], arr), name
        for name, arr in want["grads"].items():
            assert np.array_equal(got[run]["grads"][name], arr), name


def _jax_steps(run: str, params) -> tuple[list, dict]:
    """The JAX package's steps of ``run`` on the conftest's 8 devices:
    (losses, whole weights by leaf name)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from faabric_tpu.models import ModelConfig as JaxConfig
    from faabric_tpu.models import data_sharding as jax_data_sharding
    from faabric_tpu.models import init_train_state as jax_init_train_state
    from faabric_tpu.models import make_train_step as jax_make_train_step
    from faabric_tpu.parallel import MeshConfig as JaxMeshConfig
    from faabric_tpu.parallel import build_mesh as jax_build_mesh
    from faabric_tpu.parallel.pipeline import (
        init_pp_train_state as jax_init_pp_train_state,
        make_pp_train_step as jax_make_pp_train_step,
    )

    from faabric_tpu_torch.models.transformer import _leaves
    from tests.test_torch_procs import STEP_CFG

    jcfg = JaxConfig(**{k: v for k, v in STEP_CFG.items()
                        if k not in ("attention_impl", "norm_impl")},
                     compute_dtype=jnp.float32)
    rng = np.random.RandomState(0)
    draws = [rng.randint(0, 128, (8, 16)).astype(np.int32) for _ in range(4)]
    if run == "dense":
        mesh = jax_build_mesh(jax.devices()[:8], JaxMeshConfig(tp=2))
        p, state = jax_init_train_state(jax.random.PRNGKey(0), jcfg, mesh)
        step = jax_make_train_step(jcfg, mesh)
        losses = []
        for tok, tgt in (draws[0:2], draws[2:4]):
            p, state, loss = step(p, state,
                                  jax.device_put(tok, jax_data_sharding(mesh)),
                                  jax.device_put(tgt, jax_data_sharding(mesh)))
            losses.append(float(loss))
    else:
        # The reference's run: its first two draws went to the dense step
        ds = sorted(jax.devices()[:8], key=lambda d: d.id)
        mesh = jax_build_mesh([ds[i] for i in (0, 1, 4, 5, 2, 3, 6, 7)],
                              JaxMeshConfig(tp=2, pp=2))
        rng = np.random.RandomState(0)
        draws = [rng.randint(0, 128, (8, 16)).astype(np.int32)
                 for _ in range(6)]
        p, state = jax_init_pp_train_state(jax.random.PRNGKey(0), jcfg, mesh)
        step = jax_make_pp_train_step(jcfg, mesh, n_microbatches=2,
                                      schedule_name="1f1b")
        batch = NamedSharding(mesh, P("dp", None))
        p, state, loss = step(p, state, jax.device_put(draws[4], batch),
                              jax.device_put(draws[5], batch))
        losses = [float(loss)]
    return losses, dict(_leaves(jax.tree.map(np.asarray, p)))


@pytest.mark.parametrize("run", ["dense", "pp"])
def test_planeworker_steps_match_the_jax_package(planeworkers, step_weights,
                                                 run):
    """The two processes' steps against the JAX package's
    ``make_train_step`` and ``make_pp_train_step`` on the conftest's 8
    devices, from the same ``init_train_state(PRNGKey(0))`` and batches:
    the losses within 1e-5, the weights as ``assert_adam_close`` holds
    them (every element within lr a step, all but one in a thousand
    within 2e-6), as ``tests/test_torch_dryrun.py`` holds the
    single-process step."""
    from tests.test_torch_train import assert_adam_close

    want_losses, want = _jax_steps(run, step_weights[1])
    _, runs = planeworkers
    for got in runs:
        np.testing.assert_allclose([float(x) for x in got[run]["losses"]],
                                   want_losses, atol=1e-5)
        assert set(got[run]["params"]) == set(want)
        assert_adam_close(got[run]["params"], want, 2e-6, 3e-4,
                          len(want_losses))


# The runs of STEP_RUNS held in two processes joined at a coordinator
SPLIT_RUNS = ("tp_cross", "clip", "pp_split", "accum")


@pytest.fixture(scope="module")
def crossing_steps(step_weights, tmp_path_factory):
    """``SPLIT_RUNS`` of ``STEP_RUNS`` in two processes joined directly
    at a coordinator: (their reports, their step results)."""
    from tests.test_torch_mpi import _hold_ports
    from tests.test_torch_multiprocess import port_slot
    from tests.test_torch_procs import load_step_runs

    out = tmp_path_factory.mktemp("crossing-steps")
    for _ in range(20):
        reports = steps_across_processes(
            SPLIT_RUNS, step_weights[0], str(out), port_slot(),
            lambda ports: _hold_ports(ports, listen=True))
        if reports:
            break
    assert len(reports) == N_PROCS
    for i, rep in enumerate(reports):
        assert rep["ok"], f"process {i}: {rep['err']}"
    return reports, [load_step_runs(str(out / f"{i}.npz"))
                     for i in range(N_PROCS)]


def _assert_runs_bitwise(got: dict, want: dict) -> None:
    assert [float(x) for x in got["losses"]] == want["losses"]
    for kind in ("params", "grads"):
        assert set(got[kind]) == set(want[kind])
        for name, arr in want[kind].items():
            assert np.array_equal(got[kind][name], arr), (kind, name)


def test_tp_crossing_the_processes_under_remat_is_bitwise_one_process(
        crossing_steps, single_process_steps):
    """Two steps over (dp 4, tp 2) laid in the order (0, 4, 1, 5, 2, 6,
    3, 7), so that every tp pair spans the processes, with remat on:
    the activation allreduces cross the boundary with their gradients,
    forward and again in each block's recomputation. Both processes'
    losses, weights and gradients are bitwise the single-process
    mesh's."""
    reports, runs = crossing_steps
    assert reports[0]["ranks"]["tp_cross"] == [0, 2, 4, 6]
    assert reports[1]["ranks"]["tp_cross"] == [1, 3, 5, 7]
    assert all(rep["crossing"]["tp_cross"] for rep in reports)
    assert all(rep["jax"] == [] for rep in reports)
    for got in runs:
        _assert_runs_bitwise(got["tp_cross"], single_process_steps["tp_cross"])


def test_clip_norm_across_the_processes_is_bitwise_one_process(
        crossing_steps, single_process_steps, step_weights):
    """Two steps with ``clip_norm`` 0.05, under the first step's gradient
    norm, so that the clip scales every gradient: each shard's squares
    counted once over the plane, whichever process holds its first
    holder (here all of them the first process's), and the steps bitwise
    the single-process mesh's."""
    from faabric_tpu_torch.models import (
        data_sharding,
        loss_fn,
        params_from_jax,
    )
    from faabric_tpu_torch.models.train import backward_copies
    from faabric_tpu_torch.parallel import MeshConfig, build_mesh
    from tests.test_torch_procs import STEP_RUNS, step_config

    _, runs = crossing_steps
    for got in runs:
        _assert_runs_bitwise(got["clip"], single_process_steps["clip"])
    # The clip bites on the first step
    clip, seed = STEP_RUNS["clip"]["clip"], STEP_RUNS["clip"]["seed"]
    mesh = build_mesh([torch.device("cpu")] * 8, MeshConfig(tp=2))
    model = params_from_jax(step_weights[1], step_config(), mesh=mesh)
    rng = np.random.RandomState(seed)
    tok, tgt = (data_sharding(mesh).shard(
        rng.randint(0, 128, (8, 16)).astype(np.int32)) for _ in range(2))
    backward_copies(loss_fn(model, tok, tgt))
    model.allreduce_grads()
    assert float(model.grad_norm()) > 4 * clip


@pytest.mark.parametrize("run,ranks", [
    ("pp_split", ([0, 1, 2, 3], [4, 5, 6, 7])),
    ("accum", ([0, 1, 2, 3], [4, 5, 6, 7]))])
def test_split_layouts_are_bitwise_one_process(crossing_steps,
                                               single_process_steps, run,
                                               ranks):
    """Two more layouts across the processes, bitwise the single-process
    mesh's: 1F1B with each process holding half of each stage (the hops
    inside a process, the stage's in-stage groups too, the stacked
    slabs' gradients crossing over dp; remat on), and the (dp 4, tp 2)
    step accumulating 2 microbatches (two backward passes across the
    processes before the one update)."""
    reports, runs = crossing_steps
    assert tuple(rep["ranks"][run] for rep in reports) == ranks
    assert not any(rep["crossing"][run] for rep in reports)
    for got in runs:
        _assert_runs_bitwise(got[run], single_process_steps[run])


# ---------------------------------------------------------------------------
# A mesh of which another process holds half, in this process
# ---------------------------------------------------------------------------

def _plane_entries(order=tuple(range(8))):
    """Eight plane devices, 0-3 this process's (process 0 of an unjoined
    plane), 4-7 another's, in ``order``."""
    from faabric_tpu_torch.parallel import PlaneDevice

    return [PlaneDevice(i // 4, torch.device("cpu")) for i in order]


def test_mesh_over_plane_devices_holds_this_processes_ranks():
    """A mesh over the plane's devices keeps each rank's process: this
    process's ranks have their devices, the others' None; a shard spec
    places only this process's pieces; whether an axis crosses the
    processes is the same answer whichever process asks."""
    from faabric_tpu_torch.parallel import MeshConfig, build_mesh, named

    mesh = build_mesh(_plane_entries(), MeshConfig(tp=2))
    assert mesh.multiprocess and mesh.local_ranks == [0, 1, 2, 3]
    assert mesh.rank_process == [0] * 4 + [1] * 4
    assert mesh.rank_devices[4:] == [None] * 4
    assert mesh.device == torch.device("cpu")
    assert not mesh.crosses("tp") and mesh.crosses("dp")
    assert mesh.crosses(mesh.axis_names)
    pieces = named(mesh, "dp", None).shard(np.arange(16.0).reshape(8, 2))
    assert [p is None for p in pieces] == [False] * 4 + [True] * 4
    assert torch.equal(pieces[2], torch.tensor([[4.0, 5.0], [6.0, 7.0]],
                                               dtype=torch.float64))
    pp = build_mesh(_plane_entries((0, 1, 4, 5, 2, 3, 6, 7)),
                    MeshConfig(tp=2, pp=2))
    assert pp.local_ranks == [0, 1, 4, 5]
    assert pp.crosses("pp") and not pp.crosses("tp")
    assert not pp.crosses("dp")


def test_mesh_over_keeps_groups_inside_this_process_local():
    """Over an axis whose groups all lie in one process, ``over`` runs
    this process's groups with the single-process collectives (autograd
    included) and makes no exchange: the results are the single-process
    mesh's for this process's ranks, None for the others'."""
    from faabric_tpu_torch.parallel import MeshConfig, build_mesh

    xs = [torch.full((3,), float(r + 1), requires_grad=True)
          for r in range(8)]
    one = build_mesh([torch.device("cpu")] * 8, MeshConfig(tp=2))
    want = one.over("tp", xs, "allreduce")
    mesh = build_mesh(_plane_entries(), MeshConfig(tp=2))
    got = mesh.over("tp", [x if r < 4 else None for r, x in enumerate(xs)],
                    "allreduce")
    assert got[4:] == [None] * 4
    for r in range(4):
        assert torch.equal(got[r], want[r])
    torch.autograd.backward(got[:4], [torch.ones(3)] * 4)
    assert [float(xs[r].grad[0]) for r in range(4)] == [2.0] * 4


def test_sharded_model_over_plane_devices_holds_only_its_shards():
    """A ``ShardedTransformer`` over such a mesh builds leaves for this
    process's ranks alone, under the names a single-process model gives
    them; its unique parameters are the copies whose replica group's
    first rank is this process's."""
    from faabric_tpu_torch.models import Transformer, shard_params
    from faabric_tpu_torch.parallel import MeshConfig, build_mesh
    from tests.test_torch_procs import step_config

    cfg = step_config()
    whole = Transformer(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    one = shard_params(whole, build_mesh([torch.device("cpu")] * 8,
                                         MeshConfig(tp=2)), cfg)
    mesh = build_mesh(_plane_entries(), MeshConfig(tp=2))
    model = shard_params(whole, mesh, cfg)
    assert [sh is None for sh in model.shards()] == [False] * 4 + [True] * 4
    names = set(model.state_dict())
    assert names == {k for k in one.state_dict()
                     if int(k.split(".")[1]) < 4}
    for k, v in model.state_dict().items():
        assert torch.equal(v, one.state_dict()[k]), k
    assert len(model.unique_parameters()) == len(one.unique_parameters())
    far = shard_params(whole, build_mesh(_plane_entries(
        (4, 5, 6, 7, 0, 1, 2, 3)), MeshConfig(tp=2)), cfg)
    assert far.unique_parameters() == []


@pytest.mark.parametrize("form", ["decode", "perplexity", "several_devices"])
def test_forms_not_ported_across_processes_raise_naming_their_items(form):
    """What stays refused across processes raises ``NotImplementedError``
    before any exchange, naming its ``ROADMAP.md`` item: sharded decode
    and perplexity (step 13), and a collective whose local ranks lie on
    several devices (step 9)."""
    from faabric_tpu_torch.models import Transformer
    from faabric_tpu_torch.parallel import (
        DeviceCollectives,
        MeshConfig,
        PlaneDevice,
        build_mesh,
    )
    from tests.test_torch_procs import step_config

    cfg = step_config()
    rng = np.random.RandomState(0)
    tok, tgt = (rng.randint(0, 128, (8, 16)).astype(np.int32)
                for _ in range(2))
    item = "step 9" if form == "several_devices" else "step 13"
    with pytest.raises(NotImplementedError, match=item):
        if form == "several_devices":
            col = DeviceCollectives(
                [PlaneDevice(0, torch.device("cpu")),
                 PlaneDevice(0, torch.device("meta")),
                 PlaneDevice(1, torch.device("cpu"))])
            col.scan([torch.zeros(2), torch.zeros(2, device="meta"), None])
        else:
            from faabric_tpu_torch.models import (
                evaluate_perplexity,
                generate,
                shard_params,
            )

            mesh = build_mesh(_plane_entries(), MeshConfig(tp=2))
            model = shard_params(Transformer(
                cfg, device="cpu", generator=torch.Generator().manual_seed(0)),
                mesh, cfg)
            if form == "decode":
                from faabric_tpu_torch.parallel import named

                generate(model, named(mesh, "dp", None).shard(tok[:, :4]), 2)
            else:
                evaluate_perplexity(model, [(tok, tgt)])


if __name__ == "__main__":
    if "--steps-child" in sys.argv:
        i = sys.argv.index("--steps-child")
        _steps_child_main(int(sys.argv[i + 1]), int(sys.argv[i + 2]),
                          *sys.argv[i + 3:i + 6])
    if "--dp-child" in sys.argv:
        i = sys.argv.index("--dp-child")
        _child_main(int(sys.argv[i + 1]), int(sys.argv[i + 2]),
                    sys.argv[i + 3])
